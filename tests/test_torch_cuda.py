"""The port's kernels on the card (marker `cuda`): each kernel (K1-K4 on
the per-element passes, K5-K8 on the H0 rebuild and apply of a
cyclic-reduction plan) against its plain PyTorch version on CUDA tensors,
and DOT steps on the card against the same steps on the CPU (dense and
cyclic-reduction plans). Skipped where there is no CUDA device; on the GPU
machine run

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch

from dot_tpu_torch import partition, scripts
from dot_tpu_torch.config import Config
from dot_tpu_torch.kernels import ops, soa
from dot_tpu_torch.mesh_gen import bar_mesh
from dot_tpu_torch.steppers import DOTStepper, System

pytestmark = pytest.mark.cuda

# f64 agrees to roundoff (1e-10, H 1e-9); f32 to 1e-5 on elementwise
# results and sums, norm-wise 1e-4 on the atomically summed gradient and H
TOL = {torch.float64: (1e-10, 1e-9), torch.float32: (1e-5, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dtype, dev, n_cells=(6, 3, 3)):
    mesh = bar_mesh(*n_cells)
    mesh.set_lame(1e5, 0.4)
    rng = np.random.default_rng(0)
    n = mesh.n_elem

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    x = mesh.V + 0.05 * rng.normal(size=mesh.V.shape)
    return dict(conn=t(mesh.conn.T, torch.int32),
                g9=t(mesh.rest_tri_inv.reshape(-1, 9).T), u=t(mesh.u),
                lam=t(mesh.lam), w=t(mesh.vol), x=t(x),
                p=t(rng.normal(size=mesh.V.shape)),
                F0=t(rng.normal(size=(9, n))), Fp=t(rng.normal(size=(9, n))),
                alpha=torch.tensor(0.5, dtype=dtype, device=dev))


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name", sorted(soa.SOA_MATERIALS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_plain_versions(cuda, dtype, name):
    d = _inputs(dtype, cuda)
    tol, tol_n = TOL[dtype]
    mat = soa.SOA_MATERIALS[name]
    ops.reset_launches()
    ek, sk = ops.ls_trial_energy(d["F0"], d["Fp"], d["alpha"], d["u"],
                                 d["lam"], d["w"], mat, want_sigma=True)
    er, sr = soa.ls_trial_energy_ref(d["F0"], d["Fp"], d["alpha"], d["u"],
                                     d["lam"], d["w"], mat, want_sigma=True)
    assert _rel(ek, er) <= tol and _rel(sk, sr) <= tol
    args = (d["x"], d["conn"], d["conn"], d["g9"], d["u"], d["lam"], d["w"],
            mat)
    assert _rel(ops.elem_gradient(*args), soa.elem_gradient_ref(*args)) \
        <= tol_n
    hargs = (d["x"], d["conn"], d["g9"], d["u"], d["lam"], d["w"], mat,
             0.025 ** 2)
    hk, hr = ops.elem_hessian(*hargs), soa.elem_hessian_ref(*hargs)
    assert _rel(hk, hr) <= tol_n
    fk, qk = ops.direction_pass(d["p"], d["conn"], d["g9"], hr)
    fr, qr = soa.direction_pass_ref(d["p"], d["conn"], d["g9"], hr)
    assert _rel(fk, fr) <= tol and _rel(qk, qr) <= tol
    torch.cuda.synchronize()
    assert all(ops.launches[k] == 1 for k in (
        "ls_trial_energy", "elem_gradient", "elem_hessian",
        "direction_pass")), ops.launches


def test_dot_step_on_card_matches_cpu(cuda):
    mesh = bar_mesh(8, 3, 3)
    cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script="twist", handle_ratio=0.05)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = scripts.init_script(mesh, "twist")
    mesh.fixed_mask = sd.fixed0.copy()
    plan = partition.build_plan(mesh, 4, pad_elem_to=16, pad_n3_to=48)
    out = []
    for dev in ("cpu", cuda):
        st = DOTStepper(System(mesh, cfg, plan, dtype=torch.float64,
                               device=dev), sd)
        s = st.init_state()
        for _ in range(2):
            s, (_, e) = st.step(s)
        out.append((s.x.cpu().numpy(), e))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-9, atol=1e-12)
    assert out[1][1] == pytest.approx(out[0][1], rel=1e-9)


def _banded_scene(dev, dtype):
    """bar 40x3x3 stretch, 2 parts, band_bs_unit 48 (nb 11, bs 96): the
    cyclic-reduction recipe of tests/test_torch_cr.py, on `dev`."""
    mesh = bar_mesh(40, 3, 3)
    cfg = Config(energy="FCR", time_stepper="DOT", partition_amt=2, dt=0.025,
                 rho=1000.0, ym=1e5, pr=0.4, script="stretch",
                 handle_ratio=0.1)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = scripts.init_script(mesh, "stretch")
    mesh.fixed_mask = sd.fixed0.copy()
    plan = partition.build_plan(mesh, 2, pad_elem_to=16, pad_n3_to=48,
                                band_bs_unit=48, band_min_nb=3)
    return mesh, cfg, sd, plan, System(mesh, cfg, plan, dtype=dtype,
                                       device=dev)


# K5-K8 vs plain: f64 1e-12 (K6 1e-10), f32 1e-4, norm-wise
TOL_H0 = {torch.float64: (1e-12, 1e-10), torch.float32: (1e-4, 1e-4)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_h0_kernels_match_plain_versions(cuda, dtype):
    from dot_tpu_torch.kernels import band
    tol, tol_c = TOL_H0[dtype]
    _, _, sd, _, sysm = _banded_scene(cuda, dtype)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(sd.x0 + 0.01 * rng.normal(size=sd.x0.shape),
                        dtype=dtype, device=cuda)
    fixed = torch.as_tensor(sd.fixed0, device=cuda)
    eh = sysm.element_hessians(x)
    freef = sysm._free(fixed).to(dtype).reshape(-1)
    ops.reset_launches()
    fk = ops.band_assemble(eh, freef, sysm.mass_flat, sysm.band_plan)
    fr = band.band_assemble_ref(eh, freef, sysm.mass_flat, sysm.band_plan)
    assert _rel(fk, fr) <= tol
    P, nb, bs = sysm.n_parts, sysm.band_nb, sysm.band_bs
    diag = fk[:P * nb * bs * bs].view(nb, P, bs, bs)
    sub = fk[P * nb * bs * bs:].view(nb - 1, P, bs, bs)
    dsq = torch.sqrt(diag.diagonal(dim1=-2, dim2=-1))
    A = (diag / dsq[..., :, None] / dsq[..., None, :]).reshape(-1, bs, bs)
    A = A.contiguous()
    for sym in (True, False):
        Lk, Xk, bk = ops.chol_inv(A, sym)
        Lr, Xr, br = band.chol_inv_ref(A, sym)
        assert not bk.any() and not br.any()
        assert _rel(Lk, Lr) <= tol_c and _rel(Xk, Xr) <= tol_c
    bad = A[:4].clone()
    bad[2, 3, 3] = -1.0
    Lb, Xb, bb = ops.chol_inv(bad, True)
    assert bb.tolist() == [False, False, True, False]
    assert torch.isnan(Lb[2]).all() and torch.isnan(Xb[2]).all()
    assert torch.isfinite(Lb[[0, 1, 3]]).all()
    fac, d = sysm.factorize((diag, sub), fast=True)
    G = fac.levels[0][1].reshape(-1, bs, bs)
    stores = [G] + ([G.to(torch.float32)] if dtype == torch.float32 else [])
    if dtype == torch.float32:
        assert G.dtype == torch.bfloat16
    v = torch.as_tensor(rng.normal(size=(G.shape[0], bs)), dtype=dtype,
                        device=cuda)
    c = torch.as_tensor(rng.normal(size=(G.shape[0], bs)), dtype=dtype,
                        device=cuda)
    for S in stores:
        for trans in (False, True):
            assert _rel(ops.block_matvec(S, v, c, trans),
                        band.block_matvec_ref(S, v, c, trans)) <= tol
            out = c.clone()
            ops.block_matvec(S, v, out, trans, out=out)
            assert _rel(out, band.block_matvec_ref(S, v, c, trans)) <= tol
    rhs = torch.as_tensor(rng.normal(size=(sysm.n_vert, 3)), dtype=dtype,
                          device=cuda)
    z = torch.as_tensor(rng.normal(size=(P, sysm.n3)), dtype=dtype,
                        device=cuda)
    g = (rhs, sysm.l2g, sysm.local_valid, d)
    a = (z, d, sysm.gath_perm, sysm.gath_segids, sysm.gath_off, sysm.dup)
    assert _rel(ops.h0_gather(*g), band.h0_gather_ref(*g)) <= tol
    assert _rel(ops.h0_average(*a), band.h0_average_ref(*a)) <= tol
    torch.cuda.synchronize()
    assert all(ops.launches[k] > 0 for k in (
        "band_assemble", "chol_inv", "block_matvec", "h0_gather",
        "h0_average")), ops.launches


def test_cr_step_on_card_matches_cpu(cuda):
    """Two DOT steps on the cyclic-reduction plan in f64: the card (K1-K8)
    against the CPU (plain versions)."""
    out = []
    for dev in ("cpu", cuda):
        mesh, cfg, sd, plan, sysm = _banded_scene(dev, torch.float64)
        st = DOTStepper(sysm, sd)
        s = st.init_state()
        for _ in range(2):
            s, (_, e) = st.step(s)
        out.append((s.x.cpu().numpy(), e, type(s.chol).__name__))
    assert out[0][2] == out[1][2] == "CRFactor"
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-9, atol=1e-12)
    assert out[1][1] == pytest.approx(out[0][1], rel=1e-9)
