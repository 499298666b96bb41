"""The port's kernels on the card (marker `cuda`): each kernel (K1-K4 on
the per-element passes, K5-K8 on the H0 rebuild and apply of a
cyclic-reduction plan, K9 on random histories, K10-K11 on a coarse plan,
K5's compact entry point and K12 on a forced chunked rebuild) against its
plain PyTorch version on CUDA tensors, and DOT steps on the card against
the same steps on the CPU (dense, cyclic-reduction, and coarse + chunked
plans). Skipped where there is no CUDA device; on the GPU machine run

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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gradient_with_padding_elements(cuda, dtype):
    """Padding elements (corners 0 for the gather, the dump row nV for the
    scatter, zero weight) add nothing; K2 skips them."""
    d = _inputs(dtype, cuda)
    nv, pad = d["x"].shape[0], 256
    zi = torch.zeros((4, pad), dtype=torch.int32, device=cuda)
    conn = torch.cat([d["conn"], zi], 1)
    conn_s = torch.cat([d["conn"], zi + nv], 1)
    g9 = torch.cat([d["g9"], torch.zeros((9, pad), dtype=dtype,
                                         device=cuda)], 1)
    ones = torch.ones(pad, dtype=dtype, device=cuda)
    u, lam = torch.cat([d["u"], ones]), torch.cat([d["lam"], ones])
    w = torch.cat([d["w"], 0 * ones])
    mat = soa.SOA_MATERIALS["FCR"]
    args = (d["x"], conn, conn_s, g9, u, lam, w, mat)
    gk, gr = ops.elem_gradient(*args), soa.elem_gradient_ref(*args)
    assert _rel(gk, gr) <= TOL[dtype][1]
    assert float(gk[nv].abs().max()) == 0.0 == float(gr[nv].abs().max())


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


# K9-K12 vs plain: f64 1e-12, f32 1e-5 max-rel (norm-wise 1e-4 on sums
# over many terms in another order)
TOL_NEW = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-4)}


def _rel_max(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def _rel0(a, b):
    """Norm-wise relative error; 0 when both are zero (no valid pair)."""
    return float((a - b).norm()) / max(float(b.norm()), 1e-300)


@pytest.mark.parametrize("n", [3000, 400000])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lbfgs_kernels_match_plain_versions(cuda, dtype, n):
    from dot_tpu_torch.kernels import lbfgs
    tol, tol_n = TOL_NEW[dtype]
    rng = np.random.default_rng(7)
    m = 5
    ops.reset_launches()
    for n_valid in range(m + 1):
        S = rng.normal(size=(m, n))
        T = S * rng.uniform(0.5, 2.0, size=(m, n)) + 0.1 * rng.normal(
            size=(m, n))
        valid = np.zeros(m)
        valid[m - n_valid:] = 1.0
        rho = np.where(valid > 0, np.einsum("ki,ki->k", S, T), 1.0)
        S[valid == 0] = 0.0
        T[valid == 0] = 0.0

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=cuda)
        S_, T_, g, r = t(S), t(T), t(rng.normal(size=n)), t(rng.normal(size=n))
        rho_, val_ = t(rho), t(valid)
        k, G = ops.lbfgs_loop1(S_, T_, g, rho_, val_)
        kr, Gr = lbfgs.lbfgs_loop1_ref(S_, T_, g, rho_, val_)
        assert _rel0(G, Gr) <= tol_n and _rel0(k, kr) <= tol_n
        c = ops.lbfgs_loop2(T_, r, kr, Gr, rho_, val_)
        cr = lbfgs.lbfgs_loop2_ref(T_, r, kr, Gr, rho_, val_)
        assert _rel0(c, cr) <= tol_n
        for neg in (False, True):
            q = ops.lbfgs_combine(g, kr + 1.0, T_, neg, neg)
            qr = lbfgs.lbfgs_combine_ref(g, kr + 1.0, T_, neg, neg)
            assert _rel_max(q, qr) <= tol
    torch.cuda.synchronize()
    assert ops.launches["lbfgs_loop1"] == ops.launches["lbfgs_loop2"] == 6
    assert ops.launches["lbfgs_combine"] == 12


def _coarse_system(dev, dtype, chunk=False):
    """bar 20x4x4 twist, 4 parts, `coarse 1` (tests/test_coarse.py's
    recipe); `chunk` forces the chunked rebuild."""
    mesh = bar_mesh(20, 4, 4)
    cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script="twist", handle_ratio=0.1, coarse=1)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = scripts.init_script(mesh, "twist")
    mesh.fixed_mask = sd.fixed0.copy()
    plan = partition.build_plan(mesh, 4, pad_elem_to=16, pad_n3_to=48,
                                band_bs_unit=48, band_min_nb=3)
    sysm = System(mesh, cfg, plan, dtype=dtype, device=dev)
    if chunk:
        sysm._chunk = True
    return sd, sysm


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_coarse_and_chunk_kernels_match_plain_versions(cuda, dtype):
    from dot_tpu_torch.kernels import band, coarse
    tol, tol_n = TOL_NEW[dtype]
    sd, sysm = _coarse_system(cuda, dtype)
    rng = np.random.default_rng(8)
    x = torch.as_tensor(sd.x0 + 0.01 * rng.normal(size=sd.x0.shape),
                        dtype=dtype, device=cuda)
    fixed = torch.as_tensor(sd.fixed0, device=cuda)
    eh = sysm.element_hessians(x)
    freev = torch.logical_not(fixed).to(dtype)
    cp = sysm.coarse_plan
    ops.reset_launches()
    kk = ops.coarse_assemble(eh, sysm.conn, freev, sysm.mass, cp)
    kr = coarse.coarse_assemble_ref(eh, sysm.conn, freev, sysm.mass, cp)
    assert _rel(kk, kr) <= tol_n
    P = sysm.n_parts
    rhs = torch.as_tensor(rng.normal(size=(sysm.n_vert, 3)), dtype=dtype,
                          device=cuda)
    dc = torch.as_tensor(rng.uniform(0.5, 2.0, size=6 * P), dtype=dtype,
                         device=cuda)
    y = torch.as_tensor(rng.normal(size=6 * P), dtype=dtype, device=cuda)
    assert _rel(ops.coarse_restrict(rhs, freev, dc, cp),
                coarse.coarse_restrict_ref(rhs, freev, dc, cp)) <= tol_n
    for base in (None, rhs):
        assert _rel_max(ops.coarse_prolong(y, dc, freev, cp, base),
                        coarse.coarse_prolong_ref(y, dc, freev, cp,
                                                  base)) <= tol
    freef = sysm._free(fixed).to(dtype).reshape(-1)
    ck = ops.band_compact(eh, freef, sysm.mass_flat, sysm.band_plan)
    cr = band.band_compact_ref(eh, freef, sysm.mass_flat, sysm.band_plan)
    assert _rel(ck, cr) <= tol_n
    lp = band.low_plan(sysm.plan, sysm.band_plan, cuda)
    bdt = torch.bfloat16 if dtype == torch.float32 else dtype
    fk, dk = ops.band_equil_scatter(cr, lp, bdt)
    fr, dr = band.band_equil_scatter_ref(cr, lp, bdt)
    assert fk.dtype == bdt and torch.equal(dk, dr) and torch.equal(fk, fr)
    torch.cuda.synchronize()
    assert all(ops.launches[k] > 0 for k in (
        "coarse_assemble", "coarse_restrict", "coarse_prolong",
        "band_compact", "band_equil_scatter")), ops.launches


def test_coarse_chunk_step_on_card_matches_cpu(cuda):
    """Two f32 DOT steps with the coarse space and the chunked rebuild
    forced: the card (K1-K12) against the CPU (plain versions), sysE
    within 1e-4 (bf16 band and leaves round the same way on both)."""
    out = []
    for dev in ("cpu", cuda):
        sd, sysm = _coarse_system(dev, torch.float32, chunk=True)
        st = DOTStepper(sysm, sd)
        s = st.init_state()
        es = []
        for _ in range(2):
            s, (stats, e) = st.step(s)
            es.append(e)
            assert stats.stop in ("tol", "rel_dec")
        assert s.kc_chol is not None and s.chol.linv.dtype == torch.bfloat16
        out.append(es)
    np.testing.assert_allclose(out[1], out[0], rtol=1e-4)
