"""The port's kernels on the card (marker `cuda`): each kernel (K1-K4 on
the per-element passes, K5-K8 on the H0 rebuild and apply of a
cyclic-reduction plan, K9 on random histories, K10-K11 on a coarse plan,
K5's compact entry point and K12 on a forced chunked rebuild, K13-K16 on
the other steppers' plans (K15 as one launch of K7's solve entry a
pd_solve), K31 at the scan's shapes and on a chunked band, K17-K20
(K20's line-search entry w_quad) and the per-slab /
from-F entry points on the ADMM plans, K6 at any width, the 2D kernels K21-K24 with
the check entries of their device functions, K25-K28, K29, K30 and the
ADMM-DD entries of K21, K22, K26, K32 on random factors and on the
spikes scene's) against its plain PyTorch version on CUDA tensors, K6
at its paths' shapes in one launch a call, and time steps on the card against the same steps on the CPU or on the
plain versions (DOT on dense, cyclic-reduction and coarse + chunked plans,
Newton, LBFGS-PD, GSDD, ADMM-PD, ADMM-DD, the 2D Newton, DOT 4, ADMM-PD
and ADMM-DD 4).
Skipped where there is no CUDA device; where there is one, run

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
    if dtype == torch.float32:
        assert fac.levels[0][1].dtype == torch.bfloat16
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
        "band_assemble", "chol_inv", "h0_gather", "h0_average")), \
        ops.launches


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
    """K9's two fused entries against their plain versions with m = 1, 3
    and 5 history slots, of which the newest 0..m hold pairs: one launch
    an entry."""
    from dot_tpu_torch.kernels import lbfgs
    tol, tol_n = TOL_NEW[dtype]
    rng = np.random.default_rng(7)
    ops.reset_launches()
    calls = 0
    for m in (1, 3, 5):
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
            S_, T_ = t(S), t(T)
            g, r = t(rng.normal(size=n)), t(rng.normal(size=n))
            rho_, val_ = t(rho), t(valid)
            q, k, G = ops.lbfgs_first(S_, T_, g, rho_, val_)
            qr, kr, Gr = lbfgs.lbfgs_first_ref(S_, T_, g, rho_, val_)
            assert _rel0(G, Gr) <= tol_n and _rel0(k, kr) <= tol_n
            assert _rel_max(q, qr) <= tol
            out = ops.lbfgs_second(T_, S_, r, kr, Gr, rho_, val_)
            outr = lbfgs.lbfgs_second_ref(T_, S_, r, kr, Gr, rho_, val_)
            assert _rel_max(out, outr) <= tol
            calls += 1
    torch.cuda.synchronize()
    assert ops.launches["lbfgs_first"] == ops.launches["lbfgs_second"] \
        == calls


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


# ----------------------------------------------------------------------
# K13-K16: warmStart 5, LBFGS-PD, the GSDD sweep
# ----------------------------------------------------------------------
def _stepper_scene(script="stretch", cells=(8, 3, 3)):
    mesh = bar_mesh(*cells)
    cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script=script, handle_ratio=0.05)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = scripts.init_script(mesh, script)
    mesh.fixed_mask = sd.fixed0.copy()
    return mesh, cfg, sd


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stepper_kernels_match_plain_versions(cuda, dtype):
    """K13 (hessian_diag), K14 (pd_assemble) and K16 (local gather /
    scatter) against their plain versions: f64 1e-12, f32 1e-5 (K15 is
    K7's "pd" solve: test_pd_solve_matches_plain_in_one_launch)."""
    from dot_tpu_torch.kernels import pd
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    mesh, cfg, sd = _stepper_scene()
    rng = np.random.default_rng(2)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    sysm = System(mesh, cfg, None, dtype=dtype, device=cuda)
    x = t(sd.x0 + 0.02 * rng.normal(size=sd.x0.shape))
    fixed = torch.as_tensor(sd.fixed0, device=cuda)
    eh = sysm.element_hessians(x)
    args = (eh, sysm.scat_perm, sysm.scat_segids, sysm.scat_off, sysm.mass)
    assert _rel_max(ops.hessian_diag(*args), pd.hessian_diag_ref(*args)) <= tol

    bp = pd.pd_plan(partition.build_pd_band_plan(sysm._conn_scatter_np,
                                                 mesh.n_vert, bs_unit=16),
                    cuda)
    assert bp.nb >= 3
    sysm._pd_plan = bp
    free = torch.logical_not(fixed).to(dtype)
    a_args = (sysm.g9, sysm.conn, sysm._pd_weights(), free, sysm.mass, bp)
    assert _rel_max(ops.pd_assemble(*a_args),
                    pd.pd_assemble_ref(*a_args)) <= tol
    rhs = t(rng.normal(size=(mesh.n_vert, 3)))

    plan = partition.build_plan(mesh, 4, pad_elem_to=16, pad_n3_to=48)
    s4 = System(mesh, cfg, plan, dtype=dtype, device=cuda)
    dd = t(rng.uniform(0.5, 2.0, size=(4, s4.n3)))
    for i in range(4):
        g_args = (rhs, s4.l2g, s4.local_valid, dd, i)
        assert _rel_max(ops.local_gather_one(*g_args),
                        pd.local_gather_one_ref(*g_args)) <= tol
        zi = t(rng.normal(size=s4.n3))
        s_args = (zi, dd, s4.l2g, s4.local_valid, i, mesh.n_vert)
        assert _rel_max(ops.local_scatter_one(*s_args),
                        pd.local_scatter_one_ref(*s_args)) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_block_solve_on_a_strided_subdomain_slice(cuda, dtype):
    """K7's solve reads one subdomain's blocks of scan-major (m, P, n, n)
    leaves in place: the same bits as on contiguous copies, no copy made
    (f32 on bf16 leaves, as the paths' factors)."""
    from dot_tpu_torch.kernels import band
    rng = np.random.default_rng(3)
    nb, n = 5, 48
    linv = torch.as_tensor(np.tril(rng.normal(size=(nb, 3, n, n))) / n ** 0.5
                           + np.eye(n), dtype=dtype, device=cuda)
    sub = torch.as_tensor(rng.normal(size=(nb - 1, 3, n, n)) / n,
                          dtype=dtype, device=cuda)
    r = torch.as_tensor(rng.normal(size=(1, nb * n)), dtype=dtype,
                        device=cuda)
    stores = [(linv, sub)]
    if dtype == torch.float32:
        stores.append((linv.to(torch.bfloat16), sub.to(torch.bfloat16)))
    for leaves in stores:
        view = [t[:, 1:2] for t in leaves]
        assert not any(t.is_contiguous() for t in view)
        got = ops.block_solve(band.solve_program("btd", view), view, r)
        copy = [t.contiguous() for t in view]
        want = ops.block_solve(band.solve_program("btd", copy), copy, r)
        assert torch.isfinite(got).all() and torch.equal(got, want)


def _solve_cases(dev, dtype):
    """(kind, leaves, r's shape) of the solves the paths give, on factors
    rebuilt at a deformed state: the cyclic-reduction factor of the
    2-part band (bf16 leaves in f32) and the exact block scan of the same
    matrices, each whole and on subdomain 1's slice; the same two on a
    1-part band (P = 1); the coarse pair on Lc^{-1} of the coarse plan."""
    from dot_tpu_torch.steppers.core import BTDFactor, CRFactor, factor_leaves
    rng = np.random.default_rng(2)
    cases = []
    mesh, cfg, sd, _, _ = _banded_scene(dev, dtype)
    for parts in (2, 1):
        plan = partition.build_plan(mesh, parts, pad_elem_to=16,
                                    pad_n3_to=48, band_bs_unit=48,
                                    band_min_nb=3)
        sysm = System(mesh, cfg, plan, dtype=dtype, device=dev)
        x = torch.as_tensor(sd.x0 + 0.01 * rng.normal(size=sd.x0.shape),
                            dtype=dtype, device=dev)
        fixed = torch.as_tensor(sd.fixed0, device=dev)
        _, L, _, _ = sysm.rebuild_h0(x, fixed)
        H = sysm.assemble_subdomains(sysm.element_hessians(x), fixed)
        Lb, _ = sysm.factorize(H, fast=False)
        assert isinstance(L, CRFactor) and isinstance(Lb, BTDFactor)
        for kind, leaves in (("cr", factor_leaves(L)), ("btd", list(Lb))):
            cases.append((kind, leaves, (parts, sysm.n3)))
            if parts > 1:
                cases.append((kind, [t[:, 1:2] for t in leaves],
                              (1, sysm.n3)))
    sd, sysm = _coarse_system(dev, dtype)
    x = torch.as_tensor(sd.x0, dtype=dtype, device=dev)
    _, _, _, kc = sysm.rebuild_h0(x, torch.as_tensor(sd.fixed0, device=dev))
    cases.append(("pair", [kc.linv], (1, kc.linv.shape[0])))
    return cases


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_block_solve_matches_plain_in_one_launch(cuda, dtype):
    """K7's solve entry on every factor kind (cyclic reduction, block scan,
    P = 1, a subdomain's strided slice, the coarse pair): one launch and
    one device kernel a solve, the plain version within K7's tolerance
    (f64 1e-12, f32 1e-4 norm-wise), and two calls bit for bit."""
    from dot_tpu_torch.kernels import band
    from dot_tpu_torch.profiling import captured_work
    rng = np.random.default_rng(4)
    for kind, leaves, shape in _solve_cases(cuda, dtype):
        r = torch.as_tensor(rng.normal(size=shape), dtype=dtype, device=cuda)
        prog = band.solve_program(kind, leaves)
        n0 = dict(ops.launches)
        z = ops.block_solve(prog, leaves, r)
        assert ops.launches["block_solve"] == n0["block_solve"] + 1
        assert torch.isfinite(z).all(), kind
        assert _rel(z, band.block_solve_ref(prog, leaves, r)) \
            <= TOL_H0[dtype][0], kind
        k = captured_work(lambda: ops.block_solve(prog, leaves, r))
        assert sum(k.values()) == 1 and "solve_kernel" in next(iter(k)), k
        assert torch.equal(ops.block_solve(prog, leaves, r), z), kind


def test_block_solve_raises_when_the_launch_is_refused(cuda):
    """A grid above the co-resident limit (the C entry's grid argument) is
    refused by the cooperative launch: the wrapper raises and nothing
    falls back."""
    from dot_tpu_torch.kernels import band
    kind, leaves, shape = _solve_cases(cuda, torch.float32)[0]
    prog = band.solve_program(kind, leaves)
    r = torch.ones(shape, device=cuda)
    n0 = dict(ops.launches)
    with pytest.raises(RuntimeError, match="block_solve"):
        ops._block_solve(prog, leaves, r, 10 ** 6)
    assert ops.launches == n0
    z = ops.block_solve(prog, leaves, r)          # and the next one runs
    torch.cuda.synchronize()
    assert _rel(z, band.block_solve_ref(prog, leaves, r)) \
        <= TOL_H0[torch.float32][0]


def test_lbfgs_pd_and_gsdd_steps_kernels_match_plain(cuda):
    """One LBFGS-PD time step (banded PD factor) and one GSDD time step
    (block-scan factor, 2 parts) on the card: the kernel path against the
    plain versions on the same card, f64."""
    from dot_tpu_torch.kernels import pd
    from dot_tpu_torch.steppers import GSDDStepper, LBFGSPD
    mesh, cfg, sd = _stepper_scene()
    outs = []
    for use in (True, False):
        sysm = System(mesh, cfg, None, dtype=torch.float64, device=cuda,
                      use_kernels=use)
        sysm._pd_plan = pd.pd_plan(partition.build_pd_band_plan(
            sysm._conn_scatter_np, mesh.n_vert, bs_unit=16), cuda)
        st = LBFGSPD(sysm, sd)
        n0 = dict(ops.launches)
        s, (stats, sys_e) = st.step(st.init_state())
        if use:
            # one launch of K7's solve entry a pd_solve (one an iteration)
            assert ops.launches["pd_assemble"] == n0["pd_assemble"] + 1
            assert ops.launches["block_solve"] \
                == n0["block_solve"] + stats.inner_iters
        outs.append((s.x.cpu().numpy(), stats.inner_iters, sys_e))
    assert outs[0][1] == outs[1][1]
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-9, atol=1e-12)

    plan = partition.build_plan(mesh, 2, pad_elem_to=16, pad_n3_to=48,
                                band_bs_unit=48, band_min_nb=3)
    outs = []
    for use in (True, False):
        sysm = System(mesh, cfg, plan, dtype=torch.float64, device=cuda,
                      use_kernels=use, use_coarse=False)
        st = GSDDStepper(sysm, sd)
        n0 = dict(ops.launches)
        s, (stats, sys_e) = st.step(st.init_state())
        if use:
            assert ops.launches["local_gather_one"] \
                == n0["local_gather_one"] + 2 * stats.inner_iters
            assert ops.launches["local_scatter_one"] \
                == n0["local_scatter_one"] + 2 * stats.inner_iters
        outs.append((s.x.cpu().numpy(), stats.inner_iters, sys_e))
    assert outs[0][1] == outs[1][1]
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-9, atol=1e-12)


def _pd_solve_cases(dev, dtype):
    """(leaves, nV) of K7's "pd" solve: the banded PD factor of the
    stepper scene (bs_unit 16) and random P = 1 factors at bar17's block
    width (n 512, nb 5) and at an odd width (n 37, nb 4), each with a
    random permutation (padding rows) and scale."""
    from dot_tpu_torch.kernels import pd
    rng = np.random.default_rng(12)
    mesh, cfg, sd = _stepper_scene()
    sysm = System(mesh, cfg, None, dtype=dtype, device=dev)
    sysm._pd_plan = pd.pd_plan(partition.build_pd_band_plan(
        sysm._conn_scatter_np, mesh.n_vert, bs_unit=16), dev)
    bp = sysm.pd_band_plan
    L, d = sysm.build_pd_factor(torch.as_tensor(sd.fixed0, device=dev))
    cases = [([L.linv, L.sub, bp.inv, bp.perm, d[0]], mesh.n_vert)]
    for nb, n, nv in ((5, 512, 2500), (4, 37, 140)):
        def t(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt, device=dev)
        linv = t(np.tril(rng.normal(size=(nb, 1, n, n))) / n ** 0.5
                 + np.eye(n))
        sub = t(rng.normal(size=(nb - 1, 1, n, n)) / n)
        perm = rng.permutation(nb * n)[:nv]
        inv = np.full(nb * n, -1)
        inv[perm] = np.arange(nv)
        cases.append(([linv, sub, t(inv, torch.int64), t(perm, torch.int64),
                       t(rng.uniform(0.5, 2.0, size=nb * n))], nv))
    return cases


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pd_solve_matches_plain_in_one_launch(cuda, dtype):
    """K7's solve entry with the "pd" kind (System.pd_solve): one launch and
    one device kernel a call at the path's factor and at n 512 and 37, the
    plain version (the gather, 4 nb - 2 3-column products, the scatter)
    within K15's tolerance (f64 1e-12, f32 1e-5 norm-wise), and two calls
    bit for bit."""
    from dot_tpu_torch.kernels import band
    from dot_tpu_torch.profiling import captured_work
    rng = np.random.default_rng(13)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for leaves, nv in _pd_solve_cases(cuda, dtype):
        r = torch.as_tensor(rng.normal(size=(nv, 3)), dtype=dtype,
                            device=cuda)
        prog = band.solve_program("pd", leaves)
        n0 = dict(ops.launches)
        z = ops.block_solve(prog, leaves, r)
        assert ops.launches["block_solve"] == n0["block_solve"] + 1
        assert torch.isfinite(z).all()
        assert _rel(z, band.block_solve_ref(prog, leaves, r)) <= tol
        k = captured_work(lambda: ops.block_solve(prog, leaves, r))
        assert sum(k.values()) == 1 and "solve_kernel" in next(iter(k)), k
        assert torch.equal(ops.block_solve(prog, leaves, r), z)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_w_quad_matches_plain_and_repeats_bit_for_bit(cuda, dtype):
    """K20's line-search entry against w_quad_ref (f64 1e-12, f32 1e-5 on
    the largest coefficient), the same bits in two runs, one device kernel
    a call, and with fixed rows and an all-free mask."""
    from dot_tpu_torch.kernels import admm as kadmm
    from dot_tpu_torch.profiling import captured_work
    from dot_tpu_torch.steppers import ADMMDDStepper
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    rng = np.random.default_rng(14)
    mesh, cfg, sd, plan, ap = _admm_dd_scene()
    sysm = System(mesh, cfg, plan, dtype=dtype, device=cuda)
    dd = ADMMDDStepper(sysm, sd, ap)
    P = sysm.n_parts
    x = torch.as_tensor(sd.x0 + 0.02 * rng.normal(size=sd.x0.shape),
                        dtype=dtype, device=cuda)
    for fixed in (sd.fixed0, np.zeros_like(sd.fixed0)):
        fx = torch.as_tensor(fixed, device=cuda)
        _, wv, _, _ = dd.update_weights(x, fx)
        free3f = dd._free3(fx).reshape(-1).contiguous()
        aug0, pa = torch.as_tensor(rng.normal(size=(2, free3f.shape[0])),
                                   dtype=dtype, device=cuda)
        args = (wv, free3f, aug0, pa, dd.wp, P)
        n0 = ops.launches["w_quad"]
        got = ops.w_quad(*args)
        assert ops.launches["w_quad"] == n0 + 1 and got.shape == (3, P)
        want = kadmm.w_quad_ref(*args)
        assert _rel_max(got, want) <= tol
        assert torch.equal(ops.w_quad(*args), got)
        k = captured_work(lambda: ops.w_quad(*args))
        assert sum(k.values()) == 1 and "w_quad_kernel" in next(iter(k)), k


# ----------------------------------------------------------------------
# K17-K20 and the per-slab / from-F entry points: the two ADMM steppers
# ----------------------------------------------------------------------
def _local_step_inputs(n, dtype, dev, rng):
    """(Dx, u9), each (9, n): a third random deformation gradients, a third
    inverted near the identity, a third near rank 1; small duals."""
    third = n // 3
    f = np.empty((9, n))
    f[:, :third] = np.eye(3).reshape(9, 1) + 0.5 * rng.normal(size=(9, third))
    inv = np.eye(3).reshape(9, 1) + 0.1 * rng.normal(size=(9, third))
    inv[[0, 3, 6]] *= -1.0
    f[:, third:2 * third] = inv
    m = n - 2 * third
    uv = rng.normal(size=(3, m))[:, None] * rng.normal(size=(3, m))[None]
    f[:, 2 * third:] = uv.reshape(9, m) + 1e-3 * rng.normal(size=(9, m))
    return (torch.as_tensor(f, dtype=dtype, device=dev),
            torch.as_tensor(0.1 * rng.normal(size=(9, n)), dtype=dtype,
                            device=dev))


def _admm_dd_scene():
    """bar 18x3x3, 3 parts, banded own-element plan (nb >= 3)."""
    mesh, cfg, sd = _stepper_scene(cells=(18, 3, 3))
    plan = partition.build_plan(mesh, 3, own_plan=True, pad_elem_to=16,
                                pad_n3_to=48, band_bs_unit=48, band_min_nb=3)
    assert plan.band_nb >= 3 and plan.own_band_dest is not None
    return mesh, cfg, sd, plan, partition.build_admm_dd_plan(mesh, plan)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_admm_kernels_match_plain_versions(cuda, dtype):
    """K17 (equal loop counts, z and du where they are), its SPD projection,
    K18 with both epilogues, K19, K20 and its diagonal flag, K1 per slab and
    K2 from carried F against their plain versions: per-element results f64
    1e-10 / f32 1e-5, sums f64 1e-12 / f32 1e-5, the scattered gradient and
    the band norm-wise 1e-4 in f32."""
    from dot_tpu_torch.kernels import admm as kadmm
    from dot_tpu_torch.steppers import ADMMDDStepper, ADMMPDStepper
    f64 = dtype == torch.float64
    t_el, t_sum, t_n = ((1e-10, 1e-12, 1e-10) if f64 else (1e-5, 1e-5, 1e-4))
    rng = np.random.default_rng(5)
    mesh, cfg, sd, plan, ap = _admm_dd_scene()

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    # K17, make_pd3, K18 on the ADMM-PD system (no plan)
    pdsys = System(mesh, cfg, None, dtype=dtype, device=cuda)
    pst = ADMMPDStepper(pdsys, sd)
    n, nv = pdsys.n_elem_p, pdsys.n_vert
    Dx, u9 = _local_step_inputs(n, dtype, cuda, rng)
    l_args = (Dx, u9, pst.w_e, pst.vol_dtsq, pdsys.u_e, pdsys.lam_e,
              pdsys.mat)
    ops.reset_launches()
    zk, duk, ck = ops.admm_local_step(*l_args, want_counts=True)
    zr, dur, cr = kadmm.admm_local_step_ref(*l_args, want_counts=True)
    ne = mesh.n_elem                  # the padding elements (w = 0) are NaN
    same = (ck == cr).all(dim=0)[:ne]
    assert int((~same).sum()) <= (1e-4 if f64 else 1e-3) * ne + 1
    assert _rel_max(zk[:, :ne][:, same], zr[:, :ne][:, same]) <= t_el
    assert _rel_max(duk[:, :ne][:, same], dur[:, :ne][:, same]) <= t_el
    a6 = t(rng.normal(size=(6, n)))
    assert _rel_max(ops.make_pd3(a6), kadmm.make_pd3_ref(a6)) <= t_el
    x = t(sd.x0 + 0.02 * rng.normal(size=sd.x0.shape))
    fixed = torch.as_tensor(sd.fixed0, device=cuda)
    free = torch.logical_not(fixed).to(dtype)
    M9 = t(rng.normal(size=(9, n)))
    base, off = t(rng.normal(size=(2, nv, 3)))
    s_args = (M9, pdsys.g9, pst.w_e, pdsys.scat_perm, pdsys.scat_segids,
              pdsys.scat_off, x)
    for epi in (dict(mass=pdsys.mass),
                dict(base=base, offset=off, free=free)):
        assert _rel_max(ops.dtw_scatter(*s_args, **epi),
                        kadmm.dtw_scatter_ref(*s_args, **epi)) <= t_sum
    assert ops.launches["admm_local_step"] == 1
    assert ops.launches["dtw_scatter"] == 2

    # K19, K20 and the two entry points on the banded ADMM-DD plan
    sysm = System(mesh, cfg, plan, dtype=dtype, device=cuda)
    dd = ADMMDDStepper(sysm, sd, ap)
    assert dd.banded_local
    P, nmax = sysm.n_parts, dd.nmax
    _, wv, _, _ = dd.update_weights(x, fixed)
    free3f = dd._free3(fixed).reshape(-1).contiguous()
    valid = sysm.local_valid[..., None]
    xl_flat = dd._to_flat(x[sysm.l2g] * valid)
    eh = sysm.k.elem_hessian(xl_flat, dd.conn_local, sysm.g9, sysm.u_e,
                             sysm.lam_e, sysm.vol_w, sysm.mat, sysm.dt_sq)
    freef = sysm._free(fixed).to(dtype).reshape(-1)
    b_args = (eh, freef, dd.mass_local.reshape(-1).contiguous(),
              sysm.own_band_plan, wv, free3f, dd.wp)
    assert _rel(ops.own_band_assemble(*b_args),
                kadmm.own_band_assemble_ref(*b_args)) <= t_n
    a = t(rng.normal(size=free3f.shape[0]))
    assert _rel_max(ops.w_matvec(wv, free3f, a, dd.wp),
                    kadmm.w_matvec_ref(wv, free3f, a, dd.wp)) <= t_sum
    assert _rel_max(ops.w_matvec(wv, free3f, None, dd.wp, diag_only=True),
                    kadmm.w_matvec_ref(wv, free3f, None, dd.wp,
                                       diag_only=True)) <= t_sum
    F0 = dd._local_defgrad(xl_flat)
    p_flat = dd._to_flat(t(0.01 * rng.normal(size=(P, nmax, 3))) * valid)
    Fp = dd._local_defgrad(p_flat)
    alpha = t([1.0, 0.5, 0.25][:P])
    e_args = (F0, Fp, alpha, sysm.u_e, sysm.lam_e, sysm.vol_w, sysm.mat, P)
    ek = ops.ls_trial_energy_parts(*e_args)
    er = kadmm.ls_trial_energy_parts_ref(*e_args)
    assert float(((ek - er).abs() / er.abs()).max()) <= t_el
    e0k = ops.ls_trial_energy_parts(F0, None, None, *e_args[3:])
    e0r = kadmm.ls_trial_energy_parts_ref(F0, None, None, *e_args[3:])
    assert float(((e0k - e0r).abs() / e0r.abs()).max()) <= t_el
    g_args = (F0, dd.conn_local, sysm.g9, sysm.u_e, sysm.lam_e, sysm.vol_w,
              sysm.mat, P * nmax)
    assert _rel(ops.elem_gradient_from_F(*g_args),
                kadmm.elem_gradient_from_F_ref(*g_args)) <= t_n
    torch.cuda.synchronize()
    for k in ("own_band_assemble", "w_matvec", "w_diag",
              "ls_trial_energy_parts", "elem_gradient_from_F"):
        assert ops.launches[k] >= 1, k


def test_admm_pd_step_on_card_matches_cpu(cuda):
    """Two ADMM-PD time steps (K17, K18, the PD band on K14 / K15), f64:
    the card against the CPU's plain versions, equal iteration counts."""
    from dot_tpu_torch.kernels import pd
    from dot_tpu_torch.steppers import ADMMPDStepper
    mesh, cfg, sd = _stepper_scene()
    out = []
    for dev in ("cpu", cuda):
        sysm = System(mesh, cfg, None, dtype=torch.float64, device=dev)
        sysm._pd_plan = pd.pd_plan(partition.build_pd_band_plan(
            sysm._conn_scatter_np, mesh.n_vert, bs_unit=16), dev)
        st = ADMMPDStepper(sysm, sd, max_iter=200)
        n0 = dict(ops.launches)
        s = st.init_state()
        its = []
        for _ in range(2):
            s, (stats, e) = st.step(s)
            its.append(stats.inner_iters)
            assert stats.stop in ("tol", "iter_cap")
        if dev != "cpu":
            assert ops.launches["admm_local_step"] \
                == n0["admm_local_step"] + sum(its)
            assert ops.launches["dtw_scatter"] \
                == n0["dtw_scatter"] + sum(its) + 2
            # pd_solve: one launch of K7's solve entry an iteration
            assert ops.launches["block_solve"] \
                == n0["block_solve"] + sum(its)
        out.append((s.x.cpu().numpy(), its, e))
    assert out[0][1] == out[1][1]
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-8, atol=1e-11)
    assert out[1][2] == pytest.approx(out[0][2], rel=1e-9)


def test_admm_dd_step_on_card_matches_cpu(cuda):
    """One ADMM-DD time step on the banded own-element plan (K19, K20, K1
    per slab, K2 from F, the exact local factor on K6 / K7), f64: the card
    against the CPU's plain versions, equal iteration counts."""
    from dot_tpu_torch.steppers import ADMMDDStepper
    mesh, cfg, sd, plan, ap = _admm_dd_scene()
    out = []
    for dev in ("cpu", cuda):
        sysm = System(mesh, cfg, plan, dtype=torch.float64, device=dev)
        st = ADMMDDStepper(sysm, sd, ap)
        assert st.banded_local
        n0 = dict(ops.launches)
        s, (stats, e) = st.step(st.init_state())
        assert stats.stop in ("tol", "iter_cap") and stats.inner_iters > 0
        if dev != "cpu":
            for k in ("own_band_assemble", "w_matvec",
                      "ls_trial_energy_parts", "elem_gradient_from_F"):
                assert ops.launches[k] > n0[k], k
            # K20: the gradient's and the consensus' w_matvec and one
            # w_quad an iteration (plus initDual's gradient and CG)
            assert ops.launches["w_quad"] == n0["w_quad"] \
                + stats.inner_iters
        out.append((s.x.cpu().numpy(), stats.inner_iters, e))
    assert out[0][1] == out[1][1]
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-7, atol=1e-10)
    assert out[1][2] == pytest.approx(out[0][2], rel=1e-8)


# ----------------------------------------------------------------------
# K6: one launch at any width and batch
# ----------------------------------------------------------------------
# (batch, width, symmetrize) at the paths' shapes: bar17's first CR level
# (36 x 768, symmetrized), bar135's scan stage (133 x 768, lower only) and
# coarse block (798), a 2,000^2 block in both modes, the batch-1 block of
# Newton's exact scan on bar17's P = 1 plan (band_bs 1152), and widths
# that are no multiple of the tile (64 in f32, 32 in f64)
K6_SHAPES = [(36, 768, True), (133, 768, False), (1, 798, True),
             (1, 2000, True), (1, 2000, False), (1, 1152, False),
             (3, 37, True), (2, 770, False)]
K6_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def _spd(batch, n, dtype, dev, symmetrize, seed=6):
    """SPD blocks G G^T / n + I with a skew part above the diagonal that
    the lower mode must not read and the symmetrized mode averages away."""
    rng = np.random.default_rng(seed)
    G = torch.as_tensor(rng.normal(size=(batch, n, n)), dtype=dtype,
                        device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)
    skew = torch.triu(torch.as_tensor(rng.normal(size=(batch, n, n)),
                                      dtype=dtype, device=dev), 1) * 1e-3
    return (G @ G.mT / n + eye + skew
            - (skew.mT if symmetrize else 0.0)).contiguous()


@pytest.mark.parametrize("shape", K6_SHAPES,
                         ids=[f"{b}x{n}-{'sym' if s else 'lower'}"
                              for b, n, s in K6_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chol_inv_one_launch_at_path_shapes(cuda, dtype, shape):
    """K6 against its plain version (f64 1e-10, f32 1e-5 norm-wise) in
    one launch a call, with zeros above the diagonal of L and L^{-1}."""
    from dot_tpu_torch.kernels import band
    batch, n, sym = shape
    A = _spd(batch, n, dtype, cuda, sym)
    ops.reset_launches()
    L, Li, bad = ops.chol_inv(A, sym)
    torch.cuda.synchronize()
    assert ops.launches["chol_inv"] == 1
    Lr, Lir, bad_r = band.chol_inv_ref(A, sym)
    assert not bad.any() and not bad_r.any()
    assert _rel(L, Lr) <= K6_TOL[dtype] and _rel(Li, Lir) <= K6_TOL[dtype]
    assert torch.equal(L, torch.tril(L)) and torch.equal(Li, torch.tril(Li))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("symmetrize", [True, False], ids=["sym", "lower"])
def test_chol_inv_flags_indefinite_blocks(cuda, symmetrize, batch):
    """A block whose bad pivot falls in the first tile or in the last one
    comes back flagged and all NaN in L and L^{-1}; its neighbours stay
    finite and match the plain version."""
    from dot_tpu_torch.kernels import band
    n, mid = 770, batch // 2
    for dtype in (torch.float64, torch.float32):
        for where in (5, 765):
            A = _spd(batch, n, dtype, cuda, symmetrize)
            A[mid, where, where] = -1.0
            L, Li, bad = ops.chol_inv(A, symmetrize)
            _, _, bad_r = band.chol_inv_ref(A, symmetrize)
            want = [b == mid for b in range(batch)]
            assert bad.tolist() == want == bad_r.tolist()
            assert torch.isnan(L[mid]).all() and torch.isnan(Li[mid]).all()
            ok = [b for b in range(batch) if b != mid]
            assert torch.isfinite(L[ok]).all() and torch.isfinite(Li[ok]).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chol_inv_above_the_panel_limit(cuda, dtype):
    """A 2,000^2 SPD block, wider than the shared-memory panel of K6's
    first design (1,664 in f32), factors in one launch a call (f64 1e-10,
    f32 1e-5 against the plain version); an indefinite one comes back
    flagged and NaN."""
    from dot_tpu_torch.kernels import band
    tol = K6_TOL[dtype]
    n = 2000
    rng = np.random.default_rng(6)
    G = torch.as_tensor(rng.normal(size=(n, n)), dtype=dtype, device=cuda)
    A = (G @ G.t() / n + torch.eye(n, dtype=dtype, device=cuda))[None]
    ops.reset_launches()
    for sym in (True, False):
        L, Li, bad = ops.chol_inv(A, sym)
        Lr, Lir, _ = band.chol_inv_ref(A, sym)
        assert not bad.any()
        assert _rel(L, Lr) <= tol and _rel(Li, Lir) <= tol
    assert ops.launches["chol_inv"] == 2
    L, Li, bad = ops.chol_inv(A - 2.0 * torch.eye(n, dtype=dtype,
                                                  device=cuda), True)
    assert bad.all() and torch.isnan(L).all() and torch.isnan(Li).all()


# K31: the block scan's Schur-complement update. The bar135 scan step, a
# P = 1 scan, bar17's 6 subdomains, and widths at and off the 64-wide
# tiles' edges (48 and 200 no multiple of 64)
SCHUR_SHAPES = [(133, 768), (1, 768), (6, 768), (3, 48), (3, 96), (2, 200),
                (2, 384)]


def _schur_inputs(batch, n, dev, d_dtype=torch.bfloat16, seed=31):
    """(D, A): D = 3 I + a small symmetric noise, A = 0.5 G / sqrt(n) in
    bf16, so that D - A A^T is SPD with entries of order 1."""
    g = torch.Generator(device=dev).manual_seed(seed + n)
    G = torch.randn((batch, n, n), generator=g, device=dev)
    A = (0.5 / n ** 0.5 * G).to(torch.bfloat16)
    N = 0.01 * torch.randn((batch, n, n), generator=g, device=dev)
    D = (3.0 * torch.eye(n, device=dev) + N + N.mT).to(d_dtype)
    return D, A


@pytest.mark.parametrize("shape", SCHUR_SHAPES,
                         ids=[f"{b}x{n}" for b, n in SCHUR_SHAPES])
def test_schur_update_matches_plain_and_repeats(cuda, shape):
    """K31 against its plain version (the f32 product on the SIMT units):
    the lower triangle within 1e-6 norm-wise (only the order of the sums
    differs), bit for bit from run to run, one launch a call; a poisoned
    strictly-upper triangle in `out` stays unread by K6 (L and L^{-1}
    unchanged bit for bit)."""
    from dot_tpu_torch.kernels import band
    batch, n = shape
    for d_dtype in (torch.bfloat16, torch.float32):
        D, A = _schur_inputs(batch, n, cuda, d_dtype)
        ops.reset_launches()
        out0 = torch.zeros((batch, n, n), device=cuda)
        ops.schur_update(D, A, out0)
        out1 = torch.full((batch, n, n), float("nan"), device=cuda)
        ops.schur_update(D, A, out1)
        torch.cuda.synchronize()
        assert ops.launches["schur_update"] == 2
        ref = band.schur_update_ref(D, A)
        low0, low1 = torch.tril(out0), torch.tril(out1)
        assert _rel(low0, torch.tril(ref)) <= 1e-6
        assert torch.equal(low0, low1)
        L0, Li0, bad0 = ops.chol_inv(out0, False)
        L1, Li1, bad1 = ops.chol_inv(out1, False)
        assert not bad0.any() and not bad1.any()
        assert torch.equal(L0, L1) and torch.equal(Li0, Li1)
        del D, A, out0, out1, ref, L0, Li0, L1, Li1
    torch.cuda.empty_cache()


def test_schur_update_reads_d_in_place(cuda):
    """D as a strided view of a scan-major band (the diagonal blocks of one
    scan step) and a width that is no multiple of 8 (A padded into a copy):
    the same as the plain version's lower triangle within 1e-6."""
    from dot_tpu_torch.kernels import band
    n = 77
    D, A = _schur_inputs(4, n, cuda)
    band4 = torch.stack([D, D + 1.0], 1)    # (4, 2, n, n), scan-major
    Dv = band4[:, 1]
    assert not Dv.is_contiguous()
    out = ops.schur_update(Dv, A)
    ref = band.schur_update_ref(Dv, A)
    assert _rel(torch.tril(out), torch.tril(ref)) <= 1e-6


def test_chunked_scan_with_schur_update_matches_the_old_route(cuda):
    """The chunked bf16 band of the coarse plan (bar 20x4x4, 4 parts) through
    the bf16-SYRK scan (K31, one launch a step) against the route it
    replaced (four casts, an f32 GEMM, the upcast and a subtraction) on the
    card: leaves at preconditioner grade (1e-2 max-abs relative, as
    tests/test_torch_cr.py)."""
    from dot_tpu_torch.steppers.core import _mm
    sd, sysm = _coarse_system(cuda, torch.float32, chunk=True)
    x = torch.as_tensor(sd.x0, dtype=torch.float32, device=cuda)
    fixed = torch.as_tensor(sd.fixed0, device=cuda)
    eh = sysm.element_hessians(x)
    flat, _ = sysm._equil_scatter(sysm._band_compact(eh, fixed))
    P, bs, nb = sysm.n_parts, sysm.band_bs, sysm.band_nb
    dg = flat[:P * nb * bs * bs].view(nb, P, bs, bs)
    sb = flat[P * nb * bs * bs:].view(nb - 1, P, bs, bs)
    ops.reset_launches()
    fac = sysm._btd_scan_equilibrated(dg, sb, 0.0, True)
    torch.cuda.synchronize()
    assert ops.launches["schur_update"] == nb - 1
    lis, lss = [], []
    Dk = dg[0].float()
    for k in range(nb):
        _, Li, _ = ops.chol_inv(Dk.contiguous(), False)
        lis.append(Li.to(torch.bfloat16))
        if k == nb - 1:
            break
        Ls = sb[k].float() @ Li.mT
        lss.append(Ls.to(torch.bfloat16))
        Dk = dg[k + 1].float() - _mm(Ls, Ls.mT, True)
    for got, want in ((fac.linv, torch.stack(lis)),
                      (fac.sub, torch.stack(lss))):
        assert got.dtype == torch.bfloat16
        assert _rel_max(got.float(), want.float()) <= 1e-2


def test_newton_step_on_card_matches_cpu(cuda):
    """Two Newton steps (bar 40x3x3 stretch on a banded P = 1 plan, nb 21,
    bs 96: K6 on the exact factor's blocks) in f64: the card against the
    CPU."""
    from dot_tpu_torch.steppers import NewtonStepper
    mesh = bar_mesh(40, 3, 3)
    cfg = Config(energy="FCR", time_stepper="Newton", dt=0.025, rho=1000.0,
                 ym=1e5, pr=0.4, script="stretch", handle_ratio=0.1)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = scripts.init_script(mesh, "stretch")
    mesh.fixed_mask = sd.fixed0.copy()
    plan = partition.build_plan(mesh, 1, pad_elem_to=16, pad_n3_to=48,
                                band_bs_unit=48, band_min_nb=3)
    out = []
    for dev in ("cpu", cuda):
        ops.reset_launches()
        st = NewtonStepper(System(mesh, cfg, plan, dtype=torch.float64,
                                  device=dev), sd)
        s = st.init_state()
        for _ in range(2):
            s, (stats, e) = st.step(s)
        if dev != "cpu":
            assert ops.launches["chol_inv"] > 0
        out.append((s.x.cpu().numpy(), e, stats.inner_iters))
    assert out[0][2] == out[1][2]
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-9, atol=1e-12)
    assert out[1][1] == pytest.approx(out[0][1], rel=1e-9)


# ----------------------------------------------------------------------
# K21-K24: the 2D Newton path
# ----------------------------------------------------------------------
def _scene_2d(dev, dtype, use_kernels=True, resolution=400):
    from dot_tpu_torch import dim2
    cfg = Config(energy="FCR", time_stepper="Newton", dt=0.025, rho=1000.0,
                 ym=1e5, pr=0.4, script="stretch", handle_ratio=0.03,
                 shape="spikes", resolution=resolution)
    mesh = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(mesh, cfg.script)
    mesh.fixed_mask = sd.fixed0.copy()
    return dim2.Newton2DStepper(
        dim2.System2D(mesh, cfg, dtype=dtype, device=dev,
                      use_kernels=use_kernels), sd)


@pytest.mark.parametrize("name", ["FCR", "SNH", "SNHWL"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dim2_kernels_match_plain_versions(cuda, dtype, name):
    """The check entries of elem2d.cuh's device functions, defgrad2d and
    K21-K24 against their plain versions (atan2 / sin / cos of the device
    library are not torch's bit for bit): f64 1e-10, f32 1e-5, norm-wise
    1e-4 on the f32 gradient and Hessians. U, V and Q are compared through
    the products they enter."""
    from dot_tpu_torch.kernels import dd2d, soa2d
    tol, tol_n = TOL[dtype]
    mat = soa2d.SOA2D_MATERIALS[name]
    st = _scene_2d(cuda, dtype)
    sysm = st.system
    n, nv = sysm.n_elem, sysm.n_vert
    rng = np.random.default_rng(7)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    F0 = rng.normal(size=(4, n))
    F0[:, 0] = (1.0, 0.0, 0.0, 1.0)             # R = 0
    F0[:, 1] = (0.0, -2.0, 2.0, 0.0)            # a scaled rotation
    F0[:, 2] = (1.0, 0.0, 0.0, -2.0)            # inverted
    F0[:, 3] = 0.0
    F0, Fp, h3 = t(F0), t(rng.normal(size=(4, n))), t(rng.normal(size=(3, n)))

    def usv(U, s, V):
        return torch.stack([U[2 * i] * s[0] * V[2 * j]
                            + U[2 * i + 1] * s[1] * V[2 * j + 1]
                            for i in range(2) for j in range(2)])

    def qlq(l_, Q):
        return torch.stack([l_[0] * Q[0] * Q[0] + l_[1] * Q[1] * Q[1],
                            l_[0] * Q[0] * Q[2] + l_[1] * Q[1] * Q[3],
                            l_[0] * Q[2] * Q[2] + l_[1] * Q[3] * Q[3]])
    ops.reset_launches()
    Uk, sk, Vk = ops.svd2_flip(F0)
    Ur, sr, Vr = soa2d.svd2_flip_ref(F0)
    assert _rel_max(sk, sr) <= tol
    assert _rel_max(usv(Uk, sk, Vk), usv(Ur, sr, Vr)) <= tol
    assert _rel_max(usv(Uk, sk, Vk), F0) <= 10 * tol
    (lk, Qk), (lr, Qr) = ops.eigh2(h3), soa2d.eigh2_ref(h3)
    assert _rel_max(lk, lr) <= tol
    assert _rel_max(qlq(lk, Qk), qlq(lr, Qr)) <= tol
    assert _rel_max(ops.make_pd2(h3), soa2d.make_pd2_ref(h3)) <= tol
    mk = ops.material2d(F0, sysm.u_e, sysm.lam_e, mat)
    mr = soa2d.material2d_ref(F0, sysm.u_e, sysm.lam_e, mat)
    scale = mr.abs().amax(dim=1).clamp_min(1e-300)
    assert float(((mk - mr).abs().amax(dim=1) / scale).max()) <= tol

    x = t(st.script_data.x0)
    x[:, :2] += t(0.01 * rng.normal(size=(nv, 2)))
    xt = x.clone()
    xt[:, :2] += t(0.005 * rng.normal(size=(nv, 2)))
    free = torch.logical_not(torch.as_tensor(st.script_data.fixed0,
                                             device=cuda)).to(dtype)
    el = (sysm.conn, sysm.g4, sysm.u_e, sysm.lam_e, sysm.vol_w, mat)
    Fk = ops.defgrad2d(x, sysm.conn, sysm.g4)
    assert _rel_max(Fk, soa2d.defgrad2d_ref(x, sysm.conn, sysm.g4)) <= tol
    alpha = torch.tensor(0.5, dtype=dtype, device=cuda)
    ek, sgk = ops.ls_trial_energy2d(F0, Fp, alpha, *el[2:], want_sigma=True)
    er, sgr = soa2d.ls_trial_energy2d_ref(F0, Fp, alpha, *el[2:],
                                          want_sigma=True)
    assert _rel(ek, er) <= tol and _rel_max(sgk, sgr) <= tol
    g_args = (x, xt, free, sysm.mass, *el, sysm.dt_sq, sysm.scatter_plan)
    gk, gr = ops.elem_gradient2d(*g_args), soa2d.elem_gradient2d_ref(*g_args)
    assert _rel(gk, gr) <= tol_n
    assert float(gk[:, 2].abs().max()) == 0.0
    assert float(gk[free == 0].abs().max()) == 0.0
    h_args = (x, *el, sysm.dt_sq)
    hk, hr = ops.elem_hessian2d(*h_args), soa2d.elem_hessian2d_ref(*h_args)
    assert _rel(hk, hr) <= tol_n
    tab = sysm.dense_tab
    Hk, dk = ops.dense_assemble2d(hr, free, sysm.mass, tab)
    Hr, dr = soa2d.dense_assemble2d_ref(hr, free, sysm.mass, tab)
    assert _rel_max(Hk, Hr) <= tol and _rel_max(dk, dr) <= tol
    assert torch.equal(Hk, Hk.t())
    # K26's one pass (mass after the mask) against the plain version's
    # sequential sums on the CPU (mass before it): the same bits; d as the
    # plain version takes it on the card (the host's sqrt rounds otherwise
    # in the last bit now and then)
    Hc, _ = soa2d.dense_assemble2d_ref(
        hr.cpu(), free.cpu(), sysm.mass.cpu(), dd2d.dense_tables(
            st.system.mesh.conn, nv, "cpu"))
    assert torch.equal(Hk.cpu(), Hc)
    assert torch.equal(dk, torch.sqrt(Hc.diagonal().to(cuda)))
    Sr = soa2d.dense_scale2d_ref(Hr, dr, tab)
    Sk = ops.dense_scale2d(Hk, dk, tab)
    assert Sk.data_ptr() == Hk.data_ptr()       # scaled in place
    assert _rel_max(Sk, Sr) <= tol
    torch.cuda.synchronize()
    for k in ("svd2_flip", "eigh2", "make_pd2", "material2d", "defgrad2d",
              "ls_trial_energy2d", "elem_gradient2d", "elem_hessian2d",
              "dense_assemble2d", "dense_scale2d"):
        assert ops.launches[k] == 1, (k, ops.launches[k])
    # K24's assembly: one device kernel a call, the one-pass kernel's
    _device_launches(lambda: ops.dense_assemble2d(hr, free, sysm.mass, tab),
                     1)


def test_newton2d_step_on_card_matches_cpu(cuda):
    """Three 2D Newton frames of the spikes scene, f64: the card (K21-K24)
    against the CPU's plain versions, equal iteration counts, z = 0; and
    the kernels against the plain versions on the same card."""
    out = []
    for dev, use in (("cpu", True), (cuda, True), (cuda, False)):
        st = _scene_2d(dev, torch.float64, use_kernels=use, resolution=200)
        n0 = dict(ops.launches)
        s = st.init_state()
        its, es = [], []
        for _ in range(3):
            s, (stats, e) = st.step(s)
            its.append(stats.inner_iters)
            es.append(e)
            assert stats.stop in ("tol", "rel_dec")
        n_launch = {k: ops.launches[k] - n0[k] for k in ops.KERNELS}
        if dev != "cpu" and use:
            assert n_launch["elem_hessian2d"] == sum(its)
            assert n_launch["dense_assemble2d"] == sum(its)
            assert n_launch["elem_gradient2d"] == sum(its) + 3
        else:
            assert not any(n_launch.values())
        assert float(s.x[:, 2].abs().max()) == 0.0
        out.append((s.x.cpu().numpy(), its, es))
    for other in out[1:]:
        assert other[1] == out[0][1]
        np.testing.assert_allclose(other[0], out[0][0], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(other[2], out[0][2], rtol=1e-10)
    # the recorded golden of tests/test_dim2.py:241-245
    np.testing.assert_allclose(out[1][2], [3.294256031942e+03,
                                           3.294256605060e+03,
                                           3.300416677680e+03], rtol=2e-4)


# ----------------------------------------------------------------------
# K25-K28: the 2D decomposed path (DOT, GSDD, LBFGS-PD / H / HI / JH)
# ----------------------------------------------------------------------
def _dd_system_2d(dev, dtype, stepper="DOT", resolution=400, plan="element",
                  parts=4, use_kernels=True):
    from dot_tpu_torch import dim2, plan2d
    from dot_tpu_torch.sim import STEPPERS
    cfg = Config(energy="FCR", time_stepper=stepper, dt=0.025, rho=1000.0,
                 ym=1e5, pr=0.4, script="stretch", handle_ratio=0.03,
                 shape="spikes", resolution=resolution, partition_amt=parts)
    mesh = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(mesh, cfg.script)
    mesh.fixed_mask = sd.fixed0.copy()
    p = {"element": lambda: plan2d.build_plan_2d(mesh, parts),
         "node": lambda: plan2d.build_node_plan_2d(mesh, parts),
         None: lambda: None}[plan]()
    sysm = dim2.System2D(mesh, cfg, dtype=dtype, device=dev, plan=p,
                         use_kernels=use_kernels)
    return STEPPERS[stepper](sysm, sd)


def _device_launches(fn, want):
    """The device kernels one call of `fn` runs (torch.profiler): `want`
    of them, every name one of the one-pass design's (no zero fill, no
    memset)."""
    from dot_tpu_torch.profiling import device_kernels
    k = device_kernels(fn)
    assert sum(k.values()) == want, k
    assert all(any(f in name for f in ("assemble_kernel", "pd_pair_vals",
                                       "sym_scale_kernel"))
               for name in k), k


# (resolution, parts): the 4-part plan of a small scene; one part at
# n2p 8,640 (67 column chunks of the one-pass kernel in f32), K28's nV
# 4,314 (rows off 32 B alignment: a head and a tail)
DD2D_CASES = {"p4": (400, 4), "wide": (8400, 1)}


@pytest.mark.parametrize("case", list(DD2D_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dd2d_kernels_match_plain_versions(cuda, dtype, case):
    """K25-K28 against their plain versions (kernels/dd2d.py) on an
    element plan of the spikes scene: f64 1e-12, f32 1e-5 max-rel (sums in
    the same order; K25's in a fixed order of its own, 1e-4 in f32); K26's
    matrices symmetric bit for bit, padding rows the unit diagonal alone,
    scaled in place; the one-subdomain scatter leaves every other vertex at
    0; one wrapper launch each; K26 one device kernel a call, K28 two (its
    pair values and the one pass), the scaling one."""
    from dot_tpu_torch.kernels import dd2d
    tol = TOL_NEW[dtype][0]
    resolution, parts = DD2D_CASES[case]
    st = _dd_system_2d(cuda, dtype, resolution=resolution, parts=parts)
    sysm = st.system
    nv = sysm.n_vert
    rng = np.random.default_rng(11)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    x = t(st.script_data.x0)
    x[:, :2] += t(0.01 * rng.normal(size=(nv, 2)))
    p = torch.zeros((nv, 3), dtype=dtype, device=cuda)
    p[:, :2] = t(rng.normal(size=(nv, 2)))
    fixed = torch.as_tensor(st.script_data.fixed0, device=cuda)
    eh = sysm.element_hessians(x)
    free = torch.logical_and(sysm.local_valid,
                             torch.logical_not(fixed[sysm.l2g])).to(dtype)
    ops.reset_launches()
    qk, Fk = ops.quadratic_form2d(p, sysm.conn, sysm.g4, eh, sysm.mass)
    qr, Fr = dd2d.quadratic_form2d_ref(p, sysm.conn, sysm.g4, eh, sysm.mass)
    assert _rel0(qk, qr) <= TOL_NEW[dtype][1] and _rel_max(Fk, Fr) <= tol
    Hk, dk = ops.subdomain_assemble2d(eh, free, sysm.mass_img, sysm.asm_tab)
    Hr, dr = dd2d.subdomain_assemble2d_ref(eh, free, sysm.mass_img,
                                           sysm.asm_tab)
    assert _rel_max(Hk, Hr) <= tol and _rel_max(dk, dr) <= tol
    assert torch.equal(Hk, Hk.mT)
    pad = torch.repeat_interleave(~sysm.local_valid, 2, dim=-1)
    assert bool(pad.any()) and bool((Hk[pad].abs().sum(-1) == 1).all())
    if case == "wide":
        assert sysm.asm_tab.n > 64 * 128
    Sr = dd2d.subdomain_scale2d_ref(Hr, dr, sysm.asm_tab)
    Sk = ops.subdomain_scale2d(Hk, dk, sysm.asm_tab)
    assert Sk.data_ptr() == Hk.data_ptr() and _rel_max(Sk, Sr) <= tol
    L, d = sysm.factorize_fast(Hr.clone(), dr)
    q = p.clone()
    rk = ops.h0_gather2d(q, sysm.l2g, sysm.local_valid, d)
    rr = dd2d.h0_gather2d_ref(q, sysm.l2g, sysm.local_valid, d)
    assert torch.equal(rk, rr)
    z = sysm.solve_local(L, rr).contiguous()
    ak = ops.h0_average2d(z, d, sysm.gath_perm, sysm.gath_segids,
                          sysm.gath_off, sysm.dup)
    ar = dd2d.h0_average2d_ref(z, d, sysm.gath_perm, sysm.gath_segids,
                               sysm.gath_off, sysm.dup)
    assert _rel_max(ak, ar) <= tol and float(ak[:, 2].abs().max()) == 0.0
    for i in range(sysm.n_parts):
        gk = ops.local_gather_one2d(q, sysm.l2g, sysm.local_valid, d, i)
        gr = dd2d.local_gather_one2d_ref(q, sysm.l2g, sysm.local_valid, d, i)
        assert torch.equal(gk, gr)
        sk_ = ops.local_scatter_one2d(gr, d, sysm.l2g, sysm.local_valid, i,
                                      nv)
        sr_ = dd2d.local_scatter_one2d_ref(gr, d, sysm.l2g, sysm.local_valid,
                                           i, nv)
        assert torch.equal(sk_, sr_)
    w = sysm.scalar(sysm.dt_sq) * sysm.vol_w * (2.0 * sysm.u_e + sysm.lam_e)
    tab = dd2d.pd_tables(sysm.mesh.conn, nv, cuda)
    fv = torch.logical_not(fixed).to(dtype)
    Pk, pk = ops.pd_assemble2d(sysm.g4, w, fv, sysm.mass, tab)
    Pr, pr = dd2d.pd_assemble2d_ref(sysm.g4, w, fv, sysm.mass, tab)
    assert _rel_max(Pk, Pr) <= tol and _rel_max(pk, pr) <= tol
    assert torch.equal(Pk, Pk.t())
    if case == "wide":
        assert nv > 32 * 128 and nv % 4 != 0
    hk = ops.hessian_diag2d(eh, sysm.mass, sysm.scatter_plan)
    hr = dd2d.hessian_diag2d_ref(eh, sysm.mass, sysm.scatter_plan)
    assert _rel_max(hk, hr) <= tol and bool((hk[:, 2] == 1).all())
    torch.cuda.synchronize()
    for k in ("quadratic_form2d", "subdomain_assemble2d", "h0_gather2d",
              "h0_average2d", "pd_assemble2d", "hessian_diag2d"):
        assert ops.launches[k] == 1, (k, ops.launches[k])
    assert ops.launches["subdomain_scale2d"] == 2      # + factorize_fast
    assert ops.launches["local_gather_one2d"] == sysm.n_parts
    assert ops.launches["local_scatter_one2d"] == sysm.n_parts
    _device_launches(lambda: ops.subdomain_assemble2d(
        eh, free, sysm.mass_img, sysm.asm_tab), 1)
    _device_launches(lambda: ops.subdomain_scale2d(Hk, dk, sysm.asm_tab), 1)
    _device_launches(lambda: ops.pd_assemble2d(sysm.g4, w, fv, sysm.mass,
                                               tab), 2)


@pytest.mark.parametrize("n_loc", [20, 40, 80])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_one_pass_rows_of_more_than_32_slots(cuda, dtype, n_loc):
    """K26's one-pass kernel on a dense synthetic batch (P 2, every row
    holds 2 n_loc slots: 40, 80 and 160, two and four slots a lane, and
    at 160 two windows of dd2d.MAX_ROW) against the plain version (sums
    in the same order; 1e-12 / 1e-5 max-rel against the card's atomic
    index_add_), one device kernel a call."""
    from dot_tpu_torch.kernels import dd2d
    rng = np.random.default_rng(13)
    P, n, n_val = 2, 2 * n_loc, 36 * 50
    # every slot of the batch, each with one to three values, plan order
    # shuffled
    dest = np.repeat(np.arange(P * n * n), rng.integers(1, 4, size=P * n * n))
    src = rng.integers(0, n_val, size=dest.size)
    order = rng.permutation(dest.size)
    tab = dd2d.slot_tables(src[order], dest[order], P, n_loc, 2, cuda)
    assert tab.max_row == n

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)
    vals = t(np.abs(rng.normal(size=(36, n_val // 36))))
    free = t((rng.uniform(size=(P, n_loc)) > 0.2).astype(np.float64))
    mass = t(rng.uniform(1.0, 2.0, size=(P, n_loc)))
    Hk, dk = ops.subdomain_assemble2d(vals, free, mass, tab)
    Hr, dr = dd2d.subdomain_assemble2d_ref(vals, free, mass, tab)
    tol = TOL_NEW[dtype][0]
    assert _rel_max(Hk, Hr) <= tol and _rel_max(dk, dr) <= tol
    _device_launches(lambda: ops.subdomain_assemble2d(vals, free, mass, tab),
                     1)


@pytest.mark.parametrize("n_vert", [None, 1101])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dense_and_pd_assembly_of_rows_longer_than_a_window(cuda, dtype,
                                                            n_vert):
    """K24 and K28 on a fan whose centre vertex has 140 neighbours (rows of
    282 and 141 slots: three and two windows of dd2d.MAX_ROW) against
    their plain versions on the CPU, bit for bit (sequential sums there,
    the same order in the kernel; d = sqrt(diag) taken on the card, whose
    sqrt rounds otherwise than the host's in the last bit now and then).
    The fan alone, and the fan in a strip of 1,101 vertices with its ids
    shuffled: K24's rows of 2,202 columns are cut into two pieces (f32) or
    three (f64) of dd2d.SEG_VECS vectors, K28's of 1,101 into two in f64,
    and the long rows' slots spread over every piece, so that a piece
    skips the windows left of it and carries its window from chunk to
    chunk."""
    from dot_tpu_torch.kernels import dd2d, soa2d
    k = 140
    i = np.arange(1, k + 1)
    conn = np.stack([np.zeros(k, np.int64), i, i % k + 1], axis=1)
    nv = k + 1
    if n_vert is not None:
        j = np.arange(k + 1, n_vert - 2)
        conn = np.concatenate([conn, np.stack([j, j + 1, j + 2], axis=1)])
        conn = np.random.default_rng(3).permutation(n_vert)[conn]
        nv = n_vert
    n_el = conn.shape[0]
    rng = np.random.default_rng(11)
    if n_vert is not None:       # K24's rows span pieces of the kernel
        vec = 128 // torch.finfo(dtype).bits          # a 16 B vector
        assert 2 * nv // vec > dd2d.SEG_VECS

    def t(a, dev):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    vals = np.abs(rng.normal(size=(36, n_el)))
    free = (rng.uniform(size=nv) > 0.2).astype(np.float64)
    free[conn[0, 0]] = 1.0
    mass = rng.uniform(1.0, 2.0, size=nv)
    g4, w = rng.normal(size=(4, n_el)), rng.uniform(0.5, 1.0, size=n_el)
    out = []
    for dev in ("cpu", cuda):
        tab = dd2d.dense_tables(conn, nv, dev)
        ptab = dd2d.pd_tables(conn, nv, dev)
        assert tab.max_row == 2 * (k + 1) and ptab.max_row == k + 1
        H, d = ops.dense_assemble2d(t(vals, dev), t(free, dev),
                                    t(mass, dev), tab)
        S, ds = ops.pd_assemble2d(t(g4, dev), t(w, dev), t(free, dev),
                                  t(mass, dev), ptab)
        out.append((H.to(cuda), S.to(cuda), d.to(cuda), ds.to(cuda)))
    (H0, S0, _, _), (H1, S1, d1, ds1) = out
    assert torch.equal(H1, H0) and torch.equal(S1, S0)
    assert torch.equal(d1, torch.sqrt(H0.diagonal()))
    assert torch.equal(ds1, torch.sqrt(S0.diagonal()))


def test_dot2d_step_on_card_matches_cpu(cuda):
    """Three DOT 4 frames of the 2D spikes scene, f64: the card (K21-K28)
    against the CPU's plain versions and against the plain versions on the
    same card, equal iteration counts, z = 0; K25 once an iteration, K26
    once a rebuild, K27 once an H0 apply."""
    out = []
    for dev, use in (("cpu", True), (cuda, True), (cuda, False)):
        st = _dd_system_2d(dev, torch.float64, resolution=200,
                           use_kernels=use)
        n0 = dict(ops.launches)
        s = st.init_state()
        its, es = [], []
        for _ in range(3):
            s, (stats, e) = st.step(s)
            its.append(stats.inner_iters)
            es.append(e)
            assert stats.stop in ("tol", "rel_dec")
        n_launch = {k: ops.launches[k] - n0[k] for k in ops.KERNELS}
        if dev != "cpu" and use:
            assert n_launch["quadratic_form2d"] == sum(its)
            assert n_launch["subdomain_assemble2d"] == 4    # init + 3 frames
            assert n_launch["h0_gather2d"] == n_launch["h0_average2d"] \
                == sum(its)
        else:
            assert not any(n_launch.values())
        assert float(s.x[:, 2].abs().max()) == 0.0
        out.append((s.x.cpu().numpy(), its, es))
    for other in out[1:]:
        assert other[1] == out[0][1]
        np.testing.assert_allclose(other[0], out[0][0], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(other[2], out[0][2], rtol=1e-10)
    np.testing.assert_allclose(out[1][2], [3.294256031942e+03,
                                           3.294256605060e+03,
                                           3.300416677680e+03], rtol=2e-4)


# ----------------------------------------------------------------------
# K32: the 2D dense H0 apply's forward and backward substitution
# ----------------------------------------------------------------------
# (P, n, layout): the spikes plan's width, column major as the library
# Cholesky leaves it; widths off the 64-row tiles in both layouts; a P = 1
# slice L[i:i + 1] of a column-major stack
K32_CASES = {"p4_5248_col": (4, 5248, "column"),
             "p3_1000_row": (3, 1000, "row"),
             "p2_333_col": (2, 333, "column"),
             "p1_slice_700": (3, 700, "slice")}


@pytest.mark.parametrize("case", list(K32_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tri_solve_matches_the_plain_pair(cuda, dtype, case):
    """K32 against its plain version (two batched library triangular
    solves) on random SPD factors: f64 1e-12, f32 1e-5 norm-wise; bit for
    bit from run to run; one launch a call."""
    from dot_tpu_torch.kernels import dd2d
    P, n, layout = K32_CASES[case]
    rng = np.random.default_rng(32)
    a = torch.as_tensor(rng.normal(size=(P, n, n)), device=cuda)
    Lc = torch.linalg.cholesky(a @ a.mT / n + torch.eye(
        n, dtype=torch.float64, device=cuda)).to(dtype)
    L = {"row": lambda: Lc.contiguous(),
         "column": lambda: Lc.mT.contiguous().mT,
         "slice": lambda: Lc.mT.contiguous().mT[1:2]}[layout]()
    r = torch.as_tensor(rng.normal(size=(L.shape[0], n)), dtype=dtype,
                        device=cuda)
    ops.reset_launches()
    z = ops.tri_solve(L, r)
    assert torch.equal(z, ops.tri_solve(L, r))
    assert ops.launches["tri_solve"] == 2
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _rel(z, dd2d.tri_solve_ref(L, r)) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tri_solve_on_the_spikes_factor(cuda, dtype):
    """K32 in System2D.solve_local on the spikes scene's factor (resolution
    20,000 on the 4-part element plan: P 4, n 5,248; System2D.rebuild_h0 at
    the start): f32 within twice the library pair's error against an f64
    solve of the same factor, f64 within 1e-12 of the pair; each
    subdomain's P = 1 slice (subdomain_solve's L[i:i + 1]) bit for bit its
    row of the batch; bit for bit from run to run; one solve_local runs
    K32's kernel alone (torch.profiler: no trsv, no device-to-device
    copy)."""
    from dot_tpu_torch.kernels import dd2d
    from dot_tpu_torch.profiling import device_kernels
    st = _dd_system_2d(cuda, dtype, resolution=20000)
    sysm = st.system
    x = torch.as_tensor(st.script_data.x0, dtype=dtype, device=cuda)
    fixed = torch.as_tensor(st.script_data.fixed0, device=cuda)
    _, L, d, _ = sysm.rebuild_h0(x, fixed)
    assert tuple(L.shape) == (4, 5248, 5248)
    g = torch.as_tensor(np.random.default_rng(2).normal(
        size=(sysm.n_vert, 3)), dtype=dtype, device=cuda)
    r = ops.h0_gather2d(g, sysm.l2g, sysm.local_valid, d)
    z = sysm.solve_local(L, r)
    assert torch.equal(z, sysm.solve_local(L, r))
    lib = dd2d.tri_solve_ref(L, r)
    if dtype == torch.float32:
        z64 = dd2d.tri_solve_ref(L.double(), r.double())
        assert _rel(z.double(), z64) <= 2 * _rel(lib.double(), z64)
    else:
        assert _rel(z, lib) <= 1e-12
    for i in range(4):
        assert torch.equal(sysm.solve_local(L[i:i + 1], r[i:i + 1])[0], z[i])
    k = device_kernels(lambda: sysm.solve_local(L, r))
    assert sum(k.values()) == 1 and all("tri_solve" in name for name in k), k


# ----------------------------------------------------------------------
# K29, K30 and the ADMM-DD entries of K21 / K22 / K26: the 2D ADMM family
# ----------------------------------------------------------------------
def _admm_2d(dev, dtype, stepper, resolution=400, use_kernels=True,
             parts=4):
    from dot_tpu_torch import dim2, plan2d
    cfg = Config(energy="FCR", time_stepper=stepper, dt=0.025, rho=1000.0,
                 ym=1e5, pr=0.4, script="stretch", handle_ratio=0.03,
                 shape="spikes", resolution=resolution, partition_amt=parts)
    mesh = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(mesh, cfg.script)
    mesh.fixed_mask = sd.fixed0.copy()
    plan = plan2d.build_plan_2d(mesh, parts) if stepper == "ADMMDD" else None
    sysm = dim2.System2D(mesh, cfg, dtype=dtype, device=dev, plan=plan,
                         use_kernels=use_kernels)
    if stepper == "ADMM":
        return dim2.ADMMPD2D(sysm, sd, max_iter=1000)
    return dim2.ADMMDD2D(sysm, sd)


@pytest.mark.parametrize("parts", [4, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_admm2d_kernels_match_plain_versions(cuda, dtype, parts):
    """K29, K30 and the four ADMM-DD entries against their plain versions
    (kernels/admm2d.py) on the spikes scene, ADMM-DD on 4 parts and on 2
    at n2p 4,416 (34 column chunks of the one-pass kernel): K29's loop counts
    equal on all but 1e-3 of the triangles (the device library's angles),
    z and du where they agree; the sums f64 1e-12, f32 1e-5 max-rel (K22
    from F norm-wise); W, C and the local Hessian symmetric bit for bit,
    padding rows of the local Hessian the unit diagonal alone; one wrapper
    launch each; W and C one device kernel a call, the local Hessian one."""
    from dot_tpu_torch.kernels import admm2d, soa2d
    tol, tol_n = TOL_NEW[dtype]
    t_el = TOL[dtype][0]
    rng = np.random.default_rng(12)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=cuda)
    pst = _admm_2d(cuda, dtype, "ADMM")
    sysm = pst.system
    n, nv = sysm.n_elem, sysm.n_vert
    Dx = t(np.eye(2).reshape(4, 1) + 0.4 * rng.normal(size=(4, n)))
    u4 = t(0.1 * rng.normal(size=(4, n)))
    ops.reset_launches()
    l_args = (Dx, u4, pst.w_e, pst.vol_dtsq, sysm.u_e, sysm.lam_e, sysm.mat)
    zk, duk, ck = ops.admm_local_step2d(*l_args, want_counts=True)
    zr, dur, cr = admm2d.admm_local_step2d_ref(*l_args, want_counts=True)
    same = (ck == cr).all(dim=0)
    assert float((~same).sum()) <= 1e-3 * n
    assert _rel_max(zk[:, same], zr[:, same]) <= t_el
    assert _rel_max(duk[:, same], dur[:, same]) <= t_el
    x = t(pst.script_data.x0)
    x[:, :2] += t(0.01 * rng.normal(size=(nv, 2)))
    M4 = t(rng.normal(size=(4, n)))
    base, off = t(rng.normal(size=(nv, 3))), t(rng.normal(size=(nv, 3)))
    free_v = t((rng.uniform(size=nv) > 0.1).astype(np.float64))
    s_args = (M4, sysm.g4, pst.w_e, sysm.scatter_plan, x)
    assert _rel_max(ops.dtw_scatter2d(*s_args, mass=sysm.mass),
                    admm2d.dtw_scatter2d_ref(*s_args, mass=sysm.mass)) <= tol
    rk = ops.dtw_scatter2d(*s_args, base=base, offset=off, free=free_v)
    rr = admm2d.dtw_scatter2d_ref(*s_args, base=base, offset=off,
                                  free=free_v)
    assert _rel_max(rk, rr) <= tol

    dd = _admm_2d(cuda, dtype, "ADMMDD",
                  **({} if parts == 4 else dict(resolution=8400, parts=2)))
    sysm = dd.system
    nv = sysm.n_vert
    x = t(dd.script_data.x0)
    x[:, :2] += t(0.01 * rng.normal(size=(nv, 2)))
    fixed = torch.as_tensor(dd.script_data.fixed0, device=cuda)
    free = dd._free(fixed)
    xl = dd._to_flat(x[sysm.l2g][:, :, :2] * sysm.local_valid[..., None])
    F0 = dd._local_defgrad(xl)
    Fp = dd._local_defgrad(dd._to_flat(
        t(0.01 * rng.normal(size=(dd.P, dd.N, 2)))))
    alpha = t([1.0, 0.5, 0.25, 0.125][:dd.P])
    e_args = (F0, Fp, alpha, dd.lu, dd.llam, dd.lw, sysm.mat, dd.P)
    ek = ops.ls_trial_energy2d_parts(*e_args)
    er = admm2d.ls_trial_energy2d_parts_ref(*e_args)
    assert float(((ek - er).abs() / er.abs()).max()) <= t_el
    g_args = (F0, dd.conn_local, dd.lg4, dd.lu, dd.llam, dd.lw, sysm.mat,
              dd.rows)
    assert _rel(ops.elem_gradient2d_from_F(*g_args),
                admm2d.elem_gradient2d_from_F_ref(*g_args)) <= tol_n
    eh = sysm.element_hessians(x)
    sfree = torch.cat([torch.logical_not(fixed[dd.shared_ids]).to(dtype),
                       torch.zeros(1, dtype=dtype, device=cuda)])
    w_args = (eh, free, sfree, dd.md_sh, dd.w_tab, dd.c_tab)
    Wk, Ck, dck = ops.w_assemble2d(*w_args)
    Wr, Cr, dcr = admm2d.w_assemble2d_ref(*w_args)
    assert _rel_max(Wk, Wr) <= tol and _rel_max(Ck, Cr) <= tol
    assert _rel_max(dck, dcr) <= tol
    assert torch.equal(Wk, Wk.mT) and torch.equal(Ck, Ck.mT)
    ehl = soa2d.elem_hessian2d_ref(xl, dd.conn_local, dd.lg4, dd.lu, dd.llam,
                                   dd.lw, sysm.mat, sysm.dt_sq)
    # the kernel's W, as on the path (ordered slot sums: symmetric bit for
    # bit; the plain version's atomic index_add_ on the card need not be)
    h_args = (ehl, Wk, free, dd.mass_local + dd.mass_dif * free, dd.own_tab)
    Hk, dk = ops.local_h_assemble2d(*h_args)
    Hr, dr = admm2d.local_h_assemble2d_ref(*h_args)
    assert _rel_max(Hk, Hr) <= tol and _rel_max(dk, dr) <= tol
    assert torch.equal(Hk, Hk.mT)
    pad = torch.repeat_interleave(~sysm.local_valid, 2, dim=-1)
    assert bool(pad.any()) and bool((Hk[pad].abs().sum(-1) == 1).all())
    if parts == 2:
        assert dd.own_tab.n > 32 * 128
    torch.cuda.synchronize()
    for k, m in (("admm_local_step2d", 1), ("dtw_scatter2d", 2),
                 ("ls_trial_energy2d_parts", 1), ("elem_gradient2d_from_F", 1),
                 ("w_assemble2d", 1), ("local_h_assemble2d", 1)):
        assert ops.launches[k] == m, (k, ops.launches[k])
    _device_launches(lambda: ops.w_assemble2d(*w_args), 1)
    _device_launches(lambda: ops.local_h_assemble2d(*h_args), 1)


@pytest.mark.parametrize("stepper", ["ADMM", "ADMMDD"])
def test_admm2d_frame_on_card_matches_cpu(cuda, stepper):
    """One frame of 2D ADMM-PD / ADMM-DD 4 on the spikes golden scene, f64:
    the card (K29 / K30, or the four ADMM-DD entries) against the CPU's
    plain versions, equal iteration counts, z = 0; K29 once an iteration,
    K30 once an iteration and once a frame; w_assemble2d once a frame."""
    out = []
    for dev in ("cpu", cuda):
        st = _admm_2d(dev, torch.float64, stepper, resolution=200)
        n0 = dict(ops.launches)
        s, (stats, e) = st.step(st.init_state())
        assert stats.stop == "tol" and stats.inner_iters > 0
        n_launch = {k: ops.launches[k] - n0[k] for k in ops.KERNELS}
        if dev != "cpu":
            if stepper == "ADMM":
                assert n_launch["admm_local_step2d"] == stats.inner_iters
                assert n_launch["dtw_scatter2d"] == stats.inner_iters + 1
            else:
                assert n_launch["w_assemble2d"] == 1
                assert n_launch["elem_gradient2d_from_F"] \
                    == stats.inner_iters + 1
                assert n_launch["local_h_assemble2d"] \
                    == 1 + (stats.inner_iters - 1) // 20
                assert n_launch["ls_trial_energy2d_parts"] \
                    >= 2 * stats.inner_iters
        assert float(s.x[:, 2].abs().max()) == 0.0
        out.append((s.x.cpu().numpy(), stats.inner_iters, e))
    assert out[0][1] == out[1][1]
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-8, atol=1e-11)
    assert out[1][2] == pytest.approx(out[0][2], rel=1e-9)
