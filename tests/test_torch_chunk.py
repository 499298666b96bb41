"""The port's chunked low-memory H0 rebuild against dot_tpu's on the CPU:
the compact equilibrated from its own diagonal blocks, rounded to bf16 and
scattered lower-only into the band (K5's compact entry point and K12),
the pre-equilibrated block scan with its tiers, and DOT frames on it.

The recipe of tests/test_banded.py:174-220: bar 24x4x4 twist, 5 parts,
band_bs_unit 48 (one numpy plan from dot_tpu.partition for both
packages). Its band is small, so both packages are forced onto the path
by setting `_chunk` on a built System, as that test does (dot_tpu also
builds its scan-assembly tables, which hold its lower-only selection).

Tolerances: f32 1e-6 on the equilibrated compact and d (the same sums in
another order); 1e-2 between the two packages' chunked solves (bf16 band
and bf16 factor leaves, rounding flips at different entries); f64 1e-10
on the scan alone; f32 sysE over three frames 2e-4. K31's plain version and the
scan's bf16-SYRK route on it: bit for bit the route they replaced (four
casts, an f32 GEMM, the upcast of D and a subtraction)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dot_tpu import partition as jpartition
from dot_tpu import scripts as jscripts
from dot_tpu.config import Config
from dot_tpu.mesh_gen import bar_mesh
from dot_tpu.steppers import DOTStepper as JDOT
from dot_tpu.steppers import System as JSystem
from dot_tpu_torch import convert
from dot_tpu_torch.kernels import band, ops
from dot_tpu_torch.steppers import DOTStepper
from dot_tpu_torch.steppers.core import BTDFactor, CoarseFactor, factor_leaves

_CACHE = {}
_JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _scene(coarse_key=-1):
    key = ("scene", coarse_key)
    if key not in _CACHE:
        mesh = bar_mesh(24, 4, 4)
        cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                     script="twist", handle_ratio=0.1, coarse=coarse_key)
        mesh.set_lame(cfg.ym, cfg.pr)
        mesh.find_border_verts(cfg.handle_ratio)
        sd = jscripts.init_script(mesh, "twist")
        mesh.fixed_mask = sd.fixed0.copy()
        plan = jpartition.build_plan(mesh, 5, pad_elem_to=16, pad_n3_to=48,
                                     band_bs_unit=48, band_min_nb=3)
        _CACHE[key] = (mesh, cfg, sd, plan)
    return _CACHE[key]


def _forced(dtype, coarse_key=-1):
    """(dot_tpu System, port System) on the chunked path."""
    key = ("sys", dtype, coarse_key)
    if key not in _CACHE:
        mesh, cfg, _, plan = _scene(coarse_key)
        j = JSystem(mesh, cfg, plan, dtype=_JDT[dtype])
        t = convert.system_from_plan(mesh, cfg, plan, dtype=dtype)
        assert getattr(j, "_chunk", None) is None and t._chunk is None
        j._chunk = True
        j._build_scan_assembly(plan)
        t._chunk = True
        _CACHE[key] = (j, t)
    return _CACHE[key]


def _x(seed=0):
    _, _, sd, _ = _scene()
    rng = np.random.default_rng(seed)
    return sd.x0 + 0.01 * rng.normal(size=sd.x0.shape), sd.fixed0.copy()


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _np(t):
    return t.detach().to(torch.float64).numpy()


def test_equilibrated_compact_and_d_match_dot_tpu():
    """dot_tpu core.py:1478-1488 against K5 (compact) + the first half of
    K12's plain version, on dot_tpu's element Hessians (f32)."""
    j, t = _forced(torch.float32)
    x, fixed = _x()
    _, U, s, V = j.fsvd(jnp.asarray(x, jnp.float32))
    eh = j.element_hessians(U, s, V)
    jfixed = jnp.asarray(fixed)
    # dot_tpu's compact, then its equilibration steps in f32 numpy
    compact = np.asarray(j._band_compact(eh, jfixed))
    P, N = j.n_parts, j.n3 // 3
    diag_ub = np.asarray(j.band_diag_ub)
    ub_row, ub_col = np.asarray(j.band_ub_row), np.asarray(j.band_ub_col)
    d2 = np.ones((P * N, 3), np.float32)
    d2[ub_row[diag_ub]] = compact[diag_ub][:, [0, 4, 8]]
    jd = np.sqrt(d2.reshape(P, N * 3))
    dinv = (np.float32(1.0) / jd).reshape(P * N, 3)
    jeq = compact * (dinv[ub_row][:, :, None]
                     * dinv[ub_col][:, None, :]).reshape(-1, 9)

    tc = t._band_compact(torch.as_tensor(np.array(eh)),
                         torch.as_tensor(fixed))
    lp = band.low_plan(t.plan, t.band_plan, "cpu")
    teq, td = band.band_equilibrate_ref(tc, lp)
    assert _rel(_np(td), jd) <= 1e-6
    # the lower-only selection is dot_tpu's, and on it the compacts agree
    # (dot_tpu's scan assembly leaves the strict-upper blocks zero)
    assert np.array_equal(lp.sel.numpy(), np.asarray(j.band_low_sel))
    low = lp.sel.numpy()
    assert _rel(_np(teq)[low], jeq[low]) <= 1e-6
    assert np.array_equal(lp.dest.numpy(), np.asarray(j.band_low_dest))
    # the bf16 band holds exactly the rounded lower blocks and unit pads
    flat, d = band.band_equil_scatter_ref(tc, lp, torch.bfloat16)
    assert flat.dtype == torch.bfloat16 and torch.equal(d, td)
    ok = lp.dest < lp.total
    vals = teq[lp.sel].to(torch.bfloat16).reshape(-1)
    assert torch.equal(flat[lp.dest[ok]], vals[ok])
    assert bool((flat[lp.pad_diag] == 1).all())


def test_chunked_solves_match_dot_tpu():
    j, t = _forced(torch.float32)
    x, fixed = _x()
    _, jL, jd, _ = j._rebuild_h0(jnp.asarray(x, jnp.float32),
                                 jnp.asarray(fixed))
    calls = []
    orig = t._btd_scan_equilibrated
    t._btd_scan_equilibrated = lambda *a: calls.append(a[2:]) or orig(*a)
    try:
        _, tL, td, kc = t.rebuild_h0(torch.as_tensor(x, dtype=torch.float32),
                                     torch.as_tensor(fixed))
    finally:
        del t._btd_scan_equilibrated
    assert calls == [(0.0, True)] and kc is None
    assert isinstance(tL, BTDFactor)
    assert tL.linv.shape[0] == t.band_nb
    assert all(a.dtype == torch.bfloat16 for a in factor_leaves(tL))
    assert _rel(_np(td), jd) <= 1e-6
    r = np.random.default_rng(3).normal(size=(t.n_parts, t.n3))
    z_j = np.asarray(j.solve_local(jL, jnp.asarray(r, jnp.float32)))
    z_t = _np(t.solve_local(tL, torch.as_tensor(r, dtype=torch.float32)))
    assert _rel(z_t, z_j) <= 1e-2


@pytest.mark.parametrize("shift", [0.0, 1.0e-4])
def test_scan_equilibrated_f64_matches_dot_tpu(shift):
    """_btd_scan_equilibrated alone, f64, bf16 off, on the same equilibrated
    blocks (dot_tpu's own band, scaled by its diagonal)."""
    j, t = _forced(torch.float64)
    x, fixed = _x()
    _, U, s, V = j.fsvd(jnp.asarray(x))
    eh = j.element_hessians(U, s, V)
    diag, sub = j._assemble_btd(eh, jnp.asarray(fixed))
    dinv = 1.0 / jnp.sqrt(jnp.diagonal(diag, axis1=-2, axis2=-1))
    dg = diag * dinv[..., :, None] * dinv[..., None, :]
    sb = sub * dinv[1:, :, :, None] * dinv[:-1, :, None, :]
    jf = j._btd_scan_equilibrated(dg, sb, shift, False)
    tf = t._btd_scan_equilibrated(torch.as_tensor(np.array(dg)),
                                  torch.as_tensor(np.array(sb)), shift,
                                  False)
    assert tf.linv.dtype == torch.float64
    assert _rel(_np(tf.linv), jf.linv) <= 1e-10
    assert _rel(_np(tf.sub), jf.sub) <= 1e-10


@pytest.mark.parametrize("case", ["bf16_fails", "exact_fails"])
def test_chunked_tier_order(monkeypatch, case):
    """The bf16-SYRK scan, then the exact scan on the same bf16 band, then
    a 1e-4 shift; one host read per decision."""
    _, t = _forced(torch.float32)
    x, fixed = _x()
    calls, bands = [], []
    orig = t._btd_scan_equilibrated
    fail = {"bf16_fails": lambda s, b: b,
            "exact_fails": lambda s, b: s == 0.0}[case]

    def spy(dg, sb, shift, bf16):
        calls.append((shift, bf16))
        bands.append((dg.data_ptr(), sb.data_ptr(), dg.dtype))
        fac = orig(dg, sb, shift, bf16)
        if fail(shift, bf16):
            fac.linv[0, 0, 0, 0] = float("nan")
        return fac

    monkeypatch.setattr(t, "_btd_scan_equilibrated", spy)
    n0 = t.n_syncs
    L, _ = t._rebuild_banded_chunked(
        t.element_hessians(torch.as_tensor(x, dtype=torch.float32)),
        torch.as_tensor(fixed))
    want = {"bf16_fails": [(0.0, True), (0.0, False)],
            "exact_fails": [(0.0, True), (0.0, False), (1e-4, False)]}[case]
    assert calls == want
    assert len(set(bands)) == 1 and bands[0][2] == torch.bfloat16
    assert t.n_syncs - n0 == 2      # the shifted build is not read back
    assert not any(torch.isnan(a).any() for a in factor_leaves(L))


def test_chunked_coarse_frames_f32_match_dot_tpu():
    """Three f32 DOT frames with the coarse space and the chunked rebuild
    forced in both packages, from dot_tpu's initial state carried across:
    sysE within 2e-4."""
    mesh, cfg, sd, plan = _scene(coarse_key=1)
    j, t = _forced(torch.float32, coarse_key=1)
    assert j.use_coarse and t.use_coarse
    jst, tst = JDOT(j, sd), DOTStepper(t, sd)
    js = jst.init_state()
    ts = convert.state_from_numpy(jax.tree.map(np.array, js), t)
    assert isinstance(ts.chol, BTDFactor)
    assert isinstance(ts.kc_chol, CoarseFactor)
    je, te, it_j, it_t = [], [], [], []
    for _ in range(3):
        js, (jstats, e) = jst.step(js, rel_tol=1e-5)
        je.append(float(e))
        it_j.append(int(jstats.inner_iters))
        ts, (stats, e) = tst.step(ts, rel_tol=1e-5)
        te.append(e)
        it_t.append(stats.inner_iters)
        assert stats.stop in ("tol", "rel_dec")
    print(f"iterations dot_tpu {it_j}, port {it_t}")
    assert isinstance(ts.chol, BTDFactor)
    assert ts.chol.linv.dtype == torch.bfloat16
    np.testing.assert_allclose(te, je, rtol=2e-4)


def _old_schur(D, Ls):
    """The scan's update before K31: D_{k+1} upcast, minus _mm(Ls, Ls^T,
    True) (both operands rounded to bf16 and upcast, an f32 GEMM)."""
    b16, f32 = torch.bfloat16, torch.float32
    return D.to(f32) - Ls.to(b16).to(f32) @ Ls.mT.to(b16).to(f32)


@pytest.mark.parametrize("n", [48, 77])
@pytest.mark.parametrize("d_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_schur_update_ref_is_the_old_update_bit_for_bit(d_dtype, n):
    """band.schur_update_ref (K31's plain version, ops.schur_update's CPU
    route) against the route it replaced: the lower triangle bit for bit
    (the kernel writes the lower tiles; the plain version every entry)."""
    rng = np.random.default_rng(n)
    B = 3
    Ls = torch.as_tensor(rng.normal(size=(B, n, n)) / np.sqrt(n),
                         dtype=torch.float32)
    D = torch.as_tensor(rng.normal(size=(B, n, n)) + 2 * n * np.eye(n),
                        dtype=d_dtype)
    want = _old_schur(D, Ls)
    got = band.schur_update_ref(D, Ls.to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert torch.equal(torch.tril(got), torch.tril(want))
    out = torch.full((B, n, n), float("nan"))
    assert ops.schur_update(D, Ls.to(torch.bfloat16), out) is out
    assert torch.equal(torch.tril(out), torch.tril(want))


def _old_scan(dg, sb, out_dt):
    """_btd_scan_equilibrated's bf16-SYRK route before K31."""
    lis, lss = [], []
    Dk = dg[0].to(torch.float32)
    for k in range(dg.shape[0]):
        _, Li, _ = band.chol_inv_ref(Dk.contiguous(), False)
        lis.append(Li.to(out_dt))
        if k == dg.shape[0] - 1:
            break
        Ls = sb[k].to(torch.float32) @ Li.mT
        lss.append(Ls.to(out_dt))
        Dk = _old_schur(dg[k + 1], Ls)
    return torch.stack(lis), torch.stack(lss)


@pytest.mark.parametrize("band_dt,out_dt", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16)], ids=["bf16-bf16", "bf16-f32",
                                           "f32-bf16"])
def test_bf16_scan_is_the_old_route_bit_for_bit(band_dt, out_dt):
    """The chunked band (bf16, as the low-memory path stores it, or f32 as
    _factorize_btd's scan without it) through the bf16-SYRK scan on K31's
    route: every leaf bit for bit the old route's, leaves in bf16 or f32."""
    _, t = _forced(torch.float32)
    x, fixed = _x()
    eh = t.element_hessians(torch.as_tensor(x, dtype=torch.float32))
    flat, _ = t._equil_scatter(t._band_compact(eh, torch.as_tensor(fixed)))
    P, bs, nb = t.n_parts, t.band_bs, t.band_nb
    dg = flat[:P * nb * bs * bs].view(nb, P, bs, bs).to(band_dt)
    sb = flat[P * nb * bs * bs:].view(nb - 1, P, bs, bs).to(band_dt)
    fac = t._btd_scan_equilibrated(dg, sb, 0.0, True, out_dt)
    linv, sub = _old_scan(dg, sb, out_dt)
    assert fac.linv.dtype == fac.sub.dtype == out_dt
    assert torch.equal(fac.linv, linv) and torch.equal(fac.sub, sub)
