"""The port's quasi-Newton H0 preconditioner against dot_tpu's on the CPU:
block cyclic reduction (CRFactor) with bf16 factor leaves in f32, the
robustness tiers, applyDtype, the chunked-rebuild gate and the dense f32
factorize_fast.

Plans (built once with dot_tpu.partition, handed to both packages): the
cyclic-reduction recipe of tests/test_banded.py:140-149 (bar 40x3x3,
stretch, 2 parts, band_bs_unit 48: nb 11, bs 96, so 2 CR levels and a
3-block root, like bar17's 13 -> 7 -> 4) and a dense one-part plan of
bar 12x4x4 with n3 = 1152 (three 384-wide panels).

Tolerances: f64 1e-10 (exact factorizations of the same systems); f32
1e-2 max-abs relative between the two packages' bf16-stored factors (bf16
rounding flips at different entries), 5e-2 against the f64 exact solve
(test_banded.py:151); f32 sysE over three frames 2e-4."""

import dataclasses

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
from dot_tpu.steppers.core import CRFactor as JCR
from dot_tpu_torch import convert
from dot_tpu_torch import io as tio
from dot_tpu_torch.sim import Simulator
from dot_tpu_torch.steppers import DOTStepper
from dot_tpu_torch.steppers.core import BTDFactor, CRFactor, factor_leaves

_CACHE = {}
_JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _scene():
    if "cr" not in _CACHE:
        mesh = bar_mesh(40, 3, 3)
        cfg = Config(energy="FCR", time_stepper="DOT", partition_amt=2,
                     dt=0.025, rho=1000.0, ym=1e5, pr=0.4, script="stretch",
                     handle_ratio=0.1)
        mesh.set_lame(cfg.ym, cfg.pr)
        mesh.find_border_verts(cfg.handle_ratio)
        sd = jscripts.init_script(mesh, "stretch")
        mesh.fixed_mask = sd.fixed0.copy()
        plan = jpartition.build_plan(mesh, 2, pad_elem_to=16, pad_n3_to=48,
                                     band_bs_unit=48, band_min_nb=3)
        assert plan.band_nb >= 9
        _CACHE["cr"] = (mesh, cfg, sd, plan)
    return _CACHE["cr"]


def _systems(dtype):
    key = ("sys", dtype)
    if key not in _CACHE:
        mesh, cfg, sd, plan = _scene()
        _CACHE[key] = (JSystem(mesh, cfg, plan, dtype=_JDT[dtype]),
                       convert.system_from_plan(mesh, cfg, plan, dtype=dtype))
    return _CACHE[key]


def _x(seed=0):
    _, _, sd, _ = _scene()
    rng = np.random.default_rng(seed)
    return sd.x0 + 0.01 * rng.normal(size=sd.x0.shape), sd.fixed0.copy()


def _factors(dtype):
    """(dot_tpu (L, d), port (L, d)) rebuilt at one deformed state."""
    key = ("fac", dtype)
    if key not in _CACHE:
        jsys, tsys = _systems(dtype)
        x, fixed = _x()
        _, jL, jd, _ = jsys.rebuild_h0(jnp.asarray(x, _JDT[dtype]),
                                       jnp.asarray(fixed))
        _, tL, td = tsys.rebuild_h0(torch.as_tensor(x, dtype=dtype),
                                    torch.as_tensor(fixed))
        _CACHE[key] = ((jL, jd), (tL, td))
    return _CACHE[key]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _np(t):
    return t.detach().to(torch.float64).numpy()


def _rhs(tsys, dtype, seed=3):
    r = np.random.default_rng(seed).normal(size=(tsys.n_parts, tsys.n3))
    return r, torch.as_tensor(r, dtype=dtype)


def test_cr_factor_f64_matches_dot_tpu():
    (jL, jd), (tL, td) = _factors(torch.float64)
    jsys, tsys = _systems(torch.float64)
    assert isinstance(jL, JCR) and isinstance(tL, CRFactor)
    assert len(tL.levels) == len(jL.levels) == 2
    assert _rel(_np(td), jd) <= 1e-12
    for lt, lj in zip(tL.levels, jL.levels):
        for a, b in zip(lt, lj):
            assert a.dtype == torch.float64
            assert _rel(_np(a), b) <= 1e-10
    assert _rel(_np(tL.root.linv), jL.root.linv) <= 1e-10
    assert _rel(_np(tL.root.sub), jL.root.sub) <= 1e-10
    r, tr = _rhs(tsys, torch.float64)
    jz = jsys.solve_local(jL, jnp.asarray(r))
    assert _rel(_np(tsys.solve_local(tL, tr)), jz) <= 1e-10
    rhs = np.random.default_rng(4).normal(size=(tsys.n_vert, 3))
    jp = jax.jit(lambda s, L, d, q: s.h0_apply(L, d, q))(
        jsys, jL, jd, jnp.asarray(rhs))
    assert _rel(_np(tsys.h0_apply(tL, td, torch.as_tensor(rhs))), jp) <= 1e-10


def test_cr_f32_bf16_leaves_match_dot_tpu():
    (jL, jd), (tL, td) = _factors(torch.float32)
    jsys, tsys = _systems(torch.float32)
    assert isinstance(tL, CRFactor) and len(tL.levels) == len(jL.levels)
    assert tsys.apply_dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in factor_leaves(tL))
    assert all(np.asarray(t).dtype.name == "bfloat16"
               for t in jax.tree.leaves(jL))
    r, tr = _rhs(tsys, torch.float32)
    z_t = _np(tsys.solve_local(tL, tr))
    z_j = np.asarray(jsys.solve_local(jL, jnp.asarray(r, jnp.float32)))
    assert _rel(z_t, z_j) <= 1e-2
    # both within the preconditioner grade of the f64 exact solve
    _, t64 = _systems(torch.float64)
    x, fixed = _x()
    H = t64.assemble_subdomains(
        t64.element_hessians(torch.as_tensor(x)), torch.as_tensor(fixed))
    Lex, dex = t64.factorize(H, fast=False)
    assert isinstance(Lex, BTDFactor)
    z64 = _np(t64.solve_local(Lex, torch.as_tensor(r)))
    assert _rel(z_t, z64) <= 5e-2 and _rel(z_j, z64) <= 5e-2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_carried_cr_factor_gives_rebuilt_h0_apply(dtype):
    """dot_tpu's CRFactor carried across (leaves keep their storage dtype)
    applies as the port's own rebuilt factor does."""
    (jL, jd), (tL, td) = _factors(dtype)
    _, tsys = _systems(dtype)
    carried = convert.factor_from_numpy(jax.tree.map(np.asarray, jL))
    assert isinstance(carried, CRFactor)
    assert [t.dtype for t in factor_leaves(carried)] == \
        [t.dtype for t in factor_leaves(tL)]
    rhs = torch.as_tensor(np.random.default_rng(5).normal(
        size=(tsys.n_vert, 3)), dtype=dtype)
    a = _np(tsys.h0_apply(carried, td, rhs))
    b = _np(tsys.h0_apply(tL, td, rhs))
    assert _rel(a, b) <= (1e-10 if dtype == torch.float64 else 1e-2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cr_frames_match_dot_tpu(dtype):
    """Three DOT frames from dot_tpu's initial state (its CR factor carried
    across): f64 positions within rtol 1e-7, f32 sysE within 2e-4."""
    mesh, cfg, sd, plan = _scene()
    jst = JDOT(JSystem(mesh, cfg, plan, dtype=_JDT[dtype]), sd)
    tsys = convert.system_from_plan(mesh, cfg, plan, dtype=dtype)
    tst = DOTStepper(tsys, sd)
    js = jst.init_state()
    ts = convert.state_from_numpy(jax.tree.map(np.array, js), tsys)
    assert isinstance(ts.chol, CRFactor)
    je, te, it_j, it_t = [], [], [], []
    for _ in range(3):
        js, (jstats, e) = jst.step(js, rel_tol=1e-5)
        je.append(float(e))
        it_j.append(int(jstats.inner_iters))
        ts, (stats, e) = tst.step(ts, rel_tol=1e-5)
        te.append(e)
        it_t.append(stats.inner_iters)
        assert stats.stop in ("tol", "rel_dec")
    print(f"{dtype}: iterations dot_tpu {it_j}, port {it_t}")
    assert isinstance(ts.chol, CRFactor)
    if dtype == torch.float64:
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                                   rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(te, je, rtol=1e-9)
    else:
        np.testing.assert_allclose(te, je, rtol=2e-4)


def _record_builds(monkeypatch, tsys, fail):
    """Spy on _cr_build: records (shift, bf16) of each build and NaN-fills
    the factor of the builds `fail` selects."""
    calls = []
    orig = tsys._cr_build

    def spy(dg, sb, out_dt, bf16):
        shift = round(float(dg[0, 0, 0, 0]) - 1.0, 6)   # unit diagonal
        calls.append((shift, bf16))
        fac = orig(dg, sb, out_dt, bf16)
        if fail(shift, bf16):
            fac.root.linv[0, 0, 0, 0] = float("nan")
        return fac

    monkeypatch.setattr(tsys, "_cr_build", spy)
    return calls


@pytest.mark.parametrize("case", ["f32_bf16_fails", "f32_exact_fails",
                                  "f64_fails"])
def test_tier_order(monkeypatch, case):
    """f32: bf16 build, then exact, then the 1e-4 shift, one host read per
    decision; f64: the exact build, then the shift, one read."""
    dtype = torch.float64 if case == "f64_fails" else torch.float32
    _, tsys = _systems(dtype)
    x, fixed = _x()
    H = tsys.assemble_subdomains(
        tsys.element_hessians(torch.as_tensor(x, dtype=dtype)),
        torch.as_tensor(fixed))
    fail = {"f32_bf16_fails": lambda s, b: b,
            "f32_exact_fails": lambda s, b: s == 0.0,
            "f64_fails": lambda s, b: s == 0.0}[case]
    calls = _record_builds(monkeypatch, tsys, fail)
    n0 = tsys.n_syncs
    L, _ = tsys.factorize(H, fast=True)
    want = {"f32_bf16_fails": [(0.0, True), (0.0, False)],
            "f32_exact_fails": [(0.0, True), (0.0, False), (1e-4, False)],
            "f64_fails": [(0.0, False), (1e-4, False)]}[case]
    assert calls == want
    assert tsys.n_syncs - n0 == (1 if case == "f64_fails" else 2)
    assert not any(torch.isnan(t).any() for t in factor_leaves(L))


def test_scan_when_cr_is_off():
    """allow_cr=False (and nb < 8) takes the block scan, with the bf16
    SYRK and bf16 leaves in f32; its solves stay within 5e-2 of CR's."""
    _, tsys = _systems(torch.float32)
    x, fixed = _x()
    H = tsys.assemble_subdomains(
        tsys.element_hessians(torch.as_tensor(x, dtype=torch.float32)),
        torch.as_tensor(fixed))
    Ls, _ = tsys._factorize_btd(*H, fast=True, allow_cr=False)
    Lc, _ = tsys._factorize_btd(*H, fast=True)
    assert isinstance(Ls, BTDFactor) and isinstance(Lc, CRFactor)
    assert Ls.linv.dtype == Ls.sub.dtype == torch.bfloat16
    _, tr = _rhs(tsys, torch.float32)
    assert _rel(_np(tsys.solve_local(Ls, tr)),
                _np(tsys.solve_local(Lc, tr))) <= 5e-2


def test_apply_dtype_honoured(tmp_path):
    mesh, cfg, _, plan = _scene()
    for name, want in (("", torch.bfloat16), ("f32", torch.float32),
                       ("bf16", torch.bfloat16)):
        c = dataclasses.replace(cfg, apply_dtype=name)
        tsys = convert.system_from_plan(mesh, c, plan, dtype=torch.float32)
        x, fixed = _x()
        _, L, _ = tsys.rebuild_h0(torch.as_tensor(x, dtype=torch.float32),
                                  torch.as_tensor(fixed))
        assert {t.dtype for t in factor_leaves(L)} == {want}, name
    # the scene-file key reaches the Simulator's System
    small = bar_mesh(8, 3, 3)
    mp = tmp_path / "bar.msh"
    tio.save_tet_mesh(str(mp), small.V, small.conn, small.SF)
    scene = tmp_path / "scene.txt"
    scene.write_text("energy FCR\ntimeStepper DOT 2\ntime 1 0.025\n"
                     "script stretch\napplyDtype f32\n"
                     f"shape input {mp}\n")
    sim = Simulator(Config.load(str(scene)), str(tmp_path / "out"),
                    dtype=torch.float32, device="cpu", mute=True)
    assert sim.system.apply_dtype == torch.float32


def test_chunk_gate_raises():
    """Where dot_tpu would take its chunked bf16 rebuild (f32 band over
    2 GiB, P > 1) the port raises; f64 does not engage it."""
    mesh, cfg, _, plan = _scene()
    big = dataclasses.replace(plan, band_bs=8192)
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        convert.system_from_plan(mesh, cfg, big, dtype=torch.float32)
    convert.system_from_plan(mesh, cfg, big, dtype=torch.float64)


def test_dense_factorize_fast_matches_dot_tpu():
    """Dense plan, n3 = 1152: dot_tpu f32 takes its blocked bf16-update
    factorize_fast (384-wide panels); so does the port."""
    mesh = bar_mesh(12, 4, 4)
    cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script="stretch", handle_ratio=0.1)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = jscripts.init_script(mesh, "stretch")
    mesh.fixed_mask = sd.fixed0.copy()
    plan = jpartition.build_plan(mesh, 1, pad_elem_to=16, pad_n3_to=384,
                                 banded=False)
    assert plan.n3 == 1152
    jsys = JSystem(mesh, cfg, plan, dtype=jnp.float32)
    tsys = convert.system_from_plan(mesh, cfg, plan, dtype=torch.float32)
    rng = np.random.default_rng(6)
    x = sd.x0 + 0.01 * rng.normal(size=sd.x0.shape)
    _, jL, jd, _ = jsys.rebuild_h0(jnp.asarray(x, jnp.float32),
                                   jnp.asarray(sd.fixed0))
    calls = []
    orig = tsys._factorize_dense_fast
    tsys._factorize_dense_fast = lambda H, blk: calls.append(blk) or \
        orig(H, blk)
    _, tL, td = tsys.rebuild_h0(torch.as_tensor(x, dtype=torch.float32),
                                torch.as_tensor(sd.fixed0))
    assert calls == [384]
    assert tL.dtype == torch.float32 and not torch.isnan(tL).any()
    assert _rel(_np(td), jd) <= 1e-6
    assert _rel(_np(tL), jL) <= 1e-2
    r, tr = _rhs(tsys, torch.float32)
    z_j = np.asarray(jsys.solve_local(jL, jnp.asarray(r, jnp.float32)))
    assert _rel(_np(tsys.solve_local(tL, tr)), z_j) <= 1e-2
