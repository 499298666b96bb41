"""The port's two-level H0 coarse space and L-BFGS two-loop against dot_tpu
on the CPU.

Plans (built once with dot_tpu.partition, handed to both packages): the
recipe of tests/test_coarse.py:21-33 (bar 20x4x4 twist, band_bs_unit 48),
with 4 parts and `coarse 1` for the factor and apply, 4 and 16 parts for
the gate, and bar 36x4x4 with 12 parts (tests/test_coarse.py:122) for
three DOT frames.

Tolerances: f64 1e-10 between the two packages' coarse factors, applies
and frames' positions (rtol 1e-7), which solve the same systems by
different routes (K6 + Lc^{-1} mat-vecs against triangular solves); 1e-12
for the kernels' plain versions against dot_tpu's algebra (the same sums
in another order)."""

import types

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
from dot_tpu.steppers import quasi_newton as jqn
from dot_tpu.steppers.quasi_newton import QuasiNewtonStepper as JQN
from dot_tpu_torch import convert
from dot_tpu_torch.kernels import coarse, ops
from dot_tpu_torch.steppers import DOTStepper
from dot_tpu_torch.steppers.core import CoarseFactor
from dot_tpu_torch.steppers.quasi_newton import QuasiNewtonStepper as TQN

_CACHE = {}


def _scene(cells=(20, 4, 4), n_parts=4, coarse_key=1):
    key = (cells, n_parts, coarse_key)
    if key not in _CACHE:
        mesh = bar_mesh(*cells)
        cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                     script="twist", handle_ratio=0.1, coarse=coarse_key)
        mesh.set_lame(cfg.ym, cfg.pr)
        mesh.find_border_verts(cfg.handle_ratio)
        sd = jscripts.init_script(mesh, "twist")
        mesh.fixed_mask = sd.fixed0.copy()
        plan = jpartition.build_plan(mesh, n_parts, pad_elem_to=16,
                                     pad_n3_to=48, band_bs_unit=48,
                                     band_min_nb=3)
        _CACHE[key] = (mesh, cfg, sd, plan)
    return _CACHE[key]


def _systems():
    if "sys" not in _CACHE:
        mesh, cfg, _, plan = _scene()
        _CACHE["sys"] = (JSystem(mesh, cfg, plan, dtype=jnp.float64),
                         convert.system_from_plan(mesh, cfg, plan))
    return _CACHE["sys"]


def _rebuilt():
    """Both packages' rebuild at one deformed state (f64)."""
    if "rebuilt" not in _CACHE:
        jsys, tsys = _systems()
        _, _, sd, _ = _scene()
        x = sd.x0 + 0.01 * np.random.default_rng(0).normal(size=sd.x0.shape)
        j = jsys.rebuild_h0(jnp.asarray(x), jnp.asarray(sd.fixed0))
        t = tsys.rebuild_h0(torch.as_tensor(x), torch.as_tensor(sd.fixed0))
        _CACHE["rebuilt"] = (x, j, t)
    return _CACHE["rebuilt"]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _np(t):
    return t.detach().to(torch.float64).numpy()


def test_coarse_factor_f64_matches_dot_tpu():
    jsys, tsys = _systems()
    assert jsys.use_coarse and tsys.use_coarse
    _, (_, _, _, jkc), (_, _, _, tkc) = _rebuilt()
    assert isinstance(tkc, CoarseFactor)
    assert tkc.lc.shape == (6 * tsys.n_parts, 6 * tsys.n_parts)
    assert _rel(_np(tkc.dc), jkc[1]) <= 1e-10
    assert _rel(_np(tkc.lc), jkc[0]) <= 1e-10
    eye = np.eye(tkc.lc.shape[0])
    assert _rel(_np(tkc.linv) @ _np(tkc.lc), eye) <= 1e-10


def test_coarse_apply_f64_matches_dot_tpu():
    jsys, tsys = _systems()
    _, _, sd, _ = _scene()
    _, (_, jL, jd, jkc), (_, tL, td, tkc) = _rebuilt()
    rhs = np.random.default_rng(1).normal(size=(tsys.n_vert, 3))
    fixed = sd.fixed0
    jy = jax.jit(lambda s, kc, r, f: s._coarse_apply(kc, r, f))(
        jsys, jkc, jnp.asarray(rhs), jnp.asarray(fixed))
    ty = tsys._coarse_apply(tkc, torch.as_tensor(rhs), torch.as_tensor(fixed))
    assert _rel(_np(ty), jy) <= 1e-10
    assert np.all(_np(ty)[fixed] == 0.0)
    jp = jax.jit(lambda s, L, d, q, kc, f: s.h0_apply(L, d, q, kc=kc,
                                                      fixed=f))(
        jsys, jL, jd, jnp.asarray(rhs), jkc, jnp.asarray(fixed))
    tp = tsys.h0_apply(tL, td, torch.as_tensor(rhs), kc=tkc,
                       fixed=torch.as_tensor(fixed))
    assert _rel(_np(tp), jp) <= 1e-10


def test_coarse_tables_match_dot_tpu():
    """The owner map and the centred, scaled xc are dot_tpu's."""
    jsys, tsys = _systems()
    cp = tsys.coarse_plan
    assert np.array_equal(cp.own.numpy(), np.asarray(jsys.coarse_own))
    assert _rel(_np(cp.xc), jsys.coarse_xc) <= 1e-15
    # every item lies in its destination's chunk run, in dest order
    dest = cp.item_dest.numpy()
    assert np.all(np.diff(dest) >= 0)
    off = cp.chunk_off.numpy()
    po = cp.pair_off.numpy()
    for p, d in enumerate(cp.pair_dest.numpy()):
        lo, hi = off[po[p]], off[po[p + 1]]
        assert np.all(dest[lo:hi] == d)
        assert np.all(np.diff(off[po[p]:po[p + 1] + 1]) <= coarse.CHUNK)


@pytest.mark.parametrize("n_parts", [4, 16])
@pytest.mark.parametrize("coarse_key", [-1, 0, 1])
def test_use_coarse_gate_matches_dot_tpu(n_parts, coarse_key):
    mesh, cfg, _, plan = _scene(n_parts=n_parts, coarse_key=coarse_key)
    j = JSystem(mesh, cfg, plan, dtype=jnp.float64)
    t = convert.system_from_plan(mesh, cfg, plan)
    assert t.use_coarse == j.use_coarse
    assert t.use_coarse == (coarse_key == 1 or
                            (coarse_key == -1 and n_parts >= 16))
    assert (t.coarse_plan is None) == (not t.use_coarse)


def test_coarse_assemble_plain_matches_dot_tpu():
    """K10's plain version, symmetrized, against the Kc inside dot_tpu's
    factor (Lc Lc^T - 1e-4 I, scaled back by dc)."""
    _, tsys = _systems()
    _, (jeh, _, _, jkc), _ = _rebuilt()
    _, _, sd, _ = _scene()
    P = tsys.n_parts
    freev = torch.as_tensor(~sd.fixed0).to(torch.float64)
    kc = coarse.coarse_assemble_ref(torch.as_tensor(np.array(jeh)),
                                    tsys.conn, freev, tsys.mass,
                                    tsys.coarse_plan)
    K = _np(kc.view(P, P, 6, 6).permute(0, 2, 1, 3).reshape(6 * P, 6 * P))
    K = 0.5 * (K + K.T)
    Lc, dc = np.asarray(jkc[0]), np.asarray(jkc[1])
    Kj = (Lc @ Lc.T - 1e-4 * np.eye(6 * P)) * dc[:, None] * dc[None, :]
    assert _rel(K, Kj) <= 1e-12


def test_coarse_restrict_prolong_plain_match_dot_tpu():
    """K11's plain versions against Z^T r / dc and Z (y / dc) with Z built
    from dot_tpu's owner map and xc (tests/test_coarse.py:59-70)."""
    jsys, tsys = _systems()
    _, _, sd, _ = _scene()
    own = np.asarray(jsys.coarse_own)
    xc = np.asarray(jsys.coarse_xc, np.float64)
    free = ~sd.fixed0
    nv, P = tsys.n_vert, tsys.n_parts
    Z = np.zeros((3 * nv, 6 * P))
    E = np.eye(3)
    for v in np.flatnonzero(free):
        p = own[v]
        Z[3 * v:3 * v + 3, 6 * p:6 * p + 3] = E
        for k in range(3):
            Z[3 * v:3 * v + 3, 6 * p + 3 + k] = np.cross(E[k], xc[v])
    rng = np.random.default_rng(2)
    r = rng.normal(size=(nv, 3))
    dc = rng.uniform(0.5, 2.0, size=6 * P)
    y = rng.normal(size=6 * P)
    base = rng.normal(size=(nv, 3))
    freev = torch.as_tensor(free).to(torch.float64)
    cp = tsys.coarse_plan
    rc = coarse.coarse_restrict_ref(torch.as_tensor(r), freev,
                                    torch.as_tensor(dc), cp)
    assert _rel(_np(rc), (Z.T @ r.reshape(-1)) / dc) <= 1e-12
    pr = coarse.coarse_prolong_ref(torch.as_tensor(y), torch.as_tensor(dc),
                                   freev, cp, torch.as_tensor(base))
    assert _rel(_np(pr), base + (Z @ (y / dc)).reshape(-1, 3)) <= 1e-12


@pytest.mark.parametrize("n_valid", [0, 1, 2, 3, 4, 5])
def test_two_loop_plain_matches_dot_tpu(n_valid):
    """K9's plain versions in the port's _two_loop against dot_tpu's
    _two_loop, with a stub H0 (a fixed positive diagonal) and the newest
    n_valid of 5 history slots holding pairs."""
    rng = np.random.default_rng(10 + n_valid)
    nv, m = 40, 5
    S = rng.normal(size=(m, nv, 3))
    T = S * rng.uniform(0.5, 2.0, size=(m, nv, 3)) \
        + 0.1 * rng.normal(size=(m, nv, 3))
    valid = np.zeros(m)
    valid[m - n_valid:] = 1.0
    rho = np.where(valid > 0, np.einsum("kij,kij->k", S, T), 1.0)
    S[valid == 0] = 0.0
    T[valid == 0] = 0.0
    g = rng.normal(size=(nv, 3))
    w = rng.uniform(0.5, 2.0, size=(nv, 3))

    class JStub(JQN):
        def __init__(self):
            pass

        def h0_apply(self, state, q):
            return q * jnp.asarray(w)

    class TStub(TQN):
        def __init__(self):
            self.system = types.SimpleNamespace(k=ops)

        def h0_apply(self, state, q):
            return q * torch.as_tensor(w)

    jb = tuple(jnp.asarray(a) for a in (S, T, rho, valid))
    tb = tuple(torch.as_tensor(a) for a in (S, T, rho, valid))
    jp = JStub()._two_loop(None, jnp.asarray(g), jb)
    ops.reset_launches()
    tp = TStub()._two_loop(None, torch.as_tensor(g), tb)
    assert _rel(_np(tp), jp) <= 1e-12
    # CPU tensors take the plain versions: no kernel launch is counted
    assert ops.launches["lbfgs_first"] == ops.launches["lbfgs_second"] == 0


@pytest.mark.parametrize("m", [1, 3, 5])
def test_fused_two_loop_entries_match_dot_tpu(m, monkeypatch):
    """K9's two fused entries (plain versions on the CPU): lbfgs_first, a
    stub H0 (a fixed positive diagonal), lbfgs_second, against dot_tpu's
    _two_loop with a history of m slots, each count 0..m of valid (newest)
    slots and one history with an invalid slot between two valid ones."""
    monkeypatch.setattr(jqn, "LBFGS_HISTORY", m)
    rng = np.random.default_rng(20 + m)
    nv = 40
    patterns = [np.r_[np.zeros(m - v), np.ones(v)] for v in range(m + 1)]
    if m >= 3:
        patterns.append(np.r_[np.ones(m - 2), 0.0, 1.0])
    for valid in patterns:
        S = rng.normal(size=(m, nv, 3))
        T = S * rng.uniform(0.5, 2.0, size=(m, nv, 3)) \
            + 0.1 * rng.normal(size=(m, nv, 3))
        rho = np.where(valid > 0, np.einsum("kij,kij->k", S, T), 1.0)
        S[valid == 0] = 0.0
        T[valid == 0] = 0.0
        g = rng.normal(size=(nv, 3))
        w = rng.uniform(0.5, 2.0, size=(nv, 3))

        class JStub(JQN):
            def __init__(self):
                pass

            def h0_apply(self, state, q):
                return q * jnp.asarray(w)

        jb = tuple(jnp.asarray(a) for a in (S, T, rho, valid))
        jp = JStub()._two_loop(None, jnp.asarray(g), jb)
        St, Tt = (torch.as_tensor(a.reshape(m, -1)) for a in (S, T))
        rho_t, val_t = torch.as_tensor(rho), torch.as_tensor(valid)
        ops.reset_launches()
        q, k, G = ops.lbfgs_first(St, Tt, torch.as_tensor(g.reshape(-1)),
                                  rho_t, val_t)
        r = q * torch.as_tensor(w.reshape(-1))
        out = ops.lbfgs_second(Tt, St, r, k, G, rho_t, val_t)
        assert _rel(_np(out).reshape(nv, 3), jp) <= 1e-12
        np.testing.assert_allclose(
            _np(G), np.einsum("kn,jn->kj", S.reshape(m, -1),
                              T.reshape(m, -1)), rtol=1e-12, atol=1e-12)
        assert ops.launches["lbfgs_first"] == ops.launches["lbfgs_second"] \
            == 0


def test_coarse_frames_f64_match_dot_tpu():
    """Three f64 DOT frames with `coarse 1` (bar 36x4x4, 12 parts) from
    dot_tpu's initial state carried across: positions within rtol 1e-7."""
    mesh, cfg, sd, plan = _scene((36, 4, 4), 12, 1)
    jst = JDOT(JSystem(mesh, cfg, plan, dtype=jnp.float64), sd)
    tsys = convert.system_from_plan(mesh, cfg, plan)
    assert tsys.use_coarse
    tst = DOTStepper(tsys, sd)
    js = jst.init_state()
    ts = convert.state_from_numpy(jax.tree.map(np.array, js), tsys)
    assert isinstance(ts.kc_chol, CoarseFactor)
    it_j, it_t = [], []
    for _ in range(3):
        js, (jstats, _) = jst.step(js, rel_tol=1e-5)
        ts, (stats, _) = tst.step(ts, rel_tol=1e-5)
        it_j.append(int(jstats.inner_iters))
        it_t.append(stats.inner_iters)
        assert stats.stop in ("tol", "rel_dec")
    print(f"iterations dot_tpu {it_j}, port {it_t}")
    assert isinstance(ts.kc_chol, CoarseFactor)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-7,
                               atol=1e-10)


def test_carried_coarse_factor_gives_rebuilt_h0_apply():
    """convert.state_from_numpy carries dot_tpu's kc_chol, and the carried
    factor applies as the port's own rebuilt one does."""
    jsys, tsys = _systems()
    mesh, cfg, sd, plan = _scene()
    js = JDOT(jsys, sd).init_state()
    ts = convert.state_from_numpy(jax.tree.map(np.array, js), tsys)
    assert isinstance(ts.kc_chol, CoarseFactor)
    _, L, d, kc = tsys.rebuild_h0(ts.x, ts.fixed)
    rhs = torch.as_tensor(np.random.default_rng(5).normal(
        size=(tsys.n_vert, 3)))
    a = tsys.h0_apply(ts.chol, ts.equil, rhs, kc=ts.kc_chol, fixed=ts.fixed)
    b = tsys.h0_apply(L, d, rhs, kc=kc, fixed=ts.fixed)
    assert _rel(_np(a), _np(b)) <= 1e-10
    no_kc = convert.state_from_numpy(
        jax.tree.map(np.array, js._replace(kc_chol=None)), tsys)
    assert no_kc.kc_chol is None
