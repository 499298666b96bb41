"""The LBFGS-PD matrix, factor and solve of the port against dot_tpu on the
CPU (float64): the 16 pair values per element and the assembled band
(K14's plain version) against dot_tpu's at 1e-12, the factor's d and
pd_solve (K15's plain versions) at 1e-10, on the banded branch (a PD band
plan with bs_unit 16, handed to both packages: nb >= 3) and on the dense
branch (the default plan of this small mesh has fewer than 3 blocks), with
the initial and a changed Dirichlet set; and the 3-column block-tridiagonal
solve against three 1-column solves.

Scene: bar 8x3x3, twist, System without a plan (elements padded to 256)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dot_tpu import partition as jpartition
from dot_tpu import scripts as jscripts
from dot_tpu.config import Config
from dot_tpu.mesh_gen import bar_mesh
from dot_tpu.steppers import System as JSystem
from dot_tpu.steppers.core import BTDFactor as JBTD
from dot_tpu_torch import convert
from dot_tpu_torch.kernels import band, ops, pd
from dot_tpu_torch.steppers.core import BTDFactor

_CACHE = {}


def _scene(kind):
    """(dot_tpu System, port System, script data) without a plan; `banded`
    gives both the same 16-wide PD band plan."""
    if kind not in _CACHE:
        mesh = bar_mesh(8, 3, 3)
        cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                     script="twist", handle_ratio=0.05)
        mesh.set_lame(cfg.ym, cfg.pr)
        mesh.find_border_verts(cfg.handle_ratio)
        sd = jscripts.init_script(mesh, cfg.script)
        mesh.fixed_mask = sd.fixed0.copy()
        jsys = JSystem(mesh, cfg, None, dtype=jnp.float64)
        tsys = convert.system_from_plan(mesh, cfg, None)
        assert tsys.n_parts == 0 and tsys.n3 == 0
        assert tsys.n_elem_p == jsys.n_elem_p == 512
        if kind == "banded":
            bp = jpartition.build_pd_band_plan(jsys._conn_scatter_np,
                                               mesh.n_vert, bs_unit=16)
            assert bp is not None and bp.nb >= 3
            jsys._pd_band_plan = bp
            tsys._pd_plan = pd.pd_plan(bp, "cpu")
        else:
            assert tsys.pd_band_plan is None and jsys.pd_band_plan is None
        _CACHE[kind] = (jsys, tsys, sd)
    return _CACHE[kind]


def _fixed(sd, changed):
    fixed = sd.fixed0.copy()
    if changed:            # release a few handles, pin a few free vertices
        on = np.flatnonzero(fixed)
        off = np.flatnonzero(~fixed)
        fixed[on[::3]] = False
        fixed[off[::7]] = True
    return fixed


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(params=["banded", "dense"])
def kind(request):
    return request.param


@pytest.mark.parametrize("changed", [False, True], ids=["fixed0", "changed"])
def test_pair_values_match_dot_tpu(changed):
    jsys, tsys, sd = _scene("banded")
    fixed = _fixed(sd, changed)
    free = (~fixed).astype(np.float64)
    jv = np.asarray(jax.jit(lambda s, f: s._pd_pair_vals(None, f))(
        jsys, jnp.asarray(free)))
    tv = pd.pd_pair_vals_ref(tsys.g9, tsys.conn, tsys._pd_weights(),
                             _t(free)).numpy()
    assert tv.shape == (16, tsys.n_elem_p)
    np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=1e-12 * np.abs(jv).max())


def _j_band(sys, fixed):
    """dot_tpu's _build_pd_factor inputs: the flat band before the
    factorization (core.py:1674-1681)."""
    free = jnp.logical_not(fixed).astype(sys.dtype)
    bp = sys.pd_band_plan
    vals = sys._pd_pair_vals(None, free)
    flat = jnp.zeros((bp.total,), sys.dtype).at[sys.pd_dest].add(
        vals, mode="drop")
    flat = flat.at[sys.pd_diag_dest].add(sys.mass * free + (1.0 - free))
    return flat.at[sys.pd_pad_dest].set(1.0)


@pytest.mark.parametrize("changed", [False, True], ids=["fixed0", "changed"])
def test_assembled_band_matches_dot_tpu(changed):
    jsys, tsys, sd = _scene("banded")
    fixed = _fixed(sd, changed)
    _ = jsys.pd_band_plan
    jflat = np.asarray(jax.jit(_j_band)(jsys, jnp.asarray(fixed)))
    free = _t((~fixed).astype(np.float64))
    tflat = tsys.k.pd_assemble(tsys.g9, tsys.conn, tsys._pd_weights(), free,
                               tsys.mass, tsys.pd_band_plan).numpy()
    np.testing.assert_allclose(tflat, jflat, rtol=1e-12,
                               atol=1e-12 * np.abs(jflat).max())
    # the plan's sorted runs hold every kept item exactly once
    bp = tsys.pd_band_plan
    kept = int((bp.dest < bp.total).sum())
    assert bp.items.shape[0] == kept == int(bp.seg_off[-1])
    assert torch.equal(bp.dest[bp.items], torch.repeat_interleave(
        bp.udest, bp.seg_off[1:] - bp.seg_off[:-1]))


@pytest.mark.parametrize("changed", [False, True], ids=["fixed0", "changed"])
def test_pd_factor_and_solve_match_dot_tpu(kind, changed):
    jsys, tsys, sd = _scene(kind)
    fixed = _fixed(sd, changed)
    jL, jd = jsys.build_pd_factor(jnp.asarray(fixed))
    tL, td = tsys.build_pd_factor(_t(fixed))
    assert isinstance(tL, BTDFactor) == isinstance(jL, JBTD) \
        == (kind == "banded")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-10)
    if kind == "banded":
        assert tL.linv.shape[1] == 1 and tL.linv.dtype == torch.float64
        for a, b in zip(tL, jL):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-10,
                                       atol=1e-10 * np.abs(b).max())
    rhs = np.random.default_rng(3).normal(size=(tsys.n_vert, 3))
    jz = np.asarray(jax.jit(lambda s, L, d, r: s.pd_solve(L, d, r))(
        jsys, jL, jd, jnp.asarray(rhs)))
    tz = tsys.pd_solve(tL, td, _t(rhs)).numpy()
    np.testing.assert_allclose(tz, jz, rtol=1e-10,
                               atol=1e-10 * np.abs(jz).max())
    # the port's own state converter carries the factor across
    tz2 = tsys.pd_solve(convert.factor_from_numpy(
        jax.tree.map(np.array, jL)), _t(jd), _t(rhs)).numpy()
    np.testing.assert_allclose(tz2, jz, rtol=1e-10,
                               atol=1e-10 * np.abs(jz).max())


def test_pd_solve_inverts_the_matrix():
    """pd_solve against a dense solve of the assembled matrix M + dt^2 D^T
    W D (built from the pair values, unit rows at fixed vertices)."""
    _, tsys, sd = _scene("banded")
    fixed = _t(sd.fixed0)
    free = torch.logical_not(fixed).to(torch.float64)
    nv = tsys.n_vert
    vals = pd.pd_pair_vals_ref(tsys.g9, tsys.conn, tsys._pd_weights(), free)
    B = torch.zeros((nv + 1) * (nv + 1), dtype=torch.float64)
    cs = tsys.conn_s.long()
    for a in range(4):
        for b in range(4):
            B.index_add_(0, cs[a] * (nv + 1) + cs[b], vals[a * 4 + b])
    B = B.view(nv + 1, nv + 1)[:nv, :nv].clone()
    B.diagonal().add_(tsys.mass * free + (1.0 - free))
    rhs = _t(np.random.default_rng(4).normal(size=(nv, 3)))
    L, d = tsys.build_pd_factor(fixed)
    want = torch.linalg.solve(B, rhs)
    np.testing.assert_allclose(tsys.pd_solve(L, d, rhs).numpy(),
                               want.numpy(), rtol=1e-9,
                               atol=1e-9 * float(want.abs().max()))


def test_three_column_solve_equals_three_one_column_solves():
    _, tsys, sd = _scene("banded")
    L, _ = tsys.build_pd_factor(_t(sd.fixed0))
    n = L.linv.shape[0] * L.linv.shape[2]
    r = _t(np.random.default_rng(5).normal(size=(1, n, 3)))
    z3 = tsys._btd_solve(L, r)
    assert z3.shape == (1, n, 3)
    for j in range(3):
        zj = tsys._btd_solve(L, r[..., j].contiguous())
        np.testing.assert_allclose(z3[..., j].numpy(), zj.numpy(),
                                   rtol=1e-12, atol=1e-14)


def _pd_factor(dtype):
    """(port System in `dtype` on the banded scene's 16-wide plan, its PD
    factor L, d) at a changed Dirichlet set."""
    jsys, tsys, sd = _scene("banded")
    if dtype != torch.float64:
        mesh, cfg = tsys.mesh, tsys.cfg
        tsys = convert.system_from_plan(mesh, cfg, None, dtype=dtype)
        tsys._pd_plan = pd.pd_plan(jsys.pd_band_plan, "cpu")
    L, d = tsys.build_pd_factor(_t(_fixed(sd, True)))
    assert isinstance(L, BTDFactor) and L.linv.dtype == dtype
    return tsys, L, d


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_pd_program_is_the_k15_sequence(dtype):
    """K7's solve entry with the "pd" kind (pd_solve in one launch on the
    card): its CPU mirror walking the stage table equals pd_gather ->
    btd_solve_ref with block_matvec_k_ref (the 4 nb - 2 K15 products) ->
    pd_scatter bit for bit, and so do ops.block_solve (the plain version on
    the CPU) and System.pd_solve; the stages are the gather, the products
    one for one on (n, 3) blocks, the scatter."""
    tsys, L, d = _pd_factor(dtype)
    bp = tsys.pd_band_plan
    rhs = torch.as_tensor(np.random.default_rng(6).normal(
        size=(tsys.n_vert, 3)), dtype=dtype)
    leaves = [L.linv, L.sub, bp.inv, bp.perm, d[0]]
    prog = band.solve_program("pd", leaves)
    calls = []

    def mv(A, *a, **k):
        calls.append(A.shape)
        return pd.block_matvec_k_ref(A, *a, **k)
    rp = pd.pd_gather_ref(rhs, bp.inv, d[0])
    z = band.btd_solve_ref(L.linv, L.sub, rp[None], mv)[0]
    want = pd.pd_scatter_ref(z, bp.perm, d[0])
    nb, n = bp.nb, bp.bs
    assert len(calls) == 4 * nb - 2 and torch.isfinite(want).all()
    assert (prog.kind, prog.k, prog.shape, prog.P, prog.nb, prog.n) == (
        "pd", 3, (tsys.n_vert, 3), 1, nb, n)
    assert torch.equal(band.run_solve_program_ref(prog, leaves, rhs), want)
    assert torch.equal(band.block_solve_ref(prog, leaves, rhs), want)
    assert torch.equal(ops.block_solve(prog, leaves, rhs), want)
    tsys._solve_progs.clear()
    assert torch.equal(tsys.pd_solve(L, d, rhs), want)
    assert [k[0] for k in tsys._solve_progs] == ["pd"]
    st = prog.stages
    op = st[:, band.F_OP]
    assert op[0] == band.OP_GATHER and op[-1] == band.OP_SCATTER
    assert int(np.isin(op, (band.OP_A, band.OP_AT)).sum()) == 4 * nb - 2
    assert st[0, band.F_SYNC] == 0 and st[1:, band.F_SYNC].all()
    # the inverse factor's stages read its lower triangle only
    assert sorted(set(st[st[:, band.F_LOWER] == 1, band.F_A])) == [0]
    assert torch.equal(L.linv, torch.tril(L.linv))
    # items: a row a warp on op = A (8 rows an item), 32 columns on A^T
    assert prog.max_items == -(-n // band.rows_per_item(3))
    nbytes, flops = band.solve_cost(prog, leaves, rhs)
    tri = n * (n + 1) // 2
    assert flops == 2 * 3 * ((2 * nb) * tri + (2 * nb - 2) * n * n) \
        + 3 * (bp.nv_p + tsys.n_vert)
    sz = L.linv.element_size()
    assert nbytes == 2 * rhs.numel() * rhs.element_size() + sz * (
        nb * tri + (nb - 1) * n * n) + 8 * (bp.nv_p + tsys.n_vert) \
        + bp.nv_p * d.element_size()


def test_pd_program_refuses_other_tables():
    """The "pd" kind takes a P = 1 factor and the plan's int64 tables; a
    call with other leaves or another right-hand side shape raises."""
    tsys, L, d = _pd_factor(torch.float64)
    bp = tsys.pd_band_plan
    leaves = [L.linv, L.sub, bp.inv, bp.perm, d[0]]
    with pytest.raises(ValueError, match="inv"):
        band.solve_program("pd", [L.linv, L.sub, bp.inv[:-1], bp.perm, d[0]])
    with pytest.raises(ValueError, match="perm"):
        band.solve_program("pd", [L.linv, L.sub, bp.inv,
                                  bp.perm.to(torch.int32), d[0]])
    with pytest.raises(ValueError, match="P = 1"):
        band.solve_program("pd", [L.linv.expand(-1, 2, -1, -1), L.sub,
                                  bp.inv, bp.perm, d[0]])
    prog = band.solve_program("pd", leaves)
    rhs = torch.zeros((tsys.n_vert, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="leaves"):
        ops.block_solve(prog, [L.linv, L.sub, bp.inv, bp.perm.clone(), d[0]],
                        rhs)
    with pytest.raises(ValueError, match="shape"):
        ops.block_solve(prog, leaves, rhs[:-1].contiguous())
