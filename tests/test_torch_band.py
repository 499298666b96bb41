"""The plain versions of the H0 kernels K5-K8 (dot_tpu_torch/kernels/band.py)
and their wrappers on the CPU, against dot_tpu's assembly, Cholesky and
solve in float64 (1e-12), on the banded recipe of tests/test_banded.py
(bar 8x3x3, stretch, 2 parts, band_bs_unit 48: nb 3, bs 96).

On a CPU tensor each wrapper takes its plain version and counts no launch;
the wrappers' checks raise on what the kernels do not take."""

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
from dot_tpu_torch import convert
from dot_tpu_torch.kernels import band, ops

TOL = 1e-12
_CACHE = {}


def _scene():
    if "s" not in _CACHE:
        mesh = bar_mesh(8, 3, 3)
        cfg = Config(energy="FCR", time_stepper="DOT", partition_amt=2,
                     dt=0.025, rho=1000.0, ym=1e5, pr=0.4, script="stretch",
                     handle_ratio=0.1)
        mesh.set_lame(cfg.ym, cfg.pr)
        mesh.find_border_verts(cfg.handle_ratio)
        sd = jscripts.init_script(mesh, cfg.script)
        mesh.fixed_mask = sd.fixed0.copy()
        plan = jpartition.build_plan(mesh, 2, pad_elem_to=16, pad_n3_to=48,
                                     banded=True, band_bs_unit=48,
                                     band_min_nb=3)
        jsys = JSystem(mesh, cfg, plan, dtype=jnp.float64)
        tsys = convert.system_from_plan(mesh, cfg, plan, dtype=torch.float64)
        rng = np.random.default_rng(7)
        x = sd.x0 + 0.02 * rng.normal(size=sd.x0.shape)
        fixed = sd.fixed0.copy()
        fixed[rng.choice(len(fixed), 5, replace=False)] = True
        _CACHE["s"] = (jsys, tsys, x, fixed)
    return _CACHE["s"]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@jax.jit
def _j_assemble(sys, x, fixed):
    _, U, s, V = sys.fsvd(x)
    eh = sys.element_hessians(U, s, V)
    return eh, sys.assemble_subdomains(eh, fixed)


def test_csr_offsets():
    ids = np.asarray([0, 0, 2, 2, 2, 3, 5])
    np.testing.assert_array_equal(band.csr_offsets(ids, 6),
                                  [0, 2, 2, 5, 6, 6, 7])
    with pytest.raises(ValueError):
        band.csr_offsets(np.asarray([1, 0]), 2)


def test_band_assemble_plain_matches_dot_tpu():
    jsys, tsys, x, fixed = _scene()
    jeh, (jdiag, jsub) = _j_assemble(jsys, jnp.asarray(x), jnp.asarray(fixed))
    eh = torch.as_tensor(np.array(jeh))           # (144, nEp) block-major
    freef = tsys._free(torch.as_tensor(fixed)).to(torch.float64).reshape(-1)
    ops.reset_launches()
    flat = ops.band_assemble(eh, freef, tsys.mass_flat, tsys.band_plan)
    assert ops.launches["band_assemble"] == 0
    assert torch.equal(flat, band.band_assemble_ref(eh, freef, tsys.mass_flat,
                                                    tsys.band_plan))
    P, nb, bs = tsys.n_parts, tsys.band_nb, tsys.band_bs
    d = flat[:P * nb * bs * bs].view(nb, P, bs, bs)
    s = flat[P * nb * bs * bs:].view(nb - 1, P, bs, bs)
    assert _rel(d.numpy(), jdiag) <= TOL and _rel(s.numpy(), jsub) <= TOL
    # the CSR runs K5 walks cover every tuple once, in order
    off = tsys.band_plan.seg_off.numpy()
    assert off[0] == 0 and off[-1] == tsys.band_plan.stage1.shape[0]
    assert np.all(np.diff(off) >= 1)


@pytest.mark.parametrize("symmetrize", [True, False], ids=["sym", "lower"])
def test_chol_inv_plain_matches_jax(symmetrize):
    """K6 plain on the assembled diagonal blocks (a skew part added above
    the diagonal: the lower mode must not read it, the symmetrized mode
    must average it away) against lax.linalg's Cholesky + triangular
    solve."""
    jsys, tsys, x, fixed = _scene()
    _, (jdiag, _) = _j_assemble(jsys, jnp.asarray(x), jnp.asarray(fixed))
    A = np.asarray(jdiag).reshape(-1, tsys.band_bs, tsys.band_bs)
    A = A / np.sqrt(np.einsum("bii->bi", A))[:, :, None] \
        / np.sqrt(np.einsum("bii->bi", A))[:, None, :]
    skew = np.triu(np.random.default_rng(1).normal(size=A.shape), 1) * 1e-3
    Aj = jnp.asarray(A + skew - (np.swapaxes(skew, 1, 2) if symmetrize
                                 else 0.0))
    Lj = jax.lax.linalg.cholesky(Aj, symmetrize_input=symmetrize)
    Xj = jax.lax.linalg.triangular_solve(
        Lj, jnp.broadcast_to(jnp.eye(A.shape[-1]), A.shape), left_side=True,
        lower=True)
    L, Li, bad = ops.chol_inv(torch.as_tensor(np.array(Aj)), symmetrize)
    assert not bad.any()
    assert _rel(L.numpy(), Lj) <= TOL and _rel(Li.numpy(), Xj) <= 1e-10


def test_chol_inv_flags_an_indefinite_block():
    rng = np.random.default_rng(2)
    M = rng.normal(size=(3, 40, 40))
    A = M @ np.swapaxes(M, 1, 2) + 40 * np.eye(40)
    A[1, 7, 7] = -1.0                                  # indefinite
    L, Li, bad = ops.chol_inv(torch.as_tensor(A), True)
    assert bad.tolist() == [False, True, False]
    assert torch.isnan(L[1]).all() and torch.isnan(Li[1]).all()
    assert torch.isfinite(L[0]).all() and torch.isfinite(Li[2]).all()
    eye = np.eye(40)
    assert _rel((L[0] @ Li[0]).numpy(), eye) <= 1e-12


def _spd_skewed(n, symmetrize, seed, batch=1):
    """(SPD G G^T / n + I, the same with a skew part above the diagonal
    that the lower mode must not read and the symmetrized mode averages
    away), numpy f64 (batch, n, n)."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(batch, n, n))
    A = G @ np.swapaxes(G, 1, 2) / n + np.eye(n)
    skew = np.triu(rng.normal(size=(batch, n, n)), 1) * 1e-3
    return A, A + skew - (np.swapaxes(skew, 1, 2) if symmetrize else 0.0)


@pytest.mark.parametrize("n", [37, 770, 2000])
@pytest.mark.parametrize("symmetrize", [True, False], ids=["sym", "lower"])
@pytest.mark.parametrize("prec,tile", [("f64", 32), ("f32", 32), ("f32", 64)],
                         ids=["f64-t32", "f32-t32", "f32-t64"])
def test_chol_inv_tiled_matches_reference_and_jax(prec, tile, symmetrize, n):
    """The plain mirror of K6's tile schedule (the kernel's tiles: 32 in
    f64, 32 or 64 in f32; widths that are no multiple of them, and one
    wider than the first design's shared-memory panel) against
    chol_inv_ref and against lax.linalg's Cholesky + triangular solve in
    f64 on the same inputs: L and L^{-1} within f64 1e-10, f32 1e-5."""
    dtype, tol = {"f64": (torch.float64, 1e-10),
                  "f32": (torch.float32, 1e-5)}[prec]
    A, Ask = _spd_skewed(n, symmetrize, seed=3)
    At = torch.as_tensor(Ask, dtype=dtype)
    L, Li, bad = band.chol_inv_tiled_ref(At, symmetrize, tile)
    Lr, Lir, bad_r = band.chol_inv_ref(At, symmetrize)
    Lj = jax.lax.linalg.cholesky(jnp.asarray(Ask),
                                 symmetrize_input=symmetrize)
    Xj = jax.lax.linalg.triangular_solve(
        Lj, jnp.broadcast_to(jnp.eye(n), Ask.shape), left_side=True,
        lower=True)
    assert not bad.any() and not bad_r.any()
    assert _rel(L.numpy(), Lr.numpy()) <= tol
    assert _rel(Li.numpy(), Lir.numpy()) <= tol
    assert _rel(L.numpy(), Lj) <= tol and _rel(Li.numpy(), Xj) <= tol
    assert torch.equal(L, torch.tril(L)) and torch.equal(Li, torch.tril(Li))


@pytest.mark.parametrize("symmetrize", [True, False], ids=["sym", "lower"])
@pytest.mark.parametrize("where", ["first tile", "last tile"])
def test_chol_inv_tiled_flags_an_indefinite_block(where, symmetrize):
    """A 770^2 block whose bad pivot falls in the first tile or in the
    last one comes back flagged and all NaN in L and L^{-1} from the tile
    schedule (f64 and f32), as from chol_inv_ref; its neighbours in the
    batch stay finite and factor it: the H0 rebuild's tiers key on exactly
    that."""
    n = 770
    k = 5 if where == "first tile" else 765
    _, A = _spd_skewed(n, symmetrize, seed=4, batch=3)
    A[1, k, k] = -1.0
    for dtype in (torch.float64, torch.float32):
        At = torch.as_tensor(A, dtype=dtype)
        L, Li, bad = band.chol_inv_tiled_ref(At, symmetrize,
                                             band.k6_tile(dtype, 3))
        _, _, bad_r = band.chol_inv_ref(At, symmetrize)
        assert bad.tolist() == [False, True, False] == bad_r.tolist()
        assert torch.isnan(L[1]).all() and torch.isnan(Li[1]).all()
        assert torch.isfinite(L[0::2]).all() and torch.isfinite(Li[0::2]).all()
        eye = np.eye(n)
        tol = 1e-10 if dtype == torch.float64 else 1e-5
        assert _rel((L[2].double() @ Li[2].double()).numpy(), eye) <= tol


@pytest.mark.parametrize("trans", [False, True], ids=["A", "At"])
@pytest.mark.parametrize("adtype", [torch.float64, torch.float32,
                                    torch.bfloat16],
                         ids=["f64", "f32", "bf16"])
def test_block_matvec_plain(trans, adtype):
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.normal(size=(4, 24, 24))).to(adtype)
    v = torch.as_tensor(rng.normal(size=(4, 24)))
    c = torch.as_tensor(rng.normal(size=(4, 24)))
    An = A.to(torch.float64).numpy()
    if trans:
        An = np.swapaxes(An, 1, 2)
    want = c.numpy() - np.einsum("bij,bj->bi", An, v.numpy())
    assert _rel(band.block_matvec_ref(A, v, c, trans).numpy(), want) <= TOL
    out = c.clone()
    band.block_matvec_ref(A, v, out, trans, out=out)     # in place on c
    assert _rel(out.numpy(), want) <= TOL
    assert _rel(band.block_matvec_ref(A, v, trans=trans).numpy(),
                np.einsum("bij,bj->bi", An, v.numpy())) <= TOL


def test_h0_gather_and_average_plain_match_dot_tpu():
    jsys, tsys, x, fixed = _scene()
    rng = np.random.default_rng(4)
    rhs = rng.normal(size=x.shape)
    d = np.abs(rng.normal(size=(tsys.n_parts, tsys.n3))) + 0.5
    z = rng.normal(size=(tsys.n_parts, tsys.n3))
    # dot_tpu h0_apply's two halves (core.py:1269-1277)
    rj = (jnp.asarray(rhs)[jsys.l2g] * jsys.local_valid[..., None]).reshape(
        tsys.n_parts, tsys.n3) / d
    pj = jax.ops.segment_sum(
        (jnp.asarray(z) / d).reshape(-1, 3)[jsys.gath_perm], jsys.gath_segids,
        num_segments=tsys.n_vert + 1, indices_are_sorted=True
    )[:tsys.n_vert] / jsys.dup[:, None]
    td = torch.as_tensor(d)
    r = ops.h0_gather(torch.as_tensor(rhs), tsys.l2g, tsys.local_valid, td)
    assert _rel(r.numpy(), rj) <= TOL
    p = ops.h0_average(torch.as_tensor(z), td, tsys.gath_perm,
                       tsys.gath_segids, tsys.gath_off, tsys.dup)
    assert _rel(p.numpy(), pj) <= TOL


def test_wrappers_check_their_inputs():
    _, tsys, _, _ = _scene()
    A = torch.eye(8, dtype=torch.float64).expand(2, 8, 8).contiguous()
    with pytest.raises(TypeError):
        ops.chol_inv(A.to(torch.int32), True)
    with pytest.raises(ValueError):
        ops.chol_inv(A.mT.contiguous()[:, :, :4], True)
    prog = band.solve_program("pair", [A[0]])
    with pytest.raises(ValueError, match="shape"):
        ops.block_solve(prog, [A[0]], torch.zeros(1, 7, dtype=torch.float64))
    with pytest.raises(TypeError):
        ops.h0_gather(torch.zeros((tsys.n_vert, 3), dtype=torch.float64),
                      tsys.l2g.to(torch.int32), tsys.local_valid,
                      torch.ones((tsys.n_parts, tsys.n3), dtype=torch.float64))
    with pytest.raises(RuntimeError):
        ops.chol_inv(A.to("meta"), True)
