"""K7's solve entry (ops.block_solve: one launch a solve on the card) on
the CPU: the solve program's stage table (kernels/band.py solve_program)
walked by its CPU mirror band.run_solve_program_ref against the plain
product sequences (band.btd_solve_ref, cr_solve_ref and pair_solve_ref:
the products a launch sequence made one by one before the solve was one
launch), and System.h0_apply on it against dot_tpu's.

Factors (plans built with dot_tpu.partition, the recipe of
tests/test_torch_cr.py: band_bs_unit 48, bs 96), rebuilt by the port at a
deformed state in f64 and in f32 (bf16 leaves):
- "cr"     bar 40x3x3, 2 parts: nb 11, cyclic reduction 11 -> 6 -> 3;
- "cr1"    bar 20x3x3, 1 part: the same on a P = 1 band;
- "btd"    bar 16x3x3, 2 parts: nb 5, the block scan;
- "btd1"   bar 12x3x3, 1 part: nb 7, the scan at P = 1;
- "coarse" bar 20x4x4 twist, 4 parts, `coarse 1`: the scan and the coarse
           pair on Lc^{-1} (24^2).
Each factor's program is checked whole and, at P > 1, on subdomain 1's
slice of the leaves (the GSDD sweep's views, read in place).

Tolerances: the mirror equals the sequences bit for bit (the same
block_matvec_ref calls on the same values); the stages are the
sequence's products one for one, with a grid barrier before every stage
but the first and the copy that shares its phase, and only the inverse
factors' stages (exact zeros above their diagonals) read a lower
triangle alone, which band.solve_cost (the bound's bytes and operations)
counts as n (n + 1) / 2 entries a block; h0_apply in f64 1e-10
against dot_tpu (as tests/test_torch_cr.py and test_torch_coarse.py)."""

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
from dot_tpu_torch.steppers.core import BTDFactor, CRFactor, factor_leaves

# name -> (cells, parts, script, coarse)
SCENES = {"cr": ((40, 3, 3), 2, "stretch", -1),
          "cr1": ((20, 3, 3), 1, "stretch", -1),
          "btd": ((16, 3, 3), 2, "stretch", -1),
          "btd1": ((12, 3, 3), 1, "stretch", -1),
          "coarse": ((20, 4, 4), 4, "twist", 1)}
_CACHE = {}


def _scene(name):
    if name not in _CACHE:
        cells, parts, script, cw = SCENES[name]
        mesh = bar_mesh(*cells)
        cfg = Config(energy="FCR", time_stepper="DOT", partition_amt=parts,
                     dt=0.025, rho=1000.0, ym=1e5, pr=0.4, script=script,
                     handle_ratio=0.1, coarse=cw)
        mesh.set_lame(cfg.ym, cfg.pr)
        mesh.find_border_verts(cfg.handle_ratio)
        sd = jscripts.init_script(mesh, script)
        mesh.fixed_mask = sd.fixed0.copy()
        plan = jpartition.build_plan(mesh, parts, pad_elem_to=16,
                                     pad_n3_to=48, band_bs_unit=48,
                                     band_min_nb=3)
        x = sd.x0 + 0.01 * np.random.default_rng(0).normal(size=sd.x0.shape)
        _CACHE[name] = (mesh, cfg, sd, plan, x)
    return _CACHE[name]


def _port(name, dtype):
    """(System, L, d, kc) of the port rebuilt at the scene's state."""
    key = (name, dtype)
    if key not in _CACHE:
        mesh, cfg, sd, plan, x = _scene(name)
        tsys = convert.system_from_plan(mesh, cfg, plan, dtype=dtype)
        _, L, d, kc = tsys.rebuild_h0(torch.as_tensor(x, dtype=dtype),
                                      torch.as_tensor(sd.fixed0))
        _CACHE[key] = (tsys, L, d, kc)
    return _CACHE[key]


def _programs(name, dtype):
    """(kind, leaves, r's shape) of every solve the scene's factor serves:
    the whole factor, subdomain 1's slice at P > 1, the coarse pair."""
    tsys, L, _, kc = _port(name, dtype)
    kind = "cr" if isinstance(L, CRFactor) else "btd"
    assert kind == name.rstrip("1") or name == "coarse"
    leaves = factor_leaves(L)
    out = [(kind, leaves, (tsys.n_parts, tsys.n3))]
    if tsys.n_parts > 1:
        out.append((kind, [t[:, 1:2] for t in leaves], (1, tsys.n3)))
    if kc is not None:
        out.append(("pair", [kc.linv], (1, kc.linv.shape[0])))
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32-bf16"])
@pytest.mark.parametrize("name", list(SCENES))
def test_program_is_the_launch_sequence(name, dtype):
    """The mirror walking the stage table equals the launch sequence bit
    for bit, and so does ops.block_solve (its plain version on the CPU);
    the stages are the sequence's products one for one."""
    rng = np.random.default_rng(7)
    tsys, L, _, _ = _port(name, dtype)
    want_leaf = torch.bfloat16 if dtype == torch.float32 else dtype
    assert all(t.dtype == want_leaf for t in factor_leaves(L))
    for kind, leaves, shape in _programs(name, dtype):
        r = torch.as_tensor(rng.normal(size=shape), dtype=dtype)
        calls = []
        # the inverse factors: linv (leaf 0), and each level's Li and the
        # root's linv of a cyclic-reduction factor
        inv = [leaves[i] for i in range(0, len(leaves) - 1, 3)] \
            if kind == "cr" else leaves[:1]
        starts = {t.data_ptr() + (j * t.stride(0) + p * t.stride(1))
                  * t.element_size() for t in inv
                  for j in range(t.shape[0]) for p in range(t.shape[1])}

        def mv(A, *a, **k):
            # the entries the product needs: an inverse factor's lower
            # triangle, another block whole
            n = A.shape[-1]
            lower = A.data_ptr() in starts
            calls.append(A.shape[0] * (n * (n + 1) // 2 if lower else n * n))
            return band.block_matvec_ref(A, *a, **k)
        prog = band.solve_program(kind, leaves)
        want = band.block_solve_ref(prog, leaves, r, mv)
        assert prog.table is None and (prog.P, prog.nb * prog.n) == shape
        got = band.run_solve_program_ref(prog, leaves, r)
        assert torch.isfinite(want).all()
        assert torch.equal(got, want), kind
        assert torch.equal(ops.block_solve(prog, leaves, r), want)
        st = prog.stages
        # the stages that read a lower triangle only: exactly the inverse
        # factors', whose entries above the diagonal are exact zeros
        lower = sorted({int(i) for i in st[st[:, band.F_LOWER] == 1,
                                           band.F_A]})
        n_lev = (len(leaves) - 2) // 3
        assert lower == ([0] if kind != "cr" else
                         [3 * i for i in range(n_lev + 1)])
        assert all(torch.equal(leaves[i], torch.tril(leaves[i]))
                   for i in lower)
        copy = st[:, band.F_OP] == band.OP_COPY
        assert int((~copy).sum()) == len(calls), kind
        # the least bytes and operations of a solve (chip_smoke.py's bound)
        nbytes, flops = band.solve_cost(prog, leaves, r)
        assert flops == 2 * sum(calls)
        tri = prog.n * (prog.n - 1) // 2 * leaves[0].element_size()
        assert nbytes == 2 * r.numel() * r.element_size() + sum(
            t.numel() * t.element_size() for t in leaves) - tri * sum(
            leaves[i].numel() // prog.n ** 2 for i in lower)
        assert int(st[:, band.F_SYNC].sum()) == len(st) - 1 - int(copy.sum())
        assert st[0, band.F_SYNC] == 0 and not st[copy, band.F_SYNC].any()
        if leaves[0].shape[1] == 1 and shape[0] == 1 and kind != "pair" \
                and tsys.n_parts > 1:
            # the slice's blocks: strided views, the batch stepping over
            # the other subdomains' blocks
            several = st[(st[:, band.F_NJ] > 1) & ~copy]
            n = prog.n
            assert (several[:, band.F_A_SJ] == tsys.n_parts * n * n).all()


def test_block_solve_refuses_other_leaves():
    tsys, L, _, _ = _port("btd", torch.float64)
    leaves = factor_leaves(L)
    prog = band.solve_program("btd", leaves)
    r = torch.zeros((tsys.n_parts, tsys.n3), dtype=torch.float64)
    with pytest.raises(ValueError, match="leaves"):
        ops.block_solve(prog, [t.clone() for t in leaves], r)
    with pytest.raises(ValueError, match="shape"):
        ops.block_solve(prog, leaves, r[:, :-1].contiguous())


@pytest.mark.parametrize("name", ["cr", "btd", "coarse"])
def test_h0_apply_matches_dot_tpu(name):
    """System.h0_apply, its solves on K7's solve entry (the cyclic
    reduction, the block scan, the coarse pair), against dot_tpu's
    _cr_solve / _btd_solve / _coarse_apply in f64."""
    mesh, cfg, sd, plan, x = _scene(name)
    tsys, tL, td, tkc = _port(name, torch.float64)
    jsys = JSystem(mesh, cfg, plan, dtype=jnp.float64)
    _, jL, jd, jkc = jsys.rebuild_h0(jnp.asarray(x), jnp.asarray(sd.fixed0))
    assert isinstance(tL, CRFactor if name == "cr" else BTDFactor)
    assert (tkc is not None) == (name == "coarse")
    rhs = np.random.default_rng(4).normal(size=(tsys.n_vert, 3))
    fixed = sd.fixed0
    jp = jax.jit(lambda s, L, d, q, kc, f: s.h0_apply(L, d, q, kc=kc,
                                                      fixed=f))(
        jsys, jL, jd, jnp.asarray(rhs), jkc, jnp.asarray(fixed))
    tp = tsys.h0_apply(tL, td, torch.as_tensor(rhs), kc=tkc,
                       fixed=torch.as_tensor(fixed))
    jp = np.asarray(jp, np.float64)
    rel = float(np.abs(tp.numpy() - jp).max() / np.abs(jp).max())
    assert rel <= 1e-10


def test_three_column_program_matches_dot_tpu():
    """The "pd" kind with an identity permutation and d = 1 is the
    3-column block scan: on the P = 1 scan factor of "btd1" its CPU mirror
    matches dot_tpu's _btd_solve with 3 right-hand sides (f64, 1e-10, as
    h0_apply), and its product stages are the one-column program's with
    every vector offset and stride 3x (blocks (n, 3) row-major)."""
    mesh, cfg, sd, plan, x = _scene("btd1")
    tsys, tL, _, _ = _port("btd1", torch.float64)
    jsys = JSystem(mesh, cfg, plan, dtype=jnp.float64)
    _, jL, _, _ = jsys.rebuild_h0(jnp.asarray(x), jnp.asarray(sd.fixed0))
    assert isinstance(tL, BTDFactor) and tL.linv.shape[1] == 1
    nv_p = tL.linv.shape[0] * tL.linv.shape[-1]
    r = np.random.default_rng(11).normal(size=(1, nv_p, 3))
    jz = np.asarray(jax.jit(lambda s, L, q: s._btd_solve(L, q))(
        jsys, jL, jnp.asarray(r)))[0]
    ident = torch.arange(nv_p)
    leaves = [tL.linv, tL.sub, ident, ident,
              torch.ones(nv_p, dtype=torch.float64)]
    prog = band.solve_program("pd", leaves)
    got = band.run_solve_program_ref(prog, leaves, torch.as_tensor(r[0]))
    rel = float(np.abs(got.numpy() - jz).max() / np.abs(jz).max())
    assert rel <= 1e-10
    one = band.solve_program("btd", list(tL))
    prod = prog.stages[np.isin(prog.stages[:, band.F_OP],
                               (band.OP_A, band.OP_AT))]
    assert prod.shape == one.stages.shape
    vec = [band.F_V_OFF, band.F_V_SJ, band.F_V_SP, band.F_C_OFF,
           band.F_C_SJ, band.F_C_SP, band.F_O_OFF, band.F_O_SJ, band.F_O_SP]
    same = [f for f in range(band.N_FIELDS) if f not in vec
            and f not in (band.F_V, band.F_C, band.F_O, band.F_SYNC)]
    np.testing.assert_array_equal(prod[:, same], one.stages[:, same])
    # the one-column program reads r and writes z; the pd program keeps
    # its blocks in the workspace, so only the workspace's places scale
    ws = one.stages[:, [band.F_V, band.F_C, band.F_O]] == band.BUF_WS
    for i, f in enumerate((band.F_V, band.F_C, band.F_O)):
        for g in (f + 2, f + 3):
            m = ws[:, i]
            np.testing.assert_array_equal(prod[m, g], 3 * one.stages[m, g])
