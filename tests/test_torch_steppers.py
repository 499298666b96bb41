"""The port's non-ADMM steppers against dot_tpu on the CPU (float64):
Newton, GSDD 4, LBFGS-PD, LBFGS-H, LBFGS-HI and LBFGS-JH 4 take three time
steps from one state (dot_tpu's, carried over by convert.state_from_numpy)
and must give dot_tpu's positions at rtol 1e-7 with equal iteration and
line-search counts; each then agrees with the port's DOT run of the same
frames at the cross-solver tolerances of tests/test_lbfgs_variants.py:43-81
(sysE rtol 1e-3 and |dx| < 2e-3; HI 5e-3; JH sysE 5e-3 and 5e-3).

LBFGS-HI rounds the equilibrated matrix to bf16 and factorizes it in f32:
the two packages' f32 Cholesky factorizations (LAPACK through XLA and
through PyTorch) round differently at 1e-7, which the preconditioned
iterations carry into the positions at 2e-9 of a bar 1 long; it is held at
rtol 1e-6 with atol 1e-8, its iterStats rows at 1e-4.

Scene: bar 8x3x3, stretch, handle ratio 0.05 (tests/test_lbfgs_variants.py),
plans built with dot_tpu.partition (pad_elem_to 16, pad_n3_to 48) and handed
to both packages. Also: the GSDD sweep's one-subdomain solve on dense,
block-scan and cyclic-reduction factors (the subdomain's blocks read in
place) against the batched solve, and its scatter with padded local slots
leaving vertex 0 alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dot_tpu import partition as jpartition
from dot_tpu import scripts as jscripts
from dot_tpu import steppers as jsteppers
from dot_tpu.config import Config
from dot_tpu.mesh_gen import bar_mesh
from dot_tpu_torch import convert
from dot_tpu_torch import steppers as tsteppers
from dot_tpu_torch.kernels import band, ops
from dot_tpu_torch.steppers.core import BTDFactor, CRFactor

_CACHE = {}
SMALL = dict(pad_elem_to=16, pad_n3_to=48)
# name -> (stepper class in both packages, its plan, bf16 factor, rtol)
CASES = {
    "Newton": ("NewtonStepper", lambda m: jpartition.build_plan(m, 1, **SMALL),
               False, 1e-7),
    "GSDD4": ("GSDDStepper", lambda m: jpartition.build_plan(m, 4, **SMALL),
              False, 1e-7),
    "LBFGSPD": ("LBFGSPD", lambda m: None, False, 1e-7),
    "LBFGSH": ("LBFGSH", lambda m: jpartition.build_plan(m, 1, **SMALL),
               False, 1e-7),
    "LBFGSHI": ("LBFGSHI", lambda m: jpartition.build_plan(m, 1, **SMALL),
                True, 1e-6),
    "LBFGSJH4": ("LBFGSJH",
                 lambda m: jpartition.build_node_plan(m, 4, **SMALL),
                 False, 1e-7),
}
# against DOT after the same frames: (sysE rtol, max |dx|)
VS_DOT = {"LBFGSHI": (1e-3, 5e-3), "LBFGSJH4": (5e-3, 5e-3)}


def _scene(script="stretch", cells=(8, 3, 3)):
    mesh = bar_mesh(*cells)
    cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script=script, handle_ratio=0.05)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = jscripts.init_script(mesh, script)
    mesh.fixed_mask = sd.fixed0.copy()
    return mesh, cfg, sd


def _dot_result():
    """The port's DOT 4 run of the same three frames: (x, sysE)."""
    if "dot" not in _CACHE:
        mesh, cfg, sd = _scene()
        plan = jpartition.build_plan(mesh, 4, **SMALL)
        st = tsteppers.DOTStepper(convert.system_from_plan(mesh, cfg, plan),
                                  sd)
        s = st.init_state()
        for _ in range(3):
            s, (_, sys_e) = st.step(s)
        _CACHE["dot"] = (s.x.numpy().copy(), sys_e)
    return _CACHE["dot"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_stepper_matches_dot_tpu_from_one_state(name):
    cls, build, bf16, rtol = CASES[name]
    mesh, cfg, sd = _scene()
    plan = build(mesh)
    jsys = jsteppers.System(mesh, cfg, plan, dtype=jnp.float64,
                            factor_dtype=jnp.bfloat16 if bf16 else None)
    tsys = convert.system_from_plan(
        mesh, cfg, plan, factor_dtype=torch.bfloat16 if bf16 else None)
    jst = getattr(jsteppers, cls)(jsys, sd)
    tst = getattr(tsteppers, cls)(tsys, sd)
    js = jst.init_state()
    # copy before stepping: dot_tpu donates its state buffers
    ts = convert.state_from_numpy(jax.tree.map(np.array, js), tsys)
    if name == "LBFGSJH4":
        assert plan.dup.max() == 1 and plan.part is None
        assert not tsys.use_coarse and not tsys.banded
    if bf16:
        # the factor is f32 and came from a matrix rounded through bf16
        assert ts.chol.dtype == torch.float32
        own = tst.init_state()
        assert own.chol.dtype == torch.float32
        np.testing.assert_allclose(own.chol.numpy(), ts.chol.numpy(),
                                   rtol=0, atol=1e-5)
    for _ in range(3):
        js, (jstats, je) = jst.step(js, rel_tol=1e-5)
        ts, (tstats, te) = tst.step(ts, rel_tol=1e-5)
        assert tstats.inner_iters == int(jstats.inner_iters)
        assert tstats.ls_halvings == int(jstats.ls_halvings)
        assert tstats.stop in ("tol", "rel_dec")
        assert len(tstats.rows) == tstats.inner_iters + 1
        jrows = np.asarray(jstats.rows)[:tstats.inner_iters + 1]
        # iterStats rows (alpha, E, ||g||^2); the converged ||g||^2 is the
        # most sensitive entry (HI: 4e-6 apart at 3e-6)
        np.testing.assert_allclose(np.asarray(tstats.rows), jrows,
                                   rtol=1e-4 if bf16 else 1e-6, atol=1e-12)
        np.testing.assert_allclose(te, float(je), rtol=100 * rtol)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=rtol,
                               atol=1e-8 if bf16 else 1e-10)
    # cross-solver: the same minimization as DOT's
    x_dot, e_dot = _dot_result()
    e_tol, x_tol = VS_DOT.get(name, (1e-3, 2e-3))
    np.testing.assert_allclose(te, e_dot, rtol=e_tol)
    assert float(np.abs(ts.x.numpy() - x_dot).max()) < x_tol


def test_newton_needs_one_part():
    mesh, cfg, sd = _scene()
    plan = jpartition.build_plan(mesh, 2, **SMALL)
    with pytest.raises(ValueError, match="P = 1"):
        tsteppers.NewtonStepper(convert.system_from_plan(mesh, cfg, plan), sd)


def _factored(kind):
    """(System, L, d) on a plan of the wanted factor kind: dense (4 parts),
    scan (2 parts, nb >= 3) or cr (bar 40x3x3, 2 parts, nb >= 9)."""
    if kind in _CACHE:
        return _CACHE[kind]
    mesh, cfg, sd = _scene(cells=(40, 3, 3) if kind == "cr" else (8, 3, 3))
    if kind == "dense":
        plan = jpartition.build_plan(mesh, 4, **SMALL)
    else:
        plan = jpartition.build_plan(mesh, 2, band_bs_unit=48, band_min_nb=3,
                                     **SMALL)
    tsys = convert.system_from_plan(mesh, cfg, plan, use_coarse=False)
    x = torch.as_tensor(sd.x0 + 0.01 * np.random.default_rng(0).normal(
        size=sd.x0.shape))
    _, L, d, kc = tsys.rebuild_h0(x, torch.as_tensor(sd.fixed0))
    want = {"dense": torch.Tensor, "scan": BTDFactor, "cr": CRFactor}[kind]
    assert isinstance(L, want) and kc is None
    _CACHE[kind] = (tsys, L, d)
    return _CACHE[kind]


@pytest.mark.parametrize("kind", ["dense", "scan", "cr"])
def test_subdomain_solve_is_one_row_of_the_batched_solve(kind, monkeypatch):
    """K16 gather -> the solve on subdomain i's slice of the factor -> K16
    scatter equals row i of the batched solve, scattered; the slice's
    blocks reach K7's solve entry as strided views of the leaves (no
    copy), its program stepping over the other subdomains' blocks."""
    tsys, L, d = _factored(kind)
    q = torch.as_tensor(np.random.default_rng(1).normal(
        size=(tsys.n_vert, 3)))
    r = tsys.k.h0_gather(q, tsys.l2g, tsys.local_valid, d)
    z = tsys.solve_local(L, r) / d                       # (P, n3)
    seen = []
    real = ops.block_solve

    def spy(prog, leaves, *a):
        seen.append((prog, leaves))
        return real(prog, leaves, *a)
    monkeypatch.setattr(ops, "block_solve", spy)
    leaves = {t.data_ptr(): t for t in
              ([] if kind == "dense" else
               (list(L) if kind == "scan" else
                [t for lv in L.levels for t in lv] + list(L.root)))}
    for i in range(tsys.n_parts):
        p = tsys.subdomain_solve(L, d, q, i)
        valid = tsys.local_valid[i]
        want = torch.zeros((tsys.n_vert, 3), dtype=torch.float64)
        want[tsys.l2g[i][valid]] = z[i].reshape(-1, 3)[valid]
        np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-14)
    if kind != "dense":
        assert len(seen) == tsys.n_parts
        bs = tsys.band_bs
        lo = min(leaves)
        hi = max(p_ + t.numel() * t.element_size()
                 for p_, t in leaves.items())
        st = np.concatenate([prog.stages for prog, _ in seen])
        # every block read lies inside a factor leaf, and batches of
        # several blocks step over the other subdomain's blocks
        assert all(lo <= t.data_ptr() < hi and t.shape[1] == 1
                   for _, lv in seen for t in lv)
        several = st[(st[:, band.F_NJ] > 1) & (st[:, band.F_OP]
                                               != band.OP_COPY)]
        assert (several[:, band.F_A_SJ] == tsys.n_parts * bs * bs).all()
        if kind == "cr":
            assert len(several)


def test_local_scatter_one_leaves_vertex_0_to_its_owner():
    """Padded local slots carry l2g == 0: the scatter must not write them
    to vertex 0, and the gather must mask them."""
    l2g = torch.tensor([[3, 5, 0, 0], [0, 2, 4, 0]])
    valid = torch.tensor([[True, True, False, False],
                          [True, True, True, False]])
    d = torch.full((2, 12), 2.0, dtype=torch.float64)
    z = torch.arange(1.0, 13.0, dtype=torch.float64)
    p = ops.local_scatter_one(z, d, l2g, valid, 0, 6)
    assert p.shape == (6, 3)
    want = torch.zeros((6, 3), dtype=torch.float64)
    want[3] = z[0:3] / 2
    want[5] = z[3:6] / 2
    assert torch.equal(p, want) and float(p[0].abs().max()) == 0.0
    p = ops.local_scatter_one(z, d, l2g, valid, 1, 6)
    assert torch.equal(p[0], z[0:3] / 2)          # its owner writes it
    assert torch.equal(p[4], z[6:9] / 2) and float(p[1].abs().max()) == 0.0
    q = torch.arange(18.0, dtype=torch.float64).reshape(6, 3) + 1.0
    r = ops.local_gather_one(q, l2g, valid, d, 0)
    assert torch.equal(r, torch.cat([q[3], q[5], torch.zeros(6)]) / 2)
    with pytest.raises(ValueError, match="subdomain"):
        ops.local_gather_one(q, l2g, valid, d, 2)


def test_schur_update_refuses_blocks_it_would_have_to_copy():
    D = torch.zeros((3, 2, 4, 4), dtype=torch.float32)
    A = torch.zeros((3, 4, 4), dtype=torch.bfloat16)
    assert ops.schur_update(D[:, 1], A).shape == (3, 4, 4)    # strided: fine
    with pytest.raises(ValueError, match="row-major"):
        ops.schur_update(D[:, 1].mT, A)
