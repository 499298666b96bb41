"""The port's System (dot_tpu_torch.steppers.core) against
dot_tpu.steppers.System on the same numpy plan, in float64 on the CPU:
energy, gradient, element Hessians, dense and banded assembly, the H0
factor + apply, the quadratic form and the small helpers (rtol 1e-9).

Plans: the golden recipe (bar 8x3x3, twist, 4 parts, dense H0) and the
banded recipe of tests/test_banded.py (2 parts, band_bs_unit 48). Both are
built once with dot_tpu.partition and handed to both packages."""

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
from dot_tpu_torch import scripts as tscripts
from dot_tpu_torch.steppers.core import BTDFactor

RTOL = 1e-9
_CACHE = {}


def _scene(kind):
    """(mesh, cfg, script data, plan, dot_tpu System, port System)."""
    if kind in _CACHE:
        return _CACHE[kind]
    mesh = bar_mesh(8, 3, 3)
    if kind == "dense":
        cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                     script="twist", handle_ratio=0.05)
    else:
        cfg = Config(energy="FCR", time_stepper="DOT", partition_amt=2,
                     dt=0.025, rho=1000.0, ym=1e5, pr=0.4, script="stretch",
                     handle_ratio=0.1)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = jscripts.init_script(mesh, cfg.script)
    mesh.fixed_mask = sd.fixed0.copy()
    if kind == "dense":
        plan = jpartition.build_plan(mesh, 4, pad_elem_to=16, pad_n3_to=48)
    else:
        plan = jpartition.build_plan(mesh, 2, pad_elem_to=16, pad_n3_to=48,
                                     banded=True, band_bs_unit=48,
                                     band_min_nb=3)
    jsys = JSystem(mesh, cfg, plan, dtype=jnp.float64)
    tsys = convert.system_from_plan(mesh, cfg, plan, dtype=torch.float64)
    assert tsys.banded == (kind == "banded") == jsys.banded
    _CACHE[kind] = (mesh, cfg, sd, plan, jsys, tsys)
    return _CACHE[kind]


def _state(kind, seed=0):
    """Deformed positions x, predictor xt, fixed mask, direction p."""
    mesh, _, sd, _, _, _ = _scene(kind)
    rng = np.random.default_rng(seed)
    x = sd.x0 + 0.02 * rng.normal(size=sd.x0.shape)
    xt = sd.x0 + 0.01 * rng.normal(size=sd.x0.shape)
    p = rng.normal(size=sd.x0.shape)
    return x, xt, sd.fixed0.copy(), p


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(a, b, rtol=RTOL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


@jax.jit
def _j_fields(sys, x, xt, fixed, p):
    F, U, s, V = sys.fsvd(x)
    e = sys.energy(x, xt, s)
    g = sys.gradient(x, xt, fixed, F, U, s, V)
    eh = sys.element_hessians(U, s, V)
    H = sys.assemble_subdomains(eh, fixed)
    return (e, g, eh, H, sys.quadratic_form(eh, p), sys.inertia_quad(x, p, xt),
            sys.system_energy(x, xt, s), jnp.stack(sys.defgrad(p)))


@pytest.fixture(params=["dense", "banded"])
def kind(request):
    return request.param


def test_energy_gradient_hessian_match(kind):
    _, _, _, _, jsys, tsys = _scene(kind)
    x, xt, fixed, p = _state(kind)
    je, jg, jeh, _, jq, jiq, jse, jFp = _j_fields(
        jsys, jnp.asarray(x), jnp.asarray(xt), jnp.asarray(fixed),
        jnp.asarray(p))
    tx, txt, tfix, tp = _t(x), _t(xt), _t(fixed), _t(p)
    F = tsys.defgrad(tx)
    _close(tsys.energy(tx, txt, F), je)
    _close(tsys.gradient(tx, txt, tfix), jg)
    eh = tsys.element_hessians(tx)
    _close(eh, jeh)
    q, Fp = tsys.quadratic_form(eh, tp)
    _close(q, jq)
    _close(Fp, jFp)
    for a, b in zip(tsys.inertia_quad(tx, tp, txt), jiq):
        _close(a, b)
    _close(tsys.system_energy(tx, txt, tsys.sigma(F)), jse)


def test_assembly_matches(kind):
    _, _, _, _, jsys, tsys = _scene(kind)
    x, xt, fixed, p = _state(kind, seed=1)
    *_, jH, _, _, _, _ = _j_fields(jsys, jnp.asarray(x), jnp.asarray(xt),
                                   jnp.asarray(fixed), jnp.asarray(p))
    tH = tsys.assemble_subdomains(tsys.element_hessians(_t(x)), _t(fixed))
    if kind == "banded":
        _close(tH[0], jH[0])
        _close(tH[1], jH[1])
    else:
        _close(tH, jH)


def test_h0_factor_and_apply_match(kind):
    _, _, _, _, jsys, tsys = _scene(kind)
    x, _, fixed, _ = _state(kind, seed=2)
    _, jL, jd, _ = jsys.rebuild_h0(jnp.asarray(x), jnp.asarray(fixed))
    _, tL, td, _ = tsys.rebuild_h0(_t(x), _t(fixed))
    _close(td, jd)
    assert isinstance(tL, BTDFactor) == (kind == "banded")
    if isinstance(jL, JBTD):          # same scan factor: compare it too
        _close(tL.linv, jL.linv)
        _close(tL.sub, jL.sub)
    elif kind == "dense":
        _close(tL, jL)
    rhs = np.random.default_rng(3).normal(size=x.shape)
    jz = jax.jit(lambda s, L, d, r: s.h0_apply(L, d, r))(
        jsys, jL, jd, jnp.asarray(rhs))
    _close(tsys.h0_apply(tL, td, _t(rhs)), jz)


def _dense_of(H, part):
    """Subdomain `part` of the assembled H0 as one dense matrix."""
    if not isinstance(H, tuple):
        return H[part]
    diag, sub = H
    nb, bs = diag.shape[0], diag.shape[2]
    M = torch.zeros((nb * bs, nb * bs), dtype=diag.dtype)
    for k in range(nb):
        M[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] = diag[k, part]
        if k + 1 < nb:
            M[(k + 1) * bs:(k + 2) * bs, k * bs:(k + 1) * bs] = sub[k, part]
            M[k * bs:(k + 1) * bs, (k + 1) * bs:(k + 2) * bs] = sub[k, part].T
    return M


def test_factorize_exact_and_shifted_tiers(kind):
    """Subdomain 0 made slightly indefinite (smallest eigenvalue -5e-5 of
    the equilibrated matrix): the exact factor comes back NaN there (as
    jnp's Cholesky), the preconditioner path retries with the 1e-4 shift
    of dot_tpu's tiers and is finite."""
    _, _, _, _, _, tsys = _scene(kind)
    x, _, fixed, _ = _state(kind, seed=4)
    H = tsys.assemble_subdomains(tsys.element_hessians(_t(x)), _t(fixed))
    M = _dense_of(H, 0)
    d = torch.sqrt(torch.diagonal(M))
    lmin = float(torch.linalg.eigvalsh(M / d[:, None] / d[None, :])[0])
    c = (lmin + 5e-5) / (1.0 - 5e-5)   # (lmin - c) / (1 - c) = -5e-5
    if kind == "banded":
        diag = H[0].clone()
        diag[:, 0] -= c * torch.diag_embed(torch.diagonal(diag[:, 0],
                                                          dim1=-2, dim2=-1))
        bad = (diag, H[1])
    else:
        bad = H.clone()
        bad[0] -= c * torch.diag(torch.diagonal(bad[0]))

    def leaves(L):
        return L if isinstance(L, BTDFactor) else (L,)

    L, _ = tsys.factorize(bad, fast=False)
    assert any(torch.isnan(t).any() for t in leaves(L))
    n0 = tsys.n_syncs
    L, d_ = tsys.factorize(bad, fast=True)
    assert tsys.n_syncs == n0 + 1
    assert all(torch.isfinite(t).all() for t in leaves(L))
    r = torch.ones((tsys.n_parts, tsys.n3), dtype=torch.float64)
    assert torch.isfinite(tsys.solve_local(L, r)).all()


@pytest.mark.parametrize("option", [0, 1, 2, 3, 4])
def test_warm_start_and_x_tilta_match(option):
    _, _, _, _, jsys, tsys = _scene("dense")
    x, xt, fixed, p = _state("dense", seed=5)
    v, dxe = p, 0.5 * (xt - x)
    jw = jsys.warm_start(option, jnp.asarray(x), jnp.asarray(v),
                         jnp.asarray(dxe), jnp.asarray(fixed))
    tw = tsys.warm_start(option, _t(x), _t(v), _t(dxe), _t(fixed))
    _close(tw, jw)
    _close(tsys.compute_x_tilta(_t(x), _t(v), _t(fixed)),
           jsys._compute_x_tilta(jnp.asarray(x), jnp.asarray(v),
                                 jnp.asarray(fixed)))
    assert tsys.target_g_res(1e-5) == pytest.approx(jsys.target_g_res(1e-5),
                                                    rel=1e-12)


def test_warm_start_5_not_ported():
    """warmStart 5 was the last option the port lacked: it now runs (held
    against dot_tpu in tests/test_torch_warmstart.py) and only an option
    dot_tpu does not have either raises."""
    _, _, _, _, _, tsys = _scene("dense")
    x, xt, fixed, p = _state("dense", seed=6)
    w = tsys.warm_start(5, _t(x), _t(p), _t(p), _t(fixed), x_tilta=_t(xt))
    assert torch.isfinite(w).all()
    np.testing.assert_array_equal(w.numpy()[fixed], x[fixed])
    with pytest.raises(NotImplementedError):
        tsys.warm_start(6, _t(x), _t(p), _t(p), _t(fixed), x_tilta=_t(xt))


@pytest.mark.parametrize("script", ["twist", "stretchnsquash", "bend",
                                    "rubberBandPull"])
def test_script_step_matches(script):
    """make_step_fn (handle motion, turning points, rubberBandPull
    release) against dot_tpu's over 40 steps from the same state."""
    mesh = bar_mesh(8, 3, 3)
    mesh.find_border_verts(0.1)
    sd = jscripts.init_script(mesh, script)
    jstep = jax.jit(jscripts.make_step_fn(sd, 0.025))
    tstep = tscripts.make_step_fn(sd, 0.025)
    jx = jnp.asarray(sd.x0)
    jf = jnp.asarray(sd.fixed0)
    jv, jr = jnp.asarray(1.0), jnp.asarray(False)
    tx, tf = _t(sd.x0), _t(sd.fixed0)
    tv = torch.tensor(1.0, dtype=torch.float64)
    tr = torch.tensor(False)
    changed = 0
    for _ in range(40):
        jx, jf, jv, jr, jc = jstep(jx, jf, jv, jr)
        tx, tf, tv, tr, tc = tstep(tx, tf, tv, tr)
        assert bool(jc) == bool(tc)
        changed += bool(tc)
        # rubberBandPull: pull the waist far enough to release it
        if script == "rubberBandPull":
            jx = jx.at[:, 0].add(-0.2)
            tx = tx.clone()
            tx[:, 0] -= 0.2
    _close(tx, jx, 1e-12)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert float(tv) == float(jv) and bool(tr) == bool(jr)
    if script == "rubberBandPull":
        assert changed == 1
