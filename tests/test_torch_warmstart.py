"""warmStart 5 of the port against dot_tpu on the CPU (float64): the
Hessian diagonal (K13's plain version) against dot_tpu's hessian_diag at
1e-12 and against the diagonal of the assembled dense P = 1 matrix, one
warmStart 5 time step against dot_tpu's positions at rtol 1e-7, and the
warm starts 0, 1, 3, 4 and 5 as functions.

Scene: bar 8x3x3, twist, a dense P = 1 plan (pad_elem_to 16, pad_n3_to 48),
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
from dot_tpu.steppers import DOTStepper as JDOT
from dot_tpu.steppers import System as JSystem
from dot_tpu_torch import convert
from dot_tpu_torch.steppers import DOTStepper

_CACHE = {}


def _scene():
    """(mesh, cfg, script data, plan, dot_tpu System, port System)."""
    if not _CACHE:
        mesh = bar_mesh(8, 3, 3)
        cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                     script="twist", handle_ratio=0.05)
        mesh.set_lame(cfg.ym, cfg.pr)
        mesh.find_border_verts(cfg.handle_ratio)
        sd = jscripts.init_script(mesh, cfg.script)
        mesh.fixed_mask = sd.fixed0.copy()
        plan = jpartition.build_plan(mesh, 1, pad_elem_to=16, pad_n3_to=48)
        assert plan.band_nb < 3
        _CACHE["s"] = (mesh, cfg, sd, plan,
                       JSystem(mesh, cfg, plan, dtype=jnp.float64),
                       convert.system_from_plan(mesh, cfg, plan))
    return _CACHE["s"]


def _state(seed):
    _, _, sd, _, _, _ = _scene()
    rng = np.random.default_rng(seed)
    x = sd.x0 + 0.02 * rng.normal(size=sd.x0.shape)
    xt = sd.x0 + 0.01 * rng.normal(size=sd.x0.shape)
    v = rng.normal(size=sd.x0.shape)
    return x, xt, v, 0.5 * (xt - x), sd.fixed0.copy()


def _t(a):
    return torch.as_tensor(np.asarray(a))


@jax.jit
def _j_diag(sys, x):
    _, U, s, V = sys.fsvd(x)
    return sys.hessian_diag(sys.element_hessians(U, s, V))


def test_hessian_diag_matches_dot_tpu():
    *_, jsys, tsys = _scene()
    x = _state(0)[0]
    jd = np.asarray(_j_diag(jsys, jnp.asarray(x)))
    td = tsys.hessian_diag(tsys.element_hessians(_t(x))).numpy()
    assert td.shape == (tsys.n_vert, 3)
    np.testing.assert_allclose(td, jd, rtol=1e-12, atol=0)


def test_hessian_diag_is_the_dense_diagonal():
    """With nothing fixed the P = 1 assembled matrix is M + dt^2 H in local
    order: its diagonal, taken back to the vertices, is hessian_diag."""
    *_, tsys = _scene()
    x = _t(_state(1)[0])
    eh = tsys.element_hessians(x)
    free = torch.zeros(tsys.n_vert, dtype=torch.bool)
    H = tsys.assemble_subdomains(eh, free)
    assert H.shape == (1, tsys.n3, tsys.n3)
    dloc = H[0].diagonal().reshape(-1, 3)
    valid = tsys.local_valid[0]
    want = torch.zeros((tsys.n_vert, 3), dtype=torch.float64)
    want[tsys.l2g[0][valid]] = dloc[valid]
    np.testing.assert_allclose(tsys.hessian_diag(eh).numpy(), want.numpy(),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("option", [0, 1, 3, 4, 5])
def test_warm_start_options_match_dot_tpu(option):
    *_, jsys, tsys = _scene()
    x, xt, v, dxe, fixed = _state(2)
    jw = jax.jit(lambda s, *a: s.warm_start(option, *a[:4], x_tilta=a[4]))(
        jsys, jnp.asarray(x), jnp.asarray(v), jnp.asarray(dxe),
        jnp.asarray(fixed), jnp.asarray(xt))
    tw = tsys.warm_start(option, _t(x), _t(v), _t(dxe), _t(fixed),
                         x_tilta=_t(xt))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-10,
                               atol=1e-13)
    # fixed vertices do not move
    np.testing.assert_array_equal(tw.numpy()[fixed], x[fixed])


def test_warm_start_5_step_matches_dot_tpu():
    """Three DOT time steps with warmStart 5 from one state: positions at
    rtol 1e-7, equal iteration counts."""
    mesh, cfg, sd, plan, jsys, tsys = _scene()
    jst = JDOT(jsys, sd, warm_start_opt=5)
    tst = DOTStepper(tsys, sd, warm_start_opt=5)
    js = jst.init_state()
    ts = convert.state_from_numpy(jax.tree.map(np.array, js), tsys)
    for _ in range(3):
        js, (jstats, je) = jst.step(js, rel_tol=1e-5)
        ts, (tstats, te) = tst.step(ts, rel_tol=1e-5)
        assert tstats.inner_iters == int(jstats.inner_iters)
        assert tstats.stop in ("tol", "rel_dec")
        np.testing.assert_allclose(te, float(je), rtol=1e-9)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-7,
                               atol=1e-10)


def test_unknown_warm_start_raises():
    *_, tsys = _scene()
    x = torch.zeros((tsys.n_vert, 3), dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        tsys.warm_start(6, x, x, x, torch.zeros(tsys.n_vert, dtype=bool), x)
