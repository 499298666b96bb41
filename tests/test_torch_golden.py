"""The port's DOT stepper end to end on the CPU (float64).

1. bar 8x3x3, twist, DOT with 4 parts reproduces the recorded golden sysE
   trace of tests/test_golden.py at rtol 2e-4;
2. from one initial state (dot_tpu's, carried over by
   convert.state_from_numpy), 3 frames of the port and of dot_tpu give the
   same positions at rtol 1e-7 (the tolerance of tests/test_banded.py:108)
   on the dense plan and on a banded plan."""

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

from test_golden import GOLDEN_SYS_E


def _scene(banded):
    mesh = bar_mesh(8, 3, 3)
    cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script="twist", handle_ratio=0.05)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = jscripts.init_script(mesh, "twist")
    mesh.fixed_mask = sd.fixed0.copy()
    if banded:
        plan = jpartition.build_plan(mesh, 2, pad_elem_to=16, pad_n3_to=48,
                                     band_bs_unit=48, band_min_nb=3)
        assert plan.band_nb >= 3
    else:
        plan = jpartition.build_plan(mesh, 4, pad_elem_to=16, pad_n3_to=48)
        assert plan.band_nb < 3
    return mesh, cfg, sd, plan


def test_port_reproduces_golden_sys_e():
    mesh, cfg, sd, plan = _scene(banded=False)
    stepper = DOTStepper(convert.system_from_plan(mesh, cfg, plan), sd)
    st = stepper.init_state()
    vals, stops = [], []
    for _ in GOLDEN_SYS_E:
        st, (stats, sys_e) = stepper.step(st)
        vals.append(sys_e)
        stops.append(stats.stop)
    np.testing.assert_allclose(vals, GOLDEN_SYS_E, rtol=2e-4)
    assert set(stops) <= {"tol", "rel_dec"}


@pytest.mark.parametrize("banded", [False, True], ids=["dense", "banded"])
def test_port_matches_dot_tpu_from_one_state(banded):
    mesh, cfg, sd, plan = _scene(banded)
    jst = JDOT(JSystem(mesh, cfg, plan, dtype=jnp.float64), sd)
    tsys = convert.system_from_plan(mesh, cfg, plan, dtype=torch.float64)
    tst = DOTStepper(tsys, sd)
    js = jst.init_state()
    # copy before stepping: dot_tpu donates its state buffers
    ts = convert.state_from_numpy(jax.tree.map(np.array, js), tsys)
    je, te = [], []
    for _ in range(3):
        js, (_, e) = jst.step(js, rel_tol=1e-5)
        je.append(float(e))
        ts, (stats, e) = tst.step(ts, rel_tol=1e-5)
        te.append(e)
        assert stats.stop in ("tol", "rel_dec")
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(te, je, rtol=1e-9)
