"""The port's copied host modules against dot_tpu's, and the port's
independence from jax.

- partition.build_plan of dot_tpu_torch gives arrays identical to
  dot_tpu.partition.build_plan on the same mesh (dense and banded plans);
- a subprocess imports dot_tpu_torch, runs one small CPU step and finds no
  jax in sys.modules;
- the copied native library builds into dot_tpu_torch/build/, not into
  native/."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from dot_tpu import partition as jpartition
from dot_tpu.mesh_gen import bar_mesh as j_bar_mesh
from dot_tpu_torch import native as tnative
from dot_tpu_torch import partition as tpartition
from dot_tpu_torch.mesh_gen import bar_mesh as t_bar_mesh

_FORBIDDEN = re.compile(r"\s*(import|from)\s+(jax|jaxlib|dot_tpu)(\.|\s|$)")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLANS = {
    "dense4": (4, dict(pad_elem_to=16, pad_n3_to=48)),
    "banded2": (2, dict(pad_elem_to=16, pad_n3_to=48, band_bs_unit=48,
                        band_min_nb=3)),
    "default6": (6, dict()),
}


def _equal(a, b, path):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("name", sorted(PLANS))
def test_build_plan_identical(name):
    n_parts, kw = PLANS[name]
    jm, tm = j_bar_mesh(8, 3, 3), t_bar_mesh(8, 3, 3)
    for m in (jm, tm):
        m.find_border_verts(0.05)
    np.testing.assert_array_equal(jm.V, tm.V)
    np.testing.assert_array_equal(jm.conn, tm.conn)
    jp = jpartition.build_plan(jm, n_parts, **kw)
    tp = tpartition.build_plan(tm, n_parts, **kw)
    assert type(tp).__module__ == "dot_tpu_torch.partition"
    for f in dataclasses.fields(jp):
        _equal(getattr(jp, f.name), getattr(tp, f.name), f.name)


def test_native_library_builds_in_the_port():
    lib = tnative._load()
    assert lib is not None                     # g++ is on the test hosts
    so = tnative._SO
    assert os.path.dirname(so) == os.path.join(ROOT, "dot_tpu_torch",
                                               "build")
    assert os.path.exists(so)


def test_port_runs_without_jax():
    code = r"""
import sys
import numpy as np
import torch
from dot_tpu_torch import partition, scripts
from dot_tpu_torch.config import Config
from dot_tpu_torch.mesh_gen import bar_mesh
from dot_tpu_torch.steppers import DOTStepper, System
mesh = bar_mesh(6, 2, 2)
cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
             script="twist", handle_ratio=0.1)
mesh.set_lame(cfg.ym, cfg.pr)
mesh.find_border_verts(cfg.handle_ratio)
sd = scripts.init_script(mesh, "twist")
mesh.fixed_mask = sd.fixed0.copy()
plan = partition.build_plan(mesh, 2, pad_elem_to=16, pad_n3_to=48)
st = DOTStepper(System(mesh, cfg, plan, dtype=torch.float64, device="cpu"),
                sd)
s, (stats, e) = st.step(st.init_state())
assert np.isfinite(e) and stats.inner_iters > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "dot_tpu"))
print("LOADED", bad)
assert not bad, bad
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "LOADED []" in r.stdout


def test_port_sources_name_no_jax():
    """No module of the port imports jax or dot_tpu."""
    pkg = os.path.join(ROOT, "dot_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                for ln in fh:
                    assert not _FORBIDDEN.match(ln), (f, ln)
