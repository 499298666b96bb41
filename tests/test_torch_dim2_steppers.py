"""The port's 2D decomposed path as a whole against dot_tpu on the CPU, f64:
3 frames of the spikes stretch scene (resolution 200) under DOT 4, GSDD 4,
LBFGS (PD), LBFGSH, LBFGSHI and LBFGSJH 4, each started from dot_tpu's own
initial state (converted), against dot_tpu's same 2D stepper (positions at
rtol 1e-7 with equal iteration counts, z = 0), the recorded 2D golden sysE
(DOT, GSDD, LBFGS, LBFGSJH: tests/test_dim2.py:301-435 hold dot_tpu to it)
and, for DOT, the 2D Newton positions (2e-3 of the scale). LBFGSH and
LBFGSHI have no oracle in the reference tests and are held to dot_tpu.
Then the entry points: Sim2D dispatches each stepper to its plan, a
`DOT -1 blockSize` scene runs through run_script_2d and the CLI with the
output contract, and info.txt carries dot_tpu's lines.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dot_tpu import dim2 as jdim2
from dot_tpu import scripts as jscripts
from dot_tpu.config import Config as JConfig
from dot_tpu.steppers.dot import DOTStepper as JDOT
from dot_tpu.steppers.gsdd import GSDDStepper as JGSDD
from dot_tpu.steppers.lbfgs import LBFGSH as JLBFGSH
from dot_tpu.steppers.lbfgs import LBFGSHI as JLBFGSHI
from dot_tpu.steppers.lbfgs import LBFGSJH as JLBFGSJH
from dot_tpu.steppers.lbfgs import LBFGSPD as JLBFGSPD
from dot_tpu_torch import dim2, scripts
from dot_tpu_torch.__main__ import main as cli_main
from dot_tpu_torch.config import Config
from dot_tpu_torch.convert import plan2d_from_numpy, state2d_from_numpy
from dot_tpu_torch.sim import STEPPERS

GOLDEN_2D_SPIKES_SYS_E = [
    3.294256031942e+03,
    3.294256605060e+03,
    3.300416677680e+03,
]
KW = dict(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
          script="stretch", handle_ratio=0.03, shape="spikes",
          resolution=200, partition_amt=4)
# stepper -> (dot_tpu class, plan: "element" / "one" / "node" / None, bf16)
RUNS = {"DOT": (JDOT, "element", False), "GSDD": (JGSDD, "element", False),
        "LBFGS": (JLBFGSPD, None, False), "LBFGSH": (JLBFGSH, "one", False),
        "LBFGSHI": (JLBFGSHI, "one", True),
        "LBFGSJH": (JLBFGSJH, "node", False)}
GOLDEN_RUNS = ("DOT", "GSDD", "LBFGS", "LBFGSJH")
_cache = {}


def _pair(name):
    jcls, kind, bf16 = RUNS[name]
    jcfg = JConfig(time_stepper=name, **KW)
    cfg = Config(time_stepper=name, **KW)
    jm = jdim2.Mesh2D.from_config(jcfg)
    jsd = jscripts.init_script(jm, jcfg.script)
    jm.fixed_mask = jsd.fixed0.copy()
    m = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(m, cfg.script)
    m.fixed_mask = sd.fixed0.copy()
    jp = {"element": lambda: jdim2.build_plan_2d(jm, 4),
          "one": lambda: jdim2.build_plan_2d(jm, 1),
          "node": lambda: jdim2.build_node_plan_2d(jm, 4),
          None: lambda: None}[kind]()
    js = jdim2.System2D(jm, jcfg, dtype=jnp.float64, plan=jp,
                        factor_dtype=jnp.bfloat16 if bf16 else None)
    ts = dim2.System2D(m, cfg, device="cpu",
                       plan=None if jp is None else plan2d_from_numpy(jp),
                       factor_dtype=torch.bfloat16 if bf16 else None)
    return jcls(js, jsd), STEPPERS[name](ts, sd)


def _frames(name):
    """3 frames of dot_tpu's and the port's stepper from dot_tpu's initial
    state (cached per stepper)."""
    if name not in _cache:
        jst, st = _pair(name)
        js = jst.init_state()
        ts = state2d_from_numpy(js, st.system)
        rows = []
        for _ in range(3):
            js, (jstats, je) = jst.step(js, 1e-5)
            ts, (tstats, te) = st.step(ts, 1e-5)
            rows.append(dict(xj=np.asarray(js.x).copy(),
                             xt=ts.x.numpy().copy(),
                             itj=int(jstats.inner_iters),
                             itt=tstats.inner_iters,
                             lsj=int(jstats.ls_halvings),
                             lst=tstats.ls_halvings, ej=float(je), et=te,
                             stop=tstats.stop))
        _cache[name] = (st, rows)
    return _cache[name]


@pytest.mark.parametrize("name", list(RUNS))
def test_matches_dot_tpu(name):
    st, rows = _frames(name)
    for r in rows:
        assert r["itt"] > 0 and r["stop"] in ("tol", "rel_dec")
        assert (r["itt"], r["lst"]) == (r["itj"], r["lsj"])
        np.testing.assert_allclose(r["xt"], r["xj"], rtol=1e-7,
                                   atol=1e-12 * np.abs(r["xj"]).max())
        assert r["et"] == pytest.approx(r["ej"], rel=1e-9)
        assert (r["xt"][:, 2] == 0).all()
    sysm = st.system
    if name == "LBFGS":
        assert sysm.plan is None
    else:
        assert sysm.n_parts == (1 if RUNS[name][1] == "one" else 4)
        assert (int(sysm.dup.max()) > 1) == (RUNS[name][1] == "element")
    assert sysm._solve_dtype == (torch.float32 if name == "LBFGSHI"
                                 else torch.float64)


@pytest.mark.parametrize("name", GOLDEN_RUNS)
def test_matches_golden(name):
    _, rows = _frames(name)
    np.testing.assert_allclose([r["et"] for r in rows],
                               GOLDEN_2D_SPIKES_SYS_E, rtol=2e-4)


def test_dot_matches_newton():
    """DOT's positions against 2D projected Newton's at the same tolerance
    (tests/test_dim2.py:301-326)."""
    _, rows = _frames("DOT")
    cfg = Config(time_stepper="Newton", **KW)
    m = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(m, cfg.script)
    m.fixed_mask = sd.fixed0.copy()
    newton = dim2.Newton2DStepper(dim2.System2D(m, cfg, device="cpu"), sd)
    s = newton.init_state()
    for _ in range(3):
        s, _ = newton.step(s, 1e-5)
    xn = s.x.numpy()
    assert np.abs(xn - rows[-1]["xt"]).max() < 2e-3 * np.abs(xn).max()


SCENE_2D = """energy FCR
timeStepper {stepper}
warmStart 2
resolution 200
size 1
time 5 0.025
density 1000
stiffness 100000 0.4
script stretch
handleRatio 0.03
shape spikes
"""


def _scene(tmp_path, stepper):
    sp = tmp_path / "spikes.txt"
    sp.write_text(SCENE_2D.format(stepper=stepper))
    return str(sp)


@pytest.mark.parametrize("stepper,cls,parts,dup", [
    ("DOT 4", "DOTStepper", 4, 2), ("GSDD 4", "GSDDStepper", 4, 2),
    ("LBFGS", "LBFGSPD", 0, None), ("LBFGSH", "LBFGSH", 1, 1),
    ("LBFGSHI", "LBFGSHI", 1, 1), ("LBFGSJH 4", "LBFGSJH", 4, 1)])
def test_sim2d_runs_the_stepper_on_its_plan(tmp_path, stepper, cls, parts,
                                            dup):
    """The 2D configurations that raised "not ported yet" before: Sim2D
    builds each stepper on dot_tpu's plan for it (dim2.py:1495-1531) and
    runs a frame; the warm start 5 refusal holds for them too."""
    sim = dim2.Sim2D(Config.load(_scene(tmp_path, stepper)),
                     str(tmp_path / "out"), device="cpu", mute=True)
    assert type(sim.stepper).__name__ == cls
    assert sim.system.n_parts == parts
    if dup is not None:
        assert (int(sim.system.dup.max()) > 1) == (dup > 1)
    assert sim.system.factor_dtype == (torch.bfloat16 if stepper == "LBFGSHI"
                                       else torch.float64)
    sim.run(1)
    assert sim.frames[0]["iters"] > 0
    assert sim.frames[0]["stop"] in ("tol", "rel_dec")
    assert float(sim.state.x[:, 2].abs().max()) == 0.0
    sim.finalize()
    ws5 = Config.load(_scene(tmp_path, stepper))
    ws5.warm_start = 5
    sim5 = dim2.Sim2D(ws5, str(tmp_path / "out5"), device="cpu", mute=True)
    with pytest.raises(NotImplementedError, match="warmStart 5"):
        sim5.run(1)


def test_dot_blocksize_through_run_script_and_cli(tmp_path, capsys):
    """`timeStepper DOT -1 blockSize` (partitionAmt = nV / blockSize + 1)
    through run_script_2d and the CLI, with the output contract."""
    scene = _scene(tmp_path, "DOT -1 20")
    sim, spf = dim2.run_script_2d(scene, frames=2, output_root=str(
        tmp_path / "out"), dtype="f64", device="cpu", mute=True)
    nv = sim.mesh.n_vert
    assert sim.system.n_parts == nv // 20 + 1 > 4
    assert type(sim.stepper).__name__ == "DOTStepper" and spf > 0
    files = set(os.listdir(sim.out))
    need = {"config.txt", "iterStats.txt", "log.txt", "info.txt", "status2",
            "2.obj"}
    assert need <= files and not any(f.endswith(".msh") for f in files)
    log = open(os.path.join(sim.out, "log.txt")).read()
    sys_e = [float(ln.split("=")[1]) for ln in log.splitlines()
             if ln.startswith("sysE = ")]
    np.testing.assert_allclose(sys_e, GOLDEN_2D_SPIKES_SYS_E[:2], rtol=2e-4)
    rows = open(os.path.join(sim.out, "iterStats.txt")).read().splitlines()
    assert len(rows) == sum(r["iters"] + 1 for r in sim.frames)
    cli_main(["100", scene, "cli", "--frames", "1", "--dtype", "f64",
              "--device", "cpu", "--output-root", str(tmp_path / "cli")])
    out = capsys.readouterr().out
    assert "done: 1/200 2D frames" in out and "on cpu" in out
    run_dir, = (tmp_path / "cli").iterdir()
    assert run_dir.name.endswith("_cli") and (run_dir / "1.obj").exists()


def test_info_txt_lines_match_dot_tpu(tmp_path):
    """dot_tpu's 2D info.txt holds the five counts and nothing else
    (dim2.py:1606-1613); the port's holds the same keys in the same order,
    and the same counts on this scene."""
    scene = _scene(tmp_path, "DOT 4")
    jsim = jdim2.Sim2D(JConfig.load(scene), str(tmp_path / "j"),
                       mute=True, render=False)
    jsim.run(1)
    jsim.finalize()
    sim = dim2.Sim2D(Config.load(scene), str(tmp_path / "t"), device="cpu",
                     mute=True)
    sim.run(1)
    sim.finalize()
    lines = [open(os.path.join(d, "info.txt")).read().splitlines()
             for d in (jsim.out, sim.out)]
    assert [ln.split()[0] for ln in lines[1]] == \
        [ln.split()[0] for ln in lines[0]] == [
            "vertAmt", "elemAmt", "frames", "innerIterTotal",
            "lineSearchTotal"]
    assert lines[1] == lines[0]
