"""The port's Simulator and CLI on the CPU: a 2-frame run writes the full
per-run output contract of dot_tpu/sim.py (log.txt's line-search-failure
line against a dot_tpu run of the same scene), what the port does not
cover yet refuses clearly, and without a card the entry points run only
when the caller asks for the CPU."""

import os
import re

import numpy as np
import pytest
import torch

from dot_tpu_torch import io as meshio
from dot_tpu_torch.__main__ import main as cli_main
from dot_tpu_torch.config import Config
from dot_tpu_torch.mesh_gen import bar_mesh
from dot_tpu_torch.sim import Simulator, parse_status, run_script

SCENE = """energy FCR
timeStepper {stepper}
warmStart 2
time 5 0.025
density 1000
stiffness 100000 0.4
script twist
handleRatio 0.05
shape input {mesh}
{extra}"""


def _scene(tmp_path, stepper="DOT 2", extra=""):
    mesh = bar_mesh(8, 3, 3)
    mp = tmp_path / "bar.msh"
    meshio.save_tet_mesh(str(mp), mesh.V, mesh.conn, mesh.SF)
    sp = tmp_path / "scene.txt"
    sp.write_text(SCENE.format(stepper=stepper, mesh=mp, extra=extra))
    return str(sp)


def test_two_frame_run_writes_output_contract(tmp_path):
    sim, spf = run_script(_scene(tmp_path), frames=2,
                          output_root=str(tmp_path / "out"), dtype="f64",
                          device="cpu", mute=True)
    assert sim.frame == 2 and spf > 0
    assert sim.system.dtype == torch.float64
    files = set(os.listdir(sim.out))
    need = {"config.txt", "iterStats.txt", "log.txt", "info.txt",
            "finalResult_mesh.msh", "status0", "status1", "status2",
            "0.obj", "1.obj", "2.obj"}
    assert need <= files, need - files
    log = (tmp_path / "out" / os.path.basename(sim.out) / "log.txt"
           ).read_text()
    sys_e = [float(ln.split("=")[1]) for ln in log.splitlines()
             if ln.startswith("sysE = ")]
    assert len(sys_e) == 2 and np.all(np.isfinite(sys_e))
    assert [r["sys_e"] for r in sim.frames] == pytest.approx(sys_e,
                                                             rel=1e-9)
    rows = [ln.split() for ln in
            open(os.path.join(sim.out, "iterStats.txt")).read().splitlines()]
    assert len(rows) == sum(r["iters"] + 1 for r in sim.frames)
    assert {r[0] for r in rows} == {"0", "1"}
    x, v, dxe, frame = parse_status(os.path.join(sim.out, "status2"))
    assert frame == 2 and x.shape == (sim.mesh.n_vert, 3)
    np.testing.assert_allclose(x, sim.state.x.numpy(), rtol=1e-6,
                               atol=1e-9)
    info = open(os.path.join(sim.out, "info.txt")).read()
    assert "innerIterTotal" in info and "device" not in info
    assert re.search(r"^step (\S+)", info, re.M)    # tools/results_table.py
    cfg = Config.load(os.path.join(sim.out, "config.txt"))
    assert cfg.time_stepper == "DOT" and cfg.partition_amt == 2


def test_cli_mode_100(tmp_path, capsys):
    cli_main(["100", _scene(tmp_path), "cli", "--frames", "1",
              "--dtype", "f64", "--device", "cpu", "--output-root",
              str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert "done: 1/200 frames" in out
    assert os.path.exists(tmp_path / "out" / "bar_twist_FCR_DOT2_cli" /
                          "finalResult_mesh.msh")


def test_cli_refuses_unported_modes(tmp_path):
    with pytest.raises(SystemExit):
        cli_main(["2", _scene(tmp_path)])


@pytest.mark.parametrize("stepper,extra", [
    ("ADMM", "restart status0"), ("ADMMDD 2", "restart status0"),
    ("LBFGS", "h0Refresh 4"),
    ("DOT 2", "h0Refresh -1"), ("DOT 2", "restart status0")])
def test_unported_configurations_raise(tmp_path, stepper, extra):
    cfg = Config.load(_scene(tmp_path, stepper, extra))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulator(cfg, str(tmp_path / "out"), device="cpu", mute=True)


@pytest.mark.parametrize("stepper,folder,cls,parts,warm", [
    ("Newton", "Newton", "NewtonStepper", 1, 2),
    ("LBFGS", "LBFGS", "LBFGSPD", 0, 2),
    ("LBFGSH", "LBFGSH", "LBFGSH", 1, 2),
    ("LBFGSHI", "LBFGSHI", "LBFGSHI", 1, 2),
    ("LBFGSJH 3", "LBFGSJH3", "LBFGSJH", 3, 2),
    ("GSDD 2", "GSDD2", "GSDDStepper", 2, 2),
    ("DOT 2", "DOT2", "DOTStepper", 2, 5)])
def test_run_script_each_stepper(tmp_path, stepper, folder, cls, parts, warm):
    """One frame of every ported timeStepper (and of warmStart 5) through
    run_script on the CPU: dot_tpu/sim.py's dispatch (plan kind, factor
    dtype, coarse space off for GSDD), the folder name, finite output."""
    scene = _scene(tmp_path, stepper)
    with open(scene) as f:
        text = f.read()
    with open(scene, "w") as f:
        f.write(text.replace("warmStart 2", f"warmStart {warm}"))
    sim, _ = run_script(scene, frames=1, output_root=str(tmp_path / "out"),
                        dtype="f64", device="cpu", mute=True)
    assert type(sim.stepper).__name__ == cls
    assert sim.stepper.warm_start_opt == warm
    assert sim.system.n_parts == parts
    assert os.path.basename(sim.out) == f"bar_twist_FCR_{folder}"
    assert (sim.system.plan is None) == (stepper == "LBFGS")
    assert (sim.system.factor_dtype == torch.bfloat16) == (stepper
                                                           == "LBFGSHI")
    assert not sim.system.use_coarse
    if cls == "LBFGSJH":
        assert sim.system.plan.part is None
        assert int(sim.system.plan.dup.max()) == 1
    assert os.path.exists(os.path.join(sim.out, "label.obj")) == (
        cls in ("GSDDStepper", "DOTStepper"))
    r = sim.frames[0]
    assert np.isfinite(r["sys_e"]) and r["stop"] in ("tol", "rel_dec")
    assert r["sqn_g"] <= r["tol"] or r["stop"] == "rel_dec"
    assert torch.isfinite(sim.state.x).all()
    assert os.path.exists(os.path.join(sim.out, "finalResult_mesh.msh"))


def test_entry_points_need_a_card_unless_cpu_is_asked(tmp_path, monkeypatch):
    """With no CUDA device, Simulator, run_script and the CLI raise a clear
    error naming CUDA instead of falling back to the CPU; device="cpu"
    (--device cpu) runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = _scene(tmp_path)
    cfg = Config.load(scene)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulator(cfg, out, mute=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_script(scene, frames=1, output_root=out, mute=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["100", scene, "--frames", "1", "--output-root", out])
    sim = Simulator(cfg, out, device="cpu", mute=True)
    assert sim.device.type == "cpu" and sim.system.dtype == torch.float64
    cli_main(["100", scene, "cpu", "--frames", "1", "--device", "cpu",
              "--output-root", out])


LS_FAILED = "\tline search with Armijo's rule failed!!!"


@pytest.mark.parametrize("max_iter", [0, 3])
def test_log_has_the_line_search_failure_line_where_dot_tpu_has(tmp_path,
                                                                max_iter):
    """dot_tpu/sim.py:370-371 writes the line after a frame that reports
    `stopped` with 0 iterations: an ADMM run whose iteration cap is 0 (set
    on the Config: the scene grammar turns `ADMM 0` into 10). The port's
    log.txt carries it in the same frames, and nowhere in a run that
    iterates."""
    import jax.numpy as jnp
    from dot_tpu.config import Config as JConfig
    from dot_tpu.sim import Simulator as JSimulator
    scene = _scene(tmp_path, "ADMM")
    logs = []
    for cfg_cls, sim_cls, kw in (
            (JConfig, JSimulator, dict(dtype=jnp.float64, render=False)),
            (Config, Simulator, dict(dtype=torch.float64, device="cpu"))):
        cfg = cfg_cls.load(scene)
        cfg.max_iter_apd = max_iter
        sim = sim_cls(cfg, str(tmp_path / f"out_{sim_cls.__module__}"),
                      search_dirs=(str(tmp_path),), mute=True, **kw)
        sim.run(2)
        sim.finalize()
        logs.append(open(os.path.join(sim.out, "log.txt")).read()
                    .splitlines())
    jlog, tlog = logs
    assert jlog.count(LS_FAILED) == tlog.count(LS_FAILED) \
        == (2 if max_iter == 0 else 0)
    assert [i for i, ln in enumerate(jlog) if ln == LS_FAILED] \
        == [i for i, ln in enumerate(tlog) if ln == LS_FAILED]
    assert len(jlog) == len(tlog)
    for a, b in zip(jlog, tlog):              # the same lines, sysE to 1e-9
        if a.startswith("sysE = "):
            assert float(b.split("=")[1]) == pytest.approx(
                float(a.split("=")[1]), rel=1e-9)
        else:
            assert a == b


def test_info_txt_lines_match_dot_tpu(tmp_path):
    """info.txt carries dot_tpu's lines (dot_tpu/sim.py:421-427): the five
    counts, equal on this scene, then the timing block with the same
    activity names in the same order (no device line: the device goes to
    stdout)."""
    import jax.numpy as jnp
    from dot_tpu.config import Config as JConfig
    from dot_tpu.sim import Simulator as JSimulator
    scene = _scene(tmp_path)
    lines = []
    for cfg_cls, sim_cls, kw in (
            (JConfig, JSimulator, dict(dtype=jnp.float64, render=False)),
            (Config, Simulator, dict(dtype=torch.float64, device="cpu"))):
        sim = sim_cls(cfg_cls.load(scene),
                      str(tmp_path / f"out_{sim_cls.__module__}"),
                      search_dirs=(str(tmp_path),), mute=True, **kw)
        sim.run(2)
        sim.finalize()
        lines.append(open(os.path.join(sim.out, "info.txt")).read()
                     .splitlines())
    jlines, tlines = lines
    assert [ln.split()[0] for ln in tlines] == [ln.split()[0]
                                                for ln in jlines]
    assert tlines[:5] == jlines[:5]
    assert tlines[5] == "--- timing (s) ---"
    assert [ln.split()[0] for ln in tlines[:5]] == [
        "vertAmt", "elemAmt", "frames", "innerIterTotal", "lineSearchTotal"]
