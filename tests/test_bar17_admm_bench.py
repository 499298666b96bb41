"""The benchmark's ADMM-PD cell bar17-twist-admm on the CPU in f64, at
bar_mesh(8, 3, 3): the cell is bar17-twist's scene under `timeStepper
ADMM 30`, judged by lbfgspd's four numbers; ADMM-PD frames of Simulator,
run by the harness, pass the cell's comparison and each fault of
faults_admm.py fails it; a traced frame opens the program's
`dtw_scatter` span once an iteration and once for the Dirichlet offset,
`local_step` once an iteration, and is bit for bit the untraced frame;
the harness's spans on ADMMPDStepper._local_step and _scatter are
entered as often; the cell's two metrics read nothing where their span
was not entered."""

from __future__ import annotations

import dataclasses
import os
import time
import types

import pytest
import torch

from bench_port import driver, faults_admm, run, tracing as bench_tracing
from bench_port.metrics import admm_local_ms, admm_scatter_ms
from dot_tpu_torch import tracing
from dot_tpu_torch.config import Config
from dot_tpu_torch.steppers.admm import ADMMPDStepper

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "bar17-twist-admm"
SEED = 2 ** 40 + 7
FRAMES = 3
METRICS = (admm_local_ms, admm_scatter_ms)


def tiny_cell(lap=FRAMES):
    """The cell with its limits, scene and traffic, at bar_mesh(8, 3, 3)
    in f64, laps of `lap` frames."""
    cell = driver.load_cell(ROOT, CELL)
    cell.config["mesh"]["cells"] = [8, 3, 3]
    cell.config["scene_script"]["dtype"] = "f64"
    cell.traffic["lap_frames"] = lap
    return cell


def built_run(tmp_path, cell=None):
    r = driver.Run(cell or tiny_cell(), SEED, "cpu", str(tmp_path))
    r.build(time.perf_counter())
    return r


def judged(r, frames=FRAMES):
    """(correct, failed, checks) of `frames` frames from the lap's start."""
    r.window(float("inf"), max_frames=frames)
    r.release(free=False)
    return driver.judge(r.compare(), r.cell.limits)


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def test_cell_is_admm_30_on_the_bar17_twist_scene(tmp_path):
    cell = driver.load_cell(ROOT, CELL)
    assert cell.traffic["time_stepper"] == "ADMM 30"
    assert cell.traffic["warm_start"] == 2
    assert cell.config["name"] == "bar17-admm"
    assert cell.config["time_stepper"] == cell.traffic["time_stepper"]
    # the bar17-twist scene as published, under ADMM-PD
    lbfgspd = driver.load_cell(ROOT, "bar17-twist-lbfgspd")
    for k in ("reduced", "scene", "reference", "mesh", "scene_script"):
        assert cell.config[k] == lbfgspd.config[k], k
    assert set(cell.limits["numbers"]) == set(lbfgspd.limits["numbers"])
    assert {"admm_local_ms", "admm_scatter_ms", "pd_solve_ms",
            "iters_per_frame", "idle_pct"} <= set(cell.per_layer)
    assert "h0_solve_roofline" not in cell.per_layer
    scene = tmp_path / "scene.txt"
    driver.scene_kind(cell.config).write_scene(str(scene), cell.config,
                                               cell.traffic, "bar.msh")
    got = Config.load(str(scene))
    assert (got.time_stepper, got.max_iter_apd, got.warm_start) == (
        "ADMM", 30, 2)


def test_program_admm_frames_are_correct(tmp_path):
    r = built_run(tmp_path)
    correct, failed, checks = judged(r)
    assert correct and failed == 0, checks
    assert type(r.sim.stepper) is ADMMPDStepper
    assert r.sim.stepper.max_iter == 30
    assert all(1 <= f["iters"] < 30 and f["stop"] == "tol"
               for f in r.frame_stats)


def test_run_cell_runs_admm(tmp_path):
    res = run.run_cell(tiny_cell(), SEED, 0.05, False, device="cpu",
                       work_dir=str(tmp_path), t_process=time.perf_counter())
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert {"frame_ms", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", sorted(faults_admm.FAULTS))
def test_broken_admm_path_is_not_correct(tmp_path, monkeypatch, fault):
    """Each fault shows in 3 frames at bar_mesh(8, 3, 3): one_iteration
    leaves every frame's gradient above the tolerance, free_handles the
    handles a frame's turn off the script (full size: PERF.md section
    2)."""
    faults_admm.plant(fault, monkeypatch.setattr)
    correct, failed, checks = judged(built_run(tmp_path))
    assert correct is False and failed > 0, checks


def test_traced_admm_frame_opens_its_spans(tmp_path):
    r = built_run(tmp_path)
    sim = r.sim
    r.reset()
    start = dataclasses.replace(sim.state)
    n0 = len(sim.frames)
    tracing.enable()
    sim.run(1)
    tracing.disable()
    recs = tracing.records()
    st = sim.frames[n0]
    count = lambda name: sum(rec["name"] == name for rec in recs)
    assert st["iters"] > 0
    # K18 once an iteration (the global step's right-hand side) and once
    # a frame (the Dirichlet offset)
    assert count("dtw_scatter") == st["iters"] + 1
    assert count("local_step") == count("pd_solve") == st["iters"]
    assert count("host_read") == st["syncs"]
    by_id = {rec["id"]: rec for rec in recs}
    for rec in recs:
        if rec["name"] in ("dtw_scatter", "local_step", "pd_solve"):
            assert by_id[rec["parent"]]["name"] == "step"
    # the tracer changes nothing: the same frame untraced
    x_on = sim.state.x
    sim.state = start
    sim.run(1)
    assert torch.equal(sim.state.x, x_on)


def test_harness_spans_are_entered_once_an_iteration(tmp_path, monkeypatch):
    r = built_run(tmp_path)
    monkeypatch.setattr("torch.cuda._sleep", lambda n: None)
    spans, needs = {}, []
    for m in METRICS:
        spans.update(m.SPANS)
        needs += m.needs({})
    tracer = bench_tracing.Tracer(r.sim, spans)
    tracer.install()
    try:
        r.window(float("inf"), max_frames=2)
    finally:
        tracer.uninstall()
    iters = sum(f["iters"] for f in r.frame_stats)
    bench_tracing.check_needs(needs, tracer.calls,
                              {"frame": 2, "iter": iters})
    assert tracer.calls["admm_local"] == iters
    assert tracer.calls["admm_scatter"] == iters + 2


def _ctx(calls, dev_s):
    spans = ("admm_local", "admm_scatter")
    trace = types.SimpleNamespace(span_calls={s: calls for s in spans},
                                  span_s={s: dev_s for s in spans})
    return types.SimpleNamespace(trace=trace, frames=2)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.__name__)
def test_metrics_read_nothing_without_their_span(metric):
    assert metric.read(_ctx(0, 0.0)) is None
    empty = types.SimpleNamespace(
        trace=types.SimpleNamespace(span_calls={}, span_s={}), frames=2)
    assert metric.read(empty) is None
    assert metric.read(_ctx(34, 0.004)) == pytest.approx(2.0)
