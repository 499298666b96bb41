"""The benchmark's 2D Newton cell spikes20k-stretch-newton on the CPU in
f64, at spikes resolution 200 (122 vertices): Newton frames of Sim2D,
run by the harness, pass the cell's comparison and each fault of
faults_newton.py fails it; Sim2D's Newton system states its whole-mesh
factor as its H0 layout while a bare System2D states none; a traced
Newton frame opens the stepper's and System2D's spans once an iteration
and is bit for bit the untraced frame; the harness's spans on
System2D.factorize and solve are entered once an iteration; the cell's
three metrics read nothing where the program states no layout or the
span was not entered."""

from __future__ import annotations

import dataclasses
import os
import time
import types

import pytest
import torch

from bench_port import driver, faults_newton, run, tracing as bench_tracing
from bench_port.metrics import (newton_factor_ms, newton_factor_roofline,
                                newton_solve_roofline)
from dot_tpu_torch import tracing
from dot_tpu_torch.config import Config
from dot_tpu_torch.dim2 import Mesh2D, Newton2DStepper, System2D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "spikes20k-stretch-newton"
SEED = 2 ** 40 + 5
FRAMES = 3
METRICS = (newton_factor_ms, newton_factor_roofline, newton_solve_roofline)


def tiny_cell(lap=FRAMES, resolution=200):
    """The cell with its limits, scene and traffic, at `resolution` in
    f64, laps of `lap` frames."""
    cell = driver.load_cell(ROOT, CELL)
    cell.config["mesh"]["resolution"] = resolution
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


def test_cell_is_newton_on_the_spikes_configuration():
    cell = driver.load_cell(ROOT, CELL)
    assert cell.traffic["time_stepper"] == "Newton"
    assert cell.config["name"] == "spikes20k-newton"
    assert cell.config["time_stepper"] == cell.traffic["time_stepper"]
    # the spikes20k-stretch scene as published, under the Newton solver
    spikes = driver.load_cell(ROOT, "spikes20k-stretch-dot4").config
    for k in ("reduced", "scene", "reference", "mesh", "scene_script"):
        assert cell.config[k] == spikes[k], k
    assert set(cell.limits["numbers"]) == set(driver.load_cell(
        ROOT, "spikes20k-stretch-dot4").limits["numbers"])
    assert {"newton_factor_ms", "newton_factor_roofline",
            "newton_solve_roofline", "idle_pct"} <= set(cell.per_layer)


def test_program_newton_frames_are_correct(tmp_path):
    r = built_run(tmp_path)
    correct, failed, checks = judged(r)
    assert correct and failed == 0, checks
    assert type(r.sim.stepper) is Newton2DStepper
    assert all(f["iters"] >= 1 for f in r.frame_stats)


def test_run_cell_runs_newton(tmp_path):
    res = run.run_cell(tiny_cell(), SEED, 0.05, False, device="cpu",
                       work_dir=str(tmp_path), t_process=time.perf_counter())
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert {"frame_ms", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", sorted(faults_newton.FAULTS))
def test_broken_newton_path_is_not_correct(tmp_path, monkeypatch, fault):
    """Each fault shows in 3 frames at resolution 200: the solver faults
    leave every frame's gradient above the tolerance (full size: PERF.md
    section 2)."""
    faults_newton.plant(fault, monkeypatch.setattr)
    correct, failed, checks = judged(built_run(tmp_path))
    assert correct is False and failed > 0, checks


def test_newton_system_states_its_whole_mesh_factor(tmp_path):
    s = built_run(tmp_path).sim.system
    assert (s.n_parts, s.n3) == (1, 2 * s.n_vert) and s.plan is None
    assert (s.banded, s.use_coarse, s.apply_dtype) == (False, False, None)
    cfg = Config(energy="FCR", shape="spikes", resolution=200)
    bare = System2D(Mesh2D.from_config(cfg), cfg, device="cpu")
    assert (bare.n_parts, bare.n3, bare.banded) == (0, 0, False)


def test_traced_newton_frame_opens_its_spans(tmp_path):
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
    assert (count("newton_factor") == count("dense_factor")
            == count("dense_solve") == st["iters"])
    assert count("host_read") == st["syncs"]
    by_id = {rec["id"]: rec for rec in recs}
    parent = lambda rec: by_id[rec["parent"]]["name"]
    for rec in recs:
        if rec["name"] == "dense_factor":
            assert parent(rec) == "newton_factor"
        if rec["name"] in ("newton_factor", "dense_solve"):
            assert parent(rec) == "step"
        if rec["name"] == "element_hessians":
            assert parent(rec) == "dense_factor"
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
        needs += m.needs({"P": 1, "bs": 2 * r.sim.system.n_vert})
    tracer = bench_tracing.Tracer(r.sim, spans)
    tracer.install()
    try:
        r.window(float("inf"), max_frames=2)
    finally:
        tracer.uninstall()
    iters = sum(f["iters"] for f in r.frame_stats)
    bench_tracing.check_needs(needs, tracer.calls,
                              {"frame": 2, "iter": iters})
    assert tracer.calls["newton_factorize"] == iters
    assert tracer.calls["newton_solve"] == iters


def _ctx(P, bs, calls, dev_s):
    trace = types.SimpleNamespace(
        span_calls={"newton_factorize": calls, "newton_solve": calls},
        span_s={"newton_factorize": dev_s, "newton_solve": dev_s})
    shapes = {"P": P, "bs": bs, "field": "f32", "factor": "f32"}
    return types.SimpleNamespace(trace=trace, shapes=shapes, frames=2,
                                 power_limit="700.00 W", log=lambda *a: None)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.__name__)
def test_metrics_read_nothing_without_span_or_layout(metric):
    assert metric.read(_ctx(1, 20342, 0, 0.0)) is None
    if metric is newton_factor_ms:
        assert metric.read(_ctx(0, 0, 6, 0.5)) == pytest.approx(250.0)
    else:
        assert metric.read(_ctx(0, 0, 6, 0.5)) is None
        assert 0.0 < metric.read(_ctx(1, 20342, 6, 0.5)) < 100.0


def test_factor_roofline_counts_one_dense_cholesky():
    t, bound = newton_factor_roofline.factor_least(
        {"P": 1, "bs": 20342, "field": "f32", "factor": "f32"})
    assert bound == "ops" and t == pytest.approx(20342 ** 3 / 3 / 66.9e12)
