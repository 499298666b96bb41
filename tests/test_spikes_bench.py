"""The benchmark's 2D cell spikes20k-stretch-dot4 on the CPU in f64, at
spikes resolution 200 (122 vertices): the scene kind's mesh is the
program's; the plain reference (bench_port/references/tri_fcr.py) is
consistent with itself and with System2D; DOT 4 frames of Sim2D, run by
the harness, pass the cell's comparison, and broken paths and the TF32
control fail it; a lap replays after a reset; System2D states its H0
layout and its DOT path opens System's spans."""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from bench_port import control, driver, faults, run
from bench_port.references import tri_fcr
from bench_port.scenes import spikes
from dot_tpu_torch import mesh_gen, scripts, tracing
from dot_tpu_torch.config import Config
from dot_tpu_torch.dim2 import Mesh2D, System2D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "spikes20k-stretch-dot4"
SEED = 2 ** 40 + 3
FRAMES = 3


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


def reference(resolution=200, prec="f64"):
    cell = tiny_cell()
    cell.config["mesh"]["resolution"] = resolution
    mesh = spikes.spikes_2d(1.0, resolution)
    return tri_fcr.Scene(cell.config, mesh, "cpu", prec), mesh


def perturbed(ref, seed=0):
    """(x, xt): the rest shape and a predictor moved by a few mm, z = 0."""
    g = torch.Generator().manual_seed(seed)
    x, xt = (ref.x0 + a * torch.randn(ref.x0.shape, generator=g,
                                      dtype=torch.float64)
             for a in (0.01, 0.005))
    x[:, 2] = 0.0
    xt[:, 2] = 0.0
    return x, xt


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.mark.parametrize("resolution", [200, 800])
def test_scene_mesh_is_the_programs(resolution):
    V, F, (left, right) = spikes.spikes_2d(1.0, resolution)
    Vp, Fp, (lp, rp) = mesh_gen.spikes_2d(size=1.0, elem_amt=resolution)
    assert np.array_equal(V, Vp) and np.array_equal(F, Fp)
    assert np.array_equal(left, lp) and np.array_equal(right, rp)


def test_scene_mesh_cache_is_keyed_by_the_mesh(tmp_path):
    cfg = tiny_cell().config
    V, F, hs = spikes.cached_mesh(cfg, str(tmp_path))
    V2, F2, hs2 = spikes.cached_mesh(cfg, str(tmp_path))
    assert np.array_equal(V, V2) and np.array_equal(F, F2)
    assert all(np.array_equal(a, b) for a, b in zip(hs, hs2))
    cfg["mesh"]["resolution"] = 800
    assert len(spikes.cached_mesh(cfg, str(tmp_path))[0]) == 442
    assert len(os.listdir(tmp_path)) == 2


def test_seed_velocity_is_planar_and_zero_at_handles():
    x0 = torch.as_tensor(spikes.spikes_2d(1.0, 200)[0])
    fixed = torch.zeros(len(x0), dtype=torch.bool)
    fixed[:5] = True
    v1 = spikes.seed_velocity(SEED, x0, fixed, 1e-3)
    assert torch.equal(v1, spikes.seed_velocity(SEED, x0, fixed, 1e-3))
    assert not torch.equal(v1, spikes.seed_velocity(1, x0, fixed, 1e-3))
    assert v1[:, 2].abs().max() == 0 and v1[fixed].abs().max() == 0
    assert 0 < v1.abs().max() <= 1e-3


def test_reference_gradient_is_autograd_of_its_energy():
    ref, _ = reference()
    x, xt = perturbed(ref)
    xa = x.clone().requires_grad_(True)
    (g_ad,) = torch.autograd.grad(ref.energy(xa, xt), xa)
    g_ad = torch.where(ref.free[:, None], g_ad, 0.0)
    g = ref.gradient(x, xt)
    assert torch.allclose(g, g_ad, rtol=1e-12, atol=1e-12 * g.abs().max())


def test_reference_matches_system2d():
    """Energy, gradient, system energy and tolerance of the same state."""
    ref, _ = reference()
    cfg = Config(energy="FCR", time_stepper="Newton", dt=0.025, rho=1000.0,
                 ym=1e5, pr=0.4, script="stretch", shape="spikes",
                 resolution=200)
    mesh = Mesh2D.from_config(cfg)
    sd = scripts.init_script(mesh, cfg.script)
    mesh.fixed_mask = sd.fixed0.copy()
    s = System2D(mesh, cfg, dtype=torch.float64, device="cpu")
    assert np.array_equal(np.flatnonzero(sd.fixed0), ref.handles)
    x, xt = perturbed(ref)
    F = s.defgrad(x)
    rel = lambda a, b: float(abs(a - b) / abs(b))
    assert rel(ref.energy(x, xt), s.energy(x, xt, F)) < 1e-13
    g = ref.gradient(x, xt)
    assert float((s.gradient(x, xt, ~ref.free) - g).norm() / g.norm()) < 1e-13
    assert rel(ref.system_energy(x, xt)[0],
               s.system_energy(x, xt, s.sigma(F))) < 1e-13
    assert rel(ref.target, s.target_g_res(1e-5)) < 1e-13


def test_program_frames_are_correct(tmp_path):
    correct, failed, checks = judged(built_run(tmp_path))
    assert correct and failed == 0, checks


def test_run_cell_reads_system2d(tmp_path):
    """run.py's result on the CPU: its shapes read off System2D."""
    res = run.run_cell(tiny_cell(), SEED, 0.05, False, device="cpu",
                       work_dir=str(tmp_path), t_process=time.perf_counter())
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["device"]["platform"] == "cpu" and res["attempted"] >= 1
    assert {"frame_ms", "setup_s"} <= set(res["metrics"])


# fault -> (resolution, frames): the stepper faults leave a frame's
# gradient far above the tolerance only as the lap goes on (at full size
# they pass the limit from the lap's fifth frame on, PERF.md section 2),
# so they run 8 frames of a 1,143-vertex spikes
FAULT_RUNS = {"unchanged": (200, FRAMES), "moved_vertex": (200, FRAMES),
              "sys_e_altered": (200, FRAMES), "one_iteration": (2000, 8),
              "half_two_loop": (2000, 8)}


@pytest.mark.parametrize("fault", sorted(FAULT_RUNS))
def test_broken_path_is_not_correct(tmp_path, monkeypatch, fault):
    resolution, frames = FAULT_RUNS[fault]
    faults.plant(fault, monkeypatch.setattr)
    r = built_run(tmp_path, tiny_cell(frames, resolution))
    correct, failed, checks = judged(r, frames)
    assert correct is False and failed > 0, checks


@pytest.mark.parametrize("precision,correct", [("tf32", False),
                                               ("f32", True)])
def test_control(tmp_path, precision, correct):
    res = control.run_control(tiny_cell(), 7, 2, precision, "cpu",
                              work_dir=str(tmp_path))
    assert res["correct"] is correct, res["checks"]


def test_lap_replays_after_reset(tmp_path):
    r = built_run(tmp_path)
    r.window(float("inf"), max_frames=3 * FRAMES)
    laps = r.lap_summary()
    assert len(laps) == 3 and laps[0]["frames"] == FRAMES
    assert laps[0] == laps[1] == laps[2]
    e = [f["sys_e"] for f in r.frame_stats]
    assert e[:FRAMES] == e[FRAMES:2 * FRAMES] == e[2 * FRAMES:]
    xs = [x for _, x in r.records]
    assert all(torch.equal(xs[i], xs[i + FRAMES])
               for i in range(2 * FRAMES))


def test_system2d_states_its_h0_layout(tmp_path):
    s = built_run(tmp_path).sim.system
    assert (s.n_parts, s.n3) == (4, s.plan.n2)
    assert s.n3 % 64 == 0 and 2 * s.plan.n_local_max <= s.n3
    assert (s.banded, s.use_coarse, s.apply_dtype) == (False, False, None)
    cfg = Config(energy="FCR", shape="spikes", resolution=200)
    bare = System2D(Mesh2D.from_config(cfg), cfg, device="cpu")
    assert (bare.n_parts, bare.n3, bare.banded) == (0, 0, False)


def test_tracer_counts_a_dot_frame(tmp_path):
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
    assert count("frame") == 1 and count("rebuild_h0") == 1
    assert count("h0_apply") == count("solve_local") == st["iters"] > 0
    assert count("host_read") == st["syncs"]
    rebuild = {rec["id"] for rec in recs if rec["name"] == "rebuild_h0"}
    kids = {rec["name"] for rec in recs if rec["parent"] in rebuild}
    assert kids == {"element_hessians", "assemble", "h0_factor"}
    assert count("gradient") >= st["iters"]
    # the tracer changes nothing: the same frame untraced
    x_on = sim.state.x
    sim.state = start
    sim.run(1)
    assert torch.equal(sim.state.x, x_on)
