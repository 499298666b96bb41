"""Runs of the harness on the CPU at bar_mesh(8, 3, 3): the lap replays
exactly after a reset, the comparison passes the program's frames and
fails the TF32 control and a run with the timed path broken underneath
(faults.py; the look for a card skipped: run_cell on device "cpu")."""

from __future__ import annotations

import time

import pytest
import torch

from bench_port import control, driver, faults, run
from bench_port.scenes import bar


def _run(cell, seconds=1.5, seed=2 ** 40 + 3, tmp=None):
    return run.run_cell(cell, seed, seconds, False, device="cpu",
                        work_dir=str(tmp), t_process=time.perf_counter())


def test_lap_replays_after_reset(tiny_cell, tmp_path):
    cell = tiny_cell()
    r = driver.Run(cell, 12345, "cpu", str(tmp_path))
    r.build(time.perf_counter())
    r.window(float("inf"), max_frames=3 * cell.traffic["lap_frames"])
    laps = r.lap_summary()
    assert len(laps) == 3 and laps[0]["frames"] == 4
    assert laps[0] == laps[1] == laps[2]
    e = [f["sys_e"] for f in r.frame_stats]
    assert e[:4] == e[4:8] == e[8:]
    xs = [x for _, x in r.records]
    assert all(torch.equal(xs[i], xs[i + 4]) for i in range(8))


def test_seeds_change_the_numbers_not_the_mesh(tiny_cell, tmp_path):
    x0 = torch.rand(5, 3, generator=torch.Generator().manual_seed(0))
    fixed = torch.tensor([True, False, False, False, True])
    v1 = bar.seed_velocity(1, x0, fixed, 1e-3)
    v2 = bar.seed_velocity(2 ** 33 + 1, x0, fixed, 1e-3)
    assert torch.equal(v1, bar.seed_velocity(1, x0, fixed, 1e-3))
    assert not torch.equal(v1, v2)
    assert v1[fixed].abs().max() == 0 and v1.abs().max() <= 1e-3


TINY = {"dot6": ("dot6", "DOT 4", "bar17-twist-dot6"),
        "lbfgspd": ("lbfgspd", "LBFGS", "bar17-twist-lbfgspd")}


@pytest.mark.parametrize("traffic,stepper", [("dot6", "DOT 4"),
                                             ("lbfgspd", "LBFGS")])
def test_program_passes(tiny_cell, tmp_path, traffic, stepper):
    res = _run(tiny_cell(*TINY[traffic]), tmp=tmp_path)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["device"]["platform"] == "cpu"
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}


@pytest.mark.parametrize("precision,correct", [("tf32", False),
                                               ("f32", True)])
def test_control(tiny_cell, tmp_path, precision, correct):
    res = control.run_control(tiny_cell(), 7, 2, precision, "cpu",
                              work_dir=str(tmp_path))
    assert res["correct"] is correct, res["checks"]


# the faults the comparison has to catch, each on a tiny cell whose path
# it breaks as it breaks the cell's at full size (PERF.md section 2):
# identity_h0 leaves DOT's answers within the sound ones (L-BFGS recovers
# in 70-140 iterations) and half_two_loop reads under the limit at DOT's
# tiny size, so those two are planted on LBFGS-PD
@pytest.mark.parametrize("fault,traffic", [
    ("unchanged", "dot6"), ("moved_vertex", "dot6"),
    ("sys_e_altered", "dot6"), ("half_elements", "dot6"),
    ("one_iteration", "dot6"), ("one_iteration", "lbfgspd"),
    ("identity_h0", "lbfgspd"), ("half_two_loop", "lbfgspd")])
def test_broken_path_is_not_correct(tiny_cell, tmp_path, monkeypatch, fault,
                                    traffic):
    faults.plant(fault, monkeypatch.setattr)
    res = _run(tiny_cell(*TINY[traffic]), tmp=tmp_path)
    assert res["correct"] is False and res["failed"] > 0, res["checks"]
