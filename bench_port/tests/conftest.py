"""Shared pieces of the benchmark's own tests (CPU, small sizes):
    python -m pytest bench_port/tests -q
"""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def load(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


@pytest.fixture
def tiny_cell():
    """bar17-twist-dot6 on bar_mesh(8, 3, 3) under DOT 4, laps of 4
    frames, under `script`: the cell's limits, scene and traffic
    otherwise."""
    from bench_port import driver

    def make(traffic="dot6", stepper="DOT 4", workload="bar17-twist-dot6",
             script="twist"):
        cfg = copy.deepcopy(load("bench_port/configs/bar17-twist.json"))
        cfg["name"] = "tiny"
        cfg["scene_script"]["script"] = script
        cfg["mesh"]["cells"] = [8, 3, 3]
        tr = copy.deepcopy(load(f"bench_port/traffic/{traffic}.json"))
        tr["time_stepper"] = stepper
        tr["lap_frames"] = 4
        return driver.Cell(workload=workload, config=cfg, traffic=tr,
                           limits=load(f"bench_port/limits/{workload}.json"),
                           end_to_end=["frame_ms", "frame_ms_p95", "setup_s"],
                           per_layer=[])
    return make
