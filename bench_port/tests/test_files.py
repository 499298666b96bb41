"""Every file the benchmark finds by name loads, and each cell writes the
scene its configuration and traffic name."""

from __future__ import annotations

import importlib
import os
import re

import pytest

from bench_port.tests.conftest import BENCH, ROOT, load

BENCHMARK = load("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["bench_port"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCHMARK[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCHMARK["end_to_end"]} >= {"setup_s"}
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells


@pytest.mark.parametrize("cfg", BENCHMARK["configs"],
                         ids=lambda c: c["name"])
def test_config_file_loads(cfg):
    c = load(cfg["file"])
    assert c["name"] == cfg["name"] and c["source"] == cfg["source"]
    assert c["reduced"] == cfg["reduced"]
    importlib.import_module(f"bench_port.references.{c['reference']}")


@pytest.mark.parametrize("w", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_cell_writes_its_scene(w, tmp_path):
    from bench_port import driver
    cell = driver.load_cell(ROOT, w["name"])
    assert cell.chips == 1 and "setup_s" in cell.end_to_end
    assert cell.per_layer
    for n in cell.end_to_end + cell.per_layer:
        importlib.import_module(f"bench_port.metrics.{n}")
    scene = tmp_path / "scene.txt"
    driver.scene_kind(cell.config).write_scene(str(scene), cell.config, cell.traffic, "bar.msh")
    from dot_tpu_torch.config import Config
    got = Config.load(str(scene))
    sc = cell.config["scene_script"]
    assert got.time_stepper == cell.traffic["time_stepper"].split()[0]
    assert (got.energy, got.dt, got.ym, got.pr, got.rho, got.script) == (
        sc["energy"], sc["dt"], sc["youngs"], sc["poisson"], sc["density"],
        sc["script"])
    assert got.warm_start == cell.traffic["warm_start"]
    assert got.input_shape_path == "bar.msh"


def test_every_metric_file_declares_source_and_unit():
    units = {m["name"]: (m["unit"], m["source"])
             for k in ("end_to_end", "per_layer") for m in BENCHMARK[k]}
    files = sorted(f[:-3] for f in os.listdir(os.path.join(BENCH, "metrics"))
                   if f.endswith(".py") and f != "__init__.py")
    assert files == sorted(units)
    for n in files:
        m = importlib.import_module(f"bench_port.metrics.{n}")
        assert (m.UNIT, m.SOURCE) == units[n]


def test_bar_mesh_is_the_programs():
    import numpy as np
    from bench_port.scenes.bar import bar_mesh
    from dot_tpu_torch.mesh_gen import bar_mesh as program_bar_mesh
    for cells in ((3, 2, 2), (8, 3, 3), (5, 4, 3)):
        V, TT = bar_mesh(*cells, size=(4.0, 1.0, 1.0))
        m = program_bar_mesh(*cells, size=(4.0, 1.0, 1.0))
        assert np.array_equal(V, m.V) and np.array_equal(TT, m.conn)


def test_no_card_no_result(capsys):
    """A real run on a machine without a card exits 2 and prints no
    result: it never falls back to the CPU."""
    from bench_port import run
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "bar17-twist-dot6", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""
