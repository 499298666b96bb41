"""The port's span tracer (dot_tpu_torch.tracing) on the CPU at
bar_mesh(8, 3, 3): off it records nothing; on it leaves every frame bit
for bit as it was; its spans nest by frame; the counts a frame match the
program's own (host_read = StepStats.syncs, two_loop = iterations,
rebuild_h0 once a DOT frame); every stepper opens its own spans; K31's
`schur_update` span is entered once a scan step of the chunked rebuild
and never by a cyclic-reduction rebuild or LBFGS-PD's factor; and
profiling.span_tree splits host time by span path."""

import dataclasses
import os

import pytest
import torch

from dot_tpu_torch import io as meshio
from dot_tpu_torch import partition, profiling, scripts, tracing
from dot_tpu_torch.config import Config
from dot_tpu_torch.mesh_gen import bar_mesh
from dot_tpu_torch.sim import Simulator
from dot_tpu_torch.steppers import System
from dot_tpu_torch.steppers.core import BTDFactor, CRFactor

FRAMES = 2


def _sim(tmp_path, stepper, warm=2, script="twist"):
    mesh = bar_mesh(8, 3, 3, size=(4.0, 1.0, 1.0))
    mp = os.path.join(tmp_path, "bar.msh")
    meshio.save_tet_mesh(mp, mesh.V, mesh.conn, mesh.SF)
    sp = os.path.join(tmp_path, "scene.txt")
    with open(sp, "w") as f:
        f.write(profiling.SCENE.format(stepper=stepper, warm=warm, mesh=mp)
                .replace("script twist", f"script {script}"))
    return Simulator(Config.load(sp), os.path.join(tmp_path, "out"),
                     dtype=torch.float64, device="cpu", mute=True,
                     save_every=10 ** 9)


def _traced(sim, frames=FRAMES):
    """Records of `frames` frames with the tracer on."""
    tracing.reset()
    tracing.enable()
    try:
        sim.run(frames)
    finally:
        tracing.disable()
    recs = tracing.records()
    tracing.reset()
    return recs


def _per_frame(recs, name):
    out = {}
    for r in recs:
        if r["name"] == name:
            out[r["frame"]] = out.get(r["frame"], 0) + 1
    return out


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def test_off_records_nothing(tmp_path):
    sim = _sim(tmp_path, "DOT 4")
    sim.run(1)
    assert tracing.records() == []
    with tracing.span("frame") as rec:
        assert rec is None
    assert tracing.records() == []


@pytest.mark.parametrize("stepper", ["DOT 4", "LBFGS"])
def test_on_leaves_frames_bit_for_bit(tmp_path, stepper):
    sim = _sim(tmp_path, stepper)
    start = dataclasses.replace(sim.state)
    sim.run(FRAMES)
    off_x, off_stats = sim.state.x, sim.frames[-FRAMES:]
    sim.state, sim.frame = dataclasses.replace(start), 0
    recs = _traced(sim)
    assert recs
    assert torch.equal(sim.state.x, off_x)
    on_stats = sim.frames[-FRAMES:]
    for a, b in zip(off_stats, on_stats):
        a, b = dict(a), dict(b)
        a.pop("seconds"), b.pop("seconds")
        assert a == b


@pytest.mark.parametrize("stepper", ["DOT 4", "LBFGS"])
def test_spans_nest_and_count_a_frame(tmp_path, stepper):
    sim = _sim(tmp_path, stepper)
    n0 = len(sim.frames)
    recs = _traced(sim)
    stats = sim.frames[n0:]
    by_id = {r["id"]: r for r in recs}
    frames = [r for r in recs if r["name"] == "frame"]
    assert [r["frame"] for r in frames] == list(range(FRAMES))
    assert all(r["parent"] is None for r in frames)
    steps = [r for r in recs if r["name"] == "step"]
    assert [by_id[r["parent"]]["name"] for r in steps] == ["frame"] * FRAMES
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        if r["name"] != "frame":
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
            assert r["frame"] == p["frame"]
    syncs = [s["syncs"] for s in stats]
    iters = [s["iters"] for s in stats]
    assert _per_frame(recs, "host_read") == dict(enumerate(syncs))
    assert _per_frame(recs, "two_loop") == dict(enumerate(iters))
    reads = [r for r in recs if r["name"] == "host_read"]
    assert all(0 <= r["wait_ns"] <= r["end_ns"] - r["start_ns"]
               for r in reads)
    if stepper == "DOT 4":
        assert _per_frame(recs, "rebuild_h0") == {i: 1
                                                   for i in range(FRAMES)}
        assert _per_frame(recs, "h0_apply") == dict(enumerate(iters))
        rebuild = {r["id"] for r in recs if r["name"] == "rebuild_h0"}
        kids = {r["name"] for r in recs if r["parent"] in rebuild}
        assert {"element_hessians", "assemble", "h0_factor"} <= kids
    else:
        assert _per_frame(recs, "pd_solve") == dict(enumerate(iters))
        assert "rebuild_h0" not in {r["name"] for r in recs}


# stepper line, warm start -> spans its frames must open
STEPPERS = {
    "GSDD 4": (2, {"gsdd_sweep", "subdomain_solve",
                   "line_search", "gradient", "rebuild_h0", "finish"}),
    "Newton": (2, {"newton_factor", "element_hessians", "assemble",
                   "h0_factor", "h0_apply", "line_search"}),
    "LBFGSH": (2, {"two_loop", "h0_apply", "rebuild_h0", "history"}),
    "LBFGSJH 4": (2, {"two_loop", "h0_apply", "rebuild_h0"}),
    "DOT 4 ws5": (5, {"hessian_diag", "two_loop", "rebuild_h0"}),
    "ADMM": (2, {"local_step", "pd_solve", "finish"}),
    "ADMMDD 4": (2, {"update_weights", "local_factor", "local_gradient",
                     "init_dual", "solve_local", "h0_factor", "finish"}),
}


@pytest.mark.parametrize("stepper", sorted(STEPPERS))
def test_every_stepper_opens_its_spans(tmp_path, stepper):
    warm, want = STEPPERS[stepper]
    sim = _sim(tmp_path, stepper.replace(" ws5", ""), warm=warm)
    n0 = len(sim.frames)
    recs = _traced(sim, 1)
    names = {r["name"] for r in recs}
    assert want <= names, want - names
    assert _per_frame(recs, "step") == {0: 1}
    assert _per_frame(recs, "host_read") == {0: sim.frames[n0]["syncs"]}


# case -> (bar cells, script, parts): the chunked rebuild forced on a
# 5-part bar (nb 4); a deep 2-part band that takes cyclic reduction (nb
# 11, as tests/test_torch_cr.py's); LBFGS-PD's factor on the first
SCHUR_CASES = {"chunked": ((24, 4, 4), "twist", 5),
               "cr": ((40, 3, 3), "stretch", 2),
               "pd_factor": ((24, 4, 4), "twist", 5)}


@pytest.mark.parametrize("case", sorted(SCHUR_CASES))
def test_schur_update_spans_a_rebuild(case):
    """f32: the chunked rebuild's bf16-SYRK scan enters `schur_update` nb - 1
    times (once a step, K31's launch); a cyclic-reduction rebuild and
    build_pd_factor (an exact scan) never do."""
    cells, script, parts = SCHUR_CASES[case]
    mesh = bar_mesh(*cells)
    cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script=script, handle_ratio=0.1)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = scripts.init_script(mesh, script)
    mesh.fixed_mask = sd.fixed0.copy()
    plan = partition.build_plan(mesh, parts, pad_elem_to=16, pad_n3_to=48,
                                band_bs_unit=48, band_min_nb=3)
    sysm = System(mesh, cfg, plan, dtype=torch.float32, device="cpu")
    sysm._chunk = True if case == "chunked" else None
    x = torch.as_tensor(sd.x0, dtype=torch.float32)
    fixed = torch.as_tensor(sd.fixed0)
    tracing.enable()
    if case == "pd_factor":
        fac, _ = sysm.build_pd_factor(fixed)
    else:
        _, fac, _, _ = sysm.rebuild_h0(x, fixed)
    tracing.disable()
    recs = tracing.records()
    n = sum(r["name"] == "schur_update" for r in recs)
    parents = {r["id"]: r["name"] for r in recs}
    if case == "chunked":
        assert isinstance(fac, BTDFactor)
        assert n == sysm.band_nb - 1 >= 2
        assert {parents[r["parent"]] for r in recs
                if r["name"] == "schur_update"} == {"h0_factor"}
    else:
        assert isinstance(fac, CRFactor if case == "cr" else BTDFactor)
        assert n == 0


def test_spans_nest_and_disable_closes_the_open_ones():
    class S:
        @tracing.span("h0_factor")
        def outer(self):
            return self.inner()

        @tracing.span("block_solve")
        def inner(self):
            return 3
    assert S().outer() == 3                  # off: straight through
    clock = tracing.enable()
    assert len(clock) == 2
    with tracing.span("frame"):
        assert S().outer() == 3
        with tracing.span("step"):
            clock_end = tracing.disable()
    # the pair at disable is read after the one at enable, on both clocks
    assert clock_end[0] > clock[0] and clock_end[1] >= clock[1]
    recs = tracing.records()
    assert [r["name"] for r in recs] == ["block_solve", "h0_factor", "step",
                                         "frame"]
    ids = {r["name"]: r["id"] for r in recs}
    assert [r["parent"] for r in recs] == [ids["h0_factor"], ids["frame"],
                                           ids["frame"], None]
    assert {r["frame"] for r in recs} == {0}


def test_span_tree_splits_total_and_self():
    recs = [
        {"name": "frame", "id": 0, "parent": None, "frame": 0,
         "start_ns": 0, "end_ns": 10_000_000, "wait_ns": 0},
        {"name": "step", "id": 1, "parent": 0, "frame": 0,
         "start_ns": 1_000_000, "end_ns": 9_000_000, "wait_ns": 0},
        {"name": "host_read", "id": 2, "parent": 1, "frame": 0,
         "start_ns": 2_000_000, "end_ns": 5_000_000, "wait_ns": 2_000_000},
        {"name": "host_read", "id": 3, "parent": 1, "frame": 0,
         "start_ns": 6_000_000, "end_ns": 7_000_000, "wait_ns": 500_000},
    ]
    lines = profiling.span_tree(recs, 1)
    assert [ln.split()[0] for ln in lines] == ["frame", "step", "host_read"]
    frame, step, read = ([float(t) for t in ln.replace(",", " ").split()
                          if t.replace(".", "").isdigit()] for ln in lines)
    assert frame == [10.0, 2.0, 1.0]
    assert step == [8.0, 4.0, 1.0]
    assert read == [4.0, 4.0, 2.0, 2.5]
