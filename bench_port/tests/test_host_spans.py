"""host_spans.py on synthetic profiles: each idle gap of the window goes
to one class by the program's spans around the runtime calls, the clock
check catches a copy outside its read, classes that do not add up are a
lost trace, and the four metrics read the split and the program's
counts."""

from __future__ import annotations

import importlib
import types

import pytest

from bench_port import host_spans, tracing


@pytest.fixture(autouse=True)
def _restore(monkeypatch):
    """Whatever a test attaches is undone after it."""
    monkeypatch.setattr(tracing.Tracer, "mark", tracing.Tracer.mark)
    monkeypatch.setattr(tracing, "kineto_events", tracing.kineto_events)
    monkeypatch.setattr(tracing, "reduce_trace", tracing.reduce_trace)
    monkeypatch.setattr(host_spans, "_SAVED", {})
    monkeypatch.setattr(host_spans, "LAP", host_spans.Lap())

M = "at::cuda::(anonymous namespace)::spin_kernel(long)"
DTOH = "Memcpy DtoH (Device -> Pageable)"
OFF = 1_000_000          # Unix ns - perf_counter_ns of the synthetic lap
CLOCK = (5, 5 + OFF, 10_000, 10_000 + OFF)     # at enable, at disable


def rec(i, name, parent, start, end, wait=0, frame=0):
    """A program span record on perf_counter_ns (Unix ns - OFF)."""
    return {"name": name, "id": i, "parent": parent, "frame": frame,
            "start_ns": start - OFF, "end_ns": end - OFF, "wait_ns": wait}


# device operations (name, start, end, kind, correlation) on the Unix
# clock and the runtime call (name, start, end) that launched each
OPS = [(M, 0, 1, "kernel", 1), ("a", 10, 50, "kernel", 2),
       (DTOH, 60, 70, "memcpy", 3), ("b", 200, 250, "kernel", 4),
       ("c", 300, 400, "kernel", 5), ("d", 450, 500, "kernel", 6),
       (M, 1000, 1001, "kernel", 7)]
RUNTIME = {1: ("cudaLaunchKernel", 0, 1), 2: ("cudaLaunchKernel", 5, 8),
           3: ("cudaMemcpyAsync", 55, 80), 4: ("cudaLaunchKernel", 150, 160),
           5: ("cuLaunchKernelEx", 290, 295),
           6: ("cudaLaunchKernel", 440, 445),
           7: ("cudaLaunchKernel", 990, 995)}
# frame > step > {host_read, two_loop > h0_apply, line_search}; the
# harness launches the end marker after the frame
RECORDS = [rec(0, "frame", None, 2, 600), rec(1, "step", 0, 3, 590),
           rec(2, "host_read", 1, 50, 100, wait=20),
           rec(3, "two_loop", 1, 140, 400), rec(4, "h0_apply", 3, 280, 350),
           rec(5, "line_search", 1, 420, 580)]
LOG = [("window", 1), ("window", -1)]
IDLE = (10 + 10 + 130 + 50 + 50 + 500) * 1e-9


def test_each_gap_goes_to_one_class():
    sp = host_spans.split(OPS, LOG, RUNTIME, RECORDS, CLOCK, IDLE)
    ns = 1e-9
    # window start -> a: launched in step; a -> the copy: in host_read;
    # the copy's gap: after a read; c in h0_apply (a System span); d in
    # line_search; the tail: outside
    assert sp.idle_s == pytest.approx({"after_read": 130 * ns,
                                       "host_loop": (10 + 50) * ns,
                                       "in_system": (10 + 50) * ns,
                                       "outside": 500 * ns})
    assert dict(sp.by_path) == pytest.approx({
        "outside: -": 500 * ns, "after_read: frame/step/host_read": 130 * ns,
        "in_system: frame/step/two_loop/h0_apply": 50 * ns,
        "host_loop: frame/step/line_search": 50 * ns,
        "host_loop: frame/step": 10 * ns,
        "in_system: frame/step/host_read": 10 * ns})
    assert sp.offset_ns == OFF and sp.drift_ns == 0
    assert sp.reads == 1 and sp.max_miss_ns == 0
    assert sp.min_slack_ns == 5      # the call [55, 80] in the read [50, 100]


def test_the_busy_union_sets_the_gaps():
    # an operation that overlaps its predecessor closes no gap; the gap
    # after the overlap is the later end's
    ops = OPS[:2] + [("a2", 20, 90, "kernel", 8)] + OPS[3:]
    runtime = {**RUNTIME, 8: ("cudaLaunchKernel", 9, 9)}
    sp = host_spans.split(ops, LOG, runtime, RECORDS, CLOCK,
                          (10 + 110 + 50 + 50 + 500) * 1e-9)
    assert sp.idle_s["after_read"] == 0
    assert sp.idle_s["host_loop"] == pytest.approx((10 + 110 + 50) * 1e-9)


def test_a_copy_outside_its_read_is_a_lost_trace(monkeypatch):
    monkeypatch.setattr(host_spans, "MISS_LIMIT_NS", 20)
    runtime = {**RUNTIME, 3: ("cudaMemcpyAsync", 55, 130)}
    with pytest.raises(tracing.TraceLost, match="0.030 us outside"):
        host_spans.split(OPS, LOG, runtime, RECORDS, CLOCK, IDLE)
    # the same lap read with a clock 40 ns off misses too
    clock = (5, 5 + OFF + 40, 10_000, 10_000 + OFF + 40)
    with pytest.raises(tracing.TraceLost, match="outside its host_read"):
        host_spans.split(OPS, LOG, RUNTIME, RECORDS, clock, IDLE)
    # a miss within the limit passes, and its gap is still after the read
    runtime = {**RUNTIME, 3: ("cudaMemcpyAsync", 55, 115)}
    sp = host_spans.split(OPS, LOG, runtime, RECORDS, CLOCK, IDLE)
    assert sp.max_miss_ns == 15
    assert sp.idle_s["after_read"] == pytest.approx(130e-9)


def test_the_offset_is_interpolated_between_the_two_pairs():
    # perf_counter runs at half the Unix clock's rate: the offset grows by
    # 1000 ns over 1000 ns of perf_counter (Unix = 2 t + OFF). The same
    # lap at twice the times, its records on that clock, splits alike.
    clock = (0, OFF, 1000, OFF + 2000)
    ops = [op[:1] + (2 * op[1], 2 * op[2]) + op[3:] for op in OPS]
    runtime = {k: (n, 2 * s, 2 * e) for k, (n, s, e) in RUNTIME.items()}
    records = [dict(r, start_ns=r["start_ns"] + OFF // 2,
                    end_ns=r["end_ns"] + OFF // 2) for r in RECORDS]
    sp = host_spans.split(ops, LOG, runtime, records, clock, 2 * IDLE)
    want = host_spans.split(OPS, LOG, RUNTIME, RECORDS, CLOCK, IDLE)
    assert sp.drift_ns == 1000 and sp.max_miss_ns == 0
    assert sp.idle_s == pytest.approx({k: 2 * v
                                       for k, v in want.idle_s.items()})
    # read with the first pair alone, the records land far from the copies
    with pytest.raises(tracing.TraceLost):
        host_spans.split(ops, LOG, runtime, records,
                         (0, OFF, 1000, OFF + 1000), 2 * IDLE)


def test_classes_that_do_not_add_up_are_a_lost_trace():
    with pytest.raises(tracing.TraceLost, match="add up"):
        host_spans.split(OPS, LOG, RUNTIME, RECORDS, CLOCK, IDLE * 1.2)
    # a gap whose launch lost its record (c's: 50 ns) goes to no class,
    # within the tolerance (5 ns of a 1000 ns window) or not
    runtime = {k: v for k, v in RUNTIME.items() if k != 5}
    with pytest.raises(tracing.TraceLost, match="1 gaps, 50 ns"):
        host_spans.split(OPS, LOG, runtime, RECORDS, CLOCK, IDLE)
    ops = [op if op[0] != "c" else ("c", 253, 400, "kernel", 5)
           for op in OPS]
    sp = host_spans.split(ops, LOG, runtime, RECORDS, CLOCK, IDLE - 47e-9)
    assert sp.unlinked_s == pytest.approx(3e-9)
    with pytest.raises(tracing.TraceLost, match="marker"):
        host_spans.split(OPS, LOG + [("x", 1)], RUNTIME, RECORDS, CLOCK,
                         IDLE)


def test_split_agrees_with_reduce_trace():
    dev = [op[:4] for op in OPS]
    tr = tracing.reduce_trace(dev, LOG, 4)
    sp = host_spans.split(OPS, LOG, RUNTIME, RECORDS, CLOCK,
                          tr.window_s - tr.busy_s)
    assert sum(sp.idle_s.values()) == pytest.approx(tr.window_s - tr.busy_s)


def _ctx(stepper, iters, syncs, frames=1):
    stats = [{"iters": iters, "syncs": syncs}] * frames
    return types.SimpleNamespace(frames=frames, frame_stats=stats,
                                 shapes={"stepper": stepper})


@pytest.fixture
def lap(monkeypatch):
    sp = host_spans.split(OPS, LOG, RUNTIME, RECORDS, CLOCK, IDLE)
    monkeypatch.setattr(host_spans, "LAP", host_spans.Lap(
        clock=CLOCK, records=RECORDS, split=sp))
    return sp


def metric(name):
    return importlib.import_module(f"bench_port.metrics.{name}")


def test_metrics_read_the_split_and_the_counter(lap):
    ctx = _ctx("LBFGSPD", iters=1, syncs=1)
    assert metric("host_read_wait_ms").read(ctx) == pytest.approx(20e-6)
    assert metric("idle_after_read_ms").read(ctx) == pytest.approx(130e-6)
    assert metric("idle_host_loop_ms").read(ctx) == pytest.approx(60e-6)
    assert metric("idle_in_system_ms").read(ctx) == pytest.approx(60e-6)


@pytest.mark.parametrize("name,ctx,match", [
    ("host_read_wait_ms", _ctx("LBFGSPD", 1, 2), "host_read: 1"),
    ("idle_host_loop_ms", _ctx("DOT", 2, 1), "two_loop: 1"),
    ("idle_in_system_ms", _ctx("DOT", 1, 1), "rebuild_h0: 0"),
])
def test_metrics_hold_the_path(lap, name, ctx, match):
    with pytest.raises(tracing.SpanMissing, match=match):
        metric(name).read(ctx)


def test_metrics_read_nothing_without_program_spans(monkeypatch):
    monkeypatch.setattr(host_spans, "LAP", host_spans.Lap())
    for n in ("host_read_wait_ms", "idle_after_read_ms", "idle_host_loop_ms",
              "idle_in_system_ms"):
        assert metric(n).read(_ctx("DOT", 1, 1)) is None


def _lap(t, prog):
    """A window of one `frame` span through the harness's marks."""
    t.mark(tracing.WINDOW, 1)
    assert prog._on and len(host_spans.LAP.clock) == 2
    with prog.span("frame"):
        pass
    t.mark(tracing.WINDOW, -1)
    assert not prog._on and len(host_spans.LAP.clock) == 4


def test_needs_attaches_for_the_lap_and_read_detaches(monkeypatch):
    from dot_tpu_torch import tracing as prog
    mark = tracing.Tracer.mark
    monkeypatch.setattr("torch.cuda._sleep", lambda n: None)
    t = tracing.Tracer(types.SimpleNamespace(system=None, stepper=None), {})
    assert metric("idle_host_loop_ms").needs({"stepper": "DOT"}) == []
    assert tracing.Tracer.mark is not mark
    try:
        _lap(t, prog)
        assert [r["name"] for r in host_spans.LAP.records] == ["frame"]
        assert t.log == LOG
        ctx = _ctx("DOT", 0, 0)
        ctx.frame_stats = []
        assert metric("idle_host_loop_ms").read(ctx) is None   # no split
        assert tracing.Tracer.mark is mark and not host_spans._SAVED
        # detached: a later window leaves the program's tracer off
        t.mark(tracing.WINDOW, 1)
        assert not prog._on
    finally:
        prog.disable()
        prog.reset()


def test_a_failed_split_leaves_reduce_trace_whole(monkeypatch, capsys):
    from dot_tpu_torch import tracing as prog
    monkeypatch.setattr("torch.cuda._sleep", lambda n: None)
    host_spans.attach()
    t = tracing.Tracer(types.SimpleNamespace(system=None, stepper=None), {})
    try:
        _lap(t, prog)
    finally:
        prog.disable()
        prog.reset()
    # the profile lost the end marker: reduce_trace reads its own markers
    # (all there), the split sees one fewer and fails alone
    host_spans.LAP.ops, host_spans.LAP.runtime = OPS[:-1], RUNTIME
    dev = [op[:4] for op in OPS]
    tr = tracing.reduce_trace(dev, LOG, 4)
    assert tr.window_s == pytest.approx(1000e-9)
    assert host_spans.LAP.split is None
    assert "1 marker kernels for 2" in host_spans.LAP.error
    assert "the split failed" in capsys.readouterr().err
    assert metric("idle_after_read_ms").read(_ctx("DOT", 0, 0, 0)) is None
