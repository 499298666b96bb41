"""The traced lap's idle gaps put down to the program's own spans
(dot_tpu_torch.tracing), on the profile's clock.

The traced lap (run.py) profiles the device and the host's CUDA runtime
calls (torch.profiler's CUDA activity: each device operation shares a
correlation id with the runtime call that issued it). This module
switches the program's tracer on at the window's first marker and off
at its last, keeps each operation's correlation id and the runtime
records when run.py reads the profile (tracing.kineto_events), and after
tracing.reduce_trace has read the window it walks the same window over
the same union of device activity and puts each idle gap (a, b) into
one class:
- after_read: the operation that ended at `a` is a device-to-host copy
  whose runtime call lies in a `host_read` span: a sync's cost, the
  drain and the host's Python until the next launch;
- host_loop: the operation starting at `b` was launched while the
  innermost open span was stepper code (STEPPER);
- in_system: ... while it was a System method (any other span);
- outside: ... while no span was open (the harness, the lap reset).
The program's records are mapped onto the profile's Unix clock by the two
(perf_counter_ns, time_ns) pairs the tracer read when it was switched on
and off, the offset interpolated between them. The clock check holds
every device-to-host copy's runtime call inside the host_read span that
issued it, to within MISS_LIMIT_NS. A failed check, or classes that do
not add up to the window's idle time within SUM_TOLERANCE of the window
(a gap whose launch lost its runtime record goes to no class), fail the
split alone: the three idle_* metrics that read it read nothing, and
reduce_trace's result, which the other metrics read, stands.

run.py and tracing.py predate the program's tracer: attach() wraps the
three calls of tracing.py that run.py makes in its traced lap
(Tracer.mark, kineto_events, reduce_trace; run.py looks each up when it
calls it) and leaves their results as they were. The four metrics call
it from needs(), which run.py calls before the traced lap, and detach()
from read(), after it; --trace 0 imports none of them. On a program
without dot_tpu_torch.tracing it attaches nothing and the metrics read
nothing.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import importlib
import sys

from bench_port import tracing

# the innermost spans that are stepper code (the frame loop included);
# every other span of the program is a System method
STEPPER = frozenset({"frame", "step", "two_loop", "line_search", "history",
                     "finish", "gsdd_sweep", "newton_factor", "local_step",
                     "local_factor", "local_gradient", "init_dual",
                     "update_weights"})
CLASSES = ("after_read", "host_loop", "in_system", "outside")
SUM_TOLERANCE = 0.005          # of the window
# how far a copy's runtime call may lie outside the host_read span that
# issued it (ns, after the mapping); PERF.md gives the readings behind it
MISS_LIMIT_NS = 5_000


@dataclasses.dataclass
class Split:
    idle_s: dict                 # class -> seconds of the window
    by_path: list                # [[class: span path, seconds]] top 10
    offset_ns: int               # Unix ns - perf_counter_ns at enable
    drift_ns: int                # the offset at disable less at enable
    reads: int                   # device-to-host copies in the window
    max_miss_ns: int             # farthest a copy's call lies outside
    min_slack_ns: int            # least room a copy's call left inside
    unlinked_s: float = 0.0      # gaps whose launch has no runtime record


@dataclasses.dataclass
class Lap:
    clock: tuple = None          # (perf_counter_ns, time_ns) at enable,
                                 # then at disable
    records: list = None         # the program's span records
    ops: list = None             # [(name, start, end, kind, correlation)]
    runtime: dict = None         # correlation -> (name, start, end)
    split: Split = None
    error: str = None            # why the split failed


LAP = Lap()
_SAVED = {}                      # what attach() replaced, by name


def attach():
    """Wrap run.py's three calls into tracing.py until detach(), where the
    program has its tracer."""
    global LAP
    if _SAVED:
        return
    try:
        prog = importlib.import_module("dot_tpu_torch.tracing")
    except ImportError:
        return
    LAP = Lap()
    mark, kineto_events, reduce_trace = (tracing.Tracer.mark,
                                         tracing.kineto_events,
                                         tracing.reduce_trace)
    _SAVED.update(mark=mark, kineto_events=kineto_events,
                  reduce_trace=reduce_trace)

    def traced_mark(self, span, d):
        if span == tracing.WINDOW and d < 0:
            LAP.clock += prog.disable()
            LAP.records = prog.records()
        mark(self, span, d)
        if span == tracing.WINDOW and d > 0:
            LAP.records = LAP.ops = LAP.runtime = LAP.split = None
            LAP.error = None
            prog.reset()
            LAP.clock = prog.enable()

    def traced_kineto_events(prof):
        out = kineto_events(prof)
        if LAP.records is not None:
            LAP.ops, LAP.runtime = profile_events(prof)
        return out

    def traced_reduce_trace(dev, span_log, min_kernels):
        tr = reduce_trace(dev, span_log, min_kernels)
        if LAP.ops is not None:
            try:
                LAP.split = split(LAP.ops, span_log, LAP.runtime,
                                  LAP.records, LAP.clock,
                                  tr.window_s - tr.busy_s)
            except tracing.TraceLost as e:
                LAP.error = str(e)
                print(f"host spans: the split failed, the idle_* metrics "
                      f"read nothing: {e}", file=sys.stderr, flush=True)
        return tr

    tracing.Tracer.mark = traced_mark
    tracing.kineto_events = traced_kineto_events
    tracing.reduce_trace = traced_reduce_trace


def detach():
    """Put back what attach() replaced; the lap's records stay in LAP."""
    if _SAVED:
        tracing.Tracer.mark = _SAVED.pop("mark")
        tracing.kineto_events = _SAVED.pop("kineto_events")
        tracing.reduce_trace = _SAVED.pop("reduce_trace")


def needs(shapes):
    """The metrics' `needs` (run.py calls it before the traced lap): the
    spans are the program's, checked by `check` after the lap, so none of
    the harness's; attaches for the lap."""
    attach()
    return []


def profile_events(prof):
    """(the device work as tracing.kineto_events keeps it, with each
    operation's correlation id; {correlation: (name, start_ns, end_ns)}
    of the host's CUDA runtime and driver calls)."""
    ops, runtime = [], {}
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        if str(e.device_type()).endswith("CUDA"):
            kind = tracing._device_kind(e, name)
            if kind is not None:
                ops.append((name, s, s + e.duration_ns(), kind,
                            e.correlation_id()))
        elif name.startswith("cu"):
            runtime[e.correlation_id()] = (name, s, s + e.duration_ns())
    return ops, runtime


def _is_read(op):
    return op[3] == "memcpy" and "DtoH" in op[0]


def split(ops, span_log, runtime, records, clock, idle_s):
    """Split of the window's idle time (reduce_trace's `idle_s`, the
    window less its busy union) into CLASSES; see the module's doc.
    `clock`: (perf_counter_ns, time_ns) at enable, then at disable."""
    pc0, u0, pc1, u1 = clock
    off, drift = u0 - pc0, (u1 - pc1) - (u0 - pc0)
    rate = drift / (pc1 - pc0) if pc1 > pc0 else 0.0
    unix = lambda t: t + off + round(rate * (t - pc0))
    # by start, a parent before the children it opened at the same ns
    spans = sorted(((unix(r["start_ns"]), unix(r["end_ns"]), r)
                    for r in records), key=lambda sp: (sp[0], sp[2]["id"]))
    starts = [s for s, _, _ in spans]
    at = {r["id"]: (s, e, r) for s, e, r in spans}

    def innermost(t):
        i = bisect.bisect_right(starts, t) - 1
        cur = spans[i] if i >= 0 else None
        while cur is not None and cur[1] < t:
            cur = at.get(cur[2]["parent"])
        return cur

    def path(span):
        names = []
        while span is not None:
            names.append(span[2]["name"])
            span = at.get(span[2]["parent"])
        return "/".join(names[::-1])

    ops = sorted(ops, key=lambda o: o[1])
    marks = [o for o in ops if tracing.MARKER in o[0]]
    if len(marks) != len(span_log):
        raise tracing.TraceLost(f"{len(marks)} marker kernels for "
                                f"{len(span_log)} span edges")
    edges = [m for m, (span, _) in zip(marks, span_log)
             if span == tracing.WINDOW]
    if len(edges) != 2:
        raise tracing.TraceLost("the profile holds no window")
    ws, we = edges[0][1], edges[1][1]

    # the clock check: each copy's runtime call in the host_read span
    # nearest it, to within MISS_LIMIT_NS
    host_reads = [sp for sp in spans if sp[2]["name"] == "host_read"]
    read_starts = [s for s, _, _ in host_reads]
    read_of = {}                       # correlation -> its host_read
    n_reads, max_miss, min_slack = 0, 0, None
    for op in ops:
        if not (_is_read(op) and ws < op[1] < we):
            continue
        n_reads += 1
        if op[4] not in runtime:
            continue
        _, s, e = runtime[op[4]]
        i = bisect.bisect_right(read_starts, s)
        near = host_reads[max(i - 1, 0):i + 1]
        if not near:
            raise tracing.TraceLost("a device-to-host copy in a lap "
                                    "without host_read spans")
        # (ns outside the read, minus the room left inside it)
        miss, room, h = min((max(hs - s, e - he, 0), -min(s - hs, he - e),
                             k) for k, (hs, he, _) in enumerate(near))
        max_miss = max(max_miss, miss)
        if miss == 0:
            min_slack = -room if min_slack is None else min(min_slack, -room)
        if miss <= MISS_LIMIT_NS:
            read_of[op[4]] = near[h]

    idle = dict.fromkeys(CLASSES, 0)
    unlinked = []                      # gaps whose launch has no record
    by_path = collections.Counter()

    def gap(a, b, prev, nxt):
        if prev is not None and prev[4] in read_of:
            idle["after_read"] += b - a
            by_path[f"after_read: {path(read_of[prev[4]])}"] += b - a
            return
        if nxt[4] not in runtime:      # counts against SUM_TOLERANCE
            unlinked.append(b - a)
            return
        r = innermost(runtime[nxt[4]][1])
        cls = ("outside" if r is None else
               "host_loop" if r[2]["name"] in STEPPER else "in_system")
        idle[cls] += b - a
        by_path[f"{cls}: {path(r) if r else '-'}"] += b - a

    cur_e, last = ws, None
    for op in ops:
        name, s, e = op[:3]
        if tracing.MARKER in name or not ws < s < we:
            continue
        if s > cur_e:
            gap(cur_e, s, last, op)
        if min(e, we) > cur_e:
            cur_e, last = min(e, we), op
    if we > cur_e:
        gap(cur_e, we, last, edges[1])
    result = Split(idle_s={k: v * 1e-9 for k, v in idle.items()},
                   by_path=[[k, v * 1e-9] for k, v in by_path.most_common(10)],
                   offset_ns=off, drift_ns=drift, reads=n_reads,
                   max_miss_ns=max_miss,
                   min_slack_ns=min_slack if min_slack is not None else 0,
                   unlinked_s=sum(unlinked) * 1e-9)
    log(result, (we - ws) * 1e-9)
    got = sum(idle.values()) * 1e-9
    if abs(got - idle_s) > SUM_TOLERANCE * (we - ws) * 1e-9:
        raise tracing.TraceLost(f"idle classes add up to {got!r} s, the "
                                f"window's idle time is {idle_s!r} s "
                                f"({len(unlinked)} gaps, {sum(unlinked)} "
                                f"ns, lost their launch's record)")
    if max_miss > MISS_LIMIT_NS:
        raise tracing.TraceLost(f"a device-to-host copy's runtime call lies "
                                f"{max_miss / 1e3:.3f} us outside its "
                                f"host_read span (clock offset {off} ns, "
                                f"drift {drift} ns)")
    return result


def log(sp, window_s):
    p = lambda *a: print(*a, file=sys.stderr, flush=True)
    p(f"host spans: clock offset {sp.offset_ns} ns (Unix - perf_counter) "
      f"at enable, drift {sp.drift_ns} ns to disable ({window_s!r} s "
      f"window); {sp.reads} device-to-host copies, the largest miss "
      f"{sp.max_miss_ns / 1e3:.3f} us outside their host_read span "
      f"(limit {MISS_LIMIT_NS / 1e3:.3f}), the least room inside "
      f"{sp.min_slack_ns / 1e3:.3f} us")
    p("host spans: idle (s) " + ", ".join(f"{k} {v!r}"
                                           for k, v in sp.idle_s.items())
      + f"; unlinked {sp.unlinked_s!r}")
    for k, v in sp.by_path:
        p(f"host spans: {v * 1e3:.3f} ms {k}")


def check(ctx, needs):
    """Raise tracing.SpanMissing unless the traced frames show what
    `needs` names: "host_read" (one span a StepStats.syncs), "two_loop"
    (one an iteration, on the quasi-Newton steppers), "rebuild_h0" (once
    a DOT frame)."""
    stats = ctx.frame_stats
    want = {"host_read": [f["syncs"] for f in stats]}
    if ctx.shapes["stepper"] in ("DOT", "LBFGSPD"):
        want["two_loop"] = [f["iters"] for f in stats]
    if ctx.shapes["stepper"] == "DOT":
        want["rebuild_h0"] = [1] * len(stats)
    for name in needs:
        if name not in want:
            continue
        n = collections.Counter(r["frame"] for r in LAP.records
                                if r["name"] == name)
        got = [n[i] for i in range(len(stats))]
        if got != want[name]:
            bad = next(i for i, (g, w) in enumerate(zip(got, want[name]))
                       if g != w)
            raise tracing.SpanMissing(
                f"span {name}: {got[bad]} in traced frame {bad}, the "
                f"program's count is {want[name][bad]}")


def records(ctx, needs):
    """The lap's span records after `check`, or None where the program
    records no spans."""
    detach()
    if LAP.records is None:
        return None
    check(ctx, needs)
    return LAP.records


def lap(ctx, needs):
    """The lap's split after `check`, or None where the program records
    no spans or the split failed (its error is on stderr)."""
    return None if records(ctx, needs) is None else LAP.split
