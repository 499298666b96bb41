"""The traced run: spans around the calls into the program's layers,
recorded from the benchmark's own code, and the reduction of one
torch.profiler trace (device activity only) to what the per-layer metrics
read.

A span wraps methods of the Simulator's System or stepper (an instance
attribute over the class's method, taken off again after the lap) and
launches a marker kernel (torch.cuda._sleep(0): one empty spin kernel) at
each edge; two more mark the window. The program runs on one stream, so
the device work between a span's two markers is the span's own, whatever
the host's lead, and nothing synchronises. The profile records the
device's activity alone: recording the host's operators too slowed the
host loop by half and read its idle share high. Each idle gap of the
device is named by the span it falls in and the device operations before
and after it.

Each metric module names its spans (`SPANS`) and what the cell's path
must show of them (`needs`): a method that is missing, or a span entered
fewer times than the path calls it, fails the run (SpanMissing), so that
a renamed or rerouted method of the program cannot drop kernels out of a
span unseen.
"""

from __future__ import annotations

import collections
import dataclasses
import re

MARKER = "spin_kernel"
WINDOW = "window"
NOT_WORK = ("Synchronize", "Wait Event", "Overhead")


class TraceLost(RuntimeError):
    """The profile cannot be read: no device events, fewer kernels than
    the wrappers launched, or markers missing."""


class SpanMissing(RuntimeError):
    """A span's method is not on the program, or the lap entered a span
    fewer times than the cell's path calls it."""


@dataclasses.dataclass
class TraceData:
    kernels: int                 # device kernels in the window (no markers)
    span_s: dict                 # span -> device seconds of its kernels
    span_calls: dict             # span -> outermost calls
    busy_s: float                # union of device activity in the window
    window_s: float
    device_ops: list             # [[name, seconds]] top 10
    idle_gaps: list              # [[where, seconds]] top 10


class Tracer:
    def __init__(self, sim, spans):
        """`spans`: {span: [(owner, method)]}, owner "system" or
        "stepper"."""
        self.sim = sim
        self.spans = spans
        self.log = []                 # (span, +1 | -1) in launch order
        self.calls = collections.Counter()   # span -> outermost calls
        self._depth = collections.Counter()
        self._installed = []

    def mark(self, span, d):
        import torch
        self.log.append((span, d))
        torch.cuda._sleep(0)

    def install(self):
        where = {}
        for span, methods in self.spans.items():
            for m in methods:
                if where.setdefault(m, span) != span:
                    raise ValueError(f"{m} is in spans {where[m]} and {span}")
        for (owner_name, method), span in where.items():
            owner = (self.sim.system if owner_name == "system"
                     else self.sim.stepper)
            fn = getattr(owner, method, None)
            if fn is None:
                raise SpanMissing(f"{type(owner).__name__}.{method} (span "
                                  f"{span}) is not on the program")

            def wrapped(*a, _fn=fn, _span=span, **k):
                self.calls[_span] += self._depth[_span] == 0
                self._depth[_span] += 1
                self.mark(_span, 1)
                try:
                    return _fn(*a, **k)
                finally:
                    self.mark(_span, -1)
                    self._depth[_span] -= 1
            setattr(owner, method, wrapped)
            self._installed.append((owner, method))

    def uninstall(self):
        for owner, method in self._installed:
            delattr(owner, method)
        self._installed = []


def check_needs(needs, calls, units):
    """Raise SpanMissing unless every (span, per, at_least) of `needs`
    was called at least `at_least` times per `per`: "frame", "iter" (the
    counts in `units`) or another span's outermost calls."""
    for span, per, at_least in needs:
        n = units[per] if per in units else calls[per]
        if calls[span] < at_least * n:
            raise SpanMissing(f"span {span}: {calls[span]} calls for "
                              f"{n} x {per} (the path calls it at least "
                              f"{at_least} times each)")


def _device_kind(e, name):
    """"kernel", "memcpy", "memset" or None (an annotation or a wait that
    the trace draws on the device's line but that is no work of it)."""
    if any(w in name for w in NOT_WORK):
        return None
    if hasattr(e, "activity_type"):
        kind = str(e.activity_type()).lower()
        return next((k for k in ("kernel", "memcpy", "memset")
                     if k in kind), None)
    low = name.lower()
    return next((k for k in ("memcpy", "memset") if low.startswith(k)),
                "kernel")


def kineto_events(prof):
    """(device work [(name, start_ns, end_ns, kind)]: kernels, copies and
    fills; {name: count} of the device events left out)."""
    dev = []
    left_out = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        name = e.name()
        kind = _device_kind(e, name)
        if kind is None:
            left_out[name] += 1
        else:
            dev.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                        kind))
    return dev, dict(left_out.most_common(20))


def short(name):
    """A device operation's name without its template and argument lists
    and namespaces: "void dotk7::solve_kernel<...>(...)" -> "solve_kernel"."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name)[0].strip()
    return name.split("::")[-1] or name[:40]


def reduce_trace(dev, span_log, min_kernels):
    """TraceData of the window (between the two "window" markers) from
    the device work of one profile (kineto_events) and the markers' span
    log. Raises TraceLost where the profile cannot be read."""
    dev = sorted(dev, key=lambda d: d[1])
    marks = [d for d in dev if MARKER in d[0]]
    if len(marks) != len(span_log):
        raise TraceLost(f"{len(marks)} marker kernels for {len(span_log)} "
                        f"span edges in {len(dev)} device events (the "
                        f"first is {'a' if dev and dev[0] in marks else 'no'}"
                        f" marker, the last "
                        f"{'a' if dev and dev[-1] in marks else 'no'} marker)")
    edges = [m[1] for m, (span, _) in zip(marks, span_log) if span == WINDOW]
    if len(edges) != 2:
        raise TraceLost("the profile holds no window")
    ws, we = edges
    work = [d for d in dev if MARKER not in d[0] and ws < d[1] < we]
    kernels = sum(1 for d in work if d[3] == "kernel")
    if not work:
        raise TraceLost("the profile holds no device events")
    if kernels < min_kernels:
        raise TraceLost(f"the profile holds {kernels} device kernels; the "
                        f"wrappers launched at least {min_kernels}")
    opened = collections.Counter()
    stack = []
    span_s = collections.Counter()
    calls = collections.Counter()
    by_name = collections.Counter()
    idle = collections.Counter()
    busy = 0.0
    cur_s = cur_e = ws
    prev = "window start"
    log = iter(span_log)
    for name, s, e, _ in dev:
        if MARKER in name:
            span, d = next(log)
            if span == WINDOW:
                continue
            if d > 0:
                calls[span] += opened[span] == 0
                stack.append(span)
            elif span in stack:
                del stack[len(stack) - 1 - stack[::-1].index(span)]
            opened[span] += d
            continue
        if not ws < s < we:
            continue
        by_name[name] += (e - s) * 1e-9
        for span, c in opened.items():
            if c > 0:
                span_s[span] += (e - s) * 1e-9
        if s > cur_e:
            busy += (cur_e - cur_s) * 1e-9
            where = stack[-1] if stack else "loop"
            idle[f"{where}: {prev} -> {short(name)}"] += (s - cur_e) * 1e-9
            cur_s = s
        cur_e = max(cur_e, min(e, we))
        prev = short(name)
    busy += (cur_e - cur_s) * 1e-9
    if we > cur_e:
        idle[f"loop: {prev} -> window end"] += (we - cur_e) * 1e-9
    top = lambda c: [[k, v] for k, v in c.most_common(10)]
    return TraceData(kernels=kernels, span_s=dict(span_s),
                     span_calls=dict(calls), busy_s=busy,
                     window_s=(we - ws) * 1e-9, device_ops=top(by_name),
                     idle_gaps=top(idle))
