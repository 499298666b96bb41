"""Host-side spans at the port's layer boundaries, off by default.

    with tracing.span("history"):     # a block
        ...

    @tracing.span("h0_apply")         # a method or function
    def h0_apply(self, ...): ...

    clock = tracing.enable()   # (perf_counter_ns, time_ns) read together
    ...                        # frames
    clock_end = tracing.disable()   # the same pair at the end
    recs = tracing.records()

A record is a dict: name, id, parent (the id of the innermost span open
when it opened, None at the top), frame (the index of the enclosing
`frame` span since the last reset, None outside one), start_ns and end_ns
(time.perf_counter_ns), and wait_ns (a counter the span's code sets:
`host_read` stores the ns it spent blocked in the read). The pairs
enable() and disable() return map perf_counter_ns onto the Unix clock of
torch.profiler's events.

Off, a span site costs one check of a module global: a block's
__enter__ / __exit__ return at once, a decorated call goes straight
through. On, it appends to in-memory lists. Either way it never
synchronises, launches, allocates device memory or reads a tensor.
"""

from __future__ import annotations

import functools
import time

_on = False
_stack = []          # open records, innermost last
_records = []        # finished records, in the order they ended
_frames = 0          # `frame` spans opened since the last reset
_next_id = 0


class span:
    """A span named `name`: `with span(name) as rec:` (rec is the open
    record, None while tracing is off) or `@span(name)` on a function."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return _open(self.name) if _on else None

    def __exit__(self, *exc):
        if _on and _stack:
            _close()
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def traced(*a, **k):
            if not _on:
                return fn(*a, **k)
            _open(name)
            try:
                return fn(*a, **k)
            finally:
                if _on and _stack:
                    _close()
        return traced


def _open(name):
    global _next_id, _frames
    parent = _stack[-1] if _stack else None
    frame = parent["frame"] if parent else None
    if name == "frame":
        frame = _frames
        _frames += 1
    rec = {"name": name, "id": _next_id,
           "parent": parent["id"] if parent else None, "frame": frame,
           "start_ns": time.perf_counter_ns(), "end_ns": None, "wait_ns": 0}
    _next_id += 1
    _stack.append(rec)
    return rec


def _close():
    rec = _stack.pop()
    rec["end_ns"] = time.perf_counter_ns()
    _records.append(rec)


def enable():
    """Start recording (spans left open by an earlier recording are
    dropped). Returns (perf_counter_ns, time_ns), read back to back."""
    global _on
    _stack.clear()
    _on = True
    return time.perf_counter_ns(), time.time_ns()


def disable():
    """Stop recording; spans still open end now. Returns
    (perf_counter_ns, time_ns), read back to back."""
    global _on
    _on = False
    while _stack:
        _close()
    return time.perf_counter_ns(), time.time_ns()


def records():
    """The finished records (dicts, in the order they ended)."""
    return list(_records)


def reset():
    """Drop every record; the next `frame` span is frame 0 again."""
    global _frames, _next_id
    _records.clear()
    _stack.clear()
    _frames = _next_id = 0
