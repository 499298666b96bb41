"""Device idle time a frame left by the stepper's own host code: gaps
(not after a read) that end with a launch made while the innermost open
span was stepper code (step, two_loop, line_search, history, finish, ...;
host_spans.py). The lap has to show one two_loop span an iteration on
the quasi-Newton steppers."""

from bench_port import host_spans

SOURCE = "device_trace"
UNIT = "ms/frame"
NEEDS = ("host_read", "two_loop")
needs = host_spans.needs


def read(ctx):
    sp = host_spans.lap(ctx, NEEDS)
    if sp is None:
        return None
    return sp.idle_s["host_loop"] * 1e3 / ctx.frames
