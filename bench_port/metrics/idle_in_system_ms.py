"""Device idle time a frame left by host code inside System methods: gaps
(not after a read) that end with a launch made while the innermost open
span was a System span (h0_apply, block_solve, pd_solve, gradient,
rebuild_h0 and its children, host_read; host_spans.py). The lap has to
show one rebuild_h0 span a DOT frame."""

from bench_port import host_spans

SOURCE = "device_trace"
UNIT = "ms/frame"
NEEDS = ("host_read", "rebuild_h0")
needs = host_spans.needs


def read(ctx):
    sp = host_spans.lap(ctx, NEEDS)
    if sp is None:
        return None
    return sp.idle_s["in_system"] * 1e3 / ctx.frames
