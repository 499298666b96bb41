"""Device idle time a frame that follows a host read: gaps that open when
a device-to-host copy issued inside a `host_read` span ends (the queue
drained, then the host's Python until its next launch; host_spans.py).
The lap has to show one host_read span for each read StepStats.syncs
counts."""

from bench_port import host_spans

SOURCE = "device_trace"
UNIT = "ms/frame"
NEEDS = ("host_read",)
needs = host_spans.needs


def read(ctx):
    sp = host_spans.lap(ctx, NEEDS)
    if sp is None:
        return None
    return sp.idle_s["after_read"] * 1e3 / ctx.frames
