"""Device time a frame of the kernels inside System.h0_apply (gather,
the block solve, averaging, the coarse correction)."""

SOURCE = "device_trace"
UNIT = "ms/frame"
SPANS = {"h0_apply": [("system", "h0_apply")]}


def needs(shapes):
    return [("h0_apply", "iter", 1)]


def read(ctx):
    if not ctx.trace.span_calls.get("h0_apply"):
        return None
    return ctx.trace.span_s["h0_apply"] * 1e3 / ctx.frames
