"""Device time a frame of the kernels inside System.rebuild_h0 (element
Hessians, the coarse factor, assembly, factorization)."""

SOURCE = "device_trace"
UNIT = "ms/frame"
SPANS = {"rebuild_h0": [("system", "rebuild_h0")]}


def needs(shapes):
    return [("rebuild_h0", "frame", 1)]


def read(ctx):
    if not ctx.trace.span_calls.get("rebuild_h0"):
        return None
    return ctx.trace.span_s["rebuild_h0"] * 1e3 / ctx.frames
