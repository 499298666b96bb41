"""Device time a frame of the kernels inside System.pd_solve (LBFGS-PD's
H0 apply: the fixed factor's 3-column solve)."""

SOURCE = "device_trace"
UNIT = "ms/frame"
SPANS = {"pd_solve": [("system", "pd_solve")]}


def needs(shapes):
    return [("pd_solve", "iter", 1)]


def read(ctx):
    if not ctx.trace.span_calls.get("pd_solve"):
        return None
    return ctx.trace.span_s["pd_solve"] * 1e3 / ctx.frames
