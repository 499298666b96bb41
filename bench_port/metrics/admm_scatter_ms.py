"""Device time a frame of the kernels inside ADMMPDStepper._scatter,
ADMM-PD's D^T W scatter (K18): the global step's right-hand side once an
ADMM iteration and the Dirichlet offset once a frame. Each ADMM
iteration has to enter the span."""

SOURCE = "device_trace"
UNIT = "ms/frame"
SPANS = {"admm_scatter": [("stepper", "_scatter")]}


def needs(shapes):
    return [("admm_scatter", "iter", 1)]


def read(ctx):
    if not ctx.trace.span_calls.get("admm_scatter"):
        return None
    return ctx.trace.span_s["admm_scatter"] * 1e3 / ctx.frames
