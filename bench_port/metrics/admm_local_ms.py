"""Device time a frame of the kernels inside ADMMPDStepper._local_step,
ADMM-PD's per-element local step and dual update (K17). Each ADMM
iteration has to enter the span."""

SOURCE = "device_trace"
UNIT = "ms/frame"
SPANS = {"admm_local": [("stepper", "_local_step")]}


def needs(shapes):
    return [("admm_local", "iter", 1)]


def read(ctx):
    if not ctx.trace.span_calls.get("admm_local"):
        return None
    return ctx.trace.span_s["admm_local"] * 1e3 / ctx.frames
