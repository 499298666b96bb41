"""Device time a frame of the kernels inside System2D.factorize, the 2D
Newton factorization of every iteration: the element Hessians (K23), the
dense whole-mesh assembly and its scaling (K24) and the Cholesky. Each
Newton iteration has to enter the span."""

SOURCE = "device_trace"
UNIT = "ms/frame"
SPANS = {"newton_factorize": [("system", "factorize")]}


def needs(shapes):
    return [("newton_factorize", "iter", 1)]


def read(ctx):
    if not ctx.trace.span_calls.get("newton_factorize"):
        return None
    return ctx.trace.span_s["newton_factorize"] * 1e3 / ctx.frames
