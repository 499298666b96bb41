"""Share of its roofline that the dense subdomain H0 solves reach
(System2D.solve_local: the forward and backward triangular solves against
the P dense lower factors and the casts around them): the least time of
the solves the frame's H0 applies need, counted as h0_solve_roofline
counts a block-tridiagonal factor of nb = 1 block (each of the P lower
triangles' bs (bs + 1) / 2 entries read once an apply in the factor's
precision, 4 flops an entry; the right-hand sides and results once),
divided by the device time of every kernel inside the span. Each H0
apply has to enter the span once.
"""

from bench_port.metrics.h0_solve_roofline import btd_solve_work
from bench_port.peaks import DTYPE_BYTES, least_time

SOURCE = "device_trace"
UNIT = "%"
SPANS = {"h0_solve_dense": [("system", "solve_local")],
         "h0_apply": [("system", "h0_apply")]}


def needs(shapes):
    return [("h0_apply", "iter", 1), ("h0_solve_dense", "h0_apply", 1)]


def apply_least(shapes):
    """(seconds, bound) of one H0 apply's solves."""
    s = shapes
    return least_time(*btd_solve_work(s["P"], 1, s["bs"],
                                      DTYPE_BYTES[s["factor"]], 1,
                                      DTYPE_BYTES[s["field"]]), s["factor"])


def read(ctx):
    n = ctx.trace.span_calls.get("h0_apply", 0)
    dev = ctx.trace.span_s.get("h0_solve_dense", 0.0)
    if not n or dev <= 0.0:
        return None
    t, bound = apply_least(ctx.shapes)
    ctx.log(f"dense_solve_roofline: least {t * 1e3:.6f} ms an apply "
            f"(bound: {bound}), {n} applies, device {dev * 1e3:.4f} ms; "
            f"power limit {ctx.power_limit}")
    return 100.0 * n * t / dev
