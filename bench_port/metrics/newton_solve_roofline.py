"""Share of its roofline that the 2D Newton solves reach
(System2D.solve: the forward and backward triangular solves against the
dense whole-mesh factor and the scaling around them): the least time of
one solve of the stated layout, P blocks of bs (P 1, bs 2 nV), counted as
dense_solve_roofline counts it (the lower triangle's bs (bs + 1) / 2
entries read once in the factor's precision, 4 flops an entry; the
right-hand side and result once), times the span's calls, over the
device time of every kernel inside the span. A substitution pair reads
the triangle twice, so it tops out near 50 %. Reads nothing where the
program states no layout (P bs = 0) or the span was not entered.
"""

from bench_port.metrics.h0_solve_roofline import btd_solve_work
from bench_port.peaks import DTYPE_BYTES, least_time

SOURCE = "device_trace"
UNIT = "%"
SPANS = {"newton_solve": [("system", "solve")]}


def needs(shapes):
    return [("newton_solve", "iter", 1)]


def solve_least(shapes):
    """(seconds, bound) of one solve."""
    s = shapes
    return least_time(*btd_solve_work(s["P"], 1, s["bs"],
                                      DTYPE_BYTES[s["factor"]], 1,
                                      DTYPE_BYTES[s["field"]]), s["factor"])


def read(ctx):
    n = ctx.trace.span_calls.get("newton_solve", 0)
    dev = ctx.trace.span_s.get("newton_solve", 0.0)
    if not n or dev <= 0.0 or not ctx.shapes["P"] * ctx.shapes["bs"]:
        return None
    t, bound = solve_least(ctx.shapes)
    ctx.log(f"newton_solve_roofline: least {t * 1e3:.6f} ms a solve "
            f"(bound: {bound}), {n} solves, device {dev * 1e3:.4f} ms; "
            f"power limit {ctx.power_limit}")
    return 100.0 * n * t / dev
