"""Share of its roofline that the 2D Newton factorization reaches
(System2D.factorize: the element Hessians, the dense whole-mesh assembly
and scaling, the Cholesky): the least time of one dense SPD factorization
of the stated layout, P blocks of bs (P 1, bs 2 nV), counted as
dense_factor_roofline counts it (bs^3 / 3 operations a block at the rate
of the factor's precision; bs^2 read in the field's precision, the lower
triangle written in the factor's), times the span's calls, over the
device time of every kernel inside the span. Reads nothing where the
program states no layout (P bs = 0) or the span was not entered.
"""

from bench_port.metrics.h0_factor_roofline import btd_factor_work
from bench_port.peaks import DTYPE_BYTES, least_time

SOURCE = "device_trace"
UNIT = "%"
SPANS = {"newton_factorize": [("system", "factorize")]}


def needs(shapes):
    return [("newton_factorize", "iter", 1)]


def factor_least(shapes):
    """(seconds, bound) of one factorization."""
    s = shapes
    return least_time(*btd_factor_work(s["P"], 1, s["bs"],
                                       DTYPE_BYTES[s["field"]],
                                       DTYPE_BYTES[s["factor"]]), s["factor"])


def read(ctx):
    n = ctx.trace.span_calls.get("newton_factorize", 0)
    dev = ctx.trace.span_s.get("newton_factorize", 0.0)
    if not n or dev <= 0.0 or not ctx.shapes["P"] * ctx.shapes["bs"]:
        return None
    t, bound = factor_least(ctx.shapes)
    ctx.log(f"newton_factor_roofline: least {t * 1e3:.6f} ms a factorization"
            f" (bound: {bound}), {n} factorizations, device "
            f"{dev * 1e3:.4f} ms; power limit {ctx.power_limit}")
    return 100.0 * n * t / dev
