"""Share of its roofline that the dense subdomain H0 factorization reaches
(System2D.factorize_fast: the symmetrized Jacobi scaling, the batched
Cholesky of the P dense blocks and, where one fails, the refactorization
of all P with 1e-4 on the diagonal): the least time of one factorization
of P dense SPD blocks of bs, counted as h0_factor_roofline counts a
block-tridiagonal system of nb = 1 block (bs^3 / 3 operations a block at
the rate of the factor's precision; bs^2 read in the field's precision,
the lower triangle's bs (bs + 1) / 2 written in the factor's), over the
frame's rebuilds, divided by the device time of every kernel inside the
span. Each rebuild has to enter the span.
"""

from bench_port.metrics.h0_factor_roofline import btd_factor_work
from bench_port.peaks import DTYPE_BYTES, least_time

SOURCE = "device_trace"
UNIT = "%"
SPANS = {"h0_factor_dense": [("system", "factorize_fast")],
         "rebuild_h0": [("system", "rebuild_h0")]}


def needs(shapes):
    return [("rebuild_h0", "frame", 1), ("h0_factor_dense", "rebuild_h0", 1)]


def rebuild_least(shapes):
    """(seconds, bound) of one rebuild's factorization."""
    s = shapes
    return least_time(*btd_factor_work(s["P"], 1, s["bs"],
                                       DTYPE_BYTES[s["field"]],
                                       DTYPE_BYTES[s["factor"]]), s["factor"])


def read(ctx):
    n = ctx.trace.span_calls.get("rebuild_h0", 0)
    dev = ctx.trace.span_s.get("h0_factor_dense", 0.0)
    if not n or dev <= 0.0:
        return None
    t, bound = rebuild_least(ctx.shapes)
    ctx.log(f"dense_factor_roofline: least {t * 1e3:.6f} ms a rebuild "
            f"(bound: {bound}), {n} rebuilds, device {dev * 1e3:.4f} ms; "
            f"power limit {ctx.power_limit}")
    return 100.0 * n * t / dev
