"""Share of its roofline that the H0 factorization reaches: the least time
of the work the problem needs (the P block-tridiagonal systems of nb
blocks of bs, and the 6P coarse matrix where the two-level space is on),
divided by the device time of every kernel inside the factor spans
(`h0_factor`: System.factorize, on the chunked path
System._btd_scan_equilibrated; `coarse_factor`: System._coarse_factor),
over the frame's rebuilds. Each rebuild has to enter the fine factor's
span, and the coarse factor's where the two-level space is on.

The work is counted from the shapes, never from the program's stage
tables, so a rewritten factorization is read against the same work:
block Cholesky, per system and block, bs^3 / 3 for the diagonal factor,
bs^3 for the off-diagonal solve and bs^3 for the symmetric update; the
band read once in the field's precision (diagonal and sub-diagonal
blocks) and the factor written once in its stored precision (triangular
diagonal blocks, full sub-diagonal ones). Operations run at the rate of
the factor's stored precision (bf16 leaves: the 989 TFLOP/s tensor rate).
"""

from bench_port.peaks import DTYPE_BYTES, least_time

SOURCE = "device_trace"
UNIT = "%"
SPANS = {"h0_factor": [("system", "factorize"),
                       ("system", "_btd_scan_equilibrated")],
         "coarse_factor": [("system", "_coarse_factor")],
         "rebuild_h0": [("system", "rebuild_h0")]}


def needs(shapes):
    n = [("rebuild_h0", "frame", 1), ("h0_factor", "rebuild_h0", 1)]
    if shapes["coarse_n"]:
        n.append(("coarse_factor", "rebuild_h0", 1))
    return n


def btd_factor_work(P, nb, bs, in_bytes, out_bytes):
    """(flops, bytes) of factoring P block-tridiagonal SPD systems."""
    flops = P * bs ** 3 * (nb / 3.0 + 2.0 * (nb - 1))
    nbytes = (P * (2 * nb - 1) * bs * bs * in_bytes
              + P * (nb * bs * (bs + 1) / 2 + (nb - 1) * bs * bs) * out_bytes)
    return flops, nbytes


def dense_factor_work(n, nbytes_each):
    """(flops, bytes) of a dense SPD Cholesky of order n."""
    return n ** 3 / 3.0, (n * n + n * (n + 1) / 2) * nbytes_each


def rebuild_least(shapes):
    """(seconds, bound) of one rebuild's factorizations."""
    s = shapes
    fl, nb_ = btd_factor_work(s["P"], s["nb"], s["bs"],
                              DTYPE_BYTES[s["field"]],
                              DTYPE_BYTES[s["factor"]])
    t, bound = least_time(fl, nb_, s["factor"])
    if s["coarse_n"]:
        fl, nb_ = dense_factor_work(s["coarse_n"], DTYPE_BYTES[s["field"]])
        t += least_time(fl, nb_, s["field"])[0]
    return t, bound


def read(ctx):
    n = ctx.trace.span_calls.get("rebuild_h0", 0)
    dev = (ctx.trace.span_s.get("h0_factor", 0.0)
           + ctx.trace.span_s.get("coarse_factor", 0.0))
    if not n or dev <= 0.0:
        return None
    t, bound = rebuild_least(ctx.shapes)
    ctx.log(f"h0_factor_roofline: least {t * 1e3:.6f} ms a rebuild "
            f"(bound: {bound}), {n} rebuilds, device {dev * 1e3:.4f} ms; "
            f"power limit {ctx.power_limit}")
    return 100.0 * n * t / dev
