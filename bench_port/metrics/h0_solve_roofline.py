"""Share of its roofline that the H0 solves reach: the least time of the
solves the frame's H0 applies need, divided by the device time of every
kernel inside System._block_solve (K7's solve entry and its casts). Each
H0 apply has to enter that span: DOT's once for the fine factor and once
more for the coarse one where the two-level space is on, LBFGS-PD's
pd_solve once.

Counted from the shapes: a solve with a block-tridiagonal factor reads
each stored entry once (triangular diagonal blocks, full sub-diagonal
ones: P (nb bs (bs + 1) / 2 + (nb - 1) bs^2) in the factor's stored
precision) for 4 flops an entry and column (forward and backward,
multiply and add), plus its right-hand sides and results; DOT's apply
solves one column against the fine factor and, with the two-level space,
one against the coarse Lc^{-1} (6P, float32, lower triangle); LBFGS-PD's
solves three columns against its fixed P = 1 factor (float32) and reads
its permutation, inverse permutation and scale once.
"""

from bench_port.peaks import DTYPE_BYTES, least_time

SOURCE = "device_trace"
UNIT = "%"
SPANS = {"h0_solve": [("system", "_block_solve")],
         "h0_apply": [("system", "h0_apply")],
         "pd_solve": [("system", "pd_solve")]}


def needs(shapes):
    if shapes["stepper"] == "LBFGSPD":
        return [("pd_solve", "iter", 1), ("h0_solve", "pd_solve", 1)]
    return [("h0_apply", "iter", 1),
            ("h0_solve", "h0_apply", 2 if shapes["coarse_n"] else 1)]


def btd_solve_work(P, nb, bs, leaf_bytes, ncols, vec_bytes):
    """(flops, bytes) of one solve against P block-tridiagonal factors."""
    entries = P * (nb * bs * (bs + 1) / 2 + (nb - 1) * bs * bs)
    return (4.0 * entries * ncols,
            entries * leaf_bytes + 2 * P * nb * bs * ncols * vec_bytes)


def apply_least(shapes):
    """(seconds, bounds) of one DOT H0 apply's solves."""
    s = shapes
    fb = DTYPE_BYTES[s["field"]]
    t, bound = least_time(*btd_solve_work(s["P"], s["nb"], s["bs"],
                                          DTYPE_BYTES[s["factor"]], 1, fb),
                          s["factor"])
    bounds = {bound}
    if s["coarse_n"]:
        tc, bound = least_time(*btd_solve_work(1, 1, s["coarse_n"], fb, 1,
                                               fb), s["field"])
        t += tc
        bounds.add(bound)
    return t, bounds


def pd_least(shapes):
    """(seconds, bounds) of one LBFGS-PD solve."""
    pd = shapes["pd"]
    fb = DTYPE_BYTES[shapes["field"]]
    fl, nb_ = btd_solve_work(1, pd["nb"], pd["bs"], fb, 3, fb)
    nb_ += pd["n_vert"] * (fb + 2 * DTYPE_BYTES["i64"])
    t, bound = least_time(fl, nb_, shapes["field"])
    return t, {bound}


def read(ctx):
    calls = ctx.trace.span_calls
    dev = ctx.trace.span_s.get("h0_solve", 0.0)
    t, bounds = 0.0, set()
    for span, least in (("h0_apply", apply_least), ("pd_solve", pd_least)):
        if calls.get(span) and (span != "pd_solve" or ctx.shapes.get("pd")):
            tl, b = least(ctx.shapes)
            t += calls[span] * tl
            bounds |= b
    if t <= 0.0 or dev <= 0.0:
        return None
    ctx.log(f"h0_solve_roofline: least {t * 1e3:.6f} ms over the trace "
            f"(bound: {', '.join(sorted(bounds))}), device "
            f"{dev * 1e3:.4f} ms; power limit {ctx.power_limit}")
    return 100.0 * t / dev
