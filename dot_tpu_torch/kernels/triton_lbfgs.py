"""K9 in Triton: the vector passes of the L-BFGS two-loop.

Replaces the three contractions, the O(m^2) scalar recurrences and the two
combinations of dot_tpu/steppers/quasi_newton.py:116-165 (_two_loop),
which the port ran as ~70 launches of 0-d torch ops per iteration. One
two-loop is now 5 launches around the H0 apply:
  loop 1   dots_kernel (x_i . v and x_i . w_j over n, per-program
           partials) + loop1_kernel (one program: sums the partials in a
           fixed order, runs loop 1's recurrence, writes k and G)
  q        combine_kernel (q = -g - k^T T)
  loop 2   dots_kernel (t_i . r) + loop2_kernel (loop 2's recurrence -> c)
  r        combine_kernel (r + c^T S)

Bound on the H100: memory. With m = 5 pairs of n-vectors (n = 3 nV: 49,419
at bar17, 405,504 at bar135) the passes read S, T and g once for loop 1,
T and g for q, T and r for loop 2, S and r for the result: 24 n-vectors in
all plus 2 written, 0.42 MB at bar17 (the launches cost more) and 42 MB at
bar135 f32 (~13 us at 3.35 TB/s).

Design: dots_kernel holds the history rows as an (8, BLOCK) tile (m <= 8
rows, masked) so one program accumulates all m + m^2 products of its
slice at once; a fixed grid of at most MAX_PROGRAMS programs strides over
n, and the per-program partials are summed by a single program in a fixed
order: the scalars that drive convergence come out the same from run to
run. The recurrences run on scalars picked out of small vectors (a masked
sum of one entry is exact). Nothing is synchronised with the host.

`triton` is imported inside the launcher: the CPU test machines have none.
"""

from __future__ import annotations

import torch

BLOCK = 64              # dots_kernel: (8, 8, 64) products per step
MAX_PROGRAMS = 264      # two per SM on 132 SMs
MP = 8                  # history rows held per tile (m <= MP)
NP = 64                 # partial-row width (>= m + m*m)
_kernels = None


def _build():
    # Triton resolves the names a kernel uses in the module's globals
    global triton, tl, _pick, _totals
    import triton
    import triton.language as tl

    @triton.jit
    def _pick(vec, ar, i):
        # vec[i] as a scalar (a sum of one entry and zeros: exact)
        return tl.sum(tl.where(ar == i, vec, 0.0), axis=0)

    @triton.jit
    def dots_kernel(x_ptr, w_ptr, v_ptr, part_ptr, n, nprog,
                    M: tl.constexpr, HAS_W: tl.constexpr,
                    MP: tl.constexpr, NP: tl.constexpr, BLOCK: tl.constexpr):
        # part[pid, i] = sum over this program's slice of x_i . v and,
        # with HAS_W, part[pid, M + i*M + j] = x_i . w_j
        pid = tl.program_id(0)
        rows = tl.arange(0, MP)
        lanes = tl.arange(0, BLOCK)
        rmask = rows < M
        dt = v_ptr.dtype.element_ty
        acc_v = tl.zeros([MP, BLOCK], dtype=dt)
        acc_w = tl.zeros([MP, MP, BLOCK], dtype=dt)
        for start in range(pid * BLOCK, n, nprog * BLOCK):
            cols = start + lanes
            cm = cols < n
            v = tl.load(v_ptr + cols, mask=cm, other=0.0)
            off = rows[:, None].to(tl.int64) * n + cols[None, :]
            m2 = rmask[:, None] & cm[None, :]
            x = tl.load(x_ptr + off, mask=m2, other=0.0)
            acc_v += x * v[None, :]
            if HAS_W:
                w = tl.load(w_ptr + off, mask=m2, other=0.0)
                acc_w += x[:, None, :] * w[None, :, :]
        base = part_ptr + pid * NP
        tl.store(base + rows, tl.sum(acc_v, axis=1), mask=rmask)
        if HAS_W:
            g = tl.sum(acc_w, axis=2)                       # (MP, MP)
            gi = M + rows[:, None] * M + rows[None, :]
            tl.store(base + gi, g, mask=rmask[:, None] & rmask[None, :])

    @triton.jit
    def _totals(part_ptr, nprog, NP: tl.constexpr, RB: tl.constexpr):
        # column sums of the (nprog, NP) partials, rows in a fixed order
        cols = tl.arange(0, NP)
        acc = tl.zeros([RB, NP], dtype=part_ptr.dtype.element_ty)
        for start in range(0, nprog, RB):
            r = start + tl.arange(0, RB)
            acc += tl.load(part_ptr + r[:, None] * NP + cols[None, :],
                           mask=r[:, None] < nprog, other=0.0)
        return tl.sum(acc, axis=0)

    @triton.jit
    def loop1_kernel(part_ptr, nprog, rho_ptr, valid_ptr, k_ptr, g_ptr,
                     M: tl.constexpr, MP: tl.constexpr, NP: tl.constexpr,
                     RB: tl.constexpr):
        tot = _totals(part_ptr, nprog, NP, RB)
        cols = tl.arange(0, NP)
        gm = (cols >= M) & (cols < M + M * M)
        tl.store(g_ptr + cols - M, tot, mask=gm)            # G (M, M)
        ar = tl.arange(0, MP)
        kv = tl.zeros([MP], dtype=tot.dtype)
        for i in tl.static_range(M - 1, -1, -1):
            rho = tl.load(rho_ptr + i)
            val = tl.load(valid_ptr + i)
            ir = tl.where(val > 0, 1.0 / rho, 0.0) * val
            s = -_pick(tot, cols, i)                        # s_i . q0
            for j in tl.static_range(i + 1, M):
                s = s - _pick(kv, ar, j) * _pick(tot, cols, M + i * M + j)
            kv = tl.where(ar == i, s * ir, kv)
        tl.store(k_ptr + ar, kv, mask=ar < M)

    @triton.jit
    def loop2_kernel(part_ptr, nprog, rho_ptr, valid_ptr, k_ptr, g_ptr,
                     c_ptr, M: tl.constexpr, MP: tl.constexpr,
                     NP: tl.constexpr, RB: tl.constexpr):
        tot = _totals(part_ptr, nprog, NP, RB)
        cols = tl.arange(0, NP)
        ar = tl.arange(0, MP)
        cv = tl.zeros([MP], dtype=tot.dtype)
        for i in tl.static_range(M):
            rho = tl.load(rho_ptr + i)
            val = tl.load(valid_ptr + i)
            ir = tl.where(val > 0, 1.0 / rho, 0.0) * val
            t = _pick(tot, cols, i)                         # t_i . r
            for j in tl.static_range(i):
                t = t + _pick(cv, ar, j) * tl.load(g_ptr + j * M + i)
            cv = tl.where(ar == i, tl.load(k_ptr + i) - t * ir, cv)
        tl.store(c_ptr + ar, cv, mask=ar < M)

    @triton.jit
    def combine_kernel(x_ptr, c_ptr, v_ptr, out_ptr, n, M: tl.constexpr,
                       NEG_X: tl.constexpr, NEG_C: tl.constexpr,
                       BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        x = tl.load(x_ptr + offs, mask=m, other=0.0)
        acc = tl.load(c_ptr) * tl.load(v_ptr + offs, mask=m, other=0.0)
        for i in tl.static_range(1, M):
            acc += tl.load(c_ptr + i) * tl.load(
                v_ptr + i * n + offs.to(tl.int64), mask=m, other=0.0)
        if NEG_X:
            x = -x
        if NEG_C:
            r = x - acc
        else:
            r = x + acc
        tl.store(out_ptr + offs, r, mask=m)

    return dots_kernel, loop1_kernel, loop2_kernel, combine_kernel


def _get():
    global _kernels
    if _kernels is None:
        _kernels = _build()
    return _kernels


def _partials(X, W, v):
    dots_kernel = _get()[0]
    n = v.shape[0]
    nprog = max(1, min(MAX_PROGRAMS, -(-n // BLOCK)))
    part = torch.empty((nprog, NP), dtype=v.dtype, device=v.device)
    dots_kernel[(nprog,)](X, W if W is not None else X, v, part, n, nprog,
                          M=X.shape[0], HAS_W=W is not None, MP=MP, NP=NP,
                          BLOCK=BLOCK, num_warps=4)
    return part, nprog


def launch_loop1(S, T, g, rho, valid):
    """(k, G) on CUDA tensors already checked by ops.lbfgs_loop1."""
    m = S.shape[0]
    part, nprog = _partials(S, T, g)
    k = torch.empty(m, dtype=g.dtype, device=g.device)
    G = torch.empty((m, m), dtype=g.dtype, device=g.device)
    _get()[1][(1,)](part, nprog, rho, valid, k, G, M=m, MP=MP, NP=NP,
                    RB=32, num_warps=4)
    return k, G


def launch_loop2(T, r, k, G, rho, valid):
    """c on CUDA tensors already checked by ops.lbfgs_loop2."""
    m = T.shape[0]
    part, nprog = _partials(T, None, r)
    c = torch.empty(m, dtype=r.dtype, device=r.device)
    _get()[2][(1,)](part, nprog, rho, valid, k, G, c, M=m, MP=MP, NP=NP,
                    RB=32, num_warps=4)
    return c


def launch_combine(x, c, V, neg_x, neg_c):
    """(+-x) + (+-(c^T V)) on CUDA tensors checked by ops.lbfgs_combine."""
    n = x.shape[0]
    out = torch.empty_like(x)
    grid = (-(-n // 1024),)
    _get()[3][grid](x, c, V, out, n, M=V.shape[0], NEG_X=bool(neg_x),
                    NEG_C=bool(neg_c), BLOCK=1024, num_warps=4)
    return out
