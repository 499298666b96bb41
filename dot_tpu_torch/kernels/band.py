"""Plain PyTorch versions of the H0 kernels K5-K8 and K12, and the
host-side tables their CUDA versions walk.

K5 band_assemble   block-tridiagonal H0 assembly (dot_tpu/steppers/core.py
                   676-706 _assembly_compact, 733-774 _band_compact /
                   _assemble_btd)
K6 chol_inv        batched Cholesky L and L^{-1} of SPD blocks (the diagonal
                   blocks of core.py 853-1203)
K7 block_matvec    out = c - op(A) v over a batch of blocks (core.py
                   1061-1135 _cr_solve, 1219-1261 _btd_solve)
K7 block_solve     a whole block-tridiagonal / cyclic-reduction solve, the
                   coarse pair Lc^{-T} Lc^{-1} (core.py 1296-1317), or
                   LBFGS-PD's 3-column pd_solve with its permute / scale
                   passes (core.py 1704-1719: K15's products), as K7's
                   products in one launch: the launch sequences
                   btd_solve_ref / cr_solve_ref / pair_solve_ref /
                   pd_solve_ref, and the SolveProgram their kernel walks
                   (solve_program; its CPU mirror run_solve_program_ref)
K8 h0_gather /     the vertex gather and duplicate-averaging segment sum of
   h0_average      h0_apply (core.py 1263-1280)
K5 band_compact    K5's other entry point: the finished compact unique-block
                   values (core.py 733-748 _band_compact), for
K12 band_equil_    the chunked rebuild's band (core.py 1465-1499
    scatter        _rebuild_banded_chunked): the Jacobi scale d from the
                   compact diagonal blocks, the equilibrated lower blocks
                   rounded to the band's dtype and scattered, pads 1

These are what the port ran before the kernels existed. The CPU tests use
them, and System(use_kernels=False) takes them on any device for
comparison runs; the main path on a card never does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import pd


class BandPlan(NamedTuple):
    """Static index tensors of the banded H0 assembly (one per System)."""
    src_block: torch.Tensor   # (nAsm,) int64 9-wide elem_h rows, dest order
    stage1: torch.Tensor      # (nAsm,) int64 sorted unique-block ids
    seg_off: torch.Tensor     # (nUB+1,) int64 CSR offsets of `stage1`
    ub_row: torch.Tensor      # (nUB,) int64 local row vertex (flat P*N)
    ub_col: torch.Tensor      # (nUB,) int64 local column vertex
    diag_ub: torch.Tensor     # (nD,) int64 unique blocks on the diagonal
    dest: torch.Tensor        # (nUB*9,) int64 band slots; `total` = dropped
    pad_diag: torch.Tensor    # (nPad,) int64 band slots of padding diagonals
    total: int                # band length (diag + sub)


class LowPlan(NamedTuple):
    """Static tables of the chunked rebuild's lower-only band scatter
    (dot_tpu core.py:614-623, 667-674: a vertex block with local row <
    local column is never read by the scan, so it is not scattered)."""
    n_parts: int
    diag_slot: torch.Tensor   # (P*N,) int64 diagonal unique block, or -1
    ub_row: torch.Tensor      # (nUB,) int64 as BandPlan
    ub_col: torch.Tensor      # (nUB,) int64
    sel: torch.Tensor         # (nLow,) int64 unique blocks kept
    dest: torch.Tensor        # (nLow*9,) int64 band slots; `total` dropped
    pad_diag: torch.Tensor    # (nPad,) int64 band slots of pad diagonals
    total: int                # band length (diag + sub)


def low_plan(plan, band_plan, device):
    """LowPlan from a banded SubdomainPlan (numpy) and its BandPlan."""
    n_loc = plan.n3 // 3
    ub_row = np.asarray(plan.band_ub_row, np.int64)
    ub_col = np.asarray(plan.band_ub_col, np.int64)
    low = (ub_row % n_loc) >= (ub_col % n_loc)
    diag_ub = np.asarray(plan.band_diag_ub, np.int64)
    slot = np.full(plan.n_parts * n_loc, -1, np.int64)
    slot[ub_row[diag_ub]] = diag_ub
    dest = np.asarray(plan.band_dest, np.int64).reshape(-1, 9)[low]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                               device=device)
    return LowPlan(n_parts=int(plan.n_parts), diag_slot=t(slot),
                   ub_row=band_plan.ub_row, ub_col=band_plan.ub_col,
                   sel=t(np.flatnonzero(low)), dest=t(dest.reshape(-1)),
                   pad_diag=band_plan.pad_diag, total=band_plan.total)


def csr_offsets(sorted_ids, n_segments):
    """(n_segments + 1,) int64 run offsets of a sorted id array (numpy)."""
    ids = np.asarray(sorted_ids, np.int64)
    if ids.size and np.any(np.diff(ids) < 0):
        raise ValueError("segment ids must be sorted")
    return np.searchsorted(ids, np.arange(n_segments + 1)).astype(np.int64)


def band_compact_ref(elem_h, freef, mass_flat, plan):
    """K5 plain (compact): the finished (nUB, 9) unique-block values: the
    element blocks summed, fixed vertices masked, the lumped mass (free)
    or 1 (fixed) on the vertex diagonals. freef: (P*N,) 0/1 free-vertex
    mask; mass_flat: (P*N,) lumped mass per local vertex."""
    eh_rows = elem_h.t().reshape(-1, 9)                  # (nEp*16, 9)
    rows = eh_rows[plan.src_block]                       # (nAsm, 9)
    compact = torch.zeros((plan.ub_row.shape[0], 9), dtype=elem_h.dtype,
                          device=elem_h.device)
    compact.index_add_(0, plan.stage1, rows)
    mask = freef[plan.ub_row] * freef[plan.ub_col]
    compact = compact * mask[:, None]
    dslot = plan.ub_row[plan.diag_ub]
    dvals = (mass_flat * freef + (1.0 - freef))[dslot]
    cols = torch.tensor([0, 4, 8], device=elem_h.device)
    compact.index_put_((plan.diag_ub[:, None], cols[None, :]),
                       dvals[:, None].expand(-1, 3), accumulate=True)
    return compact


def band_assemble_ref(elem_h, freef, mass_flat, plan):
    """K5 plain: the flat [diag | sub] band (plan.total,) from the (144, nEp)
    block-major element Hessians (the compact above, scattered; padding
    rows get a unit diagonal)."""
    compact = band_compact_ref(elem_h, freef, mass_flat, plan)
    flat = torch.zeros(plan.total + 1, dtype=elem_h.dtype,
                       device=elem_h.device)
    flat[plan.dest] = compact.reshape(-1)
    flat[plan.pad_diag] = 1.0
    return flat[:plan.total]


def chol_inv_ref(A, symmetrize):
    """K6 plain: lower Cholesky factors L and their inverses of a batch
    (B, n, n) of SPD blocks, and a (B,) bool flag. `symmetrize` factors
    (A + A^T) / 2 (jnp.linalg.cholesky); otherwise the lower triangle only
    is read (lax.linalg.cholesky(symmetrize_input=False)). A flagged block
    (a non-positive pivot, or a non-finite factor) has NaN in L and L^{-1}."""
    M = (A + A.mT) / 2 if symmetrize else torch.tril(A)
    L, info = torch.linalg.cholesky_ex(M)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    Li = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    bad = (info != 0) | ~torch.isfinite(L).all(-1).all(-1)
    nan = torch.tensor(float("nan"), dtype=A.dtype, device=A.device)
    L = torch.where(bad[:, None, None], nan, L)
    Li = torch.where(bad[:, None, None], nan, Li)
    return L, Li, bad


def k6_tile(dtype, batch):
    """K6's tile width (csrc/chol_inv.cu): 32 in f64; in f32 64 for a
    batch of 16 blocks or more (the GEMM updates' work sets the pace: the
    wider micro-tile does more per shared-memory load), else 32 (the
    diagonal tiles' serial factor sets it: a 32-wide tile's column step
    is shorter)."""
    if dtype == torch.float64:
        return 32
    return 64 if batch >= 16 else 32


def _factor_inv_tile(W):
    """K6's in-tile step on a batch (B, T, T) whose lower triangle is
    read: at step c the columns right of c take the Schur update with the
    unscaled column c (w_ij -= w_ic (w_jc / w_cc), the division as a
    multiplication by the pivot's reciprocal) and the rows of
    Y = D L^{-1} below c take -(w_ic / w_cc) Y[c, :]; then L and L^{-1}
    are scaled by the root pivots. Returns (L, L^{-1}, bad pivot)."""
    W = torch.tril(W)
    T = W.shape[-1]
    bad = torch.zeros(W.shape[0], dtype=torch.bool, device=W.device)
    Y = torch.eye(T, dtype=W.dtype, device=W.device).repeat(W.shape[0], 1, 1)
    for c in range(T):
        piv = W[:, c, c]
        bad |= ~(piv > 0)
        ip = (1.0 / piv)[:, None]
        fy = Y[:, c, :c + 1] * ip
        Y[:, c + 1:, :c + 1] -= W[:, c + 1:, c, None] * fy[:, None, :]
        f = W[:, c + 1:, c] * ip
        W[:, c + 1:, c + 1:] -= torch.tril(W[:, c + 1:, c, None]
                                           * f[:, None, :])
    dv = torch.sqrt(torch.diagonal(W, dim1=-2, dim2=-1))
    L = torch.tril(W, -1) / dv[:, None, :] + torch.diag_embed(dv)
    return L, Y / dv[:, :, None], bad


def chol_inv_tiled_ref(A, symmetrize, tile):
    """K6's schedule in torch, a plain mirror of csrc/chol_inv.cu: the
    blocked right-looking Cholesky over tile x tile tiles (the matrix
    padded with I to a multiple of the tile) with L^{-1} built in the same
    sweep. For k = 0 .. nt-1: every tile (i, j), j >= k, takes
    -L[i, k-1] L[j, k-1]^T (lower entries) and the inverse's right-hand
    side B[i, j], i >= k, j < k, takes -L[i, k-1] X[k-1, j]; the diagonal
    tile is factored and inverted (_factor_inv_tile: Td); then the panel
    L[i, k] = A[i, k] Td^T, i > k, and the row X[k, j] = Td B[k, j], j < k.
    Returns (L, L^{-1}, bad) as chol_inv_ref."""
    B, n = A.shape[0], A.shape[-1]
    t = tile
    nt = -(-n // t)
    N = nt * t
    M = (A + A.mT) / 2 if symmetrize else A
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    L = eye.repeat(B, 1, 1)
    L[:, :n, :n] = torch.tril(M)
    X = eye.repeat(B, 1, 1)
    bad = torch.zeros(B, dtype=torch.bool, device=A.device)
    for k in range(nt):
        o, e = k * t, (k + 1) * t
        if k > 0:
            col = L[:, o:, o - t:o]
            L[:, o:, o:] -= torch.tril(col @ col.mT)
            X[:, o:, :o] -= col @ X[:, o - t:o, :o]
        Lkk, Td, piv_bad = _factor_inv_tile(L[:, o:e, o:e])
        L[:, o:e, o:e] = Lkk
        X[:, o:e, o:e] = Td
        bad |= piv_bad | ~torch.isfinite(Lkk).all(-1).all(-1)
        L[:, e:, o:e] = L[:, e:, o:e] @ Td.mT
        bad |= ~torch.isfinite(L[:, e:, o:e]).all(-1).all(-1)
        X[:, o:e, :o] = Td @ X[:, o:e, :o]
    L, X = L[:, :n, :n], X[:, :n, :n]
    nan = torch.tensor(float("nan"), dtype=A.dtype, device=A.device)
    return (torch.where(bad[:, None, None], nan, L),
            torch.where(bad[:, None, None], nan, X), bad)


def block_matvec_ref(A, v, c=None, trans=False, out=None):
    """K7 plain: op(A) v, or c - op(A) v, over a batch: A (B, n, n) in
    bf16, f32 or f64 (taken to v's dtype), v and c (B, n). `out` (may be c)
    receives the result."""
    a = A.mT if trans else A
    r = torch.matmul(a.to(v.dtype), v[..., None])[..., 0]
    if c is not None:
        r = c - r
    if out is None:
        return r
    out.copy_(r)
    return out


# ---------------------------------------------------------------------------
# K7's solves: the launch sequences, and the same products as one program
# ---------------------------------------------------------------------------
def _mv(mv, A, v, c=None, trans=False, out=None):
    """`mv` (block_matvec's signature over (B, n, n) blocks and (B, n) or
    (B, n, k) vectors) on blocks of any leading shape: A (..., n, n); v, c
    (..., n) or (..., n, k) with the same leading shape. A is viewed, never
    copied: one subdomain's slice [:, i:i+1] of a scan-major leaf keeps its
    batch stride."""
    n = A.shape[-1]
    flat = (-1, n) + tuple(v.shape[A.dim() - 1:])
    r = mv(A.view(-1, n, n), v.reshape(flat),
           None if c is None else c.reshape(flat), trans,
           None if out is None else out.view(flat))
    return r.view(v.shape)


def _btd_scan(linv, sub, rT, mv):
    """Forward / backward block substitution on scan-major right-hand
    sides rT (nb, P, n[, k]) (dot_tpu core.py:1219-1261):
      y_k = Linv_k (r_k - S_{k-1} y_{k-1}),
      x_k = Linv_k^T (y_k - S_k^T x_{k+1}); returns x scan-major."""
    nb = rT.shape[0]
    ys, y = [], None
    for k in range(nb):
        t = rT[k] if y is None else _mv(mv, sub[k - 1], y, rT[k])
        y = _mv(mv, linv[k], t)
        ys.append(y)
    xs, x = [None] * nb, None
    for k in reversed(range(nb)):
        t = ys[k] if x is None else _mv(mv, sub[k], x, ys[k], True)
        x = _mv(mv, linv[k], t, trans=True)
        xs[k] = x
    return torch.stack(xs)


def btd_solve_ref(linv, sub, r, mv=block_matvec_ref):
    """The block-tridiagonal solve with the pre-inverted diagonal factors
    (linv (nb, P, n, n), sub (nb - 1, P, n, n)) against r (P, nb n), or
    (P, nb n, k) for k right-hand sides at once: 4 nb - 2 calls of `mv`
    (block_matvec_ref; K7's launches with ops.block_matvec, K15's with
    ops.block_matvec_k and k columns)."""
    nb, P, n = linv.shape[0], linv.shape[1], linv.shape[-1]
    tail = tuple(r.shape[2:])
    rT = r.reshape((P, nb, n) + tail).transpose(0, 1).contiguous()
    return _btd_scan(linv, sub, rT, mv).transpose(0, 1) \
        .reshape((P, nb * n) + tail)


def cr_solve_ref(levels, root_linv, root_sub, r, mv=block_matvec_ref):
    """The solve against a cyclic-reduction factor (dot_tpu
    core.py:1061-1135): per level (Li, G_lo, G_hi) (n_odd, P, n, n) the
    forward reduction onto the even blocks, the root's block scan, then the
    back substitution, every block product a call of `mv`. r (P, nb n)."""
    P, n = levels[0][0].shape[1], levels[0][0].shape[-1]
    nb = r.shape[1] // n
    rT = r.reshape(P, nb, n).transpose(0, 1).contiguous()   # (nb, P, n)
    stack = []
    for Li, G_lo, G_hi in levels:
        m = rT.shape[0]
        n_odd = m // 2
        n_even = m - n_odd
        z = _mv(mv, Li, rT[1::2].contiguous())            # Li r_odd
        re = rT[0::2].contiguous()
        _mv(mv, G_lo, z, re[:n_odd], True, out=re[:n_odd])
        if n_even > 1:
            k = n_even - 1
            _mv(mv, G_hi[:k], z[:k], re[1:], True, out=re[1:])
        stack.append((z, m))
        rT = re
    xT = _btd_scan(root_linv, root_sub, rT, mv)
    for (Li, G_lo, G_hi), (z, m) in zip(reversed(levels), reversed(stack)):
        n_odd = m // 2
        t = _mv(mv, G_lo, xT[:n_odd], z)                  # z - G_lo x_a
        k = min(n_odd, xT.shape[0] - 1)                  # x_b past: zeros
        if k > 0:
            _mv(mv, G_hi[:k], xT[1:1 + k], t[:k], out=t[:k])
        full = torch.empty((m, P, n), dtype=xT.dtype, device=xT.device)
        full[0::2] = xT
        full[1::2] = _mv(mv, Li, t, trans=True)           # Li^T t
        xT = full
    return xT.transpose(0, 1).reshape(P, nb * n)


def pair_solve_ref(li, r, mv=block_matvec_ref):
    """The coarse solve's pair Lc^{-T} (Lc^{-1} r) on Lc^{-1} (n, n), r
    (1, n) (dot_tpu core.py:1296-1317): two calls of `mv`."""
    y = _mv(mv, li[None], r)
    return _mv(mv, li[None], y, trans=True)


def pd_solve_ref(linv, sub, inv, perm, d, rhs, mv=pd.block_matvec_k_ref,
                 gather=pd.pd_gather_ref, scatter=pd.pd_scatter_ref):
    """LBFGS-PD's solve against its P = 1 factor (linv (nb, 1, n, n), sub
    (nb - 1, 1, n, n)) for rhs (nV, 3), the three coordinates as right-hand
    sides (dot_tpu core.py:1704-1719): `gather` (rows permuted by inv,
    zero-padded, / d), btd_solve_ref with 3 columns (4 nb - 2 calls of the
    k-column `mv`), `scatter` (/ d, rows un-permuted by perm). With
    ops.block_matvec_k, ops.pd_gather and ops.pd_scatter: the K15 launch
    sequence that K7's solve entry replaced."""
    rp = gather(rhs, inv, d)
    z = btd_solve_ref(linv, sub, rp[None], mv)[0]
    return scatter(z.contiguous(), perm, d)


def block_solve_ref(prog, leaves, r, mv=None, gather=pd.pd_gather_ref,
                    scatter=pd.pd_scatter_ref):
    """K7's solve entry, plain: the launch sequence of `prog`'s kind (a
    SolveProgram; leaves and r as solve_program and ops.block_solve take
    them), each block product a call of `mv` (default block_matvec_ref, or
    pd.block_matvec_k_ref for the 3-column "pd" kind; ops.block_matvec /
    ops.block_matvec_k: the launches the entry replaced); "pd" also calls
    `gather` and `scatter` (ops.pd_gather / ops.pd_scatter)."""
    if prog.kind == "pd":
        return pd_solve_ref(*leaves, r, mv or pd.block_matvec_k_ref, gather,
                            scatter)
    mv = mv or block_matvec_ref
    if prog.kind == "btd":
        return btd_solve_ref(leaves[0], leaves[1], r, mv)
    if prog.kind == "pair":
        return pair_solve_ref(leaves[0], r, mv)
    levels = [tuple(leaves[i:i + 3]) for i in range(0, len(leaves) - 2, 3)]
    return cr_solve_ref(levels, leaves[-2], leaves[-1], r, mv)


# a stage of a solve program: N_FIELDS int64, in csrc/block_matvec.cu's
# order. F_A: A's leaf (on the card its address), whose block (j, p) lies
# F_A_OFF + j F_A_SJ + p F_A_SP entries in; v, c (F_C -1: none) and out:
# a buffer (BUF_*) and its block (j, p) at off + j sj + p sp, in entries
# (a block of a k-column program is n k entries, row-major (n, k)); a
# batch of F_NJ x F_NP blocks (P); F_OP one of OP_*; F_SYNC: a grid
# barrier first; F_LOWER: A is an inverse Cholesky factor (exact zeros
# above the diagonal), of which the kernel reads the lower triangle. The
# element-wise stages (OP_GATHER, OP_SCATTER) take F_NJ rows of k entries,
# F_A their int64 row table (inv, perm) and F_D the scale d (leaves; on
# the card addresses): gather out[i] = (inv[i] >= 0 ? v[inv[i]] : 0) /
# d[i], scatter out[i] = v[perm[i]] / d[perm[i]] (row i of k entries).
(F_A, F_A_OFF, F_A_SJ, F_A_SP, F_V, F_V_OFF, F_V_SJ, F_V_SP, F_C, F_C_OFF,
 F_C_SJ, F_C_SP, F_O, F_O_OFF, F_O_SJ, F_O_SP, F_NJ, F_NP, F_OP, F_SYNC,
 F_LOWER, F_D) = range(22)
N_FIELDS = 22
BUF_R, BUF_Z, BUF_WS = 0, 1, 2        # the input, the output, the workspace
OP_A, OP_AT, OP_COPY, OP_GATHER, OP_SCATTER = 0, 1, 2, 3, 4
ELEMENTWISE = (OP_GATHER, OP_SCATTER)


class SolveProgram(NamedTuple):
    """One solve as a list of K7's stages (csrc/block_matvec.cu
    dot_block_solve): `stages` (n_stage, N_FIELDS) int64 on the host with
    F_A (and F_D) the index of the stage's leaf; `table` the same on the
    leaves' CUDA device with the leaves' addresses (None on the CPU). r
    and z have `shape`: (P, nb n), or (nV, 3) for "pd"; the workspace holds
    `ws` entries; `max_items` is the most (block, row or column group)
    items a product or copy stage has (the element-wise stages stride over
    the grid); `ptrs` the leaves' addresses (a call must pass the same
    leaves); `k` the right-hand sides a block product takes (3 for "pd")."""
    kind: str            # "btd", "cr", "pair" or "pd"
    stages: np.ndarray
    P: int
    nb: int
    n: int
    ws: int
    max_items: int
    table: object
    ptrs: tuple
    k: int = 1
    shape: tuple = ()


def rows_per_item(k):
    """Rows of an op = A item of the solve kernel: 32 (4 a warp) for one
    column, 8 (a warp a row: at n = 512 and P = 1 a stage has 64 items,
    not 16) for k columns. A row's sum is the same wherever it runs."""
    return 32 if k == 1 else 8


class _Stages:
    """A solve program under construction: vector places are (buffer,
    off, sj, sp); `orig` addresses blocks in r's (P, nb n) layout, `blk`
    a workspace region of (m, P, n) blocks."""

    def __init__(self, leaves, P, nb, n, lower, k=1):
        self.strides = [(t.stride(0), t.stride(1)) for t in leaves]
        self.lower = lower               # indices of the inverse factors
        self.P, self.nb, self.n = P, nb, n
        self.vn = n * k                  # entries of a vector block
        self.rows, self.ws = [], 0

    def alloc(self, blocks):
        off = self.ws
        self.ws += blocks * self.P * self.vn
        return off

    def leaf(self, i, k=0):
        """A: blocks k, k + 1, ... of leaf i over the parts."""
        s0, s1 = self.strides[i]
        return (i, k * s0, s0, s1)

    def orig(self, buf, base, k0, kstep):
        return (buf, base + k0 * self.vn, kstep * self.vn, self.nb * self.vn)

    def blk(self, base, k=0):
        return (BUF_WS, base + k * self.P * self.vn, self.P * self.vn,
                self.vn)

    def add(self, op, nj, a, v, out, c=None, sync=True):
        row = np.zeros(N_FIELDS, np.int64)
        if a is not None:
            row[F_A:F_A + 4] = a
        row[F_V:F_V + 4] = v
        row[F_C:F_C + 4] = (-1, 0, 0, 0) if c is None else c
        row[F_O:F_O + 4] = out
        row[[F_NJ, F_NP, F_OP, F_SYNC]] = (nj, self.P, op, int(sync))
        row[F_LOWER] = int(a is not None and a[0] in self.lower)
        self.rows.append(row)

    def add_rows(self, op, rows, tab, d, v, out, sync=True):
        """An element-wise stage (OP_GATHER / OP_SCATTER) over `rows` rows:
        the row table and d are leaves `tab` and `d`; v and out (buffer,
        offset)."""
        row = np.zeros(N_FIELDS, np.int64)
        row[F_A], row[F_D] = tab, d
        row[F_V:F_V + 2] = v
        row[F_C] = -1
        row[F_O:F_O + 2] = out
        row[[F_NJ, F_NP, F_OP, F_SYNC]] = (rows, 1, op, int(sync))
        self.rows.append(row)

    def scan(self, li, sb, nbr, rhs, tmp, out, sync):
        """_btd_scan's products on leaves li (Linv) and sb (S): rhs(k) the
        right-hand side of block k, tmp(k) where t_k goes, out(k) x_k."""
        Y = self.alloc(nbr)
        self.add(OP_A, 1, self.leaf(li, 0), rhs(0), self.blk(Y, 0),
                 sync=sync)
        for k in range(1, nbr):
            self.add(OP_A, 1, self.leaf(sb, k - 1), self.blk(Y, k - 1),
                     tmp(k), c=rhs(k))
            self.add(OP_A, 1, self.leaf(li, k), tmp(k), self.blk(Y, k))
        self.add(OP_AT, 1, self.leaf(li, nbr - 1), self.blk(Y, nbr - 1),
                 out(nbr - 1))
        for k in reversed(range(nbr - 1)):
            self.add(OP_AT, 1, self.leaf(sb, k), out(k + 1), self.blk(Y, k),
                     c=self.blk(Y, k))
            self.add(OP_AT, 1, self.leaf(li, k), self.blk(Y, k), out(k))


def _cr_program(b, n_lev):
    """cr_solve_ref's products. The even blocks' right-hand sides are
    reduced in place in R, a copy of r (block i of level l at block
    i 2^l); each level's z in a region of its own; every x lands in z at
    its block (no interleave)."""
    R = b.alloc(b.nb)
    m, zs = b.nb, []
    for lev in range(n_lev):
        s = 1 << lev
        n_odd = m // 2
        n_even = m - n_odd
        Z = b.alloc(n_odd)
        src = (BUF_R, 0) if lev == 0 else (BUF_WS, R)
        b.add(OP_A, n_odd, b.leaf(3 * lev), b.orig(*src, s, 2 * s),
              b.blk(Z), sync=lev > 0)
        if lev == 0:      # R = r, beside the first products (no barrier)
            b.add(OP_COPY, b.nb, None, b.orig(BUF_R, 0, 0, 1),
                  b.orig(BUF_WS, R, 0, 1), sync=False)
        re = b.orig(BUF_WS, R, 0, 2 * s)
        b.add(OP_AT, n_odd, b.leaf(3 * lev + 1), b.blk(Z), re, c=re)
        if n_even > 1:
            re = b.orig(BUF_WS, R, 2 * s, 2 * s)
            b.add(OP_AT, n_even - 1, b.leaf(3 * lev + 2),
                  b.blk(Z), re, c=re)
        zs.append((Z, m))
        m = n_even
    s = 1 << n_lev
    b.scan(3 * n_lev, 3 * n_lev + 1, m,
           lambda k: b.orig(BUF_WS, R, k * s, 0),
           lambda k: b.orig(BUF_WS, R, k * s, 0),
           lambda k: b.orig(BUF_Z, 0, k * s, 0), sync=True)
    for lev in reversed(range(n_lev)):
        Z, m = zs[lev]
        s = 1 << lev
        n_odd = m // 2
        k = min(n_odd, m - n_odd - 1)
        z = b.blk(Z)
        b.add(OP_A, n_odd, b.leaf(3 * lev + 1),
              b.orig(BUF_Z, 0, 0, 2 * s), z, c=z)
        if k > 0:
            b.add(OP_A, k, b.leaf(3 * lev + 2),
                  b.orig(BUF_Z, 0, 2 * s, 2 * s), z, c=z)
        b.add(OP_AT, n_odd, b.leaf(3 * lev), z,
              b.orig(BUF_Z, 0, s, 2 * s))


def _pd_tables(leaves):
    """The "pd" kind's leaves: (linv, sub) and the plan's inv (nb n,),
    perm (nV,) int64 and the scale d (nb n,), checked."""
    linv, sub, inv, perm, d = leaves
    nv_p = linv.shape[0] * linv.shape[-1]
    if linv.dim() != 4 or linv.shape[1] != 1:
        raise ValueError(f"solve_program: pd takes a P = 1 factor, not "
                         f"{tuple(linv.shape)}")
    for name, t, dt, size in (("inv", inv, torch.int64, nv_p),
                              ("perm", perm, torch.int64, None),
                              ("d", d, None, nv_p)):
        if (t.dim() != 1 or not t.is_contiguous()
                or (size is not None and t.shape[0] != size)
                or (dt is not None and t.dtype != dt)
                or t.device != linv.device):
            raise ValueError(f"solve_program: pd's {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return [linv, sub], int(perm.shape[0])


def solve_program(kind, leaves):
    """The SolveProgram of one solve against factor leaves (tensors or
    views with row-major blocks): "btd" (linv (nb, P, n, n), sub
    (nb - 1, P, n, n)); "cr" each level's (Li, G_lo, G_hi) (n_odd, P, n, n),
    then the root's (linv, sub); "pair" (Lc^{-1} (n, n),) against r (1, n);
    "pd" (linv (nb, 1, n, n), sub, inv, perm, d) against r (nV, 3): the
    gather stage (rows permuted by inv, zero-padded, / d) into the
    workspace, the scan's 4 nb - 2 products on (n, 3) blocks (each x_k
    over its own right-hand side there), the scatter stage (/ d, un-permuted
    by perm) into z (nV, 3). Every factor leaf of one dtype. The inverse
    factors (linv, Li, Lc^{-1}) must hold exact zeros above the diagonal,
    as K6 writes them: the kernel reads their lower triangle only. Built on
    the host; on a CUDA device the table is uploaded once (pinned, no host
    wait)."""
    if kind == "pair":
        leaves = [leaves[0].view(1, 1, *leaves[0].shape)]
    fac, k = leaves, 1
    if kind == "pd":
        fac, n_vert = _pd_tables(leaves)
        k = 3
    n = fac[0].shape[-1]
    for t in fac:
        if t.dim() != 4 or t.shape[-2] != n or (
                n > 1 and (t.stride(-1) != 1 or t.stride(-2) != n)):
            raise ValueError(f"solve_program: a leaf of shape "
                             f"{tuple(t.shape)}, strides {t.stride()}")
        if t.dtype != fac[0].dtype or t.device != fac[0].device:
            raise TypeError("solve_program: leaves of mixed dtype or device")
    P = fac[0].shape[1]
    shape = None
    if kind in ("btd", "pd"):
        nb = fac[0].shape[0]
        b = _Stages(fac, P, nb, n, {0}, k)
        if kind == "btd":
            T = b.alloc(1)
            b.scan(0, 1, nb, lambda j: b.orig(BUF_R, 0, j, 0),
                   lambda j: b.blk(T), lambda j: b.orig(BUF_Z, 0, j, 0),
                   sync=False)
        else:
            # R: the gathered right-hand side, block j at R + j n 3; x_j
            # overwrites its r_j (read by the forward pass only)
            R, T = b.alloc(nb), b.alloc(1)
            b.add_rows(OP_GATHER, nb * n, 2, 4, (BUF_R, 0), (BUF_WS, R),
                       sync=False)
            b.scan(0, 1, nb, lambda j: b.blk(R, j), lambda j: b.blk(T),
                   lambda j: b.blk(R, j), sync=True)
            b.add_rows(OP_SCATTER, n_vert, 3, 4, (BUF_WS, R), (BUF_Z, 0))
            shape = (n_vert, k)
    elif kind == "cr":
        n_lev = (len(leaves) - 2) // 3
        if n_lev < 1 or len(leaves) != 3 * n_lev + 2:
            raise ValueError(f"solve_program: {len(leaves)} leaves of a "
                             "cyclic-reduction factor")
        nb = sum(leaves[3 * i].shape[0] for i in range(n_lev)) \
            + leaves[-2].shape[0]
        b = _Stages(leaves, P, nb, n,
                    {3 * i for i in range(n_lev)} | {3 * n_lev})
        _cr_program(b, n_lev)
    elif kind == "pair":
        nb = 1
        b = _Stages(leaves, 1, nb, n, {0})
        Y = b.alloc(1)
        b.add(OP_A, 1, b.leaf(0), b.orig(BUF_R, 0, 0, 0), b.blk(Y),
              sync=False)
        b.add(OP_AT, 1, b.leaf(0), b.blk(Y), b.orig(BUF_Z, 0, 0, 0))
    else:
        raise ValueError(f"solve_program: kind {kind!r}")
    stages = np.stack(b.rows)
    op = stages[:, F_OP]
    groups = np.where(op == OP_A, -(-n // rows_per_item(k)), -(-n // 32))
    items = stages[:, F_NJ] * stages[:, F_NP] * np.where(op == OP_COPY, 1,
                                                         groups)
    items = items[~np.isin(op, ELEMENTWISE)]
    table = None
    dev = fac[0].device
    ptrs = tuple(t.data_ptr() for t in leaves)
    if dev.type == "cuda":
        ptr = np.asarray(ptrs, np.int64)
        tab = stages.copy()
        has_a = op != OP_COPY
        tab[has_a, F_A] = ptr[tab[has_a, F_A]]
        rows = np.isin(op, ELEMENTWISE)
        tab[rows, F_D] = ptr[tab[rows, F_D]]
        table = torch.from_numpy(tab).pin_memory().to(dev, non_blocking=True)
    return SolveProgram(kind=kind, stages=stages, P=int(P), nb=int(nb),
                        n=int(n), ws=int(b.ws), max_items=int(items.max()),
                        table=table, ptrs=ptrs, k=k,
                        shape=shape or (int(P), int(nb * n)))


def solve_cost(prog, leaves, r):
    """(bytes, operations) one solve of `prog` needs at least: each factor
    leaf read once, of an inverse factor (the stages flag F_LOWER) its
    lower triangles only, n (n + 1) / 2 entries a block; the "pd" kind's
    inv, perm and d once; r read and z written once; two operations an
    entry of each block product the stages do, per column, and one an
    entry of the element-wise stages (a division)."""
    n, k = prog.n, prog.k
    tri = n * (n + 1) // 2
    st = prog.stages
    prod = st[~np.isin(st[:, F_OP], (OP_COPY,) + ELEMENTWISE)]
    lower = set(prod[prod[:, F_LOWER] == 1, F_A].tolist())
    nbytes = 2 * r.numel() * r.element_size()
    n_fac = 2 if prog.kind == "pd" else len(leaves)
    for i, t in enumerate(leaves):
        blocks = t.numel() // (n * n)
        nbytes += (t.numel() if i >= n_fac else blocks * (
            tri if i in lower else n * n)) * t.element_size()
    entries = np.where(prod[:, F_LOWER] == 1, tri, n * n)
    rows = st[np.isin(st[:, F_OP], ELEMENTWISE), F_NJ]
    return nbytes, 2 * k * int((prod[:, F_NJ] * prod[:, F_NP]
                                * entries).sum()) + k * int(rows.sum())


def run_solve_program_ref(prog, leaves, r):
    """CPU mirror of K7's solve kernel: walks prog's stages in order over
    r, the output z (prog.shape) and a workspace, each stage's products as
    one block_matvec_ref call (pd.block_matvec_k_ref with k columns) on the
    blocks the table names (F_LOWER's blocks whole: their zeros change no
    sum), the element-wise stages as pd.pd_gather_ref / pd_scatter_ref.
    Equal to block_solve_ref bit for bit (the same calls on the same
    values)."""
    n, k = prog.n, prog.k
    vn = n * k
    if prog.kind == "pair":
        leaves = [leaves[0].view(1, 1, n, n)]
    z = torch.empty(prog.shape, dtype=r.dtype, device=r.device)
    ws = torch.empty(prog.ws, dtype=r.dtype, device=r.device)
    bufs = (r, z, ws)
    for row in prog.stages.tolist():
        shape = (row[F_NJ], row[F_NP])
        if row[F_OP] in ELEMENTWISE:
            src = bufs[row[F_V]].reshape(-1)[row[F_V_OFF]:].view(-1, k)
            tab, d = leaves[row[F_A]], leaves[row[F_D]]
            res = (pd.pd_gather_ref(src, tab, d) if row[F_OP] == OP_GATHER
                   else pd.pd_scatter_ref(src[:d.shape[0]], tab, d))
            off = row[F_O_OFF]
            bufs[row[F_O]].view(-1)[off:off + res.numel()] = res.view(-1)
            continue

        def vec(f):
            t = bufs[row[f]]
            return t.as_strided(shape + (vn,), (row[f + 2], row[f + 3], 1),
                                t.storage_offset() + row[f + 1])
        v, out = vec(F_V), vec(F_O)
        if row[F_OP] == OP_COPY:
            out.copy_(v)
            continue
        leaf = leaves[row[F_A]]
        A = leaf.as_strided(shape + (n, n), (row[F_A_SJ], row[F_A_SP], n, 1),
                            leaf.storage_offset() + row[F_A_OFF])
        c = None if row[F_C] < 0 else vec(F_C).reshape(-1, n, k)
        vv = v.reshape(-1, n, k).contiguous()
        if k == 1:
            res = block_matvec_ref(A.reshape(-1, n, n), vv[..., 0],
                                   None if c is None else c[..., 0],
                                   row[F_OP] == OP_AT)
        else:
            res = pd.block_matvec_k_ref(A.reshape(-1, n, n), vv, c,
                                        row[F_OP] == OP_AT)
        out.copy_(res.reshape(out.shape))
    return z


def h0_gather_ref(rhs, l2g, valid, d):
    """K8 plain (gather): r = rhs[l2g] * valid / d. rhs: (nV, 3); l2g,
    valid: (P, N); d: (P, 3N). Returns (P, 3N)."""
    P = l2g.shape[0]
    r = rhs[l2g] * valid[..., None]
    return r.reshape(P, -1) / d


def h0_average_ref(z, d, perm, segids, seg_off, dup):
    """K8 plain (average): p = z / d, gathered by `perm` and summed over the
    sorted vertex ids `segids` (id nV is the dump), divided by the
    duplicate counts. z, d: (P, 3N); dup: (nV,). Returns (nV, 3). The CSR
    offsets `seg_off` of `segids` are the kernel's; unused here."""
    n_vert = dup.shape[0]
    p_l = (z / d).reshape(-1, 3)
    acc = torch.zeros((n_vert + 1, 3), dtype=z.dtype, device=z.device)
    acc.index_add_(0, segids, p_l[perm])
    return acc[:n_vert] / dup[:, None]


def band_equilibrate_ref(compact, lp):
    """The first half of K12 plain: (the compact scaled by dinv[row]
    dinv[col], d (P, 3N)) with d the square root of the compact diagonal
    blocks' diagonals, 1 at padding slots."""
    has = lp.diag_slot >= 0
    d2 = torch.ones((lp.diag_slot.shape[0], 3), dtype=compact.dtype,
                    device=compact.device)
    d2[has] = compact[lp.diag_slot[has]][:, [0, 4, 8]]
    d = torch.sqrt(d2)
    dinv = 1.0 / d
    sr = dinv[lp.ub_row]
    sc = dinv[lp.ub_col]
    eq = compact * (sr[:, :, None] * sc[:, None, :]).reshape(-1, 9)
    return eq, d.reshape(lp.n_parts, -1)


def band_equil_scatter_ref(compact, lp, bdt):
    """K12 plain: (the flat [diag | sub] band (lp.total,) in `bdt` holding
    the equilibrated lower blocks and unit pad diagonals, d (P, 3N))."""
    eq, d = band_equilibrate_ref(compact, lp)
    flat = torch.zeros(lp.total + 1, dtype=bdt, device=compact.device)
    flat[lp.dest] = eq[lp.sel].to(bdt).reshape(-1)
    flat[lp.pad_diag] = 1.0
    return flat[:lp.total], d
