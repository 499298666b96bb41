"""Plain PyTorch versions of the H0 kernels K5-K8 and K12, and the
host-side tables their CUDA versions walk.

K5 band_assemble   block-tridiagonal H0 assembly (dot_tpu/steppers/core.py
                   676-706 _assembly_compact, 733-774 _band_compact /
                   _assemble_btd)
K6 chol_inv        batched Cholesky L and L^{-1} of SPD blocks (the diagonal
                   blocks of core.py 853-1203)
K7 block_matvec    out = c - op(A) v over a batch of blocks (core.py
                   1061-1135 _cr_solve, 1219-1261 _btd_solve)
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
