"""Plain PyTorch versions of the four H0 kernels (K5-K8), and the host-side
CSR offsets their CUDA versions walk.

K5 band_assemble   block-tridiagonal H0 assembly (dot_tpu/steppers/core.py
                   676-706 _assembly_compact, 733-774 _band_compact /
                   _assemble_btd)
K6 chol_inv        batched Cholesky L and L^{-1} of SPD blocks (the diagonal
                   blocks of core.py 853-1203)
K7 block_matvec    out = c - op(A) v over a batch of blocks (core.py
                   1061-1135 _cr_solve, 1219-1261 _btd_solve)
K8 h0_gather /     the vertex gather and duplicate-averaging segment sum of
   h0_average      h0_apply (core.py 1263-1280)

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


def csr_offsets(sorted_ids, n_segments):
    """(n_segments + 1,) int64 run offsets of a sorted id array (numpy)."""
    ids = np.asarray(sorted_ids, np.int64)
    if ids.size and np.any(np.diff(ids) < 0):
        raise ValueError("segment ids must be sorted")
    return np.searchsorted(ids, np.arange(n_segments + 1)).astype(np.int64)


def band_assemble_ref(elem_h, freef, mass_flat, plan):
    """K5 plain: the flat [diag | sub] band (plan.total,) from the (144, nEp)
    block-major element Hessians. freef: (P*N,) 0/1 free-vertex mask;
    mass_flat: (P*N,) lumped mass per local vertex."""
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
