"""Plain PyTorch versions of the kernels K13-K16 of the non-DOT steppers,
and the host-side tables their CUDA versions walk.

K13 hessian_diag     diagonal of M + dt^2 H per vertex (warmStart 5;
                     dot_tpu/steppers/core.py 1587-1601)
K14 pd_assemble      the LBFGS-PD matrix M + dt^2 D^T W D in its RCM-banded
                     flat [diag | sub] storage (core.py 1656-1686
                     _pd_pair_vals / _build_pd_factor)
K15 pd_solve's      c - op(A) v against k right-hand sides
    products and     (block_matvec_k_ref: the k-column einsums of core.py
    passes           1224-1261 _btd_solve) and the permute / scale passes
                     of core.py 1704-1714 pd_solve (pd_gather_ref,
                     pd_scatter_ref); on the card all of it is one launch
                     of K7's solve entry (band.block_solve_ref)
K16 local_gather_one / local_scatter_one
                     one subdomain's rhs gather and zero-extended scatter of
                     the GSDD sweep (core.py 1282-1294, gsdd.py 52-55)

The CPU tests use these, and System(use_kernels=False) takes them on any
device for comparison runs; the main path on a card never does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PDPlan(NamedTuple):
    """Static tables of the banded PD matrix (from partition.PDBandPlan)."""
    bs: int                   # scalar block size
    nb: int                   # number of diagonal blocks
    nv_p: int                 # nb * bs padded vertex count
    total: int                # band length (diag + sub)
    perm: torch.Tensor        # (nV,) int64 permuted row of each vertex
    inv: torch.Tensor         # (nv_p,) int64 vertex of each row, -1 = pad
    dest: torch.Tensor        # (16 * nEp,) int64 band slots; `total` dropped
    items: torch.Tensor       # (nItems,) int64 kept items pair * nEp + e,
                              #   sorted by destination (stable)
    seg_off: torch.Tensor     # (nDest + 1,) int64 CSR offsets of `items`
    udest: torch.Tensor       # (nDest,) int64 the runs' band slots
    diag_dest: torch.Tensor   # (nV,) int64 band slots of the vertex diagonals
    pad_dest: torch.Tensor    # (nPad,) int64 band slots of padding diagonals


def pd_plan(bp, device):
    """PDPlan from a numpy partition.PDBandPlan."""
    dest = np.asarray(bp.dest, np.int64).reshape(-1)
    keep = np.flatnonzero(dest < bp.total)
    order = keep[np.argsort(dest[keep], kind="stable")]
    udest, first = np.unique(dest[order], return_index=True)
    seg_off = np.concatenate([first, [order.size]]).astype(np.int64)
    perm = np.asarray(bp.perm, np.int64)
    inv = np.full(bp.nv_p, -1, np.int64)
    inv[perm] = np.arange(perm.size)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                               device=device)
    return PDPlan(bs=int(bp.bs), nb=int(bp.nb), nv_p=int(bp.nv_p),
                  total=int(bp.total), perm=t(perm), inv=t(inv), dest=t(dest),
                  items=t(order), seg_off=t(seg_off), udest=t(udest),
                  diag_dest=t(bp.diag_dest), pad_dest=t(bp.pad_dest))


def incidence_csr(conn_scatter, n_vert):
    """(perm, segids, seg_off) of the (element, corner) incidences e*4+c
    sorted by vertex (stable; vertex n_vert is the padding dump), as
    dot_tpu builds scat_perm / scat_segids (core.py:244-248); numpy, from
    the (nEp, 4) scatter connectivity."""
    flat = np.asarray(conn_scatter).reshape(-1)
    perm = np.argsort(flat, kind="stable")
    segids = flat[perm].astype(np.int64)
    off = np.searchsorted(segids, np.arange(n_vert + 2)).astype(np.int64)
    return perm.astype(np.int64), segids, off


def hessian_diag_ref(elem_h, perm, segids, seg_off, mass):
    """K13 plain: (nV, 3) mass + the (corner, coordinate) diagonal entries
    (rows (c*4+c)*9 + 4i of the block-major (144, nEp) buffer) summed per
    vertex over the sorted incidences. `seg_off` is the kernel's."""
    n_vert = mass.shape[0]
    cols = []
    for i in range(3):
        vals = torch.stack([elem_h[(c * 4 + c) * 9 + 4 * i]
                            for c in range(4)], dim=1).reshape(-1)[perm]
        acc = torch.zeros(n_vert + 1, dtype=elem_h.dtype,
                          device=elem_h.device)
        acc.index_add_(0, segids, vals)
        cols.append(acc[:n_vert])
    return torch.stack(cols, dim=-1) + mass[:, None]


def pd_pair_vals_ref(g9, conn, w, freev):
    """(16, nEp) per-element (a, b) values w_e sum_i D_a,i D_b,i masked to
    free x free vertex pairs; D's corner 0 is minus the column sum of
    restTriInv (g9 (9, nEp)); conn (4, nEp) gather ids; freev (nV,) 0/1."""
    D = [[-((g9[j] + g9[3 + j]) + g9[6 + j]) for j in range(3)]] + \
        [[g9[(c - 1) * 3 + j] for j in range(3)] for c in range(1, 4)]
    fr = [freev[conn[c].long()] for c in range(4)]
    return torch.stack([
        w * sum(D[a][i] * D[b][i] for i in range(3)) * fr[a] * fr[b]
        for a in range(4) for b in range(4)])


def pd_assemble_ref(g9, conn, w, freev, mass, plan):
    """K14 plain: the flat [diag | sub] band (plan.total,): pair values
    scatter-added (slot `total` dropped), mass * free + (1 - free) added on
    the vertex diagonals, 1 on the padding rows' diagonals."""
    vals = pd_pair_vals_ref(g9, conn, w, freev).reshape(-1)
    flat = torch.zeros(plan.total + 1, dtype=g9.dtype, device=g9.device)
    flat.index_add_(0, plan.dest, vals)
    flat = flat[:plan.total]
    flat[plan.diag_dest] += mass * freev + (1.0 - freev)
    flat[plan.pad_dest] = 1.0
    return flat


def block_matvec_k_ref(A, v, c=None, trans=False, out=None):
    """K15 plain: op(A) v, or c - op(A) v, with k right-hand sides: A
    (B, n, n) in bf16, f32 or f64 (taken to v's dtype), v and c (B, n, k).
    `out` (may be c) receives the result."""
    a = A.mT if trans else A
    r = torch.matmul(a.to(v.dtype), v)
    if c is not None:
        r = c - r
    if out is None:
        return r
    out.copy_(r)
    return out


def pd_gather_ref(rhs, inv, d):
    """K15 plain (gather): rows permuted and zero-padded, / d. rhs (nV, 3);
    inv (nv_p,) vertex of each row or -1; d (nv_p,). Returns (nv_p, 3)."""
    rp = torch.where((inv >= 0)[:, None], rhs[inv.clamp(min=0)], 0.0)
    return rp / d[:, None]


def pd_scatter_ref(z, perm, d):
    """K15 plain (scatter): (z / d)[perm]. z (nv_p, 3) -> (nV, 3)."""
    return (z / d[:, None])[perm]


def local_gather_one_ref(rhs, l2g, valid, d, part):
    """K16 plain (gather): subdomain `part`'s rhs[l2g] * valid / d, (3N,).
    rhs (nV, 3); l2g, valid (P, N); d (P, 3N)."""
    r = rhs[l2g[part]] * valid[part][:, None]
    return r.reshape(-1) / d[part]


def local_scatter_one_ref(z, d, l2g, valid, part, n_vert):
    """K16 plain (scatter): subdomain `part`'s z / d (3N,) as a
    zero-extended (nV, 3) direction; padded slots (l2g 0) go to a dump row
    so that vertex 0 is not clobbered."""
    p_l = (z / d[part]).reshape(-1, 3) * valid[part][:, None]
    idx = torch.where(valid[part], l2g[part],
                      torch.full_like(l2g[part], n_vert))
    p = torch.zeros((n_vert + 1, 3), dtype=z.dtype, device=z.device)
    p[idx] = p_l
    return p[:n_vert]
