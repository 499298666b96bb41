"""The two-level H0's coarse space: host-side tables and the plain PyTorch
versions of K10 and K11.

K10 coarse_assemble   Kc = Z^T (dt^2 K + M) Z over 6 rigid modes per part
                      (dot_tpu/steppers/core.py:1319-1429 _coarse_factor,
                      up to the symmetrization)
K11 coarse_restrict / the restriction Z^T r / dc and the prolongation
    coarse_prolong    Z (y / dc) of the coarse apply (core.py:1296-1317
                      _coarse_apply); the solve between them is one
                      launch of K7's solve entry on Lc^{-1}

Z's columns for part p are, at each free vertex v it owns, the three
translations and the three rotations e_k x xc_v about the part's centroid
(xc centred and scaled as dot_tpu does, core.py:303-314): at a vertex
Z_v = free_v [I | S(xc_v)] with S(x)[j][k] = (e_k x x)_j.

K10 reduces a host-built item list in destination order. An item is
  - a uniform element (all four corners owned by one part q): its whole
    B^T H B, into Kc[q, q];
  - one corner pair (a <= b) of a mixed element: B_a^T H_ab B_b into
    Kc[own_a, own_b], and for a < b its transpose into Kc[own_b, own_a]
    (dot_tpu's split, core.py:320-352 and 1376-1411);
  - a vertex: the lumped-mass block m_v [I, S; S^T, S^T S] into Kc[q, q].
Padding elements carry zero Hessians and are left out. The items are
sorted by destination block (stable, so each run keeps element order) and
cut into chunks that never straddle two destinations; the kernel reduces
a chunk per thread block, and the chunk sums of a destination in order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

CHUNK = 512              # items per K10 thread block
KIND_UNIFORM = 32        # item code = index * 64 + kind; kinds < 32 are
KIND_VERTEX = 33         # (a * 4 + b) * 2 + transposed of a mixed pair


class CoarsePlan(NamedTuple):
    """Static tables of the coarse space (one per System)."""
    n_parts: int
    own: torch.Tensor        # (nV,) int64 owner part of each vertex
    xc: torch.Tensor         # (nV, 3) centred, scaled rest positions
    items: torch.Tensor      # (nI,) int64 item codes, destination order
    item_dest: torch.Tensor  # (nI,) int64 destination block p * P + q
    chunk_off: torch.Tensor  # (nC+1,) int64 item offsets of the chunks
    pair_off: torch.Tensor   # (nD+1,) int64 chunk offsets of each block
    pair_dest: torch.Tensor  # (nD,) int64 destination block of each run
    vperm: torch.Tensor      # (nV,) int64 vertices sorted by owner
    voff: torch.Tensor       # (P+1,) int64 owner runs of vperm
    counts: dict             # items by kind: uniform, pairs, vertices


def owner_and_xc(mesh, part):
    """(own (nV,) int32, xc (nV, 3) float64): the owner part of each vertex
    (the part of the last element listing it, as dot_tpu's scatter
    leaves it) and the rest positions about the owner's centroid, scaled
    by their largest entry (core.py:304-314)."""
    n_parts = int(part.max()) + 1
    own = np.zeros(mesh.n_vert, np.int32)
    own[mesh.conn.ravel()] = np.repeat(part, 4).astype(np.int32)
    cnt = np.bincount(own, minlength=n_parts).astype(np.float64)
    csum = np.zeros((n_parts, 3))
    np.add.at(csum, own, mesh.V_rest)
    cent = csum / np.maximum(cnt, 1.0)[:, None]
    xc = mesh.V_rest - cent[own]
    sc = float(np.abs(xc).max()) or 1.0
    return own, xc / sc


def build_plan(mesh, plan, dtype, device):
    """CoarsePlan for a SubdomainPlan `plan` (numpy) of `mesh`."""
    P = int(plan.n_parts)
    own, xc = owner_and_xc(mesh, np.asarray(plan.part))
    valid = np.asarray(plan.elem_valid)
    conn = np.where(valid[:, None], mesh.conn[plan.elem_src], 0)
    own_e = own[conn].astype(np.int64)                  # (nEp, 4)
    uniform = valid & (own_e == own_e[:, :1]).all(axis=1)
    mixed = valid & ~uniform
    eu = np.flatnonzero(uniform)
    em = np.flatnonzero(mixed)
    codes = [eu * 64 + KIND_UNIFORM]
    dests = [own_e[eu, 0] * (P + 1)]
    for a in range(4):
        for b in range(a, 4):
            codes.append(em * 64 + (a * 4 + b) * 2)
            dests.append(own_e[em, a] * P + own_e[em, b])
            if b > a:
                codes.append(em * 64 + (a * 4 + b) * 2 + 1)
                dests.append(own_e[em, b] * P + own_e[em, a])
    vid = np.arange(mesh.n_vert, dtype=np.int64)
    codes.append(vid * 64 + KIND_VERTEX)
    dests.append(own.astype(np.int64) * (P + 1))
    codes = np.concatenate(codes)
    dests = np.concatenate(dests)
    order = np.argsort(dests, kind="stable")
    codes, dests = codes[order], dests[order]

    # destination runs, each cut into chunks of at most CHUNK items
    starts = np.flatnonzero(np.r_[True, dests[1:] != dests[:-1]])
    lens = np.diff(np.r_[starts, len(dests)])
    nch = -(-lens // CHUNK)
    pair_off = np.r_[0, np.cumsum(nch)].astype(np.int64)
    first = np.repeat(starts, nch)
    rank = np.arange(pair_off[-1]) - np.repeat(pair_off[:-1], nch)
    chunk_off = np.r_[first + rank * CHUNK, len(dests)].astype(np.int64)

    vperm = np.argsort(own, kind="stable").astype(np.int64)
    voff = np.searchsorted(own[vperm], np.arange(P + 1)).astype(np.int64)

    def t(a, dt=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return CoarsePlan(
        n_parts=P, own=t(own), xc=t(xc, dtype), items=t(codes),
        item_dest=t(dests), chunk_off=t(chunk_off), pair_off=t(pair_off),
        pair_dest=t(dests[starts]), vperm=t(vperm), voff=t(voff),
        counts=dict(uniform=len(eu), pairs=len(codes) - len(eu)
                    - mesh.n_vert, vertices=mesh.n_vert))


def _bmat(f, x):
    """(N, 3, 6) rows of Z at N corners: f [I | S(x)]."""
    z = torch.zeros_like(f)
    x0, x1, x2 = x[:, 0], x[:, 1], x[:, 2]
    rows = [[f, z, z, z, f * x2, f * -x1],
            [z, f, z, f * -x2, z, f * x0],
            [z, z, f, f * x1, f * -x0, z]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _smat(x):
    """(N, 3, 3) S(x)[j][k] = (e_k x x)_j."""
    z = torch.zeros_like(x[:, 0])
    x0, x1, x2 = x[:, 0], x[:, 1], x[:, 2]
    return torch.stack([torch.stack([z, x2, -x1], -1),
                        torch.stack([-x2, z, x0], -1),
                        torch.stack([x1, -x0, z], -1)], -2)


def coarse_assemble_ref(elem_h, conn, freev, mass, cp):
    """K10 plain: the (P*P, 36) blocks of Kc = Z^T (dt^2 K + M) Z, not yet
    symmetrized. elem_h (144, nEp) block-major; conn (4, nEp) int32
    gather ids; freev, mass (nV,); cp: CoarsePlan."""
    P, dt, dev = cp.n_parts, elem_h.dtype, elem_h.device
    Kc = torch.zeros((P * P, 36), dtype=dt, device=dev)
    idx, kind = cp.items // 64, cp.items % 64
    xc = cp.xc

    def corner(c, e):
        v = conn[c, e].long()
        return _bmat(freev[v], xc[v])

    sel = kind == KIND_UNIFORM
    e = idx[sel]
    if e.numel():
        B = torch.cat([corner(c, e) for c in range(4)], 1)     # (n, 12, 6)
        comp = torch.tensor([(a * 4 + b) * 9 + i * 3 + j
                             for a in range(4) for i in range(3)
                             for b in range(4) for j in range(3)],
                            device=dev)
        Ht = elem_h[comp][:, e].t().reshape(-1, 12, 12)
        Me = B.mT @ Ht @ B
        Kc.index_add_(0, cp.item_dest[sel], Me.reshape(-1, 36))

    sel = kind < 32
    if sel.any():
        e, k = idx[sel], kind[sel]
        ab, tr = k // 2, k % 2
        a, b = ab // 4, ab % 4
        H = elem_h.reshape(16, 9, -1)[ab, :, e].reshape(-1, 3, 3)
        va = conn[a, e].long()
        vb = conn[b, e].long()
        Ba = _bmat(freev[va], xc[va])
        Bb = _bmat(freev[vb], xc[vb])
        M = Ba.mT @ H @ Bb
        M = torch.where(tr[:, None, None] == 1, M.mT, M)
        Kc.index_add_(0, cp.item_dest[sel], M.reshape(-1, 36))

    sel = kind == KIND_VERTEX
    v = idx[sel]
    fm = freev[v] * mass[v]
    S = _smat(xc[v])
    eye = torch.eye(3, dtype=dt, device=dev)
    StS = (S[:, 0, :, None] * S[:, 0, None, :] + S[:, 1, :, None]
           * S[:, 1, None, :] + S[:, 2, :, None] * S[:, 2, None, :])
    top = torch.cat([fm[:, None, None] * eye, fm[:, None, None] * S], 2)
    bot = torch.cat([fm[:, None, None] * S.mT, fm[:, None, None] * StS], 2)
    Kc.index_add_(0, cp.item_dest[sel], torch.cat([top, bot], 1)
                  .reshape(-1, 36))
    return Kc


def coarse_restrict_ref(rhs, freev, dc, cp):
    """K11 plain (restrict): [t_p, m_p] / dc, (6P,), with t_p and m_p the
    sums over the vertices part p owns of free r and xc x (free r)."""
    P = cp.n_parts
    r = rhs * freev[:, None]
    t = torch.zeros((P, 3), dtype=r.dtype, device=r.device)
    m = torch.zeros((P, 3), dtype=r.dtype, device=r.device)
    t.index_add_(0, cp.own, r)
    m.index_add_(0, cp.own, torch.linalg.cross(cp.xc, r))
    return torch.cat([t, m], 1).reshape(-1) / dc


def coarse_prolong_ref(y, dc, freev, cp, base=None):
    """K11 plain (prolong): (yt + yr x xc) free at every vertex, with
    (yt, yr) = (y / dc) of its owner part; plus `base` (nV, 3) if given."""
    yc = (y / dc).reshape(cp.n_parts, 6)
    yt = yc[:, :3][cp.own]
    yr = yc[:, 3:][cp.own]
    out = (yt + torch.linalg.cross(yr, cp.xc)) * freev[:, None]
    return out if base is None else base + out
