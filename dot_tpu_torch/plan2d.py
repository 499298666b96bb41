"""Static 2D decomposition plans (host numpy; port of dot_tpu/dim2.py:149-350).

`build_plan_2d` partitions the triangles by recursive coordinate bisection
and emits DOT's overlapping element plan with interface completion;
`build_node_plan_2d` emits LBFGS-JH's disjoint node plan. Both end in
`_finish_plan_2d`, which turns (subdomain, element, corner a, corner b,
local row, local col) tuples into the flat scalar assembly of the dense
(P, n2, n2) subdomain matrices and the sorted gather of the duplicate
averaging. The arrays are dot_tpu's, element by element, when both pad n2
to the same multiple (dot_tpu pads to 64, a TPU tile choice: here it is
the argument `pad_to`, 64 by default).

`asm_src` indexes dot_tpu's block-major (36, nE) element Hessians,
component (a*3 + b)*4 + i*2 + j; kernels/dd2d.py maps it to the row-major
(36, nE) order of K23 when it derives the kernels' tables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .partition import rcb_partition


class Plan2D(NamedTuple):
    """Static 2D decomposition plan: RCB element partition, overlapping
    local vertex maps, interface-completion assembly tuples and dense
    scatter destinations (the 2D analog of partition.SubdomainPlan;
    reference partition semantics: DOTTimeStepper.cpp:618-797 at DIM = 2).
    Dense only: a 2D subdomain matrix is a few thousand dofs wide."""
    n_parts: int
    n_local_max: int
    n2: int                       # 2 * n_local_max (padded)
    part: np.ndarray              # (nE,)
    local_to_global: np.ndarray   # (P, N) i32, pad -> 0
    local_valid: np.ndarray       # (P, N) bool
    dup: np.ndarray               # (nV,)
    asm_src: np.ndarray           # (nTup*4,) flat index into elem_h (36*nE)
    asm_dest: np.ndarray          # (nTup*4,) flat dest into (P*n2*n2)
    gath_perm: np.ndarray         # (P*N,)
    gath_segids: np.ndarray       # (P*N,)


def _completion_tuples_2d(conn, part, locals_, g2l, dup, n_parts, n_vert):
    """Interface-completion tuples at dim 2: for (subdomain p, shared local
    vertex v, incident element e NOT owned by p, corner a of e at v) the
    missing diagonal block (a, a) at (lv, lv) plus off-diagonal blocks
    toward the element's other corners that are also local to p
    (reference: fillInDecomposedHessians, DOTTimeStepper.cpp:694-788 at
    DIM = 2)."""
    if n_parts <= 1:
        z = np.empty(0, np.int32)
        return z, np.empty(0, np.int64), z, z, z, z
    flat = conn.ravel()
    order = np.argsort(flat, kind="stable")
    inc_elem = order // 3
    inc_corner = (order % 3).astype(np.int32)
    starts = np.searchsorted(flat[order], np.arange(n_vert + 1))
    deg = (starts[1:] - starts[:-1]).astype(np.int64)
    is_shared = dup > 1
    pr_l, vr_l = [], []
    for p in range(n_parts):
        sv = locals_[p][is_shared[locals_[p]]]
        pr_l.append(np.full(len(sv), p, np.int32))
        vr_l.append(sv.astype(np.int64))
    pv_p = np.concatenate(pr_l)
    pv_v = np.concatenate(vr_l)
    reps = deg[pv_v]
    pair_p = np.repeat(pv_p, reps)
    idx = (np.repeat(starts[pv_v], reps)
           + (np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps,
                                                reps)))
    pair_e = inc_elem[idx]
    pair_a = inc_corner[idx]
    keep = part[pair_e] != pair_p
    pair_p, pair_e, pair_a = pair_p[keep], pair_e[keep], pair_a[keep]
    pair_v = np.repeat(pv_v, reps)[keep]
    lv = g2l[pair_p, pair_v]
    b3 = np.arange(3, dtype=np.int32)
    w = conn[pair_e][:, b3]
    lw = g2l[pair_p[:, None], w]
    okb = (lw >= 0) & (b3[None, :] != pair_a[:, None])
    okb[np.arange(len(pair_a)), pair_a] = True     # diagonal (a, a)
    lw[np.arange(len(pair_a)), pair_a] = lv
    pi, bj = np.nonzero(okb)
    return (pair_p[pi], pair_e[pi].astype(np.int64), pair_a[pi],
            bj.astype(np.int32), lv[pi], lw[pi, bj])


def build_plan_2d(mesh, n_parts, pad_to=64):
    """Partition the triangle mesh (RCB over centroids; one part when
    n_parts <= 1) and emit the assembly plan with DOT's interface
    completion: each subdomain's matrix carries, for every shared vertex,
    the missing diagonal and interface-interface 2x2 blocks of elements
    owned by other subdomains (reference: fillInDecomposedHessians,
    DOTTimeStepper.cpp:618-797). n2 is padded to a multiple of `pad_to`."""
    conn = mesh.conn.astype(np.int64)
    n_elem, n_vert = mesh.n_elem, mesh.n_vert
    if n_parts <= 1:
        part = np.zeros(n_elem, np.int32)
        n_parts = 1
    else:
        cent = mesh.V_rest[conn].mean(axis=1)
        part = rcb_partition(cent, n_parts)

    by_part = [np.where(part == p)[0] for p in range(n_parts)]
    assert all(len(e) for e in by_part), "empty 2D subdomain"
    locals_ = [np.unique(conn[e].ravel()) for e in by_part]
    g2l = np.full((n_parts, n_vert), -1, np.int32)
    for p, l in enumerate(locals_):
        g2l[p, l] = np.arange(len(l), dtype=np.int32)
    dup = np.zeros(n_vert, np.int32)
    for l in locals_:
        dup[l] += 1

    # own-element tuples: all 9 corner pairs per triangle
    own_sbd = np.repeat(part, 9).astype(np.int32)
    own_elem = np.repeat(np.arange(n_elem, dtype=np.int64), 9)
    corners = np.indices((3, 3)).reshape(2, 9).T
    own_a = np.tile(corners[:, 0], n_elem).astype(np.int32)
    own_b = np.tile(corners[:, 1], n_elem).astype(np.int32)
    own_row = g2l[own_sbd, conn[own_elem, own_a]]
    own_col = g2l[own_sbd, conn[own_elem, own_b]]

    c_sbd, c_elem, c_a, c_b, c_row, c_col = _completion_tuples_2d(
        conn, part, locals_, g2l, dup, n_parts, n_vert)

    i64 = np.int64
    return _finish_plan_2d(
        n_parts, n_elem, n_vert, part, locals_, dup,
        np.concatenate([own_sbd, c_sbd]).astype(i64),
        np.concatenate([own_elem, c_elem]),
        np.concatenate([own_a, c_a]).astype(i64),
        np.concatenate([own_b, c_b]).astype(i64),
        np.concatenate([own_row, c_row]).astype(i64),
        np.concatenate([own_col, c_col]).astype(i64), pad_to)


def _finish_plan_2d(n_parts, n_elem, n_vert, part, locals_, dup, asm_sbd,
                    asm_elem, asm_a, asm_b, asm_row, asm_col, pad_to):
    """Turn assembly tuples into the flat scalar scatter plan (shared by the
    overlapping element plan and the disjoint node plan)."""
    n_local_max = max(len(l) for l in locals_)
    n2 = -(-2 * n_local_max // pad_to) * pad_to
    n_local_max = n2 // 2
    local_to_global = np.zeros((n_parts, n_local_max), np.int32)
    local_valid = np.zeros((n_parts, n_local_max), bool)
    for p, l in enumerate(locals_):
        local_to_global[p, :len(l)] = l
        local_valid[p, :len(l)] = True

    # per-scalar gather / scatter: component (a*3+b)*4 + i*2+j of element e
    # lands at sbd*(n2^2) + (row*2+i)*n2 + col*2+j
    ij = np.indices((2, 2)).reshape(2, 4).T            # (4, 2)
    i4 = ij[:, 0][None, :]
    j4 = ij[:, 1][None, :]
    comp = (asm_a * 3 + asm_b)[:, None] * 4 + i4 * 2 + j4   # (nTup, 4)
    asm_src = (comp * n_elem + asm_elem[:, None]).reshape(-1)
    dest = (asm_sbd[:, None] * (n2 * n2)
            + (asm_row[:, None] * 2 + i4) * n2
            + asm_col[:, None] * 2 + j4).reshape(-1)
    dt_idx = np.int32 if n_parts * n2 * n2 < 2 ** 31 else np.int64
    l2g_flat = local_to_global.reshape(-1).astype(np.int64).copy()
    l2g_flat[~local_valid.reshape(-1)] = n_vert        # dump slot
    gath_perm = np.argsort(l2g_flat, kind="stable").astype(np.int32)
    gath_segids = l2g_flat[gath_perm].astype(np.int32)
    return Plan2D(
        n_parts=n_parts, n_local_max=n_local_max, n2=n2, part=part,
        local_to_global=local_to_global, local_valid=local_valid, dup=dup,
        asm_src=asm_src.astype(np.int32 if 36 * n_elem < 2 ** 31
                               else np.int64),
        asm_dest=dest.astype(dt_idx),
        gath_perm=gath_perm, gath_segids=gath_segids)


def build_node_plan_2d(mesh, n_parts, pad_to=64):
    """Disjoint node partition at dim 2 for the LBFGS-JH block-Jacobi
    initializer (reference: METIS::partMesh_nodes + LBFGSTimeStepper.cpp:
    70-95 at DIM = 2): every vertex belongs to exactly one block (dup == 1);
    an element contributes its (a, b) 2x2 block iff both endpoints are in
    the same block."""
    conn = mesh.conn.astype(np.int64)
    n_elem, n_vert = mesh.n_elem, mesh.n_vert
    vpart = (rcb_partition(mesh.V_rest, n_parts).astype(np.int32)
             if n_parts > 1 else np.zeros(n_vert, np.int32))
    n_parts = max(int(vpart.max()) + 1, 1)

    locals_ = [np.where(vpart == p)[0] for p in range(n_parts)]
    assert all(len(l) for l in locals_), "empty 2D node block"
    g2l = np.full(n_vert, -1, np.int32)
    for l in locals_:
        g2l[l] = np.arange(len(l), dtype=np.int32)

    corners = np.indices((3, 3)).reshape(2, 9).T
    aa = np.tile(corners[:, 0], n_elem).astype(np.int32)
    bb = np.tile(corners[:, 1], n_elem).astype(np.int32)
    ee = np.repeat(np.arange(n_elem, dtype=np.int64), 9)
    va = conn[ee, aa]
    vb = conn[ee, bb]
    keep = vpart[va] == vpart[vb]
    # element -> block map is meaningless for a node plan; each element
    # gets the block of its first corner (dot_tpu uses it for rendering)
    part = vpart[conn[:, 0]]
    dup = np.ones(n_vert, np.int32)
    return _finish_plan_2d(
        n_parts, n_elem, n_vert, part, locals_, dup,
        vpart[va[keep]].astype(np.int64), ee[keep],
        aa[keep].astype(np.int64), bb[keep].astype(np.int64),
        g2l[va[keep]].astype(np.int64), g2l[vb[keep]].astype(np.int64),
        pad_to)
