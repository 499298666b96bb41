# Copied from dot_tpu/partition.py: the port cannot import dot_tpu, whose package import pulls in jax.
"""Spatial domain decomposition and the static subdomain assembly plan.

Replaces the reference's METIS k-way dual-graph element partition +
CHOLMOD-per-subdomain machinery (reference: src/Utils/METIS.hpp:109-160,
ADMMDDTimeStepper.cpp:88-443, DOTTimeStepper.cpp:37-235) with:

- a host-side recursive coordinate bisection (RCB) over element centroids
  (balanced, contiguous-in-space parts; METIS ufactor=30 also only
  near-balances), and
- a fully static *assembly plan*: flat index arrays that scatter the
  per-element 12x12 Hessians (plus interface-completion blocks and lumped
  mass) into padded dense per-subdomain matrices with ONE sorted
  segment-sum on device. CHOLMOD's sparse factorization becomes a batched
  dense Cholesky on the MXU.

Interface completion follows DOTTimeStepper::fillInDecomposedHessians
(reference: DOTTimeStepper.cpp:618-797): each subdomain's matrix gets, at
its interface vertices, the missing mass (here: simply the *global* lumped
mass, since interior vertices already own all their elements) and the
missing elements' 3x3 diagonal blocks plus interface-interface off-diagonal
blocks, so each local factor approximates the global Schur complement.

Elements are re-ordered so each part owns one equal-size padded contiguous
slab; this makes the element axis shardable across devices with the same
mesh axis as the subdomain axis.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from . import native
from . import ordering


def _round_up(x, m):
    return (x + m - 1) // m * m


def rcb_partition(centroids, n_parts):
    """Recursive coordinate bisection: (nE,) part ids, sizes within +-1 of
    proportional."""
    n = centroids.shape[0]
    out = np.zeros(n, dtype=np.int32)

    def rec(idx, parts_lo, parts_hi):
        k = parts_hi - parts_lo
        if k == 1:
            out[idx] = parts_lo
            return
        k1 = k // 2
        n1 = int(round(len(idx) * k1 / k))
        c = centroids[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        rec(idx[order[:n1]], parts_lo, parts_lo + k1)
        rec(idx[order[n1:]], parts_lo + k1, parts_hi)

    rec(np.arange(n), 0, n_parts)
    return out


def _interface_count(conn, part, n_vert, n_parts):
    """Number of vertices owned by more than one subdomain — the quantity
    that sets DOT's H0 quality (duplicated interface dofs)."""
    cnt = np.zeros(n_vert, dtype=np.int32)
    for p in range(n_parts):
        cnt[np.unique(conn[part == p].ravel())] += 1
    return int((cnt > 1).sum())


def _vertex_adjacency(conn, n_vert):
    """CSR vertex->vertex adjacency over tet edges (the vNeighbor role,
    reference Mesh.cpp computeVNeighbor). Returns (starts (nV+1,), adj)."""
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    a = conn[:, [p[0] for p in pairs]].ravel().astype(np.int64)
    b = conn[:, [p[1] for p in pairs]].ravel().astype(np.int64)
    key = np.unique(np.concatenate([a * n_vert + b, b * n_vert + a]))
    u = (key // n_vert).astype(np.int32)
    adj = (key % n_vert).astype(np.int32)
    starts = np.searchsorted(u, np.arange(n_vert + 1)).astype(np.int64)
    return starts, adj


def _expand_csr(starts, frontier):
    """All CSR entries of the given rows, concatenated."""
    reps = starts[frontier + 1] - starts[frontier]
    tot = int(reps.sum())
    if tot == 0:
        return np.empty(0, np.int64)
    off = np.arange(tot) - np.repeat(np.cumsum(reps) - reps, reps)
    return np.repeat(starts[frontier], reps) + off


def surface_distance_weights(mesh):
    """USE_METIS==3 element weights (ADMMDDTimeStepper.cpp:98-127): each
    element weighs the sum over its corners of the shortest vertex-graph
    distance to the surface (computeShortestDistToSurface role) — biasing
    the balance so interior-heavy subdomains stay smaller."""
    starts, adj = _vertex_adjacency(mesh.conn, mesh.n_vert)
    dist = np.full(mesh.n_vert, -1, dtype=np.int64)
    frontier = np.unique(mesh.SF.ravel()).astype(np.int64)
    dist[frontier] = 0
    d = 0
    while len(frontier):
        nbr = adj[_expand_csr(starts, frontier)].astype(np.int64)
        nbr = np.unique(nbr)
        nbr = nbr[dist[nbr] < 0]
        d += 1
        dist[nbr] = d
        frontier = nbr
    return dist[mesh.conn].sum(axis=1).astype(np.int32)


def degree_weights(mesh):
    """USE_METIS==4 element weights (ADMMDDTimeStepper.cpp:129-152): sum
    over corners of (vertex neighbor count + 1) — denser-connectivity
    regions weigh more, so irregular-valence areas get smaller parts."""
    starts, _ = _vertex_adjacency(mesh.conn, mesh.n_vert)
    deg = (starts[1:] - starts[:-1]).astype(np.int32) + 1
    return deg[mesh.conn].sum(axis=1).astype(np.int32)


def slice_partition(mesh, n_parts, axis=0):
    """Axis-aligned slab partition of element centroids — the
    partMesh_slice role (METIS.hpp:213-231, USE_METIS==2 with dimI=1;
    the reference omits the domain-minimum shift, which only works for
    meshes whose coordinates start at ~0 — here the minimum is
    subtracted so slabs always cover the mesh)."""
    cent = mesh.V_rest[mesh.conn].mean(axis=1)[:, axis]
    lo = mesh.V_rest[:, axis].min()
    hi = mesh.V_rest[:, axis].max()
    ext = hi - lo
    if not ext > 1e-12 * max(1.0, abs(hi), abs(lo)):
        raise ValueError(
            f"slice partition: mesh is degenerate along axis {axis} "
            f"(extent {ext:.3e}); pick another axis or scheme 1")
    step = ext / n_parts
    p = np.clip(((cent - lo) / step).astype(np.int64), 0, n_parts - 1)
    p = p.astype(np.int32)
    if len(np.unique(p)) != n_parts:
        raise ValueError(
            f"slice partition along axis {axis} produced an empty slab "
            f"(n_parts={n_parts}); use fewer parts or scheme 1")
    return p


def element_partition(mesh, n_parts, scheme=1):
    """K-way element partition: multilevel dual-graph partitioner
    (native/mlkway.cpp — the METIS_PartMeshDual role, contiguous +
    balanced + min edge-cut; METIS.hpp:109-160), cross-checked against
    RCB (which wins on box-like geometry where planar cuts are optimal);
    the smaller-interface partition is kept. Falls back to RCB when the
    native library is unavailable.

    `scheme` mirrors the reference's compile-time USE_METIS selector
    (ADMMDDTimeStepper.cpp:88-152): 1 uniform k-way (default), 2 axis
    slabs (partMesh_slice), 3 k-way weighted by distance-to-surface,
    4 k-way weighted by vertex valence."""
    if n_parts == 1:
        return np.zeros(mesh.n_elem, dtype=np.int32)
    if scheme == 2:
        return slice_partition(mesh, n_parts)
    wgt = None
    if scheme == 3:
        wgt = surface_distance_weights(mesh)
    elif scheme == 4:
        wgt = degree_weights(mesh)
    elif scheme != 1:
        raise ValueError(f"partitionScheme {scheme} (use 1-4)")
    cent = mesh.V_rest[mesh.conn].mean(axis=1)
    rcb = rcb_partition(cent, n_parts)
    res = native.partition_mesh_dual(mesh.conn, n_parts, elem_wgt=wgt)
    if res is None:
        return rcb   # count-balanced stand-in when native is unavailable
    ml, _cut = res
    if len(np.unique(ml)) != n_parts:   # plan machinery needs all parts
        return rcb
    if wgt is not None:
        return ml    # RCB is count-balanced; not comparable under weights
    i_ml = _interface_count(mesh.conn, ml, mesh.n_vert, n_parts)
    i_rcb = _interface_count(mesh.conn, rcb, mesh.n_vert, n_parts)
    return ml if i_ml <= i_rcb else rcb


@dataclasses.dataclass
class SubdomainPlan:
    """Static decomposition data, all plain numpy (hashable-by-id aux)."""
    n_parts: int
    elem_pad: int          # padded elements per part
    n_local_max: int       # padded local vertices per subdomain
    n3: int                # 3 * n_local_max (dense matrix dimension)

    # element reordering: new flat element arrays are built as
    # old_array[elem_src] with padded slots marked invalid
    elem_src: np.ndarray   # (P*elem_pad,) source element id (0 for pads)
    elem_valid: np.ndarray  # (P*elem_pad,) bool

    # subdomain vertex maps
    local_to_global: np.ndarray  # (P, n_local_max) i32, pad -> 0
    local_valid: np.ndarray      # (P, n_local_max) bool
    dup: np.ndarray              # (nV,) multiplicity of each vertex

    # dense assembly at 3x3-BLOCK granularity, two stages:
    # (1) gather contiguous 9-wide block rows in dest-sorted tuple order and
    #     segment-sum onto the unique (sbd, row, col) block set,
    # (2) scatter-set the compact unique blocks' scalars into the dense buf.
    # (block granularity moves 9x fewer gather/reduce rows than per-scalar)
    asm_elem: np.ndarray   # (nAsm,) NEW element index (into padded arrays)
    asm_a: np.ndarray      # (nAsm,) corner row
    asm_b: np.ndarray      # (nAsm,) corner col
    asm_tuple_perm: np.ndarray   # (nAsm,) dest-sort permutation of tuples
    asm_block_stage1: np.ndarray  # (nAsm,) unique-block segment ids (sorted)
    asm_ub_dest: np.ndarray       # (nUB*9,) scalar dests of unique blocks

    # rhs scatter (local solve results -> global, then / dup)
    gath_perm: np.ndarray    # (P*n_local_max,) sort perm over global ids
    gath_segids: np.ndarray  # (P*n_local_max,) sorted global vertex ids

    # raw pieces kept for ADMM-DD (None for node plans):
    part: np.ndarray = None        # (nE,) element part ids
    comp_tuples: tuple = None      # (sbd, elem, a, b, row, col) completion
    g2l: np.ndarray = None         # (P, nV) global->local (-1 outside)
    n_own: int = 0                 # first n_own tuples are own-element blocks
    own_perm: np.ndarray = None    # local-only assembly scatter plan (dense)
    own_stage1: np.ndarray = None
    own_udest: np.ndarray = None
    # banded local-only assembly (ADMM-DD local Hessians on banded plans):
    # same block-level two-stage scheme as the main assembly, restricted
    # to own-element tuples (the completion role is played by W there)
    own_block_perm: np.ndarray = None    # (n_own,) dest-sort perm
    own_block_stage1: np.ndarray = None  # (n_own,) unique-block segment ids
    own_band_dest: np.ndarray = None     # (nOUB*9,) banded scalar dests
    own_ub_row: np.ndarray = None        # (nOUB,) flat slot sbd*nmax + vrow
    own_ub_col: np.ndarray = None        # (nOUB,) flat slot sbd*nmax + vcol
    own_diag_ub: np.ndarray = None       # indices of diagonal (v,v) blocks

    # RCM-banded storage (None when the band is not profitable): the
    # subdomain matrices are stored BLOCK-TRIDIAGONALLY — diag blocks
    # (P, nb, bs, bs) + sub-diagonal blocks (P, nb-1, bs, bs) in one flat
    # buffer [diag | sub]; band_dest maps each unique-block scalar there
    # (upper-neighbor entries -> out-of-bounds, dropped: the symmetric
    # transpose already lives in `sub`).
    band_bs: int = 0               # block size in dofs (multiple of 3)
    band_nb: int = 0               # number of diagonal blocks (n3 = nb*bs)
    band_dest: np.ndarray = None   # (nUB*9,) dests into the flat buffer
    # compact-block masking/diagonal plan (masking + mass/identity diag
    # are applied to the (nUB, 9) compact values BEFORE the scatter — a
    # few MB instead of full passes over the banded buffer):
    band_ub_row: np.ndarray = None      # (nUB,) flat slot sbd*nmax + vrow
    band_ub_col: np.ndarray = None      # (nUB,) flat slot sbd*nmax + vcol
    band_diag_ub: np.ndarray = None     # indices of diagonal (v,v) blocks
    band_pad_diag: np.ndarray = None    # dests of padding-row unit diags


def build_plan(mesh, n_parts, pad_elem_to=256, pad_n3_to=384,
               banded=True, band_bs_unit=384, own_plan=False,
               band_min_nb=3, scheme=1):
    """Partition mesh elements and build the full static assembly plan.

    With `banded` (default), each subdomain's local vertices are RCM-
    reordered and — when the resulting band is narrow enough to pay off
    (>= 3 diagonal blocks) — banded scatter destinations are emitted so
    the factorization can run block-tridiagonally (the TPU replacement
    for CHOLMOD's fill-reducing supernodal factorization,
    reference: CHOLMODSolver.cpp:136-163).
    """
    conn = mesh.conn
    n_elem, n_vert = mesh.n_elem, mesh.n_vert

    part = element_partition(mesh, n_parts, scheme=scheme)

    # --- element reorder + pad to equal slabs -------------------------
    by_part = [np.where(part == p)[0] for p in range(n_parts)]
    elem_pad = _round_up(max(len(e) for e in by_part), pad_elem_to)
    elem_src = np.zeros(n_parts * elem_pad, dtype=np.int32)
    elem_valid = np.zeros(n_parts * elem_pad, dtype=bool)
    for p, e in enumerate(by_part):
        elem_src[p * elem_pad: p * elem_pad + len(e)] = e
        elem_valid[p * elem_pad: p * elem_pad + len(e)] = True

    # --- local vertex maps (initial unique order; RCM applied below) ----
    locals_ = [np.unique(conn[e].ravel()) for e in by_part]
    g2l = np.full((n_parts, n_vert), -1, dtype=np.int32)
    for p, l in enumerate(locals_):
        g2l[p, l] = np.arange(len(l), dtype=np.int32)

    dup = np.zeros(n_vert, dtype=np.int32)
    for l in locals_:
        dup[l] += 1

    # --- vertex -> incident (elem, corner) lists (CSR) ------------------
    flat = conn.ravel()
    order = np.argsort(flat, kind="stable")
    inc_elem = (order // 4).astype(np.int32)
    inc_corner = (order % 4).astype(np.int32)
    starts = np.searchsorted(flat[order], np.arange(n_vert + 1))

    # --- assembly tuples -------------------------------------------------
    # own elements: all 16 corner pairs, using NEW element ids
    new_ids = np.full(n_elem, -1, dtype=np.int32)
    for p, e in enumerate(by_part):
        new_ids[e] = p * elem_pad + np.arange(len(e), dtype=np.int32)

    own_sbd = np.repeat(part, 16).astype(np.int32)
    own_elem = np.repeat(new_ids, 16)
    corners = np.indices((4, 4)).reshape(2, 16).T  # (16, 2)
    own_a = np.tile(corners[:, 0], n_elem).astype(np.int32)
    own_b = np.tile(corners[:, 1], n_elem).astype(np.int32)
    row_g = conn[np.repeat(np.arange(n_elem), 16), own_a]
    col_g = conn[np.repeat(np.arange(n_elem), 16), own_b]
    own_row = g2l[own_sbd, row_g]
    own_col = g2l[own_sbd, col_g]

    # interface completion (DOTTimeStepper.cpp:694-788), vectorized:
    # for every (subdomain p, shared local vertex v, incident element e
    # NOT owned by p) pair, add the missing diagonal block (a, a) at
    # (lv, lv) plus off-diagonal blocks (a, b) toward the element's other
    # corners that are also local to p.
    is_shared = dup > 1
    if n_parts > 1:
        deg = (starts[1:] - starts[:-1]).astype(np.int64)
        pr_l, vr_l = [], []
        for p in range(n_parts):
            sv = locals_[p][is_shared[locals_[p]]]
            pr_l.append(np.full(len(sv), p, np.int32))
            vr_l.append(sv.astype(np.int64))
        pv_p = np.concatenate(pr_l)
        pv_v = np.concatenate(vr_l)
        # expand each (p, v) to its incident (elem, corner) list
        reps = deg[pv_v]
        pair_p = np.repeat(pv_p, reps)
        idx = (np.repeat(starts[pv_v], reps)
               + (np.arange(reps.sum()) - np.repeat(
                   np.cumsum(reps) - reps, reps)))
        pair_e = inc_elem[idx]
        pair_a = inc_corner[idx]
        keep = part[pair_e] != pair_p
        pair_p, pair_e, pair_a = pair_p[keep], pair_e[keep], pair_a[keep]
        pair_v = np.repeat(pv_v, reps)[keep]
        lv = g2l[pair_p, pair_v]
        # off-diagonal candidates: all 4 corners b of the element; keep
        # b != a with the other endpoint local to p; diagonal: b == a
        b4 = np.arange(4, dtype=np.int32)
        w = conn[pair_e][:, b4]                        # (nPairs, 4)
        lw = g2l[pair_p[:, None], w]                   # (nPairs, 4)
        okb = (lw >= 0) & (b4[None, :] != pair_a[:, None])
        okb[np.arange(len(pair_a)), pair_a] = True     # diagonal (a, a)
        lw[np.arange(len(pair_a)), pair_a] = lv        # row = col = lv
        pi, bj = np.nonzero(okb)
        c_sbd = pair_p[pi]
        c_elem = new_ids[pair_e[pi]]
        c_a = pair_a[pi]
        c_b = bj.astype(np.int32)
        c_row = lv[pi]
        c_col = lw[pi, bj]
    else:
        c_sbd = c_elem = c_a = c_b = c_row = c_col = np.empty(0, np.int32)

    asm_sbd = np.concatenate([own_sbd, c_sbd.astype(np.int32)])
    asm_elem = np.concatenate([own_elem, c_elem.astype(np.int32)])
    asm_a = np.concatenate([own_a, c_a.astype(np.int32)])
    asm_b = np.concatenate([own_b, c_b.astype(np.int32)])
    asm_row = np.concatenate([own_row, c_row.astype(np.int32)])
    asm_col = np.concatenate([own_col, c_col.astype(np.int32)])
    c_row = c_row.astype(np.int32)
    c_col = c_col.astype(np.int32)

    # --- RCM-reorder each subdomain's local ids (bandwidth reduction) ----
    bw_max = 0
    if banded:
        for p in range(n_parts):
            m = asm_sbd == p
            nloc = len(locals_[p])
            perm = ordering.rcm_order(nloc, asm_row[m], asm_col[m])
            asm_row[m] = perm[asm_row[m]]
            asm_col[m] = perm[asm_col[m]]
            g2l[p, locals_[p]] = perm
            locals_[p] = locals_[p][np.argsort(perm, kind="stable")]
            bw_max = max(bw_max, ordering.graph_bandwidth(
                np.arange(nloc, dtype=np.int32), asm_row[m], asm_col[m]))
        nc = len(c_row)
        if nc:
            c_row = asm_row[-nc:].copy()
            c_col = asm_col[-nc:].copy()

    # --- final padded sizes: banded (n3 = nb*bs) or dense ----------------
    n_local_raw = max(len(l) for l in locals_)
    assert pad_n3_to % 3 == 0 and band_bs_unit % 3 == 0
    band_bs = band_nb = 0
    if banded:
        band_bs = max(band_bs_unit,
                      _round_up(3 * bw_max + 3, band_bs_unit))
        band_nb = -(-3 * n_local_raw // band_bs)
    # banded whenever at least 3 blocks exist: the scan-major
    # factorization peaks at ~3x the banded storage 3(2nb-1)bs^2, below
    # the dense path's ~4(nb*bs)^2 for every nb >= 2 — and with fewer
    # flops (monkey18K DOT6: ~3 GB banded vs ~11 GB dense).
    if banded and band_nb >= band_min_nb:
        n3 = band_bs * band_nb
    else:
        band_bs = band_nb = 0
        n3 = _round_up(3 * n_local_raw, pad_n3_to)
    n_local_max = n3 // 3

    local_to_global = np.zeros((n_parts, n_local_max), dtype=np.int32)
    local_valid = np.zeros((n_parts, n_local_max), dtype=bool)
    for p, l in enumerate(locals_):
        local_to_global[p, :len(l)] = l
        local_valid[p, :len(l)] = True

    dense_sz = n_parts * n3 * n3
    udtype = np.int32 if dense_sz < 2**31 else np.int64
    asm_tuple_perm, asm_block_stage1, asm_ub_dest, ublocks = _block_level_plan(
        asm_sbd, asm_row, asm_col, n3, udtype)
    band_dest = band_ub_row = band_ub_col = band_diag_ub = band_pad = None
    if band_nb:
        band_dest = _banded_dests(ublocks, n3, n_parts, band_bs, band_nb)
        N = n3 // 3
        ub_sbd = (ublocks // (N * N)).astype(np.int32)
        ub_r = (ublocks % (N * N) // N).astype(np.int32)
        ub_c = (ublocks % N).astype(np.int32)
        band_ub_row = ub_sbd * N + ub_r
        band_ub_col = ub_sbd * N + ub_c
        band_diag_ub = np.where(ub_r == ub_c)[0].astype(np.int32)
        # padding-row unit diagonals (rows >= 3*nloc_p have no block);
        # scan-major layout (see _banded_dests)
        pads = []
        for p, l in enumerate(locals_):
            r = np.arange(3 * len(l), n3, dtype=np.int64)
            pads.append((((r // band_bs) * n_parts + p) * band_bs
                         + r % band_bs) * band_bs + (r % band_bs))
        band_pad = np.concatenate(pads).astype(band_dest.dtype)

    # own-element-only plan (no interface completion) for ADMM-DD's local
    # Hessians (the completion role is played by the frozen W there);
    # rows/cols taken post-RCM from the remapped tuple arrays. Only built
    # when requested (ADMM-DD) — it costs a 28M-key sort at ~200K elems.
    # On banded plans the own plan is BLOCK-level with banded scalar
    # destinations (mirrors the main assembly's _assemble_btd path); the
    # scalar-level dense plan is kept for small/dense meshes.
    n_own = len(own_sbd)
    own_perm = oinv = oud = None
    own_block = {}
    if own_plan:
        if band_nb:
            ob_perm, ob_stage1, _ob_dense, ob_ublocks = _block_level_plan(
                asm_sbd[:n_own], asm_row[:n_own], asm_col[:n_own], n3,
                udtype)
            N = n3 // 3
            ob_sbd = ob_ublocks // (N * N)
            ob_rem = ob_ublocks % (N * N)
            own_block = dict(
                own_block_perm=ob_perm, own_block_stage1=ob_stage1,
                own_band_dest=_banded_dests(ob_ublocks, n3, n_parts,
                                            band_bs, band_nb),
                own_ub_row=(ob_sbd * N + ob_rem // N).astype(np.int32),
                own_ub_col=(ob_sbd * N + ob_rem % N).astype(np.int32),
                own_diag_ub=np.where(ob_rem // N == ob_rem % N)[0]
                .astype(np.int32))
        else:
            own_perm, oinv, oud = native.block_plan(
                asm_sbd[:n_own], asm_row[:n_own], asm_col[:n_own], n3)

    # rhs scatter plan
    l2g_flat = local_to_global.reshape(-1).copy()
    l2g_flat[~local_valid.reshape(-1)] = n_vert  # dump slot
    gath_perm = np.argsort(l2g_flat, kind="stable").astype(np.int32)
    gath_segids = l2g_flat[gath_perm].astype(np.int32)

    return SubdomainPlan(
        n_parts=n_parts, elem_pad=elem_pad, n_local_max=n_local_max, n3=n3,
        elem_src=elem_src, elem_valid=elem_valid,
        local_to_global=local_to_global, local_valid=local_valid, dup=dup,
        asm_elem=asm_elem, asm_a=asm_a, asm_b=asm_b,
        asm_tuple_perm=asm_tuple_perm, asm_block_stage1=asm_block_stage1,
        asm_ub_dest=asm_ub_dest,
        gath_perm=gath_perm, gath_segids=gath_segids,
        part=part,
        comp_tuples=(np.asarray(c_sbd, np.int32), np.asarray(c_elem, np.int32),
                     np.asarray(c_a, np.int32), np.asarray(c_b, np.int32),
                     c_row, c_col),
        g2l=g2l,
        n_own=n_own, own_perm=own_perm, own_stage1=oinv,
        own_udest=None if oud is None else oud.astype(udtype),
        **own_block,
        band_bs=band_bs, band_nb=band_nb, band_dest=band_dest,
        band_ub_row=band_ub_row, band_ub_col=band_ub_col,
        band_diag_ub=band_diag_ub, band_pad_diag=band_pad,
    )


def _scalar_scatter_plan(sbd, row, col, n_stride, n_segments_hint=None):
    """Generic 3x3-block scatter plan: returns (perm, stage1, udest) for
    destinations sbd*(n_stride^2) + (row*3+i)*n_stride + col*3+j."""
    return native.block_plan(sbd, row, col, n_stride)


def _block_level_plan(sbd, row, col, n3, udtype):
    """Sort tuples by their (sbd, vertex-row, vertex-col) BLOCK key and
    emit (tuple_perm, block segment ids, unique-block scalar dests,
    unique block keys)."""
    N = n3 // 3
    key = (sbd.astype(np.int64) * (N * N) + row.astype(np.int64) * N
           + col.astype(np.int64))
    tuple_perm, stage1, ublocks = native.sort_unique_inverse(key)
    ub_sbd = ublocks // (N * N)
    rem = ublocks % (N * N)
    ub_r, ub_c = rem // N, rem % N
    i3 = np.arange(3, dtype=np.int64)
    dest = (ub_sbd[:, None, None] * (n3 * n3)
            + (ub_r[:, None, None] * 3 + i3[None, :, None]) * n3
            + ub_c[:, None, None] * 3 + i3[None, None, :])
    return tuple_perm, stage1, dest.reshape(-1).astype(udtype), ublocks


def _banded_dests(ublocks, n3, n_parts, bs, nb):
    """Scalar destinations of the unique blocks in the flat block-
    tridiagonal buffer [diag (nb, P, bs, bs) | sub (nb-1, P, bs, bs)] —
    SCAN-MAJOR layout so the factorization's lax.scan consumes the
    assembled buffer directly (no transposed copies; the peak-memory
    lever that lets whole-mesh Newton fit monkey18K-class bands).
    Entries of the strict upper block-neighbor go out of bounds (their
    transpose lives in `sub`); |block distance| >= 2 cannot occur when
    bs >= 3*bandwidth + 2 (asserted)."""
    N = n3 // 3
    ub_sbd = ublocks // (N * N)
    rem = ublocks % (N * N)
    ub_r, ub_c = rem // N, rem % N
    i3 = np.arange(3, dtype=np.int64)
    r = ub_r[:, None, None] * 3 + i3[None, :, None]
    c = ub_c[:, None, None] * 3 + i3[None, None, :]
    sbd = ub_sbd[:, None, None]
    kr, kc = r // bs, c // bs
    assert int(np.abs(kr - kc).max(initial=0)) <= 1, \
        "band block size too small for the graph bandwidth"
    diag_sz = n_parts * nb * bs * bs
    total = diag_sz + n_parts * (nb - 1) * bs * bs
    d_diag = ((kr * n_parts + sbd) * bs + r % bs) * bs + (c % bs)
    d_sub = (diag_sz
             + ((kc * n_parts + sbd) * bs + r % bs) * bs + (c % bs))
    dest = np.where(kr == kc, d_diag, np.where(kr == kc + 1, d_sub, total))
    udtype = np.int32 if total < 2**31 else np.int64
    return dest.reshape(-1).astype(udtype)


def _dense_scalar_to_banded(dests, n3, n_parts, bs, nb):
    """Convert scalar destinations into the dense (P, n3, n3) buffer to
    positions in the scan-major flat banded buffer [diag | sub] (same
    layout as _banded_dests). Strict upper block-neighbor entries map out
    of bounds (dropped: the Cholesky reads the lower triangle only, so
    this matches the dense path, where upper scatters land but are never
    read). Entries outside the tridiagonal band are an error — callers
    pass patterns that are subsets of the assembly pattern the band was
    sized for."""
    d = np.asarray(dests, np.int64)
    sbd = d // (n3 * n3)
    rem = d % (n3 * n3)
    r, c = rem // n3, rem % n3
    kr, kc = r // bs, c // bs
    assert int(np.abs(kr - kc).max(initial=0)) <= 1, \
        "scatter pattern outside the block-tridiagonal band"
    diag_sz = n_parts * nb * bs * bs
    total = diag_sz + n_parts * (nb - 1) * bs * bs
    d_diag = ((kr * n_parts + sbd) * bs + r % bs) * bs + (c % bs)
    d_sub = diag_sz + ((kc * n_parts + sbd) * bs + r % bs) * bs + (c % bs)
    out = np.where(kr == kc, d_diag, np.where(kr == kc + 1, d_sub, total))
    udtype = np.int32 if total < 2**31 else np.int64
    return out.astype(udtype)


@dataclasses.dataclass
class PDBandPlan:
    """Whole-mesh scalar banded plan for the fixed LBFGS-PD / ADMM-PD
    global matrix M + dt^2 D^T W D (one scalar per vertex pair, shared by
    all three coordinates — reference: LBFGSTimeStepper.cpp:113-194,
    ADMMTimeStepper.cpp:113-197). The vertex graph is RCM-reordered and
    the matrix stored block-tridiagonally, which removes the dense
    (nV, nV) ceiling (74 GB at horse136K) the same way the subdomain
    path replaces CHOLMOD's supernodal factors."""
    perm: np.ndarray        # (nV,) perm[old] = new (RCM)
    bs: int                 # scalar block size
    nb: int                 # number of diagonal blocks
    nv_p: int               # nb * bs padded vertex count
    dest: np.ndarray        # (16, nEp) flat dests of per-element (a,b) vals
    diag_dest: np.ndarray   # (nV,) dests of natural-order diagonal entries
    pad_dest: np.ndarray    # dests of padding-row unit diagonals
    total: int              # flat buffer length (diag | sub)


def build_pd_band_plan(conn_scatter, n_vert, bs_unit=256):
    """Host-side plan for the banded PD factor. `conn_scatter` is the
    padded-element connectivity with invalid corners mapped to n_vert.
    Returns None when the mesh is too small for banding to pay off."""
    valid = conn_scatter[:, 0] < n_vert
    conn_v = conn_scatter[valid]
    pairs_r, pairs_c = [], []
    for a in range(4):
        for b in range(a + 1, 4):
            pairs_r.append(conn_v[:, a])
            pairs_c.append(conn_v[:, b])
    rows = np.concatenate(pairs_r)
    cols = np.concatenate(pairs_c)
    perm = ordering.rcm_order(n_vert, rows, cols)
    bw = ordering.graph_bandwidth(perm, rows, cols)
    bs = max(bs_unit, _round_up(bw + 1, bs_unit))
    nb = -(-n_vert // bs)
    if nb < 3:
        return None
    nv_p = nb * bs
    diag_sz = nb * bs * bs
    total = diag_sz + (nb - 1) * bs * bs

    def _dest(pr, pc):
        """Flat dest in [diag | sub]; upper block-neighbor -> dropped."""
        kr, kc = pr // bs, pc // bs
        d_diag = kr * bs * bs + (pr % bs) * bs + (pc % bs)
        d_sub = diag_sz + kc * bs * bs + (pr % bs) * bs + (pc % bs)
        return np.where(kr == kc, d_diag,
                        np.where(kr == kc + 1, d_sub, total))

    # per padded element slot, all 16 (a, b) corner pairs (pads -> dump)
    perm_ext = np.concatenate([perm.astype(np.int64), [total]])
    dests = np.empty((16, conn_scatter.shape[0]), np.int64)
    for a in range(4):
        for b in range(4):
            pr = perm_ext[conn_scatter[:, a]]
            pc = perm_ext[conn_scatter[:, b]]
            d = _dest(pr, pc)
            dests[a * 4 + b] = np.where(
                (pr >= nv_p) | (pc >= nv_p), total, d)
    p = perm.astype(np.int64)
    diag_dest = (p // bs) * bs * bs + (p % bs) * bs + (p % bs)
    r = np.arange(n_vert, nv_p, dtype=np.int64)
    pad_dest = (r // bs) * bs * bs + (r % bs) * bs + (r % bs)
    dt_ = np.int32 if total < 2**31 else np.int64
    return PDBandPlan(perm=perm, bs=bs, nb=nb, nv_p=nv_p,
                      dest=dests.astype(dt_), diag_dest=diag_dest.astype(dt_),
                      pad_dest=pad_dest.astype(dt_), total=total)


@dataclasses.dataclass
class ADMMDDPlan:
    """Extra static data for the ADMM-DD stepper (on top of a
    SubdomainPlan): local connectivity, owner maps, interface masks, and
    the weight/consensus/dual scatter plans built from the same
    interface-completion tuples (reference: ADMMDDTimeStepper.cpp:88-443,
    initWeights_fast:894-1033)."""
    conn_local: np.ndarray    # (nEp, 4) flat local ids p*Nmax + l (pad -> dump)
    lscat_perm: np.ndarray    # local gradient scatter plan
    lscat_segids: np.ndarray
    mass_local: np.ndarray    # (P, Nmax) subdomain lumped mass
    is_dual: np.ndarray       # (P, Nmax) interface (shared) vertex mask
    owner_part: np.ndarray    # (nV,) owning part (first containing)
    owner_local: np.ndarray   # (nV,) local index in owner
    shared_ids: np.ndarray    # (nS,) global ids of shared vertices
    l2shared: np.ndarray      # (P, Nmax) shared index or nS (dump)
    n_shared: int
    ns3: int
    # weight matrix (local-dof indexed) scatter plan over compact values
    w_perm: np.ndarray
    w_stage1: np.ndarray
    w_udest: np.ndarray
    # consensus matrix (shared-dof indexed) scatter plan over same values
    c_perm: np.ndarray
    c_stage1: np.ndarray
    c_udest: np.ndarray
    # gather indices of completion-tuple 3x3 blocks from the (144, nEp) buf
    comp_gather: np.ndarray   # (nC, 3, 3) flat indices
    # mass-diff diag (P, Nmax): global minus local mass at interface verts
    mass_dif: np.ndarray
    # banded augmented-Hessian scatter (None on dense plans): W's compact
    # entries and the mass-diff dof diagonal mapped into the flat banded
    # buffer (W's pattern is a subset of the assembly pattern the band was
    # sized for, so every lower-triangle entry lands in diag/sub)
    w_band_dest: np.ndarray = None    # (nUW,) banded dests of w_vals
    md_band_diag: np.ndarray = None   # (P*n3,) banded dof-diagonal dests


def build_admm_dd_plan(mesh, plan: SubdomainPlan) -> ADMMDDPlan:
    P, nmax, n3 = plan.n_parts, plan.n_local_max, plan.n3
    n_vert = mesh.n_vert
    conn = mesh.conn
    g2l = plan.g2l
    part = plan.part

    # local connectivity over the padded element slabs
    src, valid = plan.elem_src, plan.elem_valid
    pid = np.repeat(np.arange(P, dtype=np.int32), plan.elem_pad)
    lconn = g2l[pid[:, None], conn[src]]
    conn_local = np.where(valid[:, None],
                          pid[:, None] * nmax + lconn, P * nmax)
    flat = conn_local.ravel()
    lscat_perm = np.argsort(flat, kind="stable").astype(np.int32)
    lscat_segids = flat[lscat_perm].astype(np.int32)

    # subdomain lumped mass (barycentric over the part's own elements,
    # reference: mesh_subdomain[i].computeMassMatrix())
    mass_local = np.zeros((P, nmax))
    corner_mass = np.abs(mesh.vol) * 6.0 / 24.0 * mesh.rho  # |det|/24 * rho
    for p in range(P):
        e = np.where(part == p)[0]
        np.add.at(mass_local[p], g2l[p, conn[e].ravel()],
                  np.repeat(corner_mass[e], 4))

    dup = plan.dup
    is_shared_g = dup > 1
    is_dual = np.zeros((P, nmax), dtype=bool)
    for p in range(P):
        lv = plan.local_valid[p]
        is_dual[p, lv] = is_shared_g[plan.local_to_global[p, lv]]

    owner_part = np.zeros(n_vert, dtype=np.int32)
    owner_local = np.zeros(n_vert, dtype=np.int32)
    seen = np.zeros(n_vert, dtype=bool)
    for p in range(P):
        lv = np.where(plan.local_valid[p])[0]
        gl = plan.local_to_global[p, lv]
        new = ~seen[gl]
        owner_part[gl[new]] = p
        owner_local[gl[new]] = lv[new]
        seen[gl[new]] = True

    shared_ids = np.where(is_shared_g)[0].astype(np.int32)
    n_shared = len(shared_ids)
    shared_of = np.full(n_vert, n_shared, dtype=np.int32)
    shared_of[shared_ids] = np.arange(n_shared, dtype=np.int32)
    l2shared = np.full((P, nmax), n_shared, dtype=np.int32)
    for p in range(P):
        lv = plan.local_valid[p]
        l2shared[p, lv] = shared_of[plan.local_to_global[p, lv]]
    # the (n_shared+1)-th slot is the dump row for non-shared gathers; it
    # gets an identity row in the consensus matrix
    # completion tuples -> compact 3x3 values gathered from (144, nEp)
    c_sbd, c_elem, c_a, c_b, c_row, c_col = plan.comp_tuples
    n_ep = P * plan.elem_pad
    i3 = np.arange(3)
    # block-major component order of the (144, nEp) element-Hessian buffer
    comp = ((c_a[:, None, None] * 4 + c_b[:, None, None]) * 9
            + i3[None, :, None] * 3 + i3[None, None, :])
    comp_gather = (comp.astype(np.int64) * n_ep
                   + c_elem[:, None, None].astype(np.int64)).astype(np.int32)

    w_perm, w_stage1, w_udest = _scalar_scatter_plan(c_sbd, c_row, c_col, n3)
    s_row = shared_of[plan.local_to_global[c_sbd, c_row]]
    s_col = shared_of[plan.local_to_global[c_sbd, c_col]]
    c_perm, c_stage1, c_udest = _scalar_scatter_plan(
        np.zeros_like(c_sbd), s_row, s_col, 3 * (n_shared + 1))

    mass_dif = (mesh.mass[plan.local_to_global] * plan.local_valid
                - mass_local) * is_dual

    w_band_dest = md_band_diag = None
    if plan.band_nb:
        bs, nb = plan.band_bs, plan.band_nb
        w_band_dest = _dense_scalar_to_banded(w_udest, n3, P, bs, nb)
        r = np.arange(n3, dtype=np.int64)
        sb = np.arange(P, dtype=np.int64)
        md = (((r[None, :] // bs) * P + sb[:, None]) * bs
              + r[None, :] % bs) * bs + (r[None, :] % bs)
        md_band_diag = md.reshape(-1).astype(w_band_dest.dtype)

    return ADMMDDPlan(
        conn_local=conn_local.astype(np.int32),
        lscat_perm=lscat_perm, lscat_segids=lscat_segids,
        mass_local=mass_local, is_dual=is_dual,
        owner_part=owner_part, owner_local=owner_local,
        shared_ids=shared_ids, l2shared=l2shared,
        n_shared=n_shared, ns3=3 * (n_shared + 1),
        w_perm=w_perm, w_stage1=w_stage1, w_udest=w_udest,
        c_perm=c_perm, c_stage1=c_stage1, c_udest=c_udest,
        comp_gather=comp_gather, mass_dif=mass_dif,
        w_band_dest=w_band_dest, md_band_diag=md_band_diag,
    )


def build_node_plan(mesh, n_parts, pad_elem_to=256, pad_n3_to=384):
    """Disjoint NODE partition for the LBFGS-JH block-Jacobi initializer
    (reference: METIS::partMesh_nodes + LBFGSTimeStepper.cpp:70-95).

    Every vertex belongs to exactly one block (dup == 1); each block's
    matrix is the corresponding principal submatrix of the global Hessian:
    an element contributes its (a, b) 3x3 block iff both endpoints are in
    the same block.
    """
    conn = mesh.conn
    n_elem, n_vert = mesh.n_elem, mesh.n_vert
    vpart = (rcb_partition(mesh.V_rest, n_parts) if n_parts > 1
             else np.zeros(n_vert, dtype=np.int32))

    # elements: identity order, padded
    elem_pad = _round_up(n_elem, pad_elem_to)
    elem_src = np.zeros(elem_pad, dtype=np.int32)
    elem_src[:n_elem] = np.arange(n_elem, dtype=np.int32)
    elem_valid = np.zeros(elem_pad, dtype=bool)
    elem_valid[:n_elem] = True

    locals_ = [np.where(vpart == pi)[0] for pi in range(n_parts)]
    n_local_max = max(len(l) for l in locals_)
    assert pad_n3_to % 3 == 0
    n3 = _round_up(3 * n_local_max, pad_n3_to)
    n_local_max = n3 // 3

    local_to_global = np.zeros((n_parts, n_local_max), dtype=np.int32)
    local_valid = np.zeros((n_parts, n_local_max), dtype=bool)
    g2l = np.full(n_vert, -1, dtype=np.int32)
    for pi, l in enumerate(locals_):
        local_to_global[pi, :len(l)] = l
        local_valid[pi, :len(l)] = True
        g2l[l] = np.arange(len(l), dtype=np.int32)

    # assembly tuples: corner pairs within one block
    corners = np.indices((4, 4)).reshape(2, 16).T
    aa = np.tile(corners[:, 0], n_elem).astype(np.int32)
    bb = np.tile(corners[:, 1], n_elem).astype(np.int32)
    ee = np.repeat(np.arange(n_elem, dtype=np.int32), 16)
    va = conn[ee, aa]
    vb = conn[ee, bb]
    keep = vpart[va] == vpart[vb]
    asm_sbd = vpart[va[keep]].astype(np.int32)
    asm_elem = ee[keep]
    asm_a = aa[keep]
    asm_b = bb[keep]
    asm_row = g2l[va[keep]]
    asm_col = g2l[vb[keep]]

    udtype = np.int32 if n_parts * n3 * n3 < 2**31 else np.int64
    tuple_perm, stage1, ub_dest, _ = _block_level_plan(asm_sbd, asm_row,
                                                       asm_col, n3, udtype)

    l2g_flat = local_to_global.reshape(-1).copy()
    l2g_flat[~local_valid.reshape(-1)] = n_vert
    gath_perm = np.argsort(l2g_flat, kind="stable").astype(np.int32)

    return SubdomainPlan(
        n_parts=n_parts, elem_pad=elem_pad, n_local_max=n_local_max, n3=n3,
        elem_src=elem_src, elem_valid=elem_valid,
        local_to_global=local_to_global, local_valid=local_valid,
        dup=np.ones(n_vert, dtype=np.int32),
        asm_elem=asm_elem, asm_a=asm_a, asm_b=asm_b,
        asm_tuple_perm=tuple_perm, asm_block_stage1=stage1,
        asm_ub_dest=ub_dest,
        gath_perm=gath_perm, gath_segids=l2g_flat[gath_perm].astype(np.int32),
    )


def partition_amt_from_config(cfg, n_vert):
    """blockSize mode: partitionAmt = nV/blockSize + 1 (main.cpp:792-798)."""
    if cfg.block_size > 0:
        amt = n_vert // cfg.block_size + 1
        if amt == 1:
            raise ValueError("blockSize >= mesh size (reference exits too)")
        return amt
    return cfg.partition_amt
