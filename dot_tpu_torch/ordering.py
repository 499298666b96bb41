# Copied from dot_tpu/ordering.py: the port cannot import dot_tpu, whose package import pulls in jax.
"""Bandwidth-reducing vertex orderings for the blocked-banded factorization.

The reference reaches large meshes through CHOLMOD's fill-reducing AMD
ordering + supernodal sparse factors (reference: CHOLMODSolver.cpp:136-163).
The TPU-native equivalent used here: reverse Cuthill-McKee (RCM) per
subdomain, which concentrates the (already nearly banded, because
subdomains are geometrically compact) sparsity into a band of width b,
so the padded dense (n3, n3) Cholesky becomes a BLOCK-TRIDIAGONAL one
with block size bs >= 3b+2 — O(n*b^2) flops instead of O(n^3/3) and
O(n*b) factor traffic instead of O(n^2).

Pure numpy, host-side, O(E log E).
"""

from __future__ import annotations

import numpy as np


def _adjacency_csr(n, rows, cols):
    """Undirected adjacency CSR from (possibly duplicated) edge lists;
    self-loops dropped."""
    m = rows != cols
    r = np.concatenate([rows[m], cols[m]])
    c = np.concatenate([cols[m], rows[m]])
    key = r.astype(np.int64) * n + c
    key = np.unique(key)
    r = (key // n).astype(np.int32)
    c = (key % n).astype(np.int32)
    starts = np.searchsorted(r, np.arange(n + 1))
    return starts, c


def _bfs_levels(starts, adj, root, n):
    """BFS level structure; returns (levels array with -1 for unreached,
    order visited)."""
    lev = np.full(n, -1, np.int32)
    lev[root] = 0
    frontier = np.asarray([root], np.int32)
    order = [frontier]
    while frontier.size:
        nxt = []
        for v in frontier:
            nb = adj[starts[v]:starts[v + 1]]
            nb = nb[lev[nb] < 0]
            lev[nb] = lev[v] + 1
            nxt.append(nb)
        frontier = np.unique(np.concatenate(nxt)) if nxt else np.empty(0, np.int32)
        if frontier.size:
            order.append(frontier)
    return lev, order


def _pseudo_peripheral(starts, adj, comp_nodes):
    """George-Liu pseudo-peripheral node of one connected component."""
    deg = starts[1:] - starts[:-1]
    root = comp_nodes[np.argmin(deg[comp_nodes])]
    n = len(starts) - 1
    last_ecc = -1
    for _ in range(8):
        lev, _ = _bfs_levels(starts, adj, root, n)
        ecc = lev[comp_nodes].max()
        if ecc <= last_ecc:
            break
        last_ecc = ecc
        last_level = comp_nodes[lev[comp_nodes] == ecc]
        root = last_level[np.argmin(deg[last_level])]
    return root


def rcm_order(n, rows, cols):
    """Reverse Cuthill-McKee permutation of graph nodes 0..n-1 given by
    symmetric edge lists. Returns perm with perm[old] = new. Handles
    disconnected graphs (components ordered one after another) and
    isolated nodes (placed last)."""
    starts, adj = _adjacency_csr(n, np.asarray(rows, np.int64),
                                 np.asarray(cols, np.int64))
    deg = starts[1:] - starts[:-1]
    visited = np.zeros(n, bool)
    out = np.empty(n, np.int32)  # out[k] = old index at new position k
    pos = 0
    while pos < n:
        unv = np.where(~visited)[0]
        # component of a pseudo-peripheral start
        lev, _ = _bfs_levels(starts, adj, unv[0], n)
        comp = unv[lev[unv] >= 0]
        root = _pseudo_peripheral(starts, adj, comp)
        # Cuthill-McKee BFS, neighbors in increasing-degree order
        visited[root] = True
        queue = [root]
        head = 0
        while head < len(queue):
            v = queue[head]
            head += 1
            out[pos] = v
            pos += 1
            nb = adj[starts[v]:starts[v + 1]]
            nb = nb[~visited[nb]]
            if nb.size:
                nb = nb[np.argsort(deg[nb], kind="stable")]
                visited[nb] = True
                queue.extend(nb.tolist())
    perm = np.empty(n, np.int32)
    perm[out[::-1]] = np.arange(n, dtype=np.int32)  # reverse => RCM
    return perm


def graph_bandwidth(perm, rows, cols):
    """max |perm[r] - perm[c]| over the edges (0 for empty edge sets)."""
    if len(rows) == 0:
        return 0
    d = np.abs(perm[rows].astype(np.int64) - perm[cols].astype(np.int64))
    return int(d.max())
