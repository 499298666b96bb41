"""The 2D decomposed path's kernels (K25-K28) in plain PyTorch, and the
host-side tables their CUDA versions (csrc/dd2d.cu) read.

Each `*_ref` function computes what dot_tpu/dim2.py's System2D computes
(the line references are on each function), in the same operation order,
on the port's layouts: the element Hessians are K23's (36, N) row-major
over the (corner, xy) dofs, not dot_tpu's block-major order; a
subdomain's free mask and lumped mass are per local vertex (P, N).
ops.py takes these for CPU tensors and System2D(use_kernels=False) on any
device; the CPU tests hold them against dot_tpu, chip_smoke.py holds the
kernels against them on the card.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

import numpy as np
import torch

from .soa2d import corner_basis2

# dot_tpu's block-major component (a*3 + b)*4 + i*2 + j -> the row-major
# component (a*2 + i)*6 + b*2 + j of K23's element Hessians
BLOCK_TO_ROW = np.array([(c // 12 * 2 + c % 4 // 2) * 6
                         + c // 4 % 3 * 2 + c % 2 for c in range(36)],
                        np.int64)


# 16 B vectors of a row one warp of K26 / K28's one-pass kernel writes,
# about (8 KB of f32): longer rows are cut into pieces of an even count
SEG_VECS = 512
# the slots of a row K26 / K28's one-pass kernel holds in its warp's
# registers at once (32 S, S up to 4); a longer row (a 2-dof row holds
# 2 (degree + 1) slots: a vertex of 64 neighbours or more) is walked in
# windows of MAX_ROW slots
MAX_ROW = 128


class SlotTables(NamedTuple):
    """A batch of dense (n_parts, n, n) matrices assembled from flat values:
    the plan's (src, dest) pairs in plan order (the plain version's scatter)
    and the same pairs grouped by destination slot, the slots in row order
    (the kernel's runs). Row p*n + r of the batch holds the slots
    row_off[p*n + r] <= k < row_off[p*n + r + 1] at columns col[k]. ADMM-DD's
    own tables also cover W's slots (`extra`), where the local-Hessian
    kernel reads W."""
    n_parts: int
    n_loc: int               # vertices per part (rows of free / mass)
    n: int                   # matrix width: dof * n_loc
    dof: int                 # 2 (subdomain matrices) or 1 (the PD matrix)
    src: torch.Tensor        # (nItem,) int64 flat index into the values
    dest: torch.Tensor       # (nItem,) int64 slot p*n*n + r*n + c
    items: torch.Tensor      # (nItem,) int32 src sorted by slot (stable)
    seg_off: torch.Tensor    # (nSlot + 1,) int32 CSR offsets of `items`
    udest: torch.Tensor      # (nSlot,) int64 the slots, ascending, with
                             #   every diagonal slot (an empty run at padding)
    row_off: torch.Tensor    # (n_parts n + 1,) int32 CSR offsets of the rows
    col: torch.Tensor        # (nSlot,) int32 column of each slot
    max_row: int             # the most slots a row holds
    extra: torch.Tensor      # (nSlot,) uint8: 1 at the slots given by
                             #   `slots` (None without them)


def slot_tables(src, dest, n_parts, n_loc, dof, device, slots=None):
    """SlotTables from flat (src, dest) numpy pairs. Slot ids are 64-bit
    (P n^2 reaches 4.1e8 at P = 1 on a 10K-vertex mesh); the kernel's
    tables are 32-bit: rows, slots, items and value indices must stay below
    2^31 (raises otherwise). `slots`: more slots the runs cover (empty runs
    there), so that a kernel over the tables reaches entries another table
    wrote."""
    src = np.asarray(src, np.int64)
    dest = np.asarray(dest, np.int64)
    n = dof * n_loc
    order = np.argsort(dest, kind="stable")
    ds = dest[order]
    diag = (np.arange(n_parts, dtype=np.int64)[:, None] * (n * n)
            + np.arange(n, dtype=np.int64)[None, :] * (n + 1)).reshape(-1)
    udest = np.union1d(ds, diag)
    if slots is not None:
        slots = np.asarray(slots, np.int64)
        udest = np.union1d(udest, slots)
    seg_off = np.concatenate([np.searchsorted(ds, udest), [ds.size]])
    row_off = np.searchsorted(udest // n, np.arange(n_parts * n + 1))
    big = 2 ** 31 - 1
    if max(src.size, n_parts * n + 1, int(src.max(initial=0)) + 1) >= big:
        raise ValueError(f"slot tables of {src.size} items over "
                         f"{n_parts} x {n}^2 need ids beyond 32 bits")

    def t(a, dt=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)
    return SlotTables(n_parts=int(n_parts), n_loc=int(n_loc), n=int(n),
                      dof=int(dof), src=t(src), dest=t(dest),
                      items=t(src[order], torch.int32),
                      seg_off=t(seg_off, torch.int32), udest=t(udest),
                      row_off=t(row_off, torch.int32),
                      col=t(udest % n, torch.int32),
                      max_row=int(np.diff(row_off).max()),
                      extra=None if slots is None else
                      t(np.isin(udest, slots), torch.uint8))


def subdomain_tables(plan, n_elem, device):
    """The K26 tables of a plan2d.Plan2D: its asm_src mapped to the
    row-major element Hessians, its asm_dest."""
    src = np.asarray(plan.asm_src, np.int64)
    comp, e = src // n_elem, src % n_elem
    return slot_tables(BLOCK_TO_ROW[comp] * n_elem + e, plan.asm_dest,
                       plan.n_parts, plan.n_local_max, 2, device)


def dense_tables(conn, n_vert, device):
    """K24's tables: the whole-mesh (2 nV)^2 matrix as one part of K26's
    batch. Value k N + e of the (36, N) row-major element Hessians lands at
    slot row * 2 nV + col of the element's dofs (dot_tpu's _hdest); the
    pairs in _hdest's order (element-major), so that each slot sums its run
    in the order index_add_ does. Raises for a vertex in no triangle (it
    would have no equation)."""
    conn = np.asarray(conn, np.int64)
    n, n2 = conn.shape[0], 2 * n_vert
    dof = np.stack([2 * conn[:, c] + i for c in range(3) for i in range(2)],
                   axis=1)                                   # (N, 6)
    dest = (np.repeat(dof, 6, axis=1) * n2 + np.tile(dof, (1, 6)))
    if np.unique(dof).size != n2:
        raise ValueError("2D mesh has a vertex that belongs to no triangle")
    src = np.arange(36)[None, :] * n + np.arange(n)[:, None]  # (N, 36)
    return slot_tables(src.reshape(-1), dest.reshape(-1), 1, n_vert, 2,
                       device)


def pd_tables(conn, n_vert, device):
    """The K28 tables of the (nV)^2 scalar PD matrix: value (a*3 + b)*N + e
    of the (9, N) pair values lands at conn[e, a] * nV + conn[e, b]
    (dot_tpu/dim2.py:707-709)."""
    conn = np.asarray(conn, np.int64)
    n = conn.shape[0]
    ab = np.arange(9)
    a, b = ab // 3, ab % 3
    # element-major, as dot_tpu's values: each slot's run in element order
    src = ab[None, :] * n + np.arange(n)[:, None]              # (N, 9)
    dest = conn[:, a] * n_vert + conn[:, b]                    # (N, 9)
    return slot_tables(src.reshape(-1), dest.reshape(-1), 1, n_vert, 1,
                       device)


# ---------------------------------------------------------------------------
# K25
# ---------------------------------------------------------------------------
def gather_corners2d(p, conn):
    """(6, N) corner values of p (nV, >= 2), row c*2 + i (dim2.py:520-523)."""
    return torch.stack([p[:, i][conn[c].long()]
                        for c in range(3) for i in range(2)])


def defgrad_from_corners2d(pe, g4):
    """(4, N) F from the (6, N) corner values (dim2.py:525-530)."""
    e = [[pe[(k + 1) * 2 + i] - pe[i] for i in range(2)] for k in range(2)]
    return torch.stack([e[0][i] * g4[j] + e[1][i] * g4[2 + j]
                        for i in range(2) for j in range(2)])


def quadratic_form2d_ref(p, conn, g4, elem_h, mass):
    """K25 plain: (p^T H p + sum m |p|^2 (0-d), F(p) (4, N)) from one corner
    gather of p (nV, 3) (dim2.py:557-565): elem_h (36, N) row-major."""
    pe = gather_corners2d(p, conn)
    k = torch.arange(36, device=p.device)
    q_el = torch.sum(elem_h * pe[k // 6] * pe[k % 6])
    q_m = torch.sum(mass[:, None] * p * p)
    return q_el + q_m, defgrad_from_corners2d(pe, g4)


# ---------------------------------------------------------------------------
# K26 and K28's assembly: dense matrices from sorted runs
# ---------------------------------------------------------------------------
def _assemble_ref(vals, free, mass, tab):
    """(H (P, n, n), d (P, n)): the values scatter-added into their slots,
    rows and columns of non-free dofs zeroed, mass f + (1 - f) added on the
    diagonal, d = sqrt(diag) (dim2.py:593-602, 719-725). free, mass:
    (P, n_loc)."""
    P, n, dof = tab.n_parts, tab.n, tab.dof
    H = torch.zeros(P * n * n, dtype=vals.dtype, device=vals.device)
    H = H.index_add_(0, tab.dest, vals.reshape(-1)[tab.src]).reshape(P, n, n)
    f = torch.repeat_interleave(free, dof, dim=-1)                 # (P, n)
    H = H * f[:, :, None] * f[:, None, :]
    H.diagonal(dim1=1, dim2=2).add_(
        torch.repeat_interleave(mass, dof, dim=-1) * f + (1.0 - f))
    return H, torch.sqrt(H.diagonal(dim1=1, dim2=2))


def assemble_rows_ref(vals, free, mass, tab, wadd=None, lanes=32,
                      seg_vecs=SEG_VECS, window=MAX_ROW):
    """CPU mirror of K26 / K28's one-pass kernel (csrc/dd2d.cu
    assemble_kernel) over the row tables: one warp a row piece. A row's
    slots row_off[row] <= k < row_off[row + 1] at columns col[k] (ascending)
    each sum their run (seg_off, items) in plan order, are masked by free
    at row and column, get wadd (P, n, n) at the slot (read where tab.extra
    marks the slot, 0 elsewhere) and mass f + (1 - f) on the diagonal
    (mass None: neither, and d None). The row is written in the kernel's
    pieces: its 16 B aligned vectors cut into nseg even pieces of at most
    `seg_vecs` vectors, the entries before the first aligned one (a head)
    with the first piece and those after the last whole vector (a tail)
    with the last, each piece in column chunks of `lanes` vectors (the
    kernel's warp step: 32), each chunk from zeros and the slots that fall
    in it. A piece walks the row's slots in windows of `window` as the
    kernel does: it skips the windows wholly left of its columns, and a
    chunk takes the next window while the current one ends left of the
    chunk's end; d is written where the diagonal's window is loaded.
    (H (P, n, n), d (P, n)): _assemble_ref's values bit for bit, whatever
    `lanes`, `seg_vecs` and `window` (an entry no chunk writes, or a slot
    no window reaches, shows as NaN or a missing value)."""
    P, n, dof = tab.n_parts, tab.n, tab.dof
    dev, dt = vals.device, vals.dtype
    vec = 16 // vals.element_size()
    vmax = n // vec
    nseg = -(-vmax // seg_vecs) if vmax > seg_vecs else 1
    segv = (-(-vmax // nseg) + 1) // 2 * 2
    flat = vals.reshape(-1)
    f = torch.repeat_interleave(free, dof, dim=-1).reshape(-1)     # (P n,)
    m = None if mass is None else \
        torch.repeat_interleave(mass, dof, dim=-1).reshape(-1)
    wf = None if wadd is None else wadd.reshape(-1)
    row_off, col = tab.row_off.tolist(), tab.col.long()
    cols_all = tab.col.tolist()
    seg_off, items = tab.seg_off.long(), tab.items.long()
    nan = float("nan")
    H = torch.full((P * n * n,), nan, dtype=dt, device=dev)
    d = None if mass is None else torch.full((P * n,), nan, dtype=dt,
                                             device=dev)
    for row in range(P * n):
        r = row % n
        kb, ke = row_off[row], row_off[row + 1]
        cols = cols_all[kb:ke]
        # one lane a slot: its run in plan order (the kernel computes each
        # slot in the piece its column falls in: the same bits)
        k = torch.arange(kb, ke, device=dev)
        c = col[k]
        lo, hi = seg_off[k], seg_off[k + 1]
        s = torch.zeros(k.shape[0], dtype=dt, device=dev)
        for q in range(int((hi - lo).max())):
            on = lo + q < hi
            s[on] += flat[items[lo[on] + q]]
        s = s * f[row] * f[row - r + c]
        if wf is not None:
            w = wf[row * n + c]
            if tab.extra is not None:       # wadd read at its own slots only
                w = torch.where(tab.extra[k].bool(), w, torch.zeros_like(w))
            s = s + w
        diag = bisect.bisect_left(cols, r)
        diag = diag if diag < len(cols) and cols[diag] == r else -1
        if m is not None and diag >= 0:
            s[diag] = s[diag] + (m[row] * f[row] + (1.0 - f[row]))
        mis = row * n % (2 * vec)
        head = 0 if mis == 0 else min(2 * vec - mis, n)
        nvec = (n - head) // vec
        tail0 = head + nvec * vec
        out = H[row * n:(row + 1) * n]
        picked = []
        for g in range(nseg):
            last = g == nseg - 1
            v_lo = min(g * segv, nvec)
            v_hi = nvec if last else min(v_lo + segv, nvec)
            clo = 0 if g == 0 else head + v_lo * vec        # its columns
            chi = n if last else head + v_hi * vec
            chunks = [(0, head)] if g == 0 and head > 0 else []
            chunks += [(head + a * vec, head + min(a + lanes, v_hi) * vec)
                       for a in range(v_lo, v_hi, lanes)]
            if last and tail0 < n:
                chunks.append((tail0, n))
            wk = 0
            while wk + window < len(cols) and cols[wk + window - 1] < clo:
                wk += window

            def load(wk):
                we = min(wk + window, len(cols))
                a = bisect.bisect_left(cols, clo, wk, we)
                b = bisect.bisect_left(cols, chi, wk, we)
                if d is not None and a <= diag < b:
                    d[row] = torch.sqrt(s[diag])
                return a, b
            win = load(wk)
            for a, b in chunks:
                out[a:b] = 0
                while True:
                    picked += [j for j in range(*win)
                               if a <= cols[j] < b]
                    if wk + window >= len(cols) or \
                            cols[wk + window - 1] >= b:
                        break
                    wk += window
                    win = load(wk)
        picked = torch.tensor(picked, dtype=torch.long, device=dev)
        out[c[picked]] = s[picked]
    return H.reshape(P, n, n), None if d is None else d.reshape(P, n)


def subdomain_assemble2d_ref(elem_h, free, mass_img, tab):
    """K26 plain: the dense (P, n2p, n2p) subdomain Hessians with interface
    completion and their sqrt-diagonals d (P, n2p) (dim2.py:588-602,
    610). elem_h (36, N) row-major; free, mass_img (P, N)."""
    return _assemble_ref(elem_h, free, mass_img, tab)


def subdomain_scale2d_ref(H, d, tab):
    """K26's second entry, plain: the Jacobi-equilibrated H / d_r / d_c,
    symmetrized as jnp.linalg.cholesky symmetrizes its input
    (dim2.py:611-617). H (P, n, n), d (P, n); returns a new tensor (the
    kernel scales H in place)."""
    dinv = 1.0 / d
    Hn = H * dinv[:, :, None] * dinv[:, None, :]
    return (Hn + Hn.mT) / 2


def pd_pair_vals2d(g4, w):
    """(9, N): w_e (D_a . D_b) for the corner pairs a*3 + b
    (dim2.py:714-718)."""
    D = corner_basis2(g4)
    return torch.stack([w * (D[a][0] * D[b][0] + D[a][1] * D[b][1])
                        for a in range(3) for b in range(3)])


def pd_assemble2d_ref(g4, w, free, mass, tab):
    """K28 plain: (S (nV, nV), d (nV,)) of M + dt^2 D^T W D with unit rows
    at fixed vertices (dim2.py:704-725); w (N,) the element weights."""
    S, d = _assemble_ref(pd_pair_vals2d(g4, w), free[None], mass[None], tab)
    return S[0], d[0]


def hessian_diag2d_ref(elem_h, mass, plan):
    """K28's second entry, plain: the (nV, 3) diagonal of M + dt^2 H at
    dim 2, z column 1 (dim2.py:567-580). plan: soa2d.Scatter2DPlan (its
    gdest: dof 2 v + i of value e*6 + c*2 + i)."""
    nv = mass.shape[0]
    diag = elem_h[torch.arange(6, device=elem_h.device) * 7]     # (6, N)
    acc = torch.zeros(2 * nv, dtype=elem_h.dtype, device=elem_h.device)
    acc.index_add_(0, plan.gdest, diag.t().reshape(-1))
    cols = acc.reshape(nv, 2) + mass[:, None]
    return torch.cat([cols, torch.ones((nv, 1), dtype=elem_h.dtype,
                                       device=elem_h.device)], dim=1)


# ---------------------------------------------------------------------------
# K27: the vertex-side halves of the H0 apply and of one subdomain's solve
# ---------------------------------------------------------------------------
def h0_gather2d_ref(rhs, l2g, valid, d):
    """K27 plain (gather): (P, 2N) rhs[l2g][:, :2] * valid / d
    (dim2.py:649-650)."""
    P, N = l2g.shape
    r = rhs[l2g][..., :2] * valid[..., None]
    return r.reshape(P, 2 * N) / d


def h0_average2d_ref(z, d, perm, segids, seg_off, dup):
    """K27 plain (average): (nV, 3) the local solutions z / d summed per
    vertex over the sorted segment ids (id nV is the padding's dump),
    divided by dup, z = 0 (dim2.py:652-658)."""
    nv = dup.shape[0]
    p_l = (z / d).reshape(-1, 2)[perm]
    acc = torch.zeros((nv + 1, 2), dtype=z.dtype, device=z.device)
    acc.index_add_(0, segids, p_l)
    fine = acc[:nv] / dup[:, None]
    return torch.cat([fine, torch.zeros((nv, 1), dtype=z.dtype,
                                        device=z.device)], dim=1)


def local_gather_one2d_ref(rhs, l2g, valid, d, part):
    """K27 plain (one subdomain's gather): (2N,) of subdomain `part`
    (dim2.py:631-635, gsdd.py:52)."""
    r = rhs[l2g[part]][:, :2] * valid[part][:, None]
    return r.reshape(-1) / d[part]


def local_scatter_one2d_ref(z, d, l2g, valid, part, n_vert):
    """K27 plain (one subdomain's scatter): the zero (nV, 3) direction with
    subdomain `part`'s z / d at its valid local vertices; padding goes to
    the dump row nV (dim2.py:637-643)."""
    p_l = (z / d[part]).reshape(-1, 2) * valid[part][:, None]
    idx = torch.where(valid[part], l2g[part], n_vert)
    p2 = torch.zeros((n_vert + 1, 2), dtype=z.dtype, device=z.device)
    p2[idx] = p_l
    return torch.cat([p2[:n_vert], torch.zeros((n_vert, 1), dtype=z.dtype,
                                               device=z.device)], dim=1)
