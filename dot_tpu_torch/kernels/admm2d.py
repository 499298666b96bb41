"""Plain PyTorch versions of the kernels of the two 2D ADMM steppers, and the
host-side tables of 2D ADMM-DD.

K29 admm_local_step2d  ADMM-PD's per-element local step at dim 2: flip-SVD of
                       Dx + u, a projected Newton on the two singular values
                       with an energy line search, z = U diag(sigma) V^T and
                       the dual increment (dot_tpu/steppers/admm.py 142-213
                       _local_step at DIM = 2, 66 _solve_sym2;
                       dot_tpu/dim2.py 780-821 ADMMPD2D's hooks)
K30 dtw_scatter2d      D^T (w M) per triangle corner, summed per vertex over
                       the vertex-sorted incidences, with ADMM-PD's two
                       per-vertex epilogues; z column 0 (dim2.py 823-832
                       _scatter, admm.py 216-226 _apply_A, 288-297 the rhs)
K21 ls_trial_energy2d_parts   the 2D line-search trial with one alpha and
                       one sum per subdomain slab (dim2.py 1173-1176,
                       1366-1372)
K22 elem_gradient2d_from_F    the 2D element gradient from carried
                       deformation gradients, summed into local rows
                       (dim2.py 1182-1189)
K26 w_assemble2d       the masked interface weights W (P, n2p, n2p) and the
                       consensus matrix C with its sqrt-diagonal
                       (dim2.py 1123-1152)
K26 local_h_assemble2d ADMM-DD's augmented local Hessian: own elements +
                       W + the subdomain mass, and its sqrt-diagonal
                       (dim2.py 1206-1232)

The CPU tests use these, and System2D(use_kernels=False) takes them on any
device for comparison runs; the main path on a card never does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import dd2d, soa2d
from .admm import LOCAL_LS_CAP, LOCAL_MAX_ITER
from ..plan2d import _completion_tuples_2d

SIG_DIAG2 = (0, 2)   # diagonal entries of the packed sym2 (00, 01, 11)


# ----------------------------------------------------------------------
# K29
# ----------------------------------------------------------------------
def solve_sym2(h3, g):
    """Solve the SPD 2x2 system H p = g (batched scalars)."""
    a, b, c = h3  # (00, 01, 11)
    inv_det = 1.0 / (a * c - b * b)
    return ((c * g[0] - b * g[1]) * inv_det,
            (a * g[1] - b * g[0]) * inv_det)


def admm_local_step2d_ref(Dx, u4, w, vol_dtsq, mu, lam, mat,
                          want_counts=False):
    """K29 plain: (z (4, N), du (4, N)) of ADMM-PD's local step at dim 2
    (with `want_counts` also the (2, N) int32 Newton iterations and energy
    evaluations each element took while it was active). Dx, u4: (4, N)
    deformation gradients and scaled duals; w, vol_dtsq, mu, lam: (N,).
    All elements step together under masks, as dot_tpu's while_loops do."""
    dxu = tuple(Dx[k] + u4[k] for k in range(4))
    U, s_hat, V = soa2d.svd2_flip_soa(dxu)

    def energy(s):
        d = tuple(s_hat[i] - s[i] for i in range(2))
        return (mat.psi(s, mu, lam) * vol_dtsq
                + 0.5 * w * (d[0] * d[0] + d[1] * d[1]))

    def grad(s):
        g = mat.dpsi(s, mu, lam)
        return tuple(g[i] * vol_dtsq - w * (s_hat[i] - s[i])
                     for i in range(2))

    def hess(s):
        h = [x * vol_dtsq for x in soa2d.make_pd2_soa(mat.d2psi(s, mu, lam))]
        for k in SIG_DIAG2:
            h[k] = h[k] + w
        return tuple(h)

    s = s_hat
    e0 = energy(s)
    active = torch.ones_like(e0, dtype=torch.bool)
    n_it = torch.zeros_like(e0, dtype=torch.int32)
    n_ev = torch.ones_like(e0, dtype=torch.int32)
    it = 0
    while it < LOCAL_MAX_ITER and bool(active.any()):
        g = grad(s)
        p = solve_sym2(hess(s), tuple(-x for x in g))
        alpha = torch.ones_like(e0)
        e = energy(tuple(s[i] + p[i] for i in range(2)))
        n_it += active
        n_ev += active
        k = 0
        while k < LOCAL_LS_CAP and bool((e > e0).any()):
            n_ev += torch.logical_and(active, e > e0)
            alpha = torch.where(e > e0, alpha * 0.5, alpha)
            e = energy(tuple(s[i] + alpha * p[i] for i in range(2)))
            k += 1
        s = tuple(torch.where(active, s[i] + alpha * p[i], s[i])
                  for i in range(2))
        e_new = torch.where(active, e, e0)
        # local convergence: |(E0 - E) / E0| < 1e-3 alpha (zuUpdate_SV:439)
        still = torch.abs((e0 - e_new) / torch.where(e0 == 0, 1.0, e0)) \
            >= 1.0e-3 * alpha
        active = torch.logical_and(active, still)
        e0 = e_new
        it += 1

    z = tuple(U[2 * i + 0] * s[0] * V[2 * j + 0]
              + U[2 * i + 1] * s[1] * V[2 * j + 1]
              for i in range(2) for j in range(2))
    du = tuple(dxu[k] - u4[k] - z[k] for k in range(4))       # Dx - z
    if want_counts:
        return torch.stack(z), torch.stack(du), torch.stack([n_it, n_ev])
    return torch.stack(z), torch.stack(du)


# ----------------------------------------------------------------------
# K30
# ----------------------------------------------------------------------
def dtw_scatter2d_ref(M4, g4, w, plan, x, mass=None, base=None, offset=None,
                      free=None):
    """K30 plain: s[v, i] = sum over the (triangle, corner) incidences of
    vertex v of sum_j D[c][j] (w M[i][j]) (z column 0), then
      s + mass x                                      (given `mass`), or
      (base + s - offset) free + x (1 - free)         (given base, offset,
                                                       free).
    M4, g4: (4, N); w: (N,); plan: soa2d.Scatter2DPlan; x, base, offset:
    (nV, 3); mass, free: (nV,)."""
    nv = x.shape[0]
    D = soa2d.corner_basis2(g4)                               # (3, 2, N)
    wm = [[w * M4[2 * i + j] for j in range(2)] for i in range(2)]
    vals = torch.stack([D[c][0] * wm[i][0] + D[c][1] * wm[i][1]
                        for c in range(3) for i in range(2)],
                       dim=1).reshape(-1)
    acc = torch.zeros(2 * nv, dtype=M4.dtype, device=M4.device)
    acc.index_add_(0, plan.gdest, vals)
    s = torch.cat([acc.reshape(nv, 2),
                   torch.zeros((nv, 1), dtype=M4.dtype, device=M4.device)],
                  dim=1)
    if mass is not None:
        return s + mass[:, None] * x
    fr = free[:, None]
    return (base + s - offset) * fr + x * (1.0 - fr)


# ----------------------------------------------------------------------
# the entry points of K21 / K22 / K26 that ADMM-DD 2D adds
# ----------------------------------------------------------------------
def ls_trial_energy2d_parts_ref(F0, Fp, alpha, u, lam, w, mat, n_parts):
    """K21 per slab, plain: (P,) sums of w Psi(sigma(F0 + alpha_p Fp)) over
    the P equal element slabs of the (4, N) buffers; alpha (P,) (Fp and
    alpha may be None: F = F0)."""
    if Fp is None:
        F = F0
    else:
        ae = torch.repeat_interleave(alpha, F0.shape[1] // n_parts)
        F = F0 + ae * Fp
    _, s, _ = soa2d.svd2_flip_soa(tuple(F))
    return torch.sum((mat.psi(s, u, lam) * w).reshape(n_parts, -1), dim=1)


class RowIncidences(NamedTuple):
    """The (triangle, corner) incidences of local rows, sorted by row (the
    order K22's from-F entry sums them in)."""
    n_rows: int
    inc_perm: torch.Tensor   # (3 N,) int64 incidences e * 3 + c by row
    inc_off: torch.Tensor    # (n_rows + 1,) int64 CSR offsets (rows past
                             #   n_rows, the padding's, are never summed)


def row_incidences(conn_s, n_rows, device):
    """RowIncidences of the (N, 3) numpy row ids `conn_s`."""
    flat = np.asarray(conn_s, np.int64).reshape(-1)
    perm = np.argsort(flat, kind="stable")
    off = np.searchsorted(flat[perm], np.arange(n_rows + 1))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                               device=device)
    return RowIncidences(n_rows=int(n_rows), inc_perm=t(perm), inc_off=t(off))


def elem_gradient2d_from_F_ref(F, conn_s, g4, u, lam, w, mat, rows):
    """K22 from carried deformation gradients, plain: the per-corner forces
    D (w P) at F (4, N) summed into the rows.n_rows rows (n_rows, 2) of
    conn_s (3, N) int32; padding triangles at row n_rows are dropped. The
    kernel sums each row over `rows`' incidences."""
    n_rows = rows.n_rows
    f = tuple(F)
    U, s, V = soa2d.svd2_flip_soa(f)
    ge = soa2d.element_gradient2_soa(mat, f, U, s, V,
                                     soa2d.corner_basis2(g4), u, lam, w)
    vals = torch.stack([torch.stack(ge[c], dim=-1) for c in range(3)],
                       dim=1)                                  # (N, 3, 2)
    acc = torch.zeros((n_rows + 1, 2), dtype=F.dtype, device=F.device)
    acc.index_add_(0, conn_s.t().reshape(-1).long(), vals.reshape(-1, 2))
    return acc[:n_rows]


def w_assemble2d_ref(elem_h, free, sfree, md_sh, w_tab, c_tab):
    """K26's W / consensus entry, plain: (Wm (P, n2p, n2p), C (ns2, ns2),
    dc (ns2,)). Wm: the interface blocks of the (36, nE) row-major element
    Hessians summed into their slots, rows and columns of non-free dofs
    zeroed (free (P, N)); C: the same values summed into the shared dofs'
    slots, + md_sh on the diagonal, the free mask sfree (ns + 1,) on rows
    and columns, a unit diagonal where it is 0; dc = sqrt(diag C)
    (dim2.py:1130-1146)."""
    P, n = w_tab.n_parts, w_tab.n
    W = torch.zeros(P * n * n, dtype=elem_h.dtype, device=elem_h.device)
    W = W.index_add_(0, w_tab.dest,
                     elem_h.reshape(-1)[w_tab.src]).reshape(P, n, n)
    f = torch.repeat_interleave(free, 2, dim=-1)
    Wm = W * f[:, :, None] * f[:, None, :]
    C, dc = dd2d._assemble_ref(elem_h, sfree[None], md_sh[None], c_tab)
    return Wm, C[0], dc[0]


def local_h_assemble2d_ref(elem_h, Wm, free, mass, tab):
    """K26's local-Hessian entry, plain: (H (P, n2p, n2p), d (P, n2p)): the
    own elements' (36, P epad) row-major Hessians summed into their slots,
    rows and columns of non-free dofs zeroed (free (P, N)), + Wm, + mass f
    + (1 - f) on the diagonal (mass (P, N): the local lumped mass plus the
    masked mass difference); d = sqrt(diag H) (dim2.py:1219-1232)."""
    P, n = tab.n_parts, tab.n
    H = torch.zeros(P * n * n, dtype=elem_h.dtype, device=elem_h.device)
    H = H.index_add_(0, tab.dest,
                     elem_h.reshape(-1)[tab.src]).reshape(P, n, n)
    f = torch.repeat_interleave(free, 2, dim=-1)
    H = H * f[:, :, None] * f[:, None, :] + Wm
    H.diagonal(dim1=1, dim2=2).add_(
        torch.repeat_interleave(mass, 2, dim=-1) * f + (1.0 - f))
    return H, torch.sqrt(H.diagonal(dim1=1, dim2=2))


# ----------------------------------------------------------------------
# host tables of ADMM-DD at dim 2 (dot_tpu/dim2.py:989-1113)
# ----------------------------------------------------------------------
class DD2DTables(NamedTuple):
    """dot_tpu's ADMMDD2D tables as numpy arrays (its names); the element
    Hessian indices (own_src, comp_gather) are dot_tpu's block-major ones."""
    g2l: np.ndarray          # (P, nV) int32 local index or -1
    epad: int                # padded triangles per subdomain slab
    elem_src: np.ndarray     # (P epad,) int64 global triangle of each slot
    elem_valid: np.ndarray   # (P epad,) bool
    conn_local: np.ndarray   # (P epad, 3) int64 local rows (pad: P N)
    own_src: np.ndarray      # (P epad 36,) int32 into the (36, P epad)
    own_dest: np.ndarray     # (P epad 36,) int64 slot (pad: P n2p^2)
    mass_local: np.ndarray   # (P, N) subdomain lumped mass
    is_dual: np.ndarray      # (P, N) bool: a shared local vertex
    owner_flat: np.ndarray   # (nV,) int64 owner's flat local row
    shared_ids: np.ndarray   # (ns,) int64
    n_shared: int
    ns2: int                 # 2 (ns + 1)
    l2shared: np.ndarray     # (P, N) int64 shared index (ns: none)
    comp_gather: np.ndarray  # (nC 4,) int32 into the (36, nE)
    w_dest: np.ndarray       # (nC 4,) int64 slot of W
    c_dest: np.ndarray       # (nC 4,) int64 slot of C
    mass_dif: np.ndarray     # (P, N) missing mass at dual vertices


def admm_dd2d_tables(mesh, plan):
    """DD2DTables of a 2D mesh and its plan2d.Plan2D, computed as
    dot_tpu's ADMMDD2D.__init__ computes them."""
    conn = mesh.conn.astype(np.int64)
    P, N, n2p = plan.n_parts, plan.n_local_max, plan.n2
    n_vert, n_elem = mesh.n_vert, mesh.n_elem
    part = plan.part
    g2l = np.full((P, n_vert), -1, np.int32)
    locals_ = []
    for p in range(P):
        lv = np.where(plan.local_valid[p])[0]
        gl = plan.local_to_global[p, lv]
        g2l[p, gl] = lv.astype(np.int32)
        locals_.append(gl.astype(np.int64))

    # padded per-subdomain element slabs
    by_part = [np.where(part == p)[0] for p in range(P)]
    epad = max(8, -(-max(len(e) for e in by_part) // 8) * 8)
    elem_src = np.zeros((P, epad), np.int64)
    elem_valid = np.zeros((P, epad), bool)
    for p, e in enumerate(by_part):
        elem_src[p, :len(e)] = e
        elem_valid[p, :len(e)] = True
    es, ev = elem_src.reshape(-1), elem_valid.reshape(-1)
    pid = np.repeat(np.arange(P, dtype=np.int64), epad)
    lconn = g2l[pid[:, None], conn[es]]
    conn_local = np.where(ev[:, None], pid[:, None] * N + lconn, P * N)

    # own-element dense assembly: 9 corner-pair 2x2 blocks per slab element
    ij = np.indices((2, 2)).reshape(2, 4).T
    i4, j4 = ij[:, 0][None, :], ij[:, 1][None, :]
    slab_e = np.arange(P * epad, dtype=np.int64)
    srcs, dests = [], []
    for a in range(3):
        for b in range(3):
            comp = (a * 3 + b) * 4 + i4 * 2 + j4
            srcs.append(comp * (P * epad) + slab_e[:, None])
            d = (pid[:, None] * (n2p * n2p)
                 + (lconn[:, a][:, None] * 2 + i4) * n2p
                 + lconn[:, b][:, None] * 2 + j4)
            dests.append(np.where(ev[:, None], d, P * n2p * n2p))
    own_src = np.concatenate(srcs, 1).reshape(-1).astype(np.int32)
    own_dest = np.concatenate(dests, 1).reshape(-1).astype(np.int64)

    # subdomain lumped mass + interface maps
    mass_local = np.zeros((P, N))
    cm = np.asarray(mesh.area) * mesh.rho / 3.0
    for p, e in enumerate(by_part):
        np.add.at(mass_local[p], g2l[p, conn[e].ravel()], np.repeat(cm[e], 3))
    is_shared_g = plan.dup > 1
    is_dual = np.zeros((P, N), bool)
    owner_part = np.zeros(n_vert, np.int32)
    owner_local = np.zeros(n_vert, np.int32)
    seen = np.zeros(n_vert, bool)
    for p in range(P):
        lv = np.where(plan.local_valid[p])[0]
        gl = plan.local_to_global[p, lv]
        is_dual[p, lv] = is_shared_g[gl]
        new = ~seen[gl]
        owner_part[gl[new]] = p
        owner_local[gl[new]] = lv[new]
        seen[gl[new]] = True
    owner_flat = owner_part.astype(np.int64) * N + owner_local
    shared_ids = np.where(is_shared_g)[0].astype(np.int64)
    n_shared = len(shared_ids)
    ns2 = 2 * (n_shared + 1)
    shared_of = np.full(n_vert, n_shared, np.int64)
    shared_of[shared_ids] = np.arange(n_shared)
    l2shared = np.full((P, N), n_shared, np.int64)
    for p in range(P):
        lv = np.where(plan.local_valid[p])[0]
        l2shared[p, lv] = shared_of[plan.local_to_global[p, lv]]

    # weight / consensus scatter plans over the completion tuples
    c_sbd, c_elem, c_a, c_b, c_row, c_col = _completion_tuples_2d(
        conn, part, locals_, g2l, plan.dup, P, n_vert)
    comp = (c_a.astype(np.int64) * 3 + c_b)[:, None] * 4 + i4 * 2 + j4
    comp_gather = (comp * n_elem + c_elem[:, None]).reshape(-1) \
        .astype(np.int32)
    w_dest = (c_sbd.astype(np.int64)[:, None] * (n2p * n2p)
              + (c_row.astype(np.int64)[:, None] * 2 + i4) * n2p
              + c_col.astype(np.int64)[:, None] * 2 + j4).reshape(-1)
    srow = shared_of[plan.local_to_global[c_sbd, c_row]]
    scol = shared_of[plan.local_to_global[c_sbd, c_col]]
    c_dest = ((srow[:, None] * 2 + i4) * ns2 + scol[:, None] * 2
              + j4).reshape(-1)
    mass_dif = (np.asarray(mesh.mass)[plan.local_to_global]
                * plan.local_valid - mass_local) * is_dual
    return DD2DTables(
        g2l=g2l, epad=int(epad), elem_src=es, elem_valid=ev,
        conn_local=conn_local, own_src=own_src, own_dest=own_dest,
        mass_local=mass_local, is_dual=is_dual, owner_flat=owner_flat,
        shared_ids=shared_ids, n_shared=int(n_shared), ns2=int(ns2),
        l2shared=l2shared, comp_gather=comp_gather, w_dest=w_dest,
        c_dest=c_dest, mass_dif=mass_dif)


def row_major_src(src, n_values):
    """dot_tpu's block-major element-Hessian indices comp * n + e mapped to
    K23's row-major (36, n) layout."""
    src = np.asarray(src, np.int64)
    return dd2d.BLOCK_TO_ROW[src // n_values] * n_values + src % n_values
