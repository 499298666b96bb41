"""Plain PyTorch versions of the kernels of the two ADMM steppers, and the
host-side tables their CUDA versions walk.

K17 admm_local_step   ADMM-PD's per-element local step: flip-SVD of Dx + u,
                      a projected Newton on the three singular values with an
                      energy line search, z = U diag(sigma) V^T and the dual
                      increment (dot_tpu/steppers/admm.py 142-213 _local_step,
                      50 _solve_sym3; dot_tpu/kernels/soa.py 263 make_pd3_soa
                      inside it)
K18 dtw_scatter       D^T (w M) per corner, summed per vertex over the sorted
                      incidences, with ADMM-PD's two per-vertex epilogues
                      (admm.py 216-240 _apply_A / _scatter, 288-295 the rhs)
K19 own_band_assemble ADMM-DD's augmented local Hessian in its banded flat
                      [diag | sub] storage: own-element blocks, the subdomain
                      lumped mass, + W, + the mass-diff diagonal
                      (dot_tpu/steppers/core.py 811-839 assemble_own_btd_flat,
                      admm_dd.py 348-361)
K20 w_matvec          the compact interface-weight operator and its diagonal
                      (admm_dd.py 213-252 _w_masked, w_matvec, w_diag, _md3f)
K20 w_quad            the line search's two W products and their per-part
                      quadratic terms a0c, a1c, a2c (admm_dd.py 524-529)
K1  ls_trial_energy_parts   the line-search trial with one alpha and one sum
                      per subdomain slab (admm_dd.py 532-543)
K2  elem_gradient_from_F    the element gradient from carried deformation
                      gradients, scattered to local rows (admm_dd.py 295-311)

The CPU tests use these, and System(use_kernels=False) takes them on any
device for comparison runs; the main path on a card never does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import band, soa

LOCAL_MAX_ITER = 100   # reference fail-safe (ADMMTimeStepper.cpp:385)
LOCAL_LS_CAP = 40
SIG_DIAG = (0, 3, 5)   # diagonal entries of the packed symmetric Hessian


def bulk_modulus(u, lam):
    """Reference: Energy::getBulkModulus (src/Energy/Energy.cpp:1273-1277)."""
    return lam + u * 2.0 / 3.0


class WPlan(NamedTuple):
    """Static tables of ADMM-DD's compact interface-weight operator: entry
    k of w_vals sits at (row[k], col[k]) of the block-diagonal (P n3)^2
    matrix, rows sorted."""
    row: torch.Tensor       # (nUW,) int64 flat row dof sbd * n3 + r, sorted
    col: torch.Tensor       # (nUW,) int64 flat column dof sbd * n3 + c
    row_off: torch.Tensor   # (P n3 + 1,) int64 CSR offsets of `row`
    md3: torch.Tensor       # (P n3,) mass-diff diagonal per local dof
    band_dest: torch.Tensor = None     # (nUW,) int64 band slots; `total`
                                       #   = dropped (upper neighbour)
    md_band_diag: torch.Tensor = None  # (P n3,) int64 band slots of the dof
                                       #   diagonal


def w_plan(ap, n3, dtype, device):
    """WPlan from a numpy partition.ADMMDDPlan."""
    ud = np.asarray(ap.w_udest, np.int64)
    sbd = ud // (n3 * n3)
    rowdof = ud % (n3 * n3) // n3
    coldof = ud % n3
    row = sbd * n3 + rowdof
    n_rows = int(ap.mass_local.shape[0]) * n3

    def t(a, dt=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)
    banded = ap.w_band_dest is not None
    return WPlan(
        row=t(row), col=t(sbd * n3 + coldof),
        row_off=t(band.csr_offsets(row, n_rows)),
        md3=t(np.repeat(ap.mass_dif, 3, axis=-1).reshape(-1), dtype),
        band_dest=t(ap.w_band_dest) if banded else None,
        md_band_diag=t(ap.md_band_diag) if banded else None)


# ----------------------------------------------------------------------
# K17
# ----------------------------------------------------------------------
def solve_sym3(h6, g):
    """Solve the SPD 3x3 system H p = g by the adjugate (batched)."""
    a, b, c, d, e, f = h6  # (00, 01, 02, 11, 12, 22)
    det = a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d)
    inv_det = 1.0 / det
    i00 = (d * f - e * e) * inv_det
    i01 = (c * e - b * f) * inv_det
    i02 = (b * e - c * d) * inv_det
    i11 = (a * f - c * c) * inv_det
    i12 = (b * c - a * e) * inv_det
    i22 = (a * d - b * b) * inv_det
    return (i00 * g[0] + i01 * g[1] + i02 * g[2],
            i01 * g[0] + i11 * g[1] + i12 * g[2],
            i02 * g[0] + i12 * g[1] + i22 * g[2])


def admm_local_step_ref(Dx, u9, w, vol_dtsq, mu, lam, mat,
                        want_counts=False):
    """K17 plain: (z (9, N), du (9, N)) of ADMM-PD's local step (with
    `want_counts` also the (2, N) int32 Newton iterations and energy
    evaluations each element took while it was active). Dx, u9:
    (9, N) deformation gradients and scaled duals; w, vol_dtsq, mu, lam:
    (N,) ADMM weights, vol dt^2 and the Lame parameters. All elements step
    together under masks, as dot_tpu's while_loops do: an element halves
    only while its own trial energy exceeds its start, and keeps its sigma
    once it has converged."""
    dxu = tuple(Dx[k] + u9[k] for k in range(9))
    U, s_hat, V = soa.svd3_flip_soa(dxu)

    def energy(s):
        d = tuple(s_hat[i] - s[i] for i in range(3))
        return (mat.psi(s, mu, lam) * vol_dtsq
                + 0.5 * w * (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]))

    def grad(s):
        g = mat.dpsi(s, mu, lam)
        return tuple(g[i] * vol_dtsq - w * (s_hat[i] - s[i])
                     for i in range(3))

    def hess(s):
        h = [x * vol_dtsq for x in soa.make_pd3_soa(mat.d2psi(s, mu, lam))]
        for k in SIG_DIAG:
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
        p = solve_sym3(hess(s), tuple(-x for x in g))
        alpha = torch.ones_like(e0)
        e = energy(tuple(s[i] + p[i] for i in range(3)))
        n_it += active
        n_ev += active
        k = 0
        while k < LOCAL_LS_CAP and bool((e > e0).any()):
            n_ev += torch.logical_and(active, e > e0)
            alpha = torch.where(e > e0, alpha * 0.5, alpha)
            e = energy(tuple(s[i] + alpha * p[i] for i in range(3)))
            k += 1
        s = tuple(torch.where(active, s[i] + alpha * p[i], s[i])
                  for i in range(3))
        e_new = torch.where(active, e, e0)
        # local convergence: |(E0 - E) / E0| < 1e-3 alpha (zuUpdate_SV:439)
        still = torch.abs((e0 - e_new) / torch.where(e0 == 0, 1.0, e0)) \
            >= 1.0e-3 * alpha
        active = torch.logical_and(active, still)
        e0 = e_new
        it += 1

    z = tuple(U[3 * i + 0] * s[0] * V[3 * j + 0]
              + U[3 * i + 1] * s[1] * V[3 * j + 1]
              + U[3 * i + 2] * s[2] * V[3 * j + 2]
              for i in range(3) for j in range(3))
    du = tuple(dxu[k] - u9[k] - z[k] for k in range(9))       # Dx - z
    if want_counts:
        return torch.stack(z), torch.stack(du), torch.stack([n_it, n_ev])
    return torch.stack(z), torch.stack(du)


def make_pd3_ref(a6):
    """The device function inside K17, on its own: the SPD projection of
    (6, N) packed symmetric 3x3 matrices (soa.make_pd3_soa)."""
    return torch.stack(soa.make_pd3_soa(tuple(a6)))


# ----------------------------------------------------------------------
# K18
# ----------------------------------------------------------------------
def dtw_scatter_ref(M9, g9, w, perm, segids, seg_off, x, mass=None,
                    base=None, offset=None, free=None):
    """K18 plain: s[v, i] = sum over the (element, corner) incidences of
    vertex v of sum_j D[c][j] (w M[i][j]), then
      s + mass x                                      (given `mass`), or
      (base + s - offset) free + x (1 - free)         (given base, offset,
                                                       free).
    M9, g9: (9, N); w: (N,); perm, segids: the incidences e * 4 + c sorted
    by vertex and their vertex ids (id nV is the padding dump); x, base,
    offset: (nV, 3); mass, free: (nV,). `seg_off` is the kernel's."""
    n_vert = x.shape[0]
    D = soa.corner_basis(g9)                                 # (4, 3, N)
    wm = [[w * M9[3 * i + j] for j in range(3)] for i in range(3)]
    cols = []
    for i in range(3):
        ge = [D[c][0] * wm[i][0] + D[c][1] * wm[i][1] + D[c][2] * wm[i][2]
              for c in range(4)]
        vals = torch.stack(ge, dim=1).reshape(-1)[perm]
        acc = torch.zeros(n_vert + 1, dtype=M9.dtype, device=M9.device)
        acc.index_add_(0, segids, vals)
        cols.append(acc[:n_vert])
    s = torch.stack(cols, dim=-1)
    if mass is not None:
        return s + mass[:, None] * x
    fr = free[:, None]
    return (base + s - offset) * fr + x * (1.0 - fr)


# ----------------------------------------------------------------------
# K19
# ----------------------------------------------------------------------
def own_band_assemble_ref(elem_h, freef, mass_flat, plan, w_vals, free3f,
                          wp):
    """K19 plain: the flat [diag | sub] band (plan.total,) of ADMM-DD's
    augmented local Hessians: K5's assembly over the own-element tables
    `plan` (a band.BandPlan) with the subdomain lumped mass, then + the
    masked W at wp.band_dest (slot `total`: an upper-neighbour entry, not
    written) and + the masked mass-diff diagonal at wp.md_band_diag."""
    flat = band.band_assemble_ref(elem_h, freef, mass_flat, plan)
    wm = w_vals * free3f[wp.row] * free3f[wp.col]
    keep = wp.band_dest < plan.total
    flat[wp.band_dest[keep]] += wm[keep]       # unique destinations
    flat[wp.md_band_diag] += wp.md3 * free3f
    return flat


# ----------------------------------------------------------------------
# K20
# ----------------------------------------------------------------------
def w_matvec_ref(w_vals, free3f, a, wp, diag_only=False):
    """K20 plain: (P n3,) y[r] = sum_k w_k free[r] free[col_k] a[col_k]
    + md3[r] free[r] a[r] over the entries k of row r; with `diag_only`
    (a is None) the diagonal of the same masked operator."""
    wm = w_vals * free3f[wp.row] * free3f[wp.col]
    if diag_only:
        v = wm * (wp.row == wp.col).to(wm.dtype)
    else:
        v = wm * a[wp.col]
    y = torch.zeros_like(free3f).index_add_(0, wp.row, v)
    md = wp.md3 * free3f
    return y + (md if diag_only else md * a)


def w_quad_ref(w_vals, free3f, aug0, pa, wp, n_parts):
    """K20's line-search entry, plain: (3, P) [a0c, a1c, a2c] with
    a0c = aug0.W aug0 / 2, a1c = (pa.W aug0 + aug0.W pa) / 2, a2c =
    pa.W pa / 2 per part (the sums of dot_tpu admm_dd.py:524-529 as
    written); aug0, pa (P n3,)."""
    Wa0 = w_matvec_ref(w_vals, free3f, aug0, wp).view(n_parts, -1)
    Wpa = w_matvec_ref(w_vals, free3f, pa, wp).view(n_parts, -1)
    a0, p = aug0.view(n_parts, -1), pa.view(n_parts, -1)
    a0c = 0.5 * torch.sum(a0 * Wa0, dim=1)
    a1c = 0.5 * (torch.sum(p * Wa0, dim=1) + torch.sum(a0 * Wpa, dim=1))
    a2c = 0.5 * torch.sum(p * Wpa, dim=1)
    return torch.stack([a0c, a1c, a2c])


# ----------------------------------------------------------------------
# the two added entry points of K1 / K2
# ----------------------------------------------------------------------
def ls_trial_energy_parts_ref(F0, Fp, alpha, u, lam, w, mat, n_parts):
    """K1 per slab, plain: (P,) sums of w Psi(sigma(F0 + alpha_p Fp)) over
    the P equal element slabs; alpha: (P,) (Fp and alpha may be None:
    F = F0)."""
    if Fp is None:
        F = F0
    else:
        ae = torch.repeat_interleave(alpha, F0.shape[1] // n_parts)
        F = F0 + ae * Fp
    _, s, _ = soa.svd3_flip_soa(tuple(F))
    return torch.sum((mat.psi(s, u, lam) * w).reshape(n_parts, -1), dim=1)


def elem_gradient_from_F_ref(F, conn_s, g9, u, lam, w, mat, n_rows):
    """K2 from carried deformation gradients, plain: per-element D (w P)
    at F (9, N) scattered into an (n_rows + 1, 3) accumulator (last row:
    padding elements). conn_s: (4, N) scatter row ids."""
    Ft = tuple(F)
    U, s, V = soa.svd3_flip_soa(Ft)
    D = soa.corner_basis(g9)
    ge = soa.element_gradient_soa(mat, Ft, U, s, V, D, u, lam, w)
    vals = torch.stack([torch.stack(ge[c], dim=-1) for c in range(4)])
    acc = torch.zeros((n_rows + 1, 3), dtype=F.dtype, device=F.device)
    acc.index_add_(0, conn_s.reshape(-1), vals.reshape(-1, 3))
    return acc
