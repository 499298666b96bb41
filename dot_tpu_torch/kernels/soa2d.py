"""2D (triangle-element) structure-of-arrays element math in plain PyTorch:
the reference version of every 2D kernel of the port
(dot_tpu/kernels/soa2d.py rewritten op for op, plus the scatter, mass and
mask steps of dot_tpu/dim2.py's System2D.gradient and System2D.factorize
that the kernels fuse).

The CUDA kernels K21-K24 in csrc/elem2d.cu compute the same functions (one
element, vertex or matrix slot per thread) with the device functions of
csrc/elem2d.cuh. The CPU tests hold this module against
dot_tpu.kernels.soa2d, and chip_smoke.py holds each kernel against the
fused references at the bottom of this file on the card. The expressions
keep dot_tpu's operation order, so that a kernel built without FMA
contraction differs from this module only where atan2 / sin / cos / sqrt
of the device library round differently from torch's.

Conventions (as in dot_tpu): a 2x2 matrix is a 4-tuple (m00, m01, m10, m11)
of (N,) tensors; sigma = (s0, s1) with s0 >= |s1| and s1 negative under
inversion (flip-SVD: det U = det V = +1); a packed sym2 is (h00, h01, h11).
The fused references take stacked component rows: F (4, N), restTriInv
(4, N), corner ids (3, N) int32, the 6x6 element Hessian (36, N) row-major
over (corner, xy) dofs, positions (nV, 3) with z = 0.

U and V are not unique where F is a scaled rotation (R = 0: atan2(0, 0)
decides the angles) or s0 = s1, and eigh2's Q is not at b = 0, a = c:
compare sigma, U diag(sigma) V^T, Psi, P, H and make_pd2's result between
two implementations, never U, V or Q alone.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_SUM_SIGMA_EPS = 1.0e-6  # reference: Energy.cpp:1112-1117 (dim-2 analog)


# ---------------------------------------------------------------------------
# 2x2 linear algebra
# ---------------------------------------------------------------------------
def cofactor2_soa(f):
    """dJ/dF for J = det F: (f11, -f10, -f01, f00)."""
    f00, f01, f10, f11 = f
    return (f11, -f10, -f01, f00)


def mmT2(a, b):
    """A @ B^T for mat2 tuples."""
    a00, a01, a10, a11 = a
    b00, b01, b10, b11 = b
    return (a00 * b00 + a01 * b01, a00 * b10 + a01 * b11,
            a10 * b00 + a11 * b01, a10 * b10 + a11 * b11)


def svd2_flip_soa(f):
    """Closed-form 2x2 flip-SVD (reference: the 2x2 path of
    AutoFlipSVD.hpp): F = U diag(s0, s1) V^T with U, V proper rotations,
    det F = s0 s1, s0 >= |s1|. With E = (f00 + f11) / 2, Fm = (f00 - f11) / 2,
    G = (f10 + f01) / 2, H = (f10 - f01) / 2: s0 = Q + R, s1 = Q - R
    (Q = |(E, H)|, R = |(Fm, G)|), U = Rot((a2 + a1) / 2),
    V = Rot((a1 - a2) / 2) for a1 = atan2(G, Fm), a2 = atan2(H, E)."""
    f00, f01, f10, f11 = f
    E = 0.5 * (f00 + f11)
    Fm = 0.5 * (f00 - f11)
    G = 0.5 * (f10 + f01)
    H = 0.5 * (f10 - f01)
    Q = torch.sqrt(E * E + H * H)
    R = torch.sqrt(Fm * Fm + G * G)
    s0 = Q + R
    s1 = Q - R
    a1 = torch.atan2(G, Fm)
    a2 = torch.atan2(H, E)
    gam = 0.5 * (a2 + a1)    # U angle
    bet = 0.5 * (a2 - a1)    # V^T angle -> V = Rot(-bet)
    cu, su = torch.cos(gam), torch.sin(gam)
    cv, sv = torch.cos(bet), torch.sin(bet)
    U = (cu, -su, su, cu)
    V = (cv, sv, -sv, cv)
    return U, (s0, s1), V


def eigh2_soa(a, b, c):
    """Symmetric 2x2 [[a, b], [b, c]]: ((lam0, lam1), Q) with lam0 >= lam1
    and Q's columns the eigenvectors."""
    mean = 0.5 * (a + c)
    half = 0.5 * (a - c)
    r = torch.sqrt(half * half + b * b)
    th = 0.5 * torch.atan2(2.0 * b, a - c)
    ct, st = torch.cos(th), torch.sin(th)
    return (mean + r, mean - r), (ct, -st, st, ct)


def make_pd2_soa(h3):
    """SPD projection of a packed sym2 (h00, h01, h11) by eigenvalue
    clamping (reference: makePD2d, IglUtils.hpp:276-308)."""
    (l0, l1), Q = eigh2_soa(*h3)
    l0 = torch.clamp(l0, min=0.0)
    l1 = torch.clamp(l1, min=0.0)
    q00, q01, q10, q11 = Q
    return (l0 * q00 * q00 + l1 * q01 * q01,
            l0 * q00 * q10 + l1 * q01 * q11,
            l0 * q10 * q10 + l1 * q11 * q11)


# ---------------------------------------------------------------------------
# sigma-space materials (dim-2 branches of the reference energies)
# ---------------------------------------------------------------------------
class FCR2D:
    """Fixed Co-Rotational, dim 2: Psi = u ||sigma - 1||^2 +
    lam/2 (J - 1)^2, J = s0 s1."""
    name = "FCR"
    code = 0

    @staticmethod
    def psi(s, u, lam):
        s0, s1 = s
        jm1 = s0 * s1 - 1.0
        return u * ((s0 - 1.0) ** 2 + (s1 - 1.0) ** 2) + 0.5 * lam * jm1 * jm1

    @staticmethod
    def dpsi(s, u, lam):
        s0, s1 = s
        t = lam * (s0 * s1 - 1.0)
        return (2.0 * u * (s0 - 1.0) + s1 * t,
                2.0 * u * (s1 - 1.0) + s0 * t)

    @staticmethod
    def d2psi(s, u, lam):
        s0, s1 = s
        return (2.0 * u + lam * s1 * s1,
                lam * (2.0 * s0 * s1 - 1.0),
                2.0 * u + lam * s0 * s0)

    @staticmethod
    def b_left(s, u, lam):
        s0, s1 = s
        return u - 0.5 * lam * (s0 * s1 - 1.0)

    @staticmethod
    def first_piola(f, U, s, V, u, lam):
        R = mmT2(U, V)
        t = lam * (s[0] * s[1] - 1.0)
        cof = cofactor2_soa(f)
        return tuple(2.0 * u * (f[k] - R[k]) + t * cof[k] for k in range(4))


class SNH2D:
    """Stable Neo-Hookean (no-log), dim 2: Psi = u/2 (||sigma||^2 - 2) +
    lam/2 (J - alpha)^2, alpha = 1 + u/lam."""
    name = "SNH"
    code = 1

    @staticmethod
    def psi(s, u, lam):
        s0, s1 = s
        jma = s0 * s1 - (1.0 + u / lam)
        return 0.5 * (u * (s0 * s0 + s1 * s1 - 2.0) + lam * jma * jma)

    @staticmethod
    def dpsi(s, u, lam):
        s0, s1 = s
        t = lam * (s0 * s1 - (1.0 + u / lam))
        return (u * s0 + s1 * t, u * s1 + s0 * t)

    @staticmethod
    def d2psi(s, u, lam):
        s0, s1 = s
        return (u + lam * s1 * s1,
                lam * (2.0 * s0 * s1 - (1.0 + u / lam)),
                u + lam * s0 * s0)

    @staticmethod
    def b_left(s, u, lam):
        s0, s1 = s
        return 0.5 * (u - lam * (s0 * s1 - (1.0 + u / lam)))

    @staticmethod
    def first_piola(f, U, s, V, u, lam):
        t = lam * (s[0] * s[1] - (1.0 + u / lam))
        cof = cofactor2_soa(f)
        return tuple(u * f[k] + t * cof[k] for k in range(4))


class SNHWL2D:
    """Stable Neo-Hookean, regularized-log variant, dim 2: Psi =
    u/2 (S - 2 - log(S + 1)) + lam/2 (J - alpha)^2, S = ||sigma||^2,
    alpha = 1 + 3u/(4 lam)."""
    name = "SNHWL"
    code = 2

    @staticmethod
    def _parts(s, u, lam):
        s0, s1 = s
        s_sq1 = s0 * s0 + s1 * s1 + 1.0
        t1 = u * (1.0 - 1.0 / s_sq1)
        jma = s0 * s1 - (1.0 + 0.75 * u / lam)
        return s_sq1, t1, jma

    @staticmethod
    def psi(s, u, lam):
        s_sq1, _, jma = SNHWL2D._parts(s, u, lam)
        return 0.5 * (u * (s_sq1 - 3.0 - torch.log(s_sq1)) + lam * jma * jma)

    @staticmethod
    def dpsi(s, u, lam):
        s0, s1 = s
        _, t1, jma = SNHWL2D._parts(s, u, lam)
        t0 = lam * jma
        return (s0 * t1 + s1 * t0, s1 * t1 + s0 * t0)

    @staticmethod
    def d2psi(s, u, lam):
        s0, s1 = s
        s_sq1, t1, jma = SNHWL2D._parts(s, u, lam)
        cv = 2.0 * u / (s_sq1 * s_sq1)
        return (t1 + cv * s0 * s0 + lam * s1 * s1,
                cv * s0 * s1 + lam * (s0 * s1 + jma),
                t1 + cv * s1 * s1 + lam * s0 * s0)

    @staticmethod
    def b_left(s, u, lam):
        _, t1, jma = SNHWL2D._parts(s, u, lam)
        return 0.5 * (t1 - lam * jma)

    @staticmethod
    def first_piola(f, U, s, V, u, lam):
        _, t1, jma = SNHWL2D._parts(s, u, lam)
        cof = cofactor2_soa(f)
        t0 = lam * jma
        return tuple(t1 * f[k] + t0 * cof[k] for k in range(4))


SOA2D_MATERIALS = {"FCR": FCR2D, "SNH": SNH2D, "SNHWL": SNHWL2D}


# ---------------------------------------------------------------------------
# element kernels
# ---------------------------------------------------------------------------
def defgrad2_soa(xT, conn, g):
    """xT: 2 (nV,) coordinate vectors; conn: 3 (N,) corner index vectors; g:
    mat2 tuple of restTriInv. F = Xt @ G with Xt's columns x_k - x_0
    (reference: Energy.cpp:396-415 at dim 2)."""
    xc = [[xT[d][conn[c]] for d in range(2)] for c in range(3)]
    e = [[xc[k + 1][d] - xc[0][d] for d in range(2)] for k in range(2)]
    return tuple(
        e[0][i] * g[2 * 0 + j] + e[1][i] * g[2 * 1 + j]
        for i in range(2) for j in range(2))


def element_gradient2_soa(mat, f, U, s, V, D, u, lam, w):
    """D: [3][2] of (N,). Returns g[c][d], [3][2] of (N,)."""
    P = mat.first_piola(f, U, s, V, u, lam)
    Pw = tuple(p * w for p in P)
    return [[D[c][0] * Pw[2 * d + 0] + D[c][1] * Pw[2 * d + 1]
             for d in range(2)] for c in range(3)]


def element_hessian2_soa(mat, U, s, V, D, u, lam, w, project_spd=True):
    """6x6 element Hessian as a list of 36 (N,) tensors, dof order
    (corner, xy), row-major H[(c*2+i)*6 + e*2+k]: the rank-1 eigen-sum
    H = sum_a alpha_a y_a y_a^T + L p p^T + R q q^T of the 3D kernel
    (reference construction: Energy.cpp:1129-1271 at dim 2 with makePD2d),
    (alpha, Q) the clamped eigenpairs of d2Psi/dsigma2, p = Wx + Wy,
    q = Wx - Wy the one twist / flip pair,
    L / R = BLeftCoef, (dPsi_0 + dPsi_1) / (2 (s0 + s1)), clamped."""
    h00, h01, h11 = mat.d2psi(s, u, lam)
    alpha, Q = eigh2_soa(h00, h01, h11)
    dpsi = mat.dpsi(s, u, lam)
    bl = mat.b_left(s, u, lam)

    ssum = s[0] + s[1]
    denom = torch.where(ssum < _SUM_SIGMA_EPS, _SUM_SIGMA_EPS, ssum)
    br = (dpsi[0] + dpsi[1]) / (2.0 * denom)

    L, R = bl, br
    if project_spd:
        alpha = tuple(torch.clamp(x, min=0.0) for x in alpha)
        L = torch.clamp(L, min=0.0)
        R = torch.clamp(R, min=0.0)

    # DV[c][b] = sum_j D[c][j] V[j][b]
    DV = [[D[c][0] * V[b] + D[c][1] * V[2 + b] for b in range(2)]
          for c in range(3)]

    # A-part vectors y_a[(c,i)] = sum_d Q[d][a] U[i][d] DV[c][d]
    ys = [[Q[a] * U[2 * i] * DV[c][0] + Q[2 + a] * U[2 * i + 1] * DV[c][1]
           for c in range(3) for i in range(2)] for a in range(2)]

    # twist / flip pair over (0, 1)
    pv, qv = [], []
    for c in range(3):
        for i in range(2):
            wx = U[2 * i + 0] * DV[c][1]
            wy = U[2 * i + 1] * DV[c][0]
            pv.append(wx + wy)
            qv.append(wx - wy)

    coeffs = [alpha[0], alpha[1], L, R]
    vecs = [ys[0], ys[1], pv, qv]

    H = [None] * 36
    for r in range(6):
        for c in range(r, 6):
            acc = coeffs[0] * vecs[0][r] * vecs[0][c]
            for t in range(1, 4):
                acc = acc + coeffs[t] * vecs[t][r] * vecs[t][c]
            acc = acc * w
            H[r * 6 + c] = acc
            if c != r:
                H[c * 6 + r] = acc
    return H


def corner_basis2(g4):
    """Per-corner basis D[c][j] from restTriInv (4, N): D_0 = -(row 0 +
    row 1), D_{k+1} = row k; returned (3, 2, N)."""
    rti = g4.reshape(2, 2, -1)
    return torch.cat([-(rti[0] + rti[1])[None], rti], dim=0)


# ---------------------------------------------------------------------------
# host-side tables of the scatters
# ---------------------------------------------------------------------------
class Scatter2DPlan(NamedTuple):
    """Static index tensors of the 2D gradient scatter and dense Hessian
    assembly (one per System2D, built on the host once)."""
    n_vert: int
    gdest: torch.Tensor      # (6 N,) int64 dof 2 v + i of value e*6 + c*2+i
    inc_perm: torch.Tensor   # (3 N,) int64 incidences e*3 + c sorted by vertex
    inc_off: torch.Tensor    # (nV + 1,) int64 CSR offsets of `inc_perm`
    hdest: torch.Tensor      # (36 N,) int64 slot row * n2 + col of value
                             #   e*36 + k (dot_tpu's _hdest)
    items: torch.Tensor      # (36 N,) int64 values e*36 + k sorted by slot
                             #   (stable: each run in element order)
    seg_off: torch.Tensor    # (nSlot + 1,) int64 CSR offsets of `items`
    udest: torch.Tensor      # (nSlot,) int64 the runs' slots, ascending


def scatter2d_plan(conn, n_vert, device):
    """Scatter2DPlan from the (N, 3) triangle connectivity (numpy). Slots
    are 64-bit: (2 nV)^2 passes 2^31 at nV > 23,170. Every dof's diagonal
    slot must occur (a vertex in no triangle has no equation)."""
    conn = np.asarray(conn, np.int64)
    n2 = 2 * n_vert
    dof = np.stack([2 * conn[:, c] + i for c in range(3) for i in range(2)],
                   axis=1)                                   # (N, 6)
    rows = np.repeat(dof, 6, axis=1)                         # (N, 36)
    cols = np.tile(dof, (1, 6))
    hdest = (rows * n2 + cols).reshape(-1)
    order = np.argsort(hdest, kind="stable")
    udest, first = np.unique(hdest[order], return_index=True)
    seg_off = np.concatenate([first, [order.size]]).astype(np.int64)
    diag = np.arange(n2, dtype=np.int64) * (n2 + 1)
    if not np.isin(diag, udest).all():
        raise ValueError("2D mesh has a vertex that belongs to no triangle")
    flat = conn.reshape(-1)
    inc_perm = np.argsort(flat, kind="stable")
    inc_off = np.searchsorted(flat[inc_perm], np.arange(n_vert + 1))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                               device=device)
    return Scatter2DPlan(n_vert=int(n_vert), gdest=t(dof.reshape(-1)),
                         inc_perm=t(inc_perm), inc_off=t(inc_off),
                         hdest=t(hdest), items=t(order), seg_off=t(seg_off),
                         udest=t(udest))


# ---------------------------------------------------------------------------
# fused references of the 2D kernels (same inputs and layouts as the
# wrappers in ops.py)
# ---------------------------------------------------------------------------
def defgrad2d_ref(x, conn, g4):
    """(4, N) deformation gradients of the in-plane coordinates of x
    (nV, >= 2); conn (3, N) int32; g4 (4, N) restTriInv."""
    return torch.stack(defgrad2_soa((x[:, 0], x[:, 1]), tuple(conn.long()),
                                    tuple(g4)))


def ls_trial_energy2d_ref(F0, Fp, alpha, u, lam, w, mat, want_sigma=False):
    """K21 plain: sum_e w Psi(sigma(F0 + alpha Fp)) in F0's dtype; Fp may be
    None (then F = F0). F0, Fp: (4, N); alpha: 0-d tensor. Returns
    (sum, sigma (2, N) or None)."""
    F = F0 if Fp is None else F0 + alpha * Fp
    _, s, _ = svd2_flip_soa(tuple(F))
    e = torch.sum(mat.psi(s, u, lam) * w)
    return e, (torch.stack(s) if want_sigma else None)


def elem_gradient2d_ref(x, x_tilta, free, mass, conn, g4, u, lam, w, mat,
                        dt_sq, plan):
    """K22 plain: the (nV, 3) gradient of the incremental potential:
    per-corner forces D (w P) at x summed per vertex, times dt_sq, plus
    mass (x - x_tilta); z = 0; zero where free (nV,) is 0."""
    f = tuple(defgrad2d_ref(x, conn, g4))
    U, s, V = svd2_flip_soa(f)
    ge = element_gradient2_soa(mat, f, U, s, V, corner_basis2(g4), u, lam, w)
    vals = torch.stack([ge[c][i] for c in range(3) for i in range(2)],
                       dim=1).reshape(-1)
    nv = x.shape[0]
    acc = torch.zeros(2 * nv, dtype=x.dtype, device=x.device)
    acc.index_add_(0, plan.gdest, vals)
    g2 = acc.reshape(nv, 2) * torch.tensor(dt_sq, dtype=x.dtype)
    g = torch.cat([g2, torch.zeros((nv, 1), dtype=x.dtype, device=x.device)],
                  dim=1)
    g = g + mass[:, None] * (x - x_tilta)
    g[:, 2] = 0.0
    return torch.where(free[:, None] != 0, g, 0.0)


def elem_hessian2d_ref(x, conn, g4, u, lam, w, mat, dt_sq, project_spd=True):
    """K23 plain: (36, N) SPD-projected 6x6 element Hessians at x,
    row-major, times dt_sq."""
    f = tuple(defgrad2d_ref(x, conn, g4))
    U, s, V = svd2_flip_soa(f)
    H = element_hessian2_soa(mat, U, s, V, corner_basis2(g4), u, lam, w,
                             project_spd)
    return torch.stack(H) * torch.tensor(dt_sq, dtype=x.dtype)


def dense_assemble2d_ref(H36, free, mass, plan):
    """K24 plain: (H (2 nV, 2 nV), d (2 nV,)): the element Hessians
    scatter-added by slot, + the lumped mass on the diagonal, rows and
    columns of fixed dofs zeroed, a unit diagonal there; d = sqrt(diag H).
    H36: (36, N); free, mass: (nV,)."""
    n2 = 2 * plan.n_vert
    vals = H36.t().reshape(-1)                       # value e*36 + k
    H = torch.zeros(n2 * n2, dtype=H36.dtype, device=H36.device)
    H = H.index_add_(0, plan.hdest, vals).reshape(n2, n2)
    H.diagonal().add_(torch.repeat_interleave(mass, 2))
    free2 = torch.repeat_interleave(free, 2)
    H = H * free2[:, None] * free2[None, :]
    H.diagonal().add_(1.0 - free2)
    return H, torch.sqrt(H.diagonal())


def dense_scale2d_ref(H, d, plan):
    """K24's second entry, plain: H / d_i / d_j as a new tensor (the kernel
    scales the assembled slots of H in place: every other entry is 0)."""
    dinv = 1.0 / d
    return H * dinv[:, None] * dinv[None, :]


# the device functions' checks, plain: the same outputs as the check
# entries of csrc/elem2d.cu
def svd2_flip_ref(F):
    """(U (4, N), sigma (2, N), V (4, N)) of F (4, N)."""
    U, s, V = svd2_flip_soa(tuple(F))
    return torch.stack(U), torch.stack(s), torch.stack(V)


def eigh2_ref(h3):
    """(lam (2, N), Q (4, N)) of packed sym2 matrices h3 (3, N)."""
    lam, Q = eigh2_soa(*h3)
    return torch.stack(lam), torch.stack(Q)


def make_pd2_ref(h3):
    """(3, N) SPD projections of packed sym2 matrices h3 (3, N)."""
    return torch.stack(make_pd2_soa(tuple(h3)))


def material2d_ref(F, u, lam, mat):
    """(11, N): Psi, dPsi (2), d2Psi (3), BLeftCoef and the first Piola
    stress (4) at the flip-SVD of F (4, N)."""
    f = tuple(F)
    U, s, V = svd2_flip_soa(f)
    return torch.stack([mat.psi(s, u, lam), *mat.dpsi(s, u, lam),
                        *mat.d2psi(s, u, lam), mat.b_left(s, u, lam),
                        *mat.first_piola(f, U, s, V, u, lam)])
