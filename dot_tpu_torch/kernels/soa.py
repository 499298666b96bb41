"""Structure-of-arrays element math in plain PyTorch: the reference
version of every per-element kernel of the port (dot_tpu/kernels/soa.py
rewritten op for op).

The CUDA kernels in csrc/elem.cu and the Triton kernel in triton_qf.py
compute the same functions one element per thread. The CPU tests hold this
module against dot_tpu.kernels.soa, and chip_smoke.py holds each kernel
against the fused references at the bottom of this file on the card. The
expressions keep dot_tpu's operation order, so that a kernel built without
FMA contraction rounds as this module does.

Conventions (as in dot_tpu):
  mat3 : tuple of 9 (N,) tensors, row-major (m00, m01, ..., m22)
  sym3 : tuple of 6 (N,) tensors (a00, a01, a02, a11, a12, a22)
  vec3 : tuple of 3 (N,) tensors
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# tuple-matrix helpers
# ---------------------------------------------------------------------------


def mm(a, b):
    """mat3 @ mat3."""
    return tuple(
        a[3 * i + 0] * b[0 + j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j]
        for i in range(3) for j in range(3))


def mmT(a, b):
    """mat3 @ mat3^T."""
    return tuple(
        a[3 * i] * b[3 * j] + a[3 * i + 1] * b[3 * j + 1] + a[3 * i + 2] * b[3 * j + 2]
        for i in range(3) for j in range(3))


def mTm_sym(a):
    """a^T a as sym3."""
    c = [(a[j], a[3 + j], a[6 + j]) for j in range(3)]

    def dot(x, y):
        return x[0] * y[0] + x[1] * y[1] + x[2] * y[2]
    return (dot(c[0], c[0]), dot(c[0], c[1]), dot(c[0], c[2]),
            dot(c[1], c[1]), dot(c[1], c[2]), dot(c[2], c[2]))


def det3(m):
    return (m[0] * (m[4] * m[8] - m[5] * m[7])
            - m[1] * (m[3] * m[8] - m[5] * m[6])
            + m[2] * (m[3] * m[7] - m[4] * m[6]))


def cofactor_soa(f):
    """Cofactor matrix (dJ/dF), columns = cross products of F's columns."""
    c0 = (f[0], f[3], f[6])
    c1 = (f[1], f[4], f[7])
    c2 = (f[2], f[5], f[8])

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])
    k0, k1, k2 = cross(c1, c2), cross(c2, c0), cross(c0, c1)
    return (k0[0], k1[0], k2[0],
            k0[1], k1[1], k2[1],
            k0[2], k1[2], k2[2])


# ---------------------------------------------------------------------------
# symmetric 3x3 Jacobi eigendecomposition (branch-free)
# ---------------------------------------------------------------------------

SWEEPS = {torch.float32: 4, torch.float64: 10}


def _eps(dtype):
    return torch.finfo(dtype).eps


def _givens(app, aqq, apq, eps):
    small = torch.abs(apq) <= eps * torch.sqrt(torch.abs(app * aqq) + eps)
    tau = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, 1.0, t)
    c = torch.rsqrt(1.0 + t * t)
    s = t * c
    return torch.where(small, 1.0, c), torch.where(small, 0.0, s)


def _rotcols(V, p, q, c, s):
    """V <- V J, J the (p, q) Givens rotation."""
    V = list(V)
    for i in range(3):
        vp, vq = V[3 * i + p], V[3 * i + q]
        V[3 * i + p] = c * vp - s * vq
        V[3 * i + q] = s * vp + c * vq
    return tuple(V)


def jacobi_eigh_soa(a, sweeps=None):
    """sym3 -> (evals vec3 (unsorted), eigvecs mat3 with det +1)."""
    a00, a01, a02, a11, a12, a22 = a
    if sweeps is None:
        sweeps = SWEEPS[a00.dtype]
    eps = _eps(a00.dtype)
    one = torch.ones_like(a00)
    zero = torch.zeros_like(a00)
    V = (one, zero, zero, zero, one, zero, zero, zero, one)
    for _ in range(sweeps):
        # pair (0, 1)
        c, s = _givens(a00, a11, a01, eps)
        n00 = c * c * a00 - 2 * s * c * a01 + s * s * a11
        n11 = s * s * a00 + 2 * s * c * a01 + c * c * a11
        n01 = (c * c - s * s) * a01 + c * s * (a00 - a11)
        n02 = c * a02 - s * a12
        n12 = s * a02 + c * a12
        a00, a01, a02, a11, a12 = n00, n01, n02, n11, n12
        V = _rotcols(V, 0, 1, c, s)
        # pair (0, 2)
        c, s = _givens(a00, a22, a02, eps)
        n00 = c * c * a00 - 2 * s * c * a02 + s * s * a22
        n22 = s * s * a00 + 2 * s * c * a02 + c * c * a22
        n02 = (c * c - s * s) * a02 + c * s * (a00 - a22)
        n01 = c * a01 - s * a12
        n12 = s * a01 + c * a12
        a00, a01, a02, a12, a22 = n00, n01, n02, n12, n22
        V = _rotcols(V, 0, 2, c, s)
        # pair (1, 2)
        c, s = _givens(a11, a22, a12, eps)
        n11 = c * c * a11 - 2 * s * c * a12 + s * s * a22
        n22 = s * s * a11 + 2 * s * c * a12 + c * c * a22
        n12 = (c * c - s * s) * a12 + c * s * (a11 - a22)
        n01 = c * a01 - s * a02
        n02 = s * a01 + c * a02
        a01, a02, a11, a12, a22 = n01, n02, n11, n12, n22
        V = _rotcols(V, 1, 2, c, s)
    return (a00, a11, a22), V


def _sort3_desc_soa(w, V):
    """Sort eigenvalues descending, permuting V columns."""
    w = list(w)
    V = list(V)

    def cswap(p, q):
        do = w[p] < w[q]
        w[p], w[q] = torch.where(do, w[q], w[p]), torch.where(do, w[p], w[q])
        for i in range(3):
            vp, vq = V[3 * i + p], V[3 * i + q]
            V[3 * i + p] = torch.where(do, vq, vp)
            V[3 * i + q] = torch.where(do, vp, vq)

    cswap(0, 1)
    cswap(0, 2)
    cswap(1, 2)
    return tuple(w), tuple(V)


# ---------------------------------------------------------------------------
# flip-SVD
# ---------------------------------------------------------------------------


def svd3_flip_soa(f, sweeps=None):
    """mat3 F -> (U mat3, sigma vec3, V mat3), flip convention:
    det(U)=det(V)=+1, s0 >= s1 >= |s2|, sign(s2) = sign(det F)."""
    eps = _eps(f[0].dtype)
    amax = f[0]
    for k in range(1, 9):
        amax = torch.maximum(amax, torch.abs(f[k]))
    amax = torch.maximum(amax, torch.abs(f[0]))
    scale = torch.where(amax > 0, amax, 1.0)
    fn = tuple(x / scale for x in f)

    a = mTm_sym(fn)
    w, V = jacobi_eigh_soa(a, sweeps)
    w, V = _sort3_desc_soa(w, V)

    sgn = torch.sign(det3(V))
    V = list(V)
    for i in range(3):
        V[3 * i + 2] = V[3 * i + 2] * sgn
    V = tuple(V)

    B = mm(fn, V)  # columns b_i = sigma_i u_i
    b0 = (B[0], B[3], B[6])
    b1 = (B[1], B[4], B[7])
    b2 = (B[2], B[5], B[8])
    tol = 16.0 * eps

    n0 = torch.sqrt(b0[0] * b0[0] + b0[1] * b0[1] + b0[2] * b0[2])
    inv0 = 1.0 / torch.clamp(n0, min=tol)
    ok0 = n0 > tol
    u0 = tuple(torch.where(ok0, b0[d] * inv0, 1.0 if d == 0 else 0.0)
               for d in range(3))

    d01 = u0[0] * b1[0] + u0[1] * b1[1] + u0[2] * b1[2]
    b1o = tuple(b1[d] - d01 * u0[d] for d in range(3))
    n1 = torch.sqrt(b1o[0] ** 2 + b1o[1] ** 2 + b1o[2] ** 2)
    ok1 = n1 > tol * torch.clamp(n0, min=1.0)
    inv1 = 1.0 / torch.clamp(n1, min=tol)
    # fallback: unit vector orthogonal to u0 — cross with the axis least
    # aligned with u0
    au = [torch.abs(u0[0]), torch.abs(u0[1]), torch.abs(u0[2])]
    m01 = au[0] < au[1]
    m = torch.where(m01, torch.where(au[0] < au[2], 0, 2),
                    torch.where(au[1] < au[2], 1, 2))
    e = tuple((m == d).to(u0[0].dtype) for d in range(3))
    fb = (u0[1] * e[2] - u0[2] * e[1],
          u0[2] * e[0] - u0[0] * e[2],
          u0[0] * e[1] - u0[1] * e[0])
    nf = torch.sqrt(fb[0] ** 2 + fb[1] ** 2 + fb[2] ** 2)
    invf = 1.0 / torch.clamp(nf, min=tol)
    u1 = tuple(torch.where(ok1, b1o[d] * inv1, fb[d] * invf) for d in range(3))

    u2 = (u0[1] * u1[2] - u0[2] * u1[1],
          u0[2] * u1[0] - u0[0] * u1[2],
          u0[0] * u1[1] - u0[1] * u1[0])

    U = (u0[0], u1[0], u2[0],
         u0[1], u1[1], u2[1],
         u0[2], u1[2], u2[2])
    s0 = n0 * scale
    s1 = (u1[0] * b1[0] + u1[1] * b1[1] + u1[2] * b1[2]) * scale
    s2 = (u2[0] * b2[0] + u2[1] * b2[1] + u2[2] * b2[2]) * scale
    return U, (s0, s1, s2), V


def make_pd3_soa(a):
    """SPD projection of sym3 by eigenvalue clamping; returns sym3."""
    w, Q = jacobi_eigh_soa(a)
    w = tuple(torch.clamp(x, min=0.0) for x in w)
    out = []
    for i in range(3):
        for j in range(i, 3):
            out.append(w[0] * Q[3 * i] * Q[3 * j]
                       + w[1] * Q[3 * i + 1] * Q[3 * j + 1]
                       + w[2] * Q[3 * i + 2] * Q[3 * j + 2])
    return tuple(out)  # (00, 01, 02, 11, 12, 22)


# ---------------------------------------------------------------------------
# materials: diagonal-space primitives + first Piola-Kirchhoff
# ---------------------------------------------------------------------------


class FCR_SOA:
    """Fixed Co-Rotational (reference: FixedCoRotEnergy.cpp:82-183)."""
    code = 0

    @staticmethod
    def psi(s, u, lam):
        s0, s1, s2 = s
        sq = (s0 - 1) * (s0 - 1) + (s1 - 1) * (s1 - 1) + (s2 - 1) * (s2 - 1)
        jm1 = s0 * s1 * s2 - 1.0
        return u * sq + 0.5 * lam * jm1 * jm1

    @staticmethod
    def dpsi(s, u, lam):
        s0, s1, s2 = s
        t = lam * (s0 * s1 * s2 - 1.0)
        return (2 * u * (s0 - 1) + s1 * s2 * t,
                2 * u * (s1 - 1) + s2 * s0 * t,
                2 * u * (s2 - 1) + s0 * s1 * t)

    @staticmethod
    def d2psi(s, u, lam):
        s0, s1, s2 = s
        sp0, sp1, sp2 = s1 * s2, s2 * s0, s0 * s1
        pm1 = s0 * s1 * s2 - 1.0
        return (2 * u + lam * sp0 * sp0,
                lam * (s2 * pm1 + sp0 * sp1),
                lam * (s1 * pm1 + sp0 * sp2),
                2 * u + lam * sp1 * sp1,
                lam * (s0 * pm1 + sp2 * sp1),
                2 * u + lam * sp2 * sp2)

    @staticmethod
    def b_left(s, u, lam):
        s0, s1, s2 = s
        pm1 = s0 * s1 * s2 - 1.0
        hl = 0.5 * lam
        return (u - hl * s2 * pm1, u - hl * s0 * pm1, u - hl * s1 * pm1)

    @staticmethod
    def first_piola(f, U, s, V, u, lam):
        R = mmT(U, V)
        jm1 = s[0] * s[1] * s[2] - 1.0
        cof = cofactor_soa(f)
        t = lam * jm1
        return tuple(2 * u * (f[k] - R[k]) + t * cof[k] for k in range(9))


class SNH_SOA:
    """Stable Neo-Hookean, no-log variant
    (reference: StableNHEnergy.cpp:79-251)."""
    code = 1

    @staticmethod
    def psi(s, u, lam):
        s0, s1, s2 = s
        jma = s0 * s1 * s2 - (1.0 + u / lam)
        return 0.5 * (u * (s0 * s0 + s1 * s1 + s2 * s2 - 3.0) + lam * jma * jma)

    @staticmethod
    def dpsi(s, u, lam):
        s0, s1, s2 = s
        t = lam * (s0 * s1 * s2 - (1.0 + u / lam))
        return (u * s0 + s1 * s2 * t, u * s1 + s2 * s0 * t, u * s2 + s0 * s1 * t)

    @staticmethod
    def d2psi(s, u, lam):
        s0, s1, s2 = s
        sp0, sp1, sp2 = s1 * s2, s2 * s0, s0 * s1
        l2 = lam * (2.0 * s0 * s1 * s2 - (1.0 + u / lam))
        return (u + lam * sp0 * sp0, s2 * l2, s1 * l2,
                u + lam * sp1 * sp1, s0 * l2,
                u + lam * sp2 * sp2)

    @staticmethod
    def b_left(s, u, lam):
        s0, s1, s2 = s
        t = lam * (s0 * s1 * s2 - (1.0 + u / lam))
        return (0.5 * (u - t * s2), 0.5 * (u - t * s0), 0.5 * (u - t * s1))

    @staticmethod
    def first_piola(f, U, s, V, u, lam):
        jma = s[0] * s[1] * s[2] - (1.0 + u / lam)
        cof = cofactor_soa(f)
        t = lam * jma
        return tuple(u * f[k] + t * cof[k] for k in range(9))


class SNHWL_SOA:
    """Stable Neo-Hookean, regularized-log variant (the reference's
    SNH_WITHLOG build, StableNHEnergy.cpp): Psi = u/2 (S - 3 - log(S+1)) +
    lam/2 (J - alpha)^2, S = ||sigma||^2, alpha = 1 + 3u/(4 lam)."""
    code = 2

    @staticmethod
    def _parts(s, u, lam):
        s0, s1, s2 = s
        s_sq1 = s0 * s0 + s1 * s1 + s2 * s2 + 1.0
        t1 = u * (1.0 - 1.0 / s_sq1)
        jma = s0 * s1 * s2 - (1.0 + 0.75 * u / lam)
        return s_sq1, t1, jma

    @staticmethod
    def psi(s, u, lam):
        s_sq1, _, jma = SNHWL_SOA._parts(s, u, lam)
        return 0.5 * (u * (s_sq1 - 4.0 - torch.log(s_sq1)) + lam * jma * jma)

    @staticmethod
    def dpsi(s, u, lam):
        s0, s1, s2 = s
        _, t1, jma = SNHWL_SOA._parts(s, u, lam)
        t0 = lam * jma
        return (s0 * t1 + s1 * s2 * t0,
                s1 * t1 + s2 * s0 * t0,
                s2 * t1 + s0 * s1 * t0)

    @staticmethod
    def d2psi(s, u, lam):
        s0, s1, s2 = s
        s_sq1, t1, jma = SNHWL_SOA._parts(s, u, lam)
        cv = 2.0 * u / (s_sq1 * s_sq1)
        sp0, sp1, sp2 = s1 * s2, s2 * s0, s0 * s1
        l2 = lam * (s0 * s1 * s2 + jma)      # lam (2J - alpha)
        return (t1 + cv * s0 * s0 + lam * sp0 * sp0,
                cv * s0 * s1 + s2 * l2,
                cv * s0 * s2 + s1 * l2,
                t1 + cv * s1 * s1 + lam * sp1 * sp1,
                cv * s1 * s2 + s0 * l2,
                t1 + cv * s2 * s2 + lam * sp2 * sp2)

    @staticmethod
    def b_left(s, u, lam):
        s0, s1, s2 = s
        _, t1, jma = SNHWL_SOA._parts(s, u, lam)
        t0 = lam * jma
        return (0.5 * (t1 - t0 * s2), 0.5 * (t1 - t0 * s0),
                0.5 * (t1 - t0 * s1))

    @staticmethod
    def first_piola(f, U, s, V, u, lam):
        _, t1, jma = SNHWL_SOA._parts(s, u, lam)
        cof = cofactor_soa(f)
        t0 = lam * jma
        return tuple(t1 * f[k] + t0 * cof[k] for k in range(9))


SOA_MATERIALS = {"FCR": FCR_SOA, "SNH": SNH_SOA, "SNHWL": SNHWL_SOA}


# ---------------------------------------------------------------------------
# element kernels
# ---------------------------------------------------------------------------

_SUM_SIGMA_EPS = 1.0e-6  # reference: Energy.cpp:1112-1117


def defgrad_soa(xT, conn, g):
    """xT: 3 (nV,) coordinate vectors; conn: 4 (N,) corner index vectors;
    g: mat3 tuple of restTriInv. Returns F mat3 with F = Xt @ G, Xt
    columns = x_k - x_0."""
    xc = [[xT[d][conn[c]] for d in range(3)] for c in range(4)]
    e = [[xc[k + 1][d] - xc[0][d] for d in range(3)] for k in range(3)]
    return tuple(
        e[0][i] * g[3 * 0 + j] + e[1][i] * g[3 * 1 + j] + e[2][i] * g[3 * 2 + j]
        for i in range(3) for j in range(3))


def element_gradient_soa(mat, f, U, s, V, D, u, lam, w):
    """D: [4][3] of (N,) tensors. Returns g[c][d] list[4][3] of (N,)."""
    P = mat.first_piola(f, U, s, V, u, lam)
    Pw = tuple(p * w for p in P)
    return [[D[c][0] * Pw[3 * d + 0] + D[c][1] * Pw[3 * d + 1]
             + D[c][2] * Pw[3 * d + 2] for d in range(3)]
            for c in range(4)]


def element_hessian_soa(mat, U, s, V, D, u, lam, w, project_spd=True):
    """Returns H as a list of 144 (N,) tensors, dof order (corner, xyz),
    row-major: H[(c*3+i)*12 + e*3+k]. Rank-1 eigen form of the reference's
    diagonal-space construction (see dot_tpu.kernels.soa)."""
    a6 = mat.d2psi(s, u, lam)
    alpha, Q = jacobi_eigh_soa(a6)
    dpsi = mat.dpsi(s, u, lam)
    bl = mat.b_left(s, u, lam)

    def right(ci, cj):
        ssum = s[ci] + s[cj]
        denom = torch.where(ssum < _SUM_SIGMA_EPS, _SUM_SIGMA_EPS, ssum)
        return (dpsi[ci] + dpsi[cj]) / (2.0 * denom)

    rights = (right(0, 1), right(1, 2), right(2, 0))
    L = list(bl)
    R = list(rights)
    if project_spd:
        alpha = tuple(torch.clamp(x, min=0.0) for x in alpha)
        L = [torch.clamp(x, min=0.0) for x in L]
        R = [torch.clamp(x, min=0.0) for x in R]

    # DV[c][b] = sum_j D[c][j] V[j][b]
    DV = [[D[c][0] * V[b] + D[c][1] * V[3 + b] + D[c][2] * V[6 + b]
           for b in range(3)] for c in range(4)]

    # A-part vectors: y_a[(c,i)] = sum_d Q[d][a] U[i][d] DV[c][d]
    ys = []
    for a in range(3):
        ys.append([Q[a] * U[3 * i] * DV[c][0]
                   + Q[3 + a] * U[3 * i + 1] * DV[c][1]
                   + Q[6 + a] * U[3 * i + 2] * DV[c][2]
                   for c in range(4) for i in range(3)])

    # twist/flip vectors for pair (x, y): Wx[(c,i)] = U[i][x] DV[c][y],
    # Wy[(c,i)] = U[i][y] DV[c][x]
    ps, qs = [], []
    for (x, y) in ((0, 1), (1, 2), (2, 0)):
        pv, qv = [], []
        for c in range(4):
            for i in range(3):
                wx = U[3 * i + x] * DV[c][y]
                wy = U[3 * i + y] * DV[c][x]
                pv.append(wx + wy)
                qv.append(wx - wy)
        ps.append(pv)
        qs.append(qv)

    coeffs = list(alpha) + L + R
    vecs = ys + ps + qs

    H = [None] * 144
    for r in range(12):
        for c in range(r, 12):
            acc = coeffs[0] * vecs[0][r] * vecs[0][c]
            for t in range(1, 9):
                acc = acc + coeffs[t] * vecs[t][r] * vecs[t][c]
            acc = acc * w
            H[r * 12 + c] = acc
            if c != r:
                H[c * 12 + r] = acc
    return H


def block_major_order():
    """Element-Hessian storage order: component (a*4+b)*9 + i*3+j holds
    H[(a,i),(b,j)], so each corner-pair 3x3 block is 9 contiguous rows."""
    return [(a * 3 + i) * 12 + b * 3 + j
            for a in range(4) for b in range(4)
            for i in range(3) for j in range(3)]


def corner_basis(g9):
    """Per-corner basis D[c][j] from restTriInv (9, N): D_0 = -sum of the
    rows of restTriInv, D_{k+1} = its row k."""
    rti = g9.reshape(3, 3, -1)
    return torch.cat([-(rti[0] + rti[1] + rti[2])[None], rti], dim=0)


# ---------------------------------------------------------------------------
# fused references of the four kernels (same inputs and layouts as the
# wrappers in ops.py)
# ---------------------------------------------------------------------------


def ls_trial_energy_ref(F0, Fp, alpha, u, lam, w, mat, want_sigma=False):
    """sum_e w Psi(sigma(F0 + alpha Fp)) in F0's dtype; Fp may be None
    (then F = F0). F0, Fp: (9, N); alpha: 0-d tensor. Returns
    (sum, sigma (3, N) or None)."""
    F = F0 if Fp is None else F0 + alpha * Fp
    _, s, _ = svd3_flip_soa(tuple(F))
    e = torch.sum(mat.psi(s, u, lam) * w)
    return e, (torch.stack(s) if want_sigma else None)


def elem_gradient_ref(x, conn, conn_s, g9, u, lam, w, mat):
    """Per-element elastic gradient blocks D (w P) scattered to an
    (nV+1, 3) accumulator (last row = dump row of padding elements).
    x: (nV, 3); conn / conn_s: (4, N) gather / scatter vertex ids."""
    F = defgrad_soa(tuple(x.T), tuple(conn), tuple(g9))
    U, s, V = svd3_flip_soa(F)
    D = corner_basis(g9)
    ge = element_gradient_soa(mat, F, U, s, V, D, u, lam, w)
    vals = torch.stack([torch.stack(ge[c], dim=-1) for c in range(4)])
    acc = torch.zeros((x.shape[0] + 1, 3), dtype=x.dtype, device=x.device)
    acc.index_add_(0, conn_s.reshape(-1), vals.reshape(-1, 3))
    return acc


def elem_hessian_ref(x, conn, g9, u, lam, w, mat, dt_sq):
    """(144, N) SPD-projected element Hessians at x, block-major, times
    dt_sq."""
    F = defgrad_soa(tuple(x.T), tuple(conn), tuple(g9))
    U, s, V = svd3_flip_soa(F)
    D = corner_basis(g9)
    H = element_hessian_soa(mat, U, s, V, D, u, lam, w, project_spd=True)
    return torch.stack([H[r] for r in block_major_order()]) \
        * torch.tensor(dt_sq, dtype=x.dtype)


def direction_pass_ref(p, conn, g9, elem_h=None):
    """F(p) (9, N) from one corner gather of p, and, given the block-major
    (144, N) element Hessians, sum_e p_e^T H_e p_e (else None)."""
    pe = [p[conn[c]] for c in range(4)]                  # 4 x (N, 3)
    e = [[pe[k + 1][:, i] - pe[0][:, i] for i in range(3)] for k in range(3)]
    F = torch.stack([e[0][i] * g9[j] + e[1][i] * g9[3 + j] + e[2][i] * g9[6 + j]
                     for i in range(3) for j in range(3)])
    if elem_h is None:
        return F, None
    pe_arr = torch.stack([pe[c][:, i] for c in range(4) for i in range(3)])
    rows = [a * 3 + i for a in range(4) for b in range(4)
            for i in range(3) for j in range(3)]
    cols = [b * 3 + j for a in range(4) for b in range(4)
            for i in range(3) for j in range(3)]
    q = torch.sum(elem_h * pe_arr[rows] * pe_arr[cols])
    return F, q
