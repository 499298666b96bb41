"""Plain PyTorch reference of a 2D triangle scene under the fixed-corotated
(FCR) energy with backward-Euler time steps and the stretch script: what
each frame of the program has to satisfy, written from the method's
definitions (Li et al., "Decomposed Optimization Time Integrator",
SIGGRAPH 2019, in the reference code's DIM = 2 build: incremental
potential, lumped mass, FCR, the characteristic tolerance and the system
energy). It imports nothing of the program. `Scene` is
references/tet_fcr.py's with the element terms of a triangle: the
incremental potential, the comparison (`frame_numbers`) and the control's
L-BFGS step (`step`) are tet_fcr's, unchanged.

Positions are (nV, 3) with z = 0, as the program keeps them. A frame goes
from (x_n, v_n) to x_{n+1}: the handle vertices (the two boundary chains
the scene kind lists, left then right) move apart along x at 0.1 m/s
each, and the free vertices minimise

    E(x) = dt^2 sum_t A_t Psi(F_t(x)) + 1/2 sum_v m_v |x_v - xt_v|^2,
    xt = x_n + dt v_n + dt^2 g,

with the 2x2 deformation gradient F = Ds Dm^-1 of each triangle (its
rest area A_t), Psi = mu |F - R|^2 + lam / 2 (det F - 1)^2 and m_v the sum
of A_t rho / 3 over the vertex's triangles. The tolerance is relTol^2
||dP/dF(I)||^2 ||l||^2 (nFree / nV) dt^4 with l_v the sum of the lengths
of the edges opposite v (the 2D "face areas").

Departures from the published description, none of which changes what
a frame must satisfy:
- R is the rotation nearest to F, (cos t, sin t) along (F00 + F11,
  F10 - F01): the polar rotation where det F > 0 and, where it is not,
  the U V^T of the signed SVD that the reference's FCR takes.
- Gravity (0, -9.80665, 0) is on, as the reference applies it at
  DIM = 2 whatever the scene says.
- The z coordinate is carried: the inertia term and the kinetic energy
  count it, so a frame that moved a vertex out of the plane would show.
- The handles move by a shift, with no matrix product, so the TF32
  control moves them exactly.
- `Scene.step` (the control) is a plain L-BFGS step with a Jacobi H0,
  not the reference's solver.

Precisions as tet_fcr's: "f64" (the comparison), "f32", and "tf32".
TF32 is switched off for torch's own float32 products.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.references import tet_fcr

GRAVITY_Y = tet_fcr.GRAVITY_Y
STRETCH_M_PER_S = tet_fcr.STRETCH_M_PER_S


def _det(F):
    return F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]


def _cofactor(F):
    """det(F) F^-T."""
    return torch.stack([torch.stack([F[..., 1, 1], -F[..., 1, 0]], dim=-1),
                        torch.stack([-F[..., 0, 1], F[..., 0, 0]], dim=-1)],
                       dim=-2)


def rotation(F):
    """The rotation nearest to F (2x2)."""
    c = F[..., 0, 0] + F[..., 1, 1]
    s = F[..., 1, 0] - F[..., 0, 1]
    r = torch.sqrt(c * c + s * s)
    c, s = c / r, s / r
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


class Scene(tet_fcr.Scene):
    """One configuration's scene on `device`, in precision `prec`."""

    def __init__(self, cfg, mesh, device, prec="f64"):
        """`mesh`: (V (nV, 3), F (nE, 3), [left, right] handle vertex ids)
        as the configuration's scene kind generates it."""
        sc = cfg["scene_script"]
        if sc["energy"] != "FCR" or sc["script"] != "stretch":
            raise NotImplementedError("tri_fcr: FCR under the stretch script")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p = tet_fcr.Precision(prec)
        dt_ = self.p.dtype
        V, TT, ends = mesh
        V = np.asarray(V, np.float64)
        TT = np.array(TT, np.int64)
        self.n_vert, self.n_elem = V.shape[0], TT.shape[0]
        self.dt = float(sc["dt"])
        E, nu, rho = float(sc["youngs"]), float(sc["poisson"]), float(sc["density"])
        self.mu = E / (2.0 * (1.0 + nu))
        self.lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

        def rest(TT):
            return np.stack([V[TT[:, c], :2] - V[TT[:, 0], :2] for c in (1, 2)],
                            axis=-1)
        neg = np.linalg.det(rest(TT)) < 0
        TT[neg, 1], TT[neg, 2] = TT[neg, 2].copy(), TT[neg, 1].copy()
        X0 = rest(TT)
        area = np.linalg.det(X0) / 2.0
        mass = np.zeros(self.n_vert)
        np.add.at(mass, TT.reshape(-1), np.repeat(area * rho / 3.0, 3))
        fixed = np.zeros(self.n_vert, bool)
        shift = np.zeros((self.n_vert, 3))
        for i, b in enumerate(ends):
            b = np.asarray(b, np.int64)
            fixed[b] = True
            shift[b, 0] = (-1.0) ** i * -STRETCH_M_PER_S * self.dt
        self.handles = np.flatnonzero(fixed)

        # the characteristic tolerance (Optimizer::computeCharNormSq at
        # DIM = 2: the lengths of the edges opposite each vertex)
        ls = np.zeros(self.n_vert)
        for c, (i, j) in enumerate(((1, 2), (2, 0), (0, 1))):
            np.add.at(ls, TT[:, c], np.linalg.norm(
                V[TT[:, j], :2] - V[TT[:, i], :2], axis=-1))
        n_free = self.n_vert - int(fixed.sum())
        self.target = (float(sc["rel_tol"]) ** 2 * self._sqnorm_dpdf_rest()
                       * float(np.sum(ls * ls)) * (n_free / self.n_vert)
                       * self.dt ** 4)

        def t(a, dtype=dt_):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)
        self.x0 = t(V)
        self.TT = t(TT, torch.int64)
        self.Dm_inv = t(np.linalg.inv(X0))
        self.vol = t(area)             # tet_fcr's per-element weight
        self.mass = t(mass)
        self.free = t(~fixed, torch.bool)
        self.handles_t = t(self.handles, torch.int64)
        self.shift = t(shift[self.handles])
        self.g = t([0.0, GRAVITY_Y, 0.0])

    def _sqnorm_dpdf_rest(self):
        """||dP/dF||_F^2 at F = I (autograd, float64)."""
        def piola(f):
            F = f.reshape(2, 2)
            return (2.0 * self.mu * (F - rotation(F))
                    + self.lam * (_det(F) - 1.0) * _cofactor(F)).reshape(4)
        jac = torch.autograd.functional.jacobian(
            piola, torch.eye(2, dtype=torch.float64).reshape(4))
        return float(torch.sum(jac * jac))

    # ---- the element terms of a triangle -------------------------------
    def defgrad(self, x):
        xc = x[..., self.TT, :2]                         # (..., nE, 3, 2)
        Ds = (xc[..., 1:, :] - xc[..., :1, :]).transpose(-1, -2)
        return self.p.mm(Ds, self.Dm_inv)

    def _psi_piola(self, F, want_piola=True):
        d = F - rotation(F)
        J = _det(F)
        psi = self.mu * torch.sum(d * d, dim=(-1, -2)) \
            + 0.5 * self.lam * (J - 1.0) ** 2
        if not want_piola:
            return psi, None
        P = 2.0 * self.mu * d + (self.lam * (J - 1.0))[..., None, None] \
            * _cofactor(F)
        return psi, P

    def elastic_gradient(self, x):
        """d/dx sum_t A_t Psi_t, (..., nV, 3) with z = 0."""
        _, P = self._psi_piola(self.defgrad(x))
        H = self.p.mm(P * self.vol[..., None, None], self.Dm_inv.mT)
        cols = H.transpose(-1, -2)                       # (..., nE, 2, 2)
        per = torch.cat([-cols.sum(dim=-2, keepdim=True), cols], dim=-2)
        per = torch.cat([per, torch.zeros_like(per[..., :1])], dim=-1)
        out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        return out.index_add_(-2, self.TT.reshape(-1),
                              per.reshape(per.shape[:-3] + (-1, 3)))

    def move_handles(self, x):
        """The handle rows of x after one frame of the script."""
        return x[..., self.handles_t, :] + self.shift
