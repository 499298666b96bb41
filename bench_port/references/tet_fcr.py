"""Plain PyTorch reference of a tet scene under the fixed-corotated (FCR)
energy with backward-Euler time steps and a twist script: what each frame
of the program has to satisfy, written from the method's definitions
(Li et al., "Decomposed Optimization Time Integrator", SIGGRAPH 2019:
incremental potential, lumped mass, FCR, the reference's characteristic
tolerance and system energy). It imports nothing of the program.

A frame goes from (x_n, v_n) to x_{n+1}: the handle vertices (the two
x-extreme slabs of width handleRatio) move by the script (`twist`: they
turn about the bar's axis by -/+ 0.1 pi rad/s * dt about the box centre;
`stretch`: they move apart along x at 0.1 m/s each), and the free
vertices minimise

    E(x) = dt^2 sum_e vol_e Psi(F_e(x)) + 1/2 sum_v m_v |x_v - xt_v|^2,
    xt = x_n + dt v_n + dt^2 g,

with Psi = mu |F - R|^2 + lam / 2 (det F - 1)^2 (R: the rotation of F's
polar decomposition). `Scene.frame_numbers` judges a frame by what it
says: the free gradient at x_{n+1} in units of the reference's tolerance
(||g||^2 <= relTol^2 ||dP/dF(I)||^2 ||l||^2 (nFree / nV) dt^4) and
against the ||g||^2 the frame reports, the handles against the script,
and the reported system energy (elastic + kinetic + gravity) against its
own. `Scene.step` is a plain
L-BFGS time step: in a precision below the configuration's, it is the
control that the comparison has to fail.

Precisions: "f64" (the comparison), "f32", and "tf32": float32 whose
matrix products round their inputs to TF32 (10 mantissa bits, nearest
even) as the tensor cores do when float32 matmuls may use TF32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GRAVITY_Y = -9.80665
TWIST_RAD_PER_S = 0.1 * math.pi
STRETCH_M_PER_S = 0.1
LBFGS_M = 5


def round_tf32(t):
    """float32 -> the nearest TF32 value (ties to even), kept in float32."""
    i = t.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + 0x0FFF + lsb, -0x2000)
    return i.view(torch.float32)


class Precision:
    def __init__(self, name):
        if name not in ("f64", "f32", "tf32"):
            raise ValueError(f"precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32

    def mm(self, a, b):
        if self.name == "tf32":
            return torch.matmul(round_tf32(a), round_tf32(b))
        return torch.matmul(a, b)


def _cofactor(F):
    """cof(F) = det(F) F^{-T}, row by row from the columns' crosses."""
    c0, c1, c2 = F[..., :, 0], F[..., :, 1], F[..., :, 2]
    return torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0),
                        torch.linalg.cross(c0, c1)], dim=-1)


def _det(F):
    return torch.sum(F[..., :, 0] * torch.linalg.cross(F[..., :, 1],
                                                       F[..., :, 2]), dim=-1)


def polar_rotation(F, iters=12):
    """R of F = R S. Newton's iteration X <- (X + X^{-T}) / 2 for det F > 0
    (quadratic from the first step on these near-rotations); the SVD with
    the sign moved to the last singular vector pair where det F <= 0."""
    J = _det(F)
    X = F
    for _ in range(iters):
        X = 0.5 * (X + _cofactor(X) / _det(X)[..., None, None])
    bad = ~(J > 0)
    if bool(bad.any()):
        U, _, Vh = torch.linalg.svd(F[bad])
        s = torch.sign(_det(U @ Vh))
        U = torch.cat([U[..., :2], U[..., 2:] * s[..., None, None]], dim=-1)
        X = X.clone()
        X[bad] = U @ Vh
    return X


class Scene:
    """One configuration's scene on `device`, in precision `prec`."""

    def __init__(self, cfg, mesh, device, prec="f64"):
        """`mesh`: (V, TT) as the configuration's scene kind generates it
        (before the scene's size transform)."""
        sc = cfg["scene_script"]
        if sc["energy"] != "FCR" or sc["script"] not in ("twist", "stretch"):
            raise NotImplementedError("tet_fcr: FCR under the twist or "
                                      "stretch script")
        self.p = Precision(prec)
        dt_ = self.p.dtype
        V, TT = mesh
        V = np.asarray(V, np.float64)
        V = V * (sc["size"] / np.ptp(V, axis=0).max())
        V = V - V.min(axis=0)
        TT = np.asarray(TT, np.int64)
        self.n_vert, self.n_elem = V.shape[0], TT.shape[0]
        self.dt = float(sc["dt"])
        E, nu, rho = float(sc["youngs"]), float(sc["poisson"]), float(sc["density"])
        self.mu = E / (2.0 * (1.0 + nu))
        self.lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

        X0 = np.stack([V[TT[:, c]] - V[TT[:, 0]] for c in (1, 2, 3)], axis=-1)
        det = np.linalg.det(X0)
        mass = np.zeros(self.n_vert)
        np.add.at(mass, TT.reshape(-1), np.repeat(np.abs(det) / 24.0 * rho, 4))
        lo, hi = V[:, 0].min(), V[:, 0].max()
        r = float(sc.get("handle_ratio", 0.01)) * (hi - lo)
        ends = [np.flatnonzero(V[:, 0] < lo + r), np.flatnonzero(V[:, 0] > hi - r)]
        fixed = np.zeros(self.n_vert, bool)
        theta = np.zeros(self.n_vert)
        shift = np.zeros((self.n_vert, 3))
        for i, b in enumerate(ends):
            fixed[b] = True
            if sc["script"] == "twist":
                theta[b] = (-1.0) ** i * -TWIST_RAD_PER_S * self.dt
            else:
                shift[b, 0] = (-1.0) ** i * -STRETCH_M_PER_S * self.dt
        self.handles = np.flatnonzero(fixed)

        # the characteristic tolerance (Optimizer::computeCharNormSq)
        areas = np.zeros((self.n_elem, 4))
        for c, (i, j, k) in enumerate(((1, 2, 3), (0, 2, 3), (0, 1, 3),
                                       (0, 1, 2))):
            n = np.cross(V[TT[:, j]] - V[TT[:, i]], V[TT[:, k]] - V[TT[:, i]])
            areas[:, c] = 0.5 * np.linalg.norm(n, axis=-1)
        ls = np.zeros(self.n_vert)
        np.add.at(ls, TT.reshape(-1), areas.reshape(-1))
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
        self.vol = t(det / 6.0)
        self.mass = t(mass)
        self.free = t(~fixed, torch.bool)
        self.handles_t = t(self.handles, torch.int64)
        self.center = t(0.5 * (V.min(axis=0) + V.max(axis=0)))
        th = theta[self.handles]
        c, s = np.cos(th), np.sin(th)
        rot = np.zeros((len(th), 3, 3))
        rot[:, 0, 0] = 1.0
        rot[:, 1, 1], rot[:, 1, 2] = c, -s
        rot[:, 2, 1], rot[:, 2, 2] = s, c
        self.rot_t = t(np.swapaxes(rot, 1, 2))      # x_row @ R^T
        self.shift = t(shift[self.handles])
        self.g = t([0.0, GRAVITY_Y, 0.0])

    def _sqnorm_dpdf_rest(self):
        """||dP/dF||_F^2 at F = I (autograd, float64)."""
        def piola(f):
            F = f.reshape(3, 3)
            R = polar_rotation(F[None])[0]
            J = _det(F)
            return (2.0 * self.mu * (F - R)
                    + self.lam * (J - 1.0) * _cofactor(F)).reshape(9)
        jac = torch.autograd.functional.jacobian(
            piola, torch.eye(3, dtype=torch.float64).reshape(9))
        return float(torch.sum(jac * jac))

    # ---- element terms (batched over leading axes of x) ----------------
    def defgrad(self, x):
        xc = x[..., self.TT, :]                          # (..., nE, 4, 3)
        Ds = (xc[..., 1:, :] - xc[..., :1, :]).transpose(-1, -2)
        return self.p.mm(Ds, self.Dm_inv)

    def _psi_piola(self, F, want_piola=True):
        R = polar_rotation(F)
        J = _det(F)
        d = F - R
        psi = self.mu * torch.sum(d * d, dim=(-1, -2)) \
            + 0.5 * self.lam * (J - 1.0) ** 2
        if not want_piola:
            return psi, None
        P = 2.0 * self.mu * d + (self.lam * (J - 1.0))[..., None, None] \
            * _cofactor(F)
        return psi, P

    def elastic_energy(self, x):
        psi, _ = self._psi_piola(self.defgrad(x), want_piola=False)
        return torch.sum(psi * self.vol, dim=-1)

    def elastic_gradient(self, x):
        """d/dx sum_e vol_e Psi_e, (..., nV, 3)."""
        _, P = self._psi_piola(self.defgrad(x))
        H = self.p.mm(P * self.vol[..., None, None], self.Dm_inv.mT)
        cols = H.transpose(-1, -2)                       # (..., nE, 3, 3)
        per = torch.cat([-cols.sum(dim=-2, keepdim=True), cols], dim=-2)
        out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        return out.index_add_(-2, self.TT.reshape(-1),
                              per.reshape(per.shape[:-3] + (-1, 3)))

    def x_tilde(self, x_n, v_n):
        xt = x_n + self.dt * v_n + self.dt * self.dt * self.g
        return torch.where(self.free[:, None], xt, x_n)

    def gradient(self, x, xt):
        g = self.dt * self.dt * self.elastic_gradient(x) \
            + self.mass[:, None] * (x - xt)
        return torch.where(self.free[:, None], g, 0.0)

    def energy(self, x, xt):
        d = x - xt
        return self.dt * self.dt * self.elastic_energy(x) \
            + 0.5 * torch.sum(self.mass * torch.sum(d * d, dim=-1), dim=-1)

    def move_handles(self, x):
        """The handle rows of x after one frame of the script."""
        h = x[..., self.handles_t, :] - self.center
        return (self.p.mm(h[..., None, :], self.rot_t)[..., 0, :]
                + self.center + self.shift)

    def system_energy(self, x, x_n):
        """(sysE, its scale: the sum of the terms' magnitudes)."""
        el = self.elastic_energy(x)
        d = x - x_n
        kin = torch.sum(self.mass * 0.5 * torch.sum(d * d, dim=-1),
                        dim=-1) / (self.dt * self.dt)
        pot = -torch.sum(self.mass * self.p.mm(x, self.g[:, None])[..., 0],
                         dim=-1)
        pot_mag = torch.sum(self.mass * self.p.mm(x, self.g[:, None])[..., 0]
                            .abs(), dim=-1)
        return el + kin + pot, el.abs() + kin + pot_mag

    # ---- the comparison -----------------------------------------------
    def frame_numbers(self, x_n, v_n, x_next, sys_e, sqn_g):
        """Per frame (leading axis), in a dict: the free gradient at x_next
        squared over the tolerance (`grad_sq_over_tol`), the reported
        ||g||^2 against it (`grad_sq_rel_gap`), the largest handle distance
        from the script's (`handle_gap_m`), |sysE - reported| over the
        energy's scale (`sys_e_rel_gap`)."""
        xt = self.x_tilde(x_n, v_n)
        g = self.gradient(x_next, xt)
        gg = torch.sum(g * g, dim=(-1, -2))
        hd = x_next[..., self.handles_t, :] - self.move_handles(x_n)
        e, scale = self.system_energy(x_next, x_n)
        t = lambda a: torch.as_tensor(a, dtype=e.dtype, device=e.device)
        return {"grad_sq_over_tol": gg / self.target,
                "grad_sq_rel_gap": (t(sqn_g) - gg).abs() / gg,
                "handle_gap_m": torch.sqrt(torch.sum(hd * hd, dim=-1))
                .amax(dim=-1),
                "sys_e_rel_gap": (t(sys_e) - e).abs() / scale}

    # ---- a plain time step (the control) ------------------------------
    def jacobi(self):
        """1 / diag(M + dt^2 sum_e vol (2 mu + lam) D_e^T D_e) per vertex."""
        gn = torch.cat([-self.Dm_inv.sum(dim=-2, keepdim=True), self.Dm_inv],
                       dim=-2)                           # (nE, 4, 3)
        w = self.vol[:, None] * torch.sum(gn * gn, dim=-1) \
            * (2.0 * self.mu + self.lam) * self.dt * self.dt
        d = self.mass.clone().index_add_(0, self.TT.reshape(-1), w.reshape(-1))
        return 1.0 / d

    def step(self, x_n, v_n, max_iter=2000):
        """One frame by L-BFGS (m = 5, Jacobi H0, halving line search from
        1) until ||g||^2 <= tol, the line search finds no decrease (the
        precision's floor) or `max_iter`. Returns (x_next, v_next, sysE,
        ||g||^2 at x_next, iterations), each in this Scene's precision."""
        xt = self.x_tilde(x_n, v_n)
        x = xt.clone()
        x[self.handles_t] = self.move_handles(x_n)
        hinv = self.jacobi()[:, None]
        e = self.energy(x, xt)
        g = self.gradient(x, xt)
        S, Y = [], []
        it = 0
        while it < max_iter and float(torch.sum(g * g)) > self.target:
            q = -g
            al = []
            for s, y in zip(reversed(S), reversed(Y)):
                a = torch.sum(s * q) / torch.sum(y * s)
                q = q - a * y
                al.append(a)
            q = hinv * q
            for (s, y), a in zip(zip(S, Y), reversed(al)):
                q = q + (a - torch.sum(y * q) / torch.sum(y * s)) * s
            alpha = 1.0
            for _ in range(64):
                x_try = x + alpha * q
                e_try = self.energy(x_try, xt)
                if bool(e_try < e):
                    break
                alpha *= 0.5
            else:
                break
            g_new = self.gradient(x_try, xt)
            s, y = x_try - x, g_new - g
            if float(torch.sum(y * s)) > 0.0:
                S, Y = (S + [s])[-LBFGS_M:], (Y + [y])[-LBFGS_M:]
            it += 1
            x, e, g = x_try, e_try, g_new
        sys_e, _ = self.system_energy(x, x_n)
        return (x, (x - x_n) / self.dt, float(sys_e), float(torch.sum(g * g)),
                it)
