"""Device-side system assembly for the DOT stepper, in PyTorch (port of
dot_tpu/steppers/core.py).

`System` holds the static buffers of one mesh + subdomain plan as tensors
on an explicit device and offers the functions the DOT stepper composes:
incremental-potential energy, gradient, element Hessians, subdomain
assembly (dense or RCM-banded block-tridiagonal), the Jacobi-equilibrated
Cholesky factorization and the H0 apply (solve + duplicate averaging).

The per-element passes go through the hand-written kernels of
kernels/ops.py (K1-K4); `use_kernels=False` swaps in their plain PyTorch
versions on any device, for comparison runs. Assembly, factorization and
solves are plain torch in this port (queue 2 of ROADMAP.md).

Precision: fields and reductions in `dtype` (as dot_tpu); the system
energy diagnostic in float64. The banded factorization is the exact scan
in `dtype`: dot_tpu's f32 runs take block cyclic reduction with bf16 SYRK
and bf16 factor storage there (core.py:187-195, 947-951), which this port
does not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops, soa

# Reference constants (dot_tpu/steppers/core.py:112-117)
GRAVITY_Y = -9.80665           # Optimizer.cpp:109
LBFGS_HISTORY = 5              # DOTTimeStepper.cpp:45
INNER_ITER_CAP = 10000         # Optimizer.cpp:662
LINE_SEARCH_CAP = 64           # reference halves literally to fp zero
REL_EDEC_STOP = 1.0e-3         # Optimizer.cpp:856-862 (allowEDecRelTol)
STATS_CAP = INNER_ITER_CAP + 16  # iterStats rows kept per step


class BTDFactor(NamedTuple):
    """Block-tridiagonal Cholesky factor of the RCM-banded subdomain
    matrices: per-block INVERTED diagonal factors and the sub-diagonal
    coupling blocks (scan-major)."""
    linv: torch.Tensor   # (nb, P, bs, bs) L_kk^{-1}
    sub: torch.Tensor    # (nb-1, P, bs, bs) L_{k+1,k}


@dataclasses.dataclass
class SimState:
    """Dynamic simulation state (dot_tpu.steppers.core.SimState without
    the coarse factor)."""
    x: torch.Tensor           # (nV, 3) positions
    x_n: torch.Tensor         # (nV, 3) previous step positions
    v: torch.Tensor           # (nV, 3) velocities
    x_tilta: torch.Tensor     # (nV, 3) inertia predictor
    dx_elastic: torch.Tensor  # (nV, 3)
    fixed: torch.Tensor       # (nV,) bool
    vel_sign: torch.Tensor    # () script turning sign
    released: torch.Tensor    # () bool rubberBandPull release happened
    elem_h: torch.Tensor      # (144, nEp) frozen element Hessians
    chol: object              # (P, n3, n3) tensor or BTDFactor
    equil: torch.Tensor       # (P, n3) equilibration sqrt-diagonals
    lb_s: torch.Tensor        # (m, nV, 3) L-BFGS s history (oldest..newest)
    lb_t: torch.Tensor        # (m, nV, 3) L-BFGS t history
    lb_rho: torch.Tensor      # (m,) t.s
    lb_valid: torch.Tensor    # (m,) 0/1


@dataclasses.dataclass
class StepStats:
    """Host-side result of one time step."""
    energy: float       # final incremental potential
    sqn_g: float        # final ||g||^2
    inner_iters: int
    ls_halvings: int
    stop: str           # "tol", "rel_dec", "ls_failed" or "iter_cap"
    rows: list          # per-iteration (alpha, E, ||g||^2), row 0 = start
    syncs: int          # device -> host reads this step took


class System:
    def __init__(self, mesh, cfg, plan, dtype=torch.float32, device="cpu",
                 use_kernels=True):
        if plan is None:
            raise NotImplementedError(
                "the port runs the partitioned DOT stepper only (a plan is "
                "required); see ROADMAP.md queue 1")
        self.mesh = mesh
        self.cfg = cfg
        self.plan = plan
        self.dtype = dtype
        self.device = torch.device(device)
        self.use_kernels = use_kernels
        self.k = ops if use_kernels else ops.plain
        self.mat = soa.SOA_MATERIALS[cfg.energy]
        self.dt = float(cfg.dt)
        self.dt_sq = self.dt * self.dt
        self.n_vert = mesh.n_vert
        self.n_parts = plan.n_parts
        self.n3 = plan.n3
        self.n_syncs = 0
        p = plan

        cw = int(getattr(cfg, "coarse", -1))
        if p.part is not None and (cw == 1 or (cw == -1 and p.n_parts >= 16)):
            raise NotImplementedError(
                "the two-level coarse space (P >= 16 or 'coarse 1') is not "
                "ported yet; see ROADMAP.md queue 1")

        def t(a, dt=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=self.device)

        # ---- padded, reordered element arrays -------------------------
        src, valid = p.elem_src, p.elem_valid
        conn = mesh.conn[src].astype(np.int32)
        conn_gather = np.where(valid[:, None], conn, 0)
        conn_scatter = np.where(valid[:, None], conn, mesh.n_vert)
        rti = mesh.rest_tri_inv[src] * valid[:, None, None]
        self.n_elem_p = conn.shape[0]
        # (4, nEp) int32 corner ids: the kernels' layout
        self.conn = t(conn_gather.T, torch.int32)
        self.conn_s = t(conn_scatter.T, torch.int32)
        self.vol_w = t((mesh.tri_weight * mesh.vol)[src] * valid, dtype)
        self.u_e = t(mesh.u[src], dtype)
        self.lam_e = t(mesh.lam[src], dtype)
        self.g9 = t(rti.reshape(-1, 9).T, dtype)   # restTriInv (9, nEp)

        # ---- global fields --------------------------------------------
        self.mass = t(mesh.mass, dtype)
        grav = np.zeros(3)
        if cfg.with_gravity:
            grav[1] = GRAVITY_Y
        self.gravity = t(grav, dtype)
        self.grav_dt_sq = t(grav * self.dt_sq, dtype)

        # ---- subdomain plan buffers ------------------------------------
        self.band_bs = int(getattr(p, "band_bs", 0) or 0)
        self.band_nb = int(getattr(p, "band_nb", 0) or 0)
        self.banded = self.band_nb >= 3
        if self.banded:
            self.band_dest = t(p.band_dest, torch.int64)
            self.band_ub_row = t(p.band_ub_row, torch.int64)
            self.band_ub_col = t(p.band_ub_col, torch.int64)
            self.band_diag_ub = t(p.band_diag_ub, torch.int64)
            self.band_pad_diag = t(p.band_pad_diag, torch.int64)
        self.l2g = t(p.local_to_global, torch.int64)
        self.local_valid = t(p.local_valid)
        self.mass_img = t(mesh.mass[p.local_to_global] * p.local_valid, dtype)
        self.dup = t(np.maximum(p.dup, 1), dtype)
        # block-level assembly plan: contiguous 9-wide rows of the
        # block-major element-Hessian buffer in dest-sorted tuple order
        src_block = (p.asm_elem.astype(np.int64) * 16 + p.asm_a * 4 + p.asm_b)
        self.asm_src_block = t(src_block[p.asm_tuple_perm], torch.int64)
        self.asm_block_stage1 = t(p.asm_block_stage1, torch.int64)
        self.asm_ub_dest = t(p.asm_ub_dest, torch.int64)
        self.n_unique_blocks = int(p.asm_ub_dest.shape[0]) // 9
        self.gath_perm = t(p.gath_perm, torch.int64)
        self.gath_segids = t(p.gath_segids, torch.int64)

        # characteristic tolerance pieces (Optimizer.cpp:612-651)
        self._sqnorm_H_rest = self._compute_sqnorm_h_rest()
        self._sqnorm_l = self.mesh.sqnorm_face_area_sums

    # ------------------------------------------------------------------
    def host(self, *vals):
        """One device -> host read of 0-d tensors (counted in n_syncs)."""
        self.n_syncs += 1
        return torch.stack([v.reshape(()).to(torch.float64)
                            for v in vals]).tolist()

    def scalar(self, v):
        return torch.tensor(v, dtype=self.dtype, device=self.device)

    def _compute_sqnorm_h_rest(self):
        """||dP/dF(I)||_F^2 with the first element's Lame params, no SPD
        projection (at F = I the rotated-basis M is dP/dF)."""
        one = torch.ones(1, dtype=torch.float64)
        u0 = torch.tensor([self.mesh.u[0]], dtype=torch.float64)
        l0 = torch.tensor([self.mesh.lam[0]], dtype=torch.float64)
        s1 = (one, one, one)
        a = self.mat.d2psi(s1, u0, l0)
        dpsi = self.mat.dpsi(s1, u0, l0)
        bl = self.mat.b_left(s1, u0, l0)
        # ||M||_F^2 = ||A||_F^2 + sum_k 2 (L+R)^2 + 2 (L-R)^2
        tot = (a[0] ** 2 + 2 * a[1] ** 2 + 2 * a[2] ** 2 + a[3] ** 2
               + 2 * a[4] ** 2 + a[5] ** 2)
        for k, (ci, cj) in enumerate(((0, 1), (1, 2), (2, 0))):
            r = (dpsi[ci] + dpsi[cj]) / (2.0 * (s1[ci] + s1[cj]))
            tot = tot + 2 * (bl[k] + r) ** 2 + 2 * (bl[k] - r) ** 2
        return float(tot[0])

    def target_g_res(self, rel_tol):
        """targetGRes = eps^2 ||H_rest||^2 ||l||^2 (nFree/nV) dt^4
        (reference: computeCharNormSq; energyParamSum == 1)."""
        n_free = self.n_vert - int(np.count_nonzero(self.mesh.fixed_mask))
        return (rel_tol * rel_tol * self._sqnorm_H_rest * self._sqnorm_l
                * (n_free / self.n_vert) * self.dt_sq * self.dt_sq)

    # ------------------------------------------------------------------
    # energy / gradient / hessian (kernels K1-K4)
    # ------------------------------------------------------------------
    def defgrad(self, x):
        """(9, nEp) deformation gradients at positions (or directions) x."""
        F, _ = self.k.direction_pass(x, self.conn, self.g9)
        return F

    def elastic_energy(self, F0, Fp=None, alpha=None):
        """dt^2 sum w Psi(sigma(F0 + alpha Fp)) (the line-search trial)."""
        e, _ = self.k.ls_trial_energy(F0, Fp, alpha, self.u_e, self.lam_e,
                                      self.vol_w, self.mat)
        return self.dt_sq * e

    def sigma(self, F):
        """(3, nEp) signed singular values of F."""
        _, s = self.k.ls_trial_energy(F, None, None, self.u_e, self.lam_e,
                                      self.vol_w, self.mat, want_sigma=True)
        return s

    def energy(self, x, x_tilta, F):
        """Incremental potential: dt^2 sum w Psi + 1/2 ||x - xt||_M^2
        (reference: Optimizer::computeEnergyVal, Optimizer.cpp:1183-1218)."""
        d = x - x_tilta
        e_in = 0.5 * torch.sum(self.mass * torch.sum(d * d, dim=-1))
        return self.elastic_energy(F) + e_in

    def inertia_quad(self, x0, p, x_tilta):
        """(c0, c1, c2) with  1/2||x0 + a p - xt||_M^2 = c0 + a c1 + a^2 c2."""
        d0 = x0 - x_tilta
        c0 = 0.5 * torch.sum(self.mass * torch.sum(d0 * d0, dim=-1))
        c1 = torch.sum(self.mass * torch.sum(d0 * p, dim=-1))
        c2 = 0.5 * torch.sum(self.mass * torch.sum(p * p, dim=-1))
        return c0, c1, c2

    def gradient(self, x, x_tilta, fixed):
        """(nV, 3), zero at fixed vertices (Optimizer.cpp:1220-1256)."""
        acc = self.k.elem_gradient(x, self.conn, self.conn_s, self.g9,
                                   self.u_e, self.lam_e, self.vol_w, self.mat)
        g = acc[:self.n_vert] * self.dt_sq
        g = g + self.mass[:, None] * (x - x_tilta)
        return torch.where(fixed[:, None], 0.0, g)

    def element_hessians(self, x):
        """(144, nEp) SPD-projected element Hessians at x, dt^2-scaled,
        block-major component order (soa.block_major_order)."""
        return self.k.elem_hessian(x, self.conn, self.g9, self.u_e,
                                   self.lam_e, self.vol_w, self.mat,
                                   self.dt_sq)

    def quadratic_form(self, elem_h, p):
        """(p^T H_tr p including the mass diagonal, F(p)) from one corner
        gather of p (alpha-init, Optimizer.cpp:1075-1093)."""
        Fp, q_el = self.k.direction_pass(p, self.conn, self.g9, elem_h)
        q_m = torch.sum(self.mass[:, None] * p * p)
        return q_el + q_m, Fp

    def system_energy(self, x, x_n, sigma):
        """Diagnostic total energy in float64: elastic + kinetic +
        potential (reference: computeSystemEnergy, Optimizer.cpp:1310-1328)."""
        f64 = torch.float64
        psi_w = self.mat.psi(tuple(sigma), self.u_e, self.lam_e) * self.vol_w
        e = torch.sum(psi_w.to(f64))
        d = (x - x_n).to(f64)
        e = e + torch.sum(self.mass.to(f64)
                          * (0.5 * torch.sum(d * d, dim=-1) / self.dt_sq
                             - (x.to(f64) @ self.gravity.to(f64))))
        return e

    # ------------------------------------------------------------------
    # subdomain assembly
    # ------------------------------------------------------------------
    def _assembly_compact(self, elem_h):
        """Gather 9-wide block rows in dest order and reduce duplicate
        (sbd, row, col) blocks with one sorted segment-sum."""
        eh_rows = elem_h.t().reshape(-1, 9)          # (nEp*16, 9)
        rows = eh_rows[self.asm_src_block]           # (nAsm, 9)
        out = torch.zeros((self.n_unique_blocks, 9), dtype=self.dtype,
                          device=self.device)
        return out.index_add_(0, self.asm_block_stage1, rows)

    def _free(self, fixed):
        return torch.logical_and(self.local_valid,
                                 torch.logical_not(fixed[self.l2g]))

    def assemble_subdomains(self, elem_h, fixed):
        """Subdomain Hessians with interface completion, lumped mass on
        free dofs, identity rows for fixed/padding (reference:
        DOTTimeStepper::fillInDecomposedHessians). Dense (P, n3, n3), or
        block-tridiagonal (diag, sub) when the plan is RCM-banded."""
        if self.banded:
            return self._assemble_btd(elem_h, fixed)
        P, n3 = self.n_parts, self.n3
        compact = self._assembly_compact(elem_h)
        Hd = torch.zeros(P * n3 * n3, dtype=self.dtype, device=self.device)
        Hd[self.asm_ub_dest] = compact.reshape(-1)
        Hd = Hd.reshape(P, n3, n3)
        f3 = torch.repeat_interleave(self._free(fixed).to(self.dtype), 3,
                                     dim=-1)                     # (P, n3)
        Hd = Hd * f3[:, :, None] * f3[:, None, :]
        diag = torch.repeat_interleave(self.mass_img, 3, dim=-1) * f3 \
            + (1.0 - f3)
        Hd.diagonal(dim1=1, dim2=2).add_(diag)
        return Hd

    def _band_compact(self, elem_h, fixed):
        """Compact unique-block values for the banded scatter: stage-1
        reduction + fixed-dof masking + lumped mass / identity diagonals."""
        compact = self._assembly_compact(elem_h)       # (nUB, 9)
        freef = self._free(fixed).to(self.dtype).reshape(-1)
        mask = freef[self.band_ub_row] * freef[self.band_ub_col]
        compact = compact * mask[:, None]
        dslot = self.band_ub_row[self.band_diag_ub]
        dvals = (self.mass_img.reshape(-1) * freef + (1.0 - freef))[dslot]
        cols = torch.tensor([0, 4, 8], device=self.device)
        compact.index_put_((self.band_diag_ub[:, None], cols[None, :]),
                           dvals[:, None].expand(-1, 3), accumulate=True)
        return compact

    def _assemble_btd(self, elem_h, fixed):
        """Block-tridiagonal assembly into the flat [diag | sub] buffer;
        upper-neighbor entries go to a dump slot past the end (their
        transpose lives in `sub`); padding rows get a unit diagonal."""
        P, bs, nb = self.n_parts, self.band_bs, self.band_nb
        compact = self._band_compact(elem_h, fixed)
        diag_sz = P * nb * bs * bs
        total = diag_sz + P * (nb - 1) * bs * bs
        flat = torch.zeros(total + 1, dtype=self.dtype, device=self.device)
        flat[self.band_dest] = compact.reshape(-1)
        flat[self.band_pad_diag] = 1.0
        diag = flat[:diag_sz].view(nb, P, bs, bs)
        sub = flat[diag_sz:total].view(nb - 1, P, bs, bs)
        return diag, sub

    # ------------------------------------------------------------------
    # factorization (Cholesky with the NaN -> shifted fallback tiers)
    # ------------------------------------------------------------------
    def factorize(self, Hd, fast=False):
        """Jacobi-equilibrated batched Cholesky. Returns (L, d); L is a
        BTDFactor for banded input.

        `fast` marks the quasi-Newton preconditioner: a factorization that
        fails (a non-SPD block: cholesky_ex's info != 0, or NaN) is
        retried with a 1e-4 shift of the unit diagonal, as dot_tpu's
        factorize_fast tiers do (core.py:963-980, 1181-1202); the exact
        tier is already the first attempt here (no bf16 SYRK). Without
        `fast` a failed factor comes back as NaN, as jnp's Cholesky does."""
        if isinstance(Hd, tuple):
            return self._factorize_btd(*Hd, fast=fast)
        d = torch.sqrt(Hd.diagonal(dim1=1, dim2=2))
        dinv = 1.0 / d
        Hn = Hd * dinv[:, :, None] * dinv[:, None, :]
        L, info = torch.linalg.cholesky_ex(Hn)
        bad = info != 0
        if fast:
            if self.host(torch.logical_or(bad.any(), torch.isnan(L).any()))[0]:
                eye = torch.eye(self.n3, dtype=self.dtype, device=self.device)
                L, info = torch.linalg.cholesky_ex(Hn + 1.0e-4 * eye)
                bad = info != 0
        return torch.where(bad[:, None, None], torch.nan, L), d

    def _factorize_btd(self, diag, sub, fast):
        """Block-tridiagonal Cholesky with Jacobi equilibration, as a loop
        over the block index:
          L_kk L_kk^T = D_k - S_{k-1} S_{k-1}^T,  S_k = A_{k+1,k} L_kk^{-T};
        each diagonal factor is inverted, so the solves are matmuls."""
        nb, P, bs = diag.shape[0], diag.shape[1], diag.shape[2]
        d = torch.sqrt(diag.diagonal(dim1=-2, dim2=-1))   # (nb, P, bs)
        dinv = 1.0 / d
        eye = torch.eye(bs, dtype=self.dtype, device=self.device)

        def factor(shift):
            linv = torch.empty_like(diag)
            subs = torch.empty_like(sub)
            bad = torch.zeros(P, dtype=torch.bool, device=self.device)
            Dk = diag[0] * dinv[0][:, :, None] * dinv[0][:, None, :] \
                + shift * eye
            for k in range(nb):
                Lk, info = torch.linalg.cholesky_ex(Dk)
                bad |= info != 0
                linv[k] = torch.linalg.solve_triangular(
                    Lk, eye.expand(P, bs, bs), upper=False)
                if k == nb - 1:
                    break
                Sk = sub[k] * dinv[k + 1][:, :, None] * dinv[k][:, None, :]
                Ls = torch.linalg.solve_triangular(Lk.mT, Sk, upper=True,
                                                   left=False)
                subs[k] = Ls
                Dk = (diag[k + 1] * dinv[k + 1][:, :, None]
                      * dinv[k + 1][:, None, :] + shift * eye) - Ls @ Ls.mT
            nan = torch.isnan(linv).any(-1).any(-1).any(0)
            if nb > 1:
                nan |= torch.isnan(subs).any(-1).any(-1).any(0)
            return BTDFactor(linv, subs), bad | nan

        fac, bad = factor(0.0)
        if fast and self.host(bad.any())[0]:
            fac, bad = factor(1.0e-4)
        if not fast:
            fac = BTDFactor(torch.where(bad[None, :, None, None], torch.nan,
                                        fac.linv), fac.sub)
        return fac, d.transpose(0, 1).reshape(P, nb * bs)

    # ------------------------------------------------------------------
    # solves and the H0 apply
    # ------------------------------------------------------------------
    def solve_local(self, L, r):
        """Solve the factored subdomain systems against equilibrated
        right-hand sides r (P, n3) -> (P, n3)."""
        if isinstance(L, BTDFactor):
            return self._btd_solve(L, r)
        y = torch.linalg.solve_triangular(L, r[..., None], upper=False)
        z = torch.linalg.solve_triangular(L.mT, y, upper=True)
        return z[..., 0]

    def _btd_solve(self, fac, r):
        """Forward/backward block substitution with the pre-inverted
        diagonal factors:  y_k = Linv_k (r_k - S_{k-1} y_{k-1}),
                           z_k = Linv_k^T (y_k - S_k^T z_{k+1})."""
        nb, P, bs = fac.linv.shape[0], fac.linv.shape[1], fac.linv.shape[2]
        rT = r.reshape(P, nb, bs, 1).transpose(0, 1)     # (nb, P, bs, 1)
        ys = []
        y = None
        for k in range(nb):
            rk = rT[k] if y is None else rT[k] - fac.sub[k - 1] @ y
            y = fac.linv[k] @ rk
            ys.append(y)
        zs = [None] * nb
        z = None
        for k in reversed(range(nb)):
            yk = ys[k] if z is None else ys[k] - fac.sub[k].mT @ z
            z = fac.linv[k].mT @ yk
            zs[k] = z
        return torch.stack(zs, dim=1).reshape(P, nb * bs)

    def h0_apply(self, L, d, rhs):
        """Per-subdomain backsolve + duplicate averaging (reference:
        DOTTimeStepper::solve_oneStep, DOTTimeStepper.cpp:406-450)."""
        P = self.n_parts
        r = rhs[self.l2g] * self.local_valid[..., None]   # (P, N, 3)
        r = r.reshape(P, self.n3) / d
        z = self.solve_local(L, r)
        p_l = (z / d).reshape(-1, 3)
        acc = torch.zeros((self.n_vert + 1, 3), dtype=self.dtype,
                          device=self.device)
        acc.index_add_(0, self.gath_segids, p_l[self.gath_perm])
        return acc[:self.n_vert] / self.dup[:, None]

    def rebuild_h0(self, x, fixed):
        """Element Hessians at x + assemble + factorize. Returns
        (elem_h, L, d)."""
        elem_h = self.element_hessians(x)
        L, d = self.factorize(self.assemble_subdomains(elem_h, fixed),
                              fast=True)
        return elem_h, L, d

    # ------------------------------------------------------------------
    # warm start (Optimizer::initX, Optimizer.cpp:441-582)
    # ------------------------------------------------------------------
    def warm_start(self, option, x, v, dx_elastic, fixed):
        if option == 0:
            return x
        if option == 1:
            d = self.dt * v
        elif option == 2:
            d = self.dt * v + self.grav_dt_sq
        elif option == 3:
            d = self.dt * v + self.grav_dt_sq + dx_elastic
        elif option == 4:
            d = self.dt * v + self.grav_dt_sq + 0.5 * dx_elastic
        else:
            raise NotImplementedError(
                f"warmStart {option} is not ported yet; see ROADMAP.md "
                "queue 1")
        return x + torch.where(fixed[:, None], 0.0, d)

    # ------------------------------------------------------------------
    def init_state(self, script_data):
        """Initial SimState (reference: Optimizer ctor + precompute)."""
        dtype, dev = self.dtype, self.device
        x = torch.as_tensor(script_data.x0, dtype=dtype, device=dev)
        fixed = torch.as_tensor(script_data.fixed0, device=dev)
        v = torch.zeros((self.n_vert, 3), dtype=dtype, device=dev)
        elem_h, L, d = self.rebuild_h0(x, fixed)
        m = LBFGS_HISTORY
        return SimState(
            x=x, x_n=x.clone(), v=v,
            x_tilta=self.compute_x_tilta(x, v, fixed),
            dx_elastic=torch.zeros_like(x), fixed=fixed,
            vel_sign=self.scalar(1.0),
            released=torch.zeros((), dtype=torch.bool, device=dev),
            elem_h=elem_h, chol=L, equil=d,
            lb_s=torch.zeros((m, self.n_vert, 3), dtype=dtype, device=dev),
            lb_t=torch.zeros((m, self.n_vert, 3), dtype=dtype, device=dev),
            lb_rho=torch.ones(m, dtype=dtype, device=dev),
            lb_valid=torch.zeros(m, dtype=dtype, device=dev))

    def compute_x_tilta(self, x_n, v, fixed):
        """x~ = x^n + dt v + dt^2 g (free), x^n (fixed)
        (reference: computeXTilta, Optimizer.cpp:584-610)."""
        return torch.where(fixed[:, None], x_n,
                           x_n + self.dt * v + self.grav_dt_sq)

    def be_update(self, state, x_new):
        """Backward-Euler end-of-step update (Optimizer.cpp:354-361), in
        place on `state`."""
        dx_el = x_new - state.x_tilta
        v = (x_new - state.x_n) / self.dt
        state.x_tilta = self.compute_x_tilta(x_new, v, state.fixed)
        state.x, state.x_n = x_new, x_new.clone()
        state.v, state.dx_elastic = v, dx_el
        return state
