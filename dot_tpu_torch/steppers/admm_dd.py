"""ADMM-DD time stepper (port of dot_tpu/steppers/admm_dd.py:88-700):
overlapping-subdomain consensus ADMM.

Reference: src/TimeStepper/ADMMDDTimeStepper.cpp (USE_GW path, the default):
  fullyImplicit          :595-701  (initPrimal / initDual -> loop:
                                    subdomainSolve, boundaryConsensusSolve(1.8),
                                    dualSolve, global ||g||^2 test; weights and
                                    consensus refreshed at the step's end)
  initDual               :736-796  (u = W^{-1} (g_global - g_local) at interfaces)
  initWeights_fast       :894-1033 (W_s = missing mass + missing-element 3x3
                                    blocks, with interface-interface off-diagonals)
  subdomainSolve         :1107-1232 (one local Newton iteration per ADMM
                                    iteration on the augmented local energy; the
                                    local Hessian is refreshed every 20)
  boundaryConsensusSolve :1254-1344 (solve sum_s W_s dz = residual, relax 1.8)
  dualSolve              :1345-1368

`inexactSolve` is parsed and does nothing, as in dot_tpu: the reference's
loop always runs exactly one local Newton iteration per ADMM iteration, so
its early exit can never trigger (dot_tpu admm_dd.py:17-26).

On the card: the augmented local Hessian (own elements + local mass + W) is
K3 at the local positions and K19 into the RCM block-tridiagonal band,
factored exactly (the f32 or f64 block scan on K6, never cyclic reduction)
and solved by K7 block products; the compact interface-weight operator W is
K20 (the line search's W terms in one launch of its w_quad entry); the
local gradient is K2's from-F entry point on the carried local
deformation gradients (updated linearly along each accepted step, never
re-gathered); each line-search trial is K1's per-slab entry point: one step
length and one energy sum per subdomain. Weights, consensus and initDual
are gathers, sorted segment sums and library factorizations in plain torch,
as they are library calls in dot_tpu. On a dense plan the local Hessian is
assembled and factorized in plain torch.

dot_tpu's prelude / chunk / finale programs are one host loop here: the
chunking only bounded one device program's run time. The loop reads
||g||^2 once an iteration, any(E_trial > E_0) once a line-search trial and
the residual once a CG step of initDual. `restore` belongs to the restart
slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..kernels import admm as kadmm
from ..scripts import make_step_fn
from .quasi_newton import _vdot, finish_step, push_row

ADMM_ITER_CAP = 1000   # ADMMDDTimeStepper.cpp:632
H_REFRESH_EVERY = 20   # ADMMDDTimeStepper.cpp:637
RELAX = 1.8            # over-relaxation (boundaryConsensusSolve's argument)
LS_CAP = 64
CG_CAP = 200           # initDual's CG: steps, and the relative residual^2
CG_REL_SQ = 1e-10


@dataclasses.dataclass
class ADMMDDState:
    """Dynamic state of ADMM-DD (dot_tpu.steppers.admm_dd.ADMMDDState)."""
    x: torch.Tensor
    x_n: torch.Tensor
    v: torch.Tensor
    x_tilta: torch.Tensor
    dx_elastic: torch.Tensor
    fixed: torch.Tensor
    vel_sign: torch.Tensor
    released: torch.Tensor
    elem_h: torch.Tensor      # (144, nEp) element Hessians at the last x
    w_vals: torch.Tensor      # (nUW,) compact interface weight entries
    cons_chol: torch.Tensor   # (ns3, ns3) consensus factor
    cons_equil: torch.Tensor  # (ns3,)


class ADMMDDStepper:
    name = "ADMMDD"

    def __init__(self, system, script_data, admm_plan, warm_start_opt=2):
        self.system = system
        self.script_data = script_data
        self.warm_start_opt = warm_start_opt
        self.ap = ap = admm_plan
        self._anim = make_step_fn(script_data, system.dt)
        sys = system
        dev = sys.device

        def t(a, dt=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=dev)
        # (4, nEp) flat local row ids p * Nmax + l; padding elements point
        # at the dump row P * Nmax (both a gather and a scatter index)
        self.conn_local = t(ap.conn_local.T, torch.int32)
        self.mass_local = t(ap.mass_local, sys.dtype)
        self.is_dual = t(ap.is_dual, torch.bool)
        self.nmax = int(ap.mass_local.shape[1])
        self.owner_flat = t(ap.owner_part.astype(np.int64) * self.nmax
                            + ap.owner_local)
        self.shared_ids = t(ap.shared_ids)
        self.l2shared = t(ap.l2shared)
        self.n_shared = int(ap.n_shared)
        self.ns3 = int(ap.ns3)
        self.w_perm = t(ap.w_perm)
        self.w_stage1 = t(ap.w_stage1)
        self.w_udest = t(ap.w_udest)
        self.wp = kadmm.w_plan(ap, sys.n3, sys.dtype, dev)
        self.c_perm = t(ap.c_perm)
        self.c_stage1 = t(ap.c_stage1)
        self.c_udest = t(ap.c_udest)
        # the banded augmented local Hessian (the path at scale): assembled
        # and factorized block-tridiagonally, every local solve block
        # products
        self.banded_local = ap.w_band_dest is not None
        self.comp_gather = t(ap.comp_gather)
        self.mass_dif = t(ap.mass_dif, sys.dtype)
        is_sh = np.zeros(sys.n_vert, bool)
        is_sh[ap.shared_ids] = True
        self.is_shared = t(is_sh, torch.bool)
        # (P,) line-search steps broadcast to the flat local rows
        am = np.repeat(np.arange(sys.n_parts), self.nmax)
        self._alpha_map = t(np.concatenate([am, [0]]))

    # ------------------------------------------------------------------
    # weights + consensus (reference: initWeights_fast + consensus solver)
    # ------------------------------------------------------------------
    @tracing.span("update_weights")
    def update_weights(self, x, fixed):
        """(elem_h, w_vals, Lc, d): the element Hessians at x, the compact
        interface weights W and the factorized, Jacobi-equilibrated
        consensus matrix over the shared dofs."""
        sys = self.system
        dt, dev = sys.dtype, sys.device
        elem_h = sys.element_hessians(x)                   # (144, nEp)
        flat = elem_h.reshape(-1)[self.comp_gather].reshape(-1)
        w_vals = torch.zeros(self.w_udest.shape[0], dtype=dt, device=dev)
        w_vals.index_add_(0, self.w_stage1, flat[self.w_perm])
        # W stays compact: the free masks and the mass-diff diagonal are
        # applied inside w_matvec / the assembly at use time

        c_compact = torch.zeros(self.c_udest.shape[0], dtype=dt, device=dev)
        c_compact.index_add_(0, self.c_stage1, flat[self.c_perm])
        ns3 = self.ns3
        C = torch.zeros(ns3 * ns3, dtype=dt, device=dev)
        C[self.c_udest] = c_compact
        C = C.reshape(ns3, ns3)
        # mass-diff diagonal mapped to the shared dofs
        md_sh = torch.zeros(self.n_shared + 1, dtype=dt, device=dev)
        md_sh.index_add_(0, self.l2shared.reshape(-1),
                         self.mass_dif.reshape(-1))
        C.diagonal().add_(torch.repeat_interleave(md_sh, 3))
        # fixed shared vertices and the dump slot get identity rows
        sfree = torch.cat([
            torch.logical_not(fixed[self.shared_ids]).to(dt),
            torch.zeros(1, dtype=dt, device=dev)])
        f3 = torch.repeat_interleave(sfree, 3)
        C = C * f3[:, None] * f3[None, :]
        C.diagonal().add_(1.0 - f3)

        d = torch.sqrt(C.diagonal())
        dinv = 1.0 / d
        Lc = sys._dense_chol_nan(sys._to_factor_dtype(
            C * dinv[:, None] * dinv[None, :])[None])[0]
        return elem_h, w_vals, Lc, d

    # ---- the compact-W operators (the dense (P, n3, n3) W never exists) --
    def _w_masked(self, w_vals, free3f):
        return w_vals * free3f[self.wp.row] * free3f[self.wp.col]

    def _md3f(self, free3f):
        """The masked mass-diff diagonal as a flat (P n3,) vector."""
        return self.wp.md3 * free3f

    def w_matvec(self, w_vals, free3f, aug):
        """y = W aug, (P, n3) -> (P, n3), masked to free rows and columns
        (K20)."""
        sys = self.system
        y = sys.k.w_matvec(w_vals, free3f, aug.reshape(-1).contiguous(),
                           self.wp)
        return y.reshape(sys.n_parts, sys.n3)

    def w_diag(self, w_vals, free3f):
        """(P n3,) diagonal of the masked W (K20's diagonal flag; initDual
        puts an identity on its zero rows)."""
        return self.system.k.w_matvec(w_vals, free3f, None, self.wp,
                                      diag_only=True)

    def w_add_dense(self, Hd, w_vals, free3f):
        """Hd + W for the dense augmented local Hessian (plain torch)."""
        sys = self.system
        P, n3 = sys.n_parts, sys.n3
        flat = Hd.reshape(-1).clone()
        flat[self.w_udest] += self._w_masked(w_vals, free3f)   # unique
        Hd = flat.reshape(P, n3, n3)
        Hd.diagonal(dim1=1, dim2=2).add_(self._md3f(free3f).reshape(P, n3))
        return Hd

    def _free3(self, fixed):
        sys = self.system
        return torch.repeat_interleave(sys._free(fixed).to(sys.dtype), 3,
                                       dim=-1)                   # (P, n3)

    # ------------------------------------------------------------------
    # local (per-subdomain) energy / gradient on padded local states
    # ------------------------------------------------------------------
    def _local_defgrad(self, xl_flat):
        """(9, nEp) local deformation gradients at xl_flat, the
        (P Nmax + 1, 3) local positions (or directions) + dump row."""
        sys = self.system
        F, _ = sys.k.direction_pass(xl_flat, self.conn_local, sys.g9)
        return F

    def _slab_energies(self, f9, fp9=None, alpha=None):
        """(P,) sum of vol Psi(sigma(f9 + alpha_p fp9)) per subdomain."""
        sys = self.system
        return sys.k.ls_trial_energy_parts(f9, fp9, alpha, sys.u_e,
                                           sys.lam_e, sys.vol_w, sys.mat,
                                           sys.n_parts)

    def _aug_vec(self, xl_flat, z, u_loc):
        """(P, n3): x_local - z_global + u at the local dof layout (only
        the dual columns of W are nonzero, so no mask is needed)."""
        sys = self.system
        xl = xl_flat[:-1].reshape(sys.n_parts, self.nmax, 3)
        return (xl - z[sys.l2g] + u_loc).reshape(sys.n_parts, sys.n3)

    def _local_energies(self, xl_flat, xhat_flat, z, u_loc, wpack, f9):
        """(P,) augmented local energies (computeEnergyVal_subdomain).
        wpack = (compact W values, flat free mask)."""
        sys = self.system
        e_el = self._slab_energies(f9) * sys.dt_sq
        d = (xl_flat - xhat_flat)[:-1].reshape(sys.n_parts, self.nmax, 3)
        e_in = 0.5 * torch.sum(self.mass_local[..., None] * d * d, dim=(1, 2))
        aug = self._aug_vec(xl_flat, z, u_loc)
        Wa = self.w_matvec(wpack[0], wpack[1], aug)
        return e_el + e_in + 0.5 * torch.sum(aug * Wa, dim=1)

    @tracing.span("local_gradient")
    def _local_gradient(self, xl_flat, xhat_flat, z, u_loc, wpack, fixed, f9):
        """(P, Nmax, 3) gradient of the augmented local energies; the
        element part from the carried local deformation gradients f9."""
        sys = self.system
        P, nmax = sys.n_parts, self.nmax
        acc = sys.k.elem_gradient_from_F(f9, self.conn_local, sys.g9,
                                         sys.u_e, sys.lam_e, sys.vol_w,
                                         sys.mat, P * nmax)
        g = acc[:-1].reshape(P, nmax, 3) * sys.scalar(sys.dt_sq)
        d = (xl_flat - xhat_flat)[:-1].reshape(P, nmax, 3)
        g = g + self.mass_local[..., None] * d
        aug = self._aug_vec(xl_flat, z, u_loc)
        g = g + self.w_matvec(wpack[0], wpack[1], aug).reshape(P, nmax, 3)
        return g * self._free3(fixed).reshape(P, nmax, 3)

    def _to_flat(self, xl):
        sys = self.system
        return torch.cat([xl.reshape(sys.n_parts * self.nmax, 3),
                          torch.zeros((1, 3), dtype=sys.dtype,
                                      device=sys.device)])

    @tracing.span("local_factor")
    def _local_h_factor(self, xl_flat, wpack, fixed):
        """(L, d): the exact factor of the augmented local Hessian = own
        elements' elasticity at the local positions + local mass + W,
        identity at fixed and padding rows."""
        sys = self.system
        elem_h = sys.k.elem_hessian(xl_flat, self.conn_local, sys.g9,
                                    sys.u_e, sys.lam_e, sys.vol_w, sys.mat,
                                    sys.dt_sq)
        if self.banded_local:
            P, bs, nb = sys.n_parts, sys.band_bs, sys.band_nb
            flat = sys.assemble_own_btd_flat(elem_h, fixed, self.mass_local,
                                             wpack[0], wpack[1], self.wp)
            diag_sz = P * nb * bs * bs
            return sys.factorize((flat[:diag_sz].view(nb, P, bs, bs),
                                  flat[diag_sz:].view(nb - 1, P, bs, bs)))
        Hd = sys.assemble_subdomains_local_only(elem_h, fixed,
                                                self.mass_local)
        return sys.factorize(self.w_add_dense(Hd, wpack[0], wpack[1]))

    # ------------------------------------------------------------------
    @tracing.span("init_dual")
    def _init_dual(self, g, g_loc, wpack, fixed):
        """u = W^{-1} (g_global - g_local) on the interface dofs: CG on the
        compact operator W + I off the dual dofs (the reference
        prefactorizes a dense W per subdomain, ADMMDDTimeStepper.cpp:
        736-796), stopped on ||r||^2 <= 1e-10 ||r0||^2 or after 200 steps."""
        sys = self.system
        P, n3, nmax = sys.n_parts, sys.n3, self.nmax
        valid = sys.local_valid[..., None]
        rhs_u = (g[sys.l2g] * valid - g_loc) * self.is_dual[..., None]
        dual3 = torch.repeat_interleave(self.is_dual.to(sys.dtype), 3,
                                        dim=-1) * self._free3(fixed)
        wd = self.w_diag(wpack[0], wpack[1]).reshape(P, n3)
        fix1 = torch.where((wd == 0.0) & (dual3 > 0.0), 1.0, 0.0).to(sys.dtype)

        def wsolve_mv(v):
            y = self.w_matvec(wpack[0], wpack[1], v)
            return y + v * (1.0 - dual3) + v * fix1

        b = rhs_u.reshape(P, n3)
        xk, rk, pk = torch.zeros_like(b), b, b
        rs = _vdot(rk, rk)
        rs0_h = rs_h = sys.host(rs)[0]
        it = 0
        while rs_h > CG_REL_SQ * rs0_h and it < CG_CAP:
            Ap = wsolve_mv(pk)
            alpha = rs / _vdot(pk, Ap)
            xk = xk + alpha * pk
            rk = rk - alpha * Ap
            rs_new = _vdot(rk, rk)
            pk = rk + (rs_new / rs) * pk
            rs = rs_new
            rs_h = sys.host(rs)[0]
            it += 1
        return xk.reshape(P, nmax, 3) * dual3.reshape(P, nmax, 3)

    @tracing.span("step")
    def step(self, state, rel_tol=1.0e-5):
        """One full time step. Updates `state` in place and returns
        (state, (StepStats, sysE))."""
        sys = self.system
        P, n3, nmax = sys.n_parts, sys.n3, self.nmax
        syncs0 = sys.n_syncs
        tol = sys.target_g_res(rel_tol)
        to_flat = self._to_flat
        valid = sys.local_valid[..., None]

        x, fixed, vel_sign, released, bc_changed = self._anim(
            state.x, state.fixed, state.vel_sign, state.released)
        state.fixed, state.vel_sign, state.released = fixed, vel_sign, released
        if self.script_data.has_bc_change and sys.host(bc_changed)[0]:
            (state.elem_h, state.w_vals, state.cons_chol,
             state.cons_equil) = self.update_weights(x, fixed)
        wv, Lc, dc = state.w_vals, state.cons_chol, state.cons_equil
        free3 = self._free3(fixed)
        free3l = free3.reshape(P, nmax, 3)
        wpack = (wv, free3.reshape(-1))
        x_tilta = state.x_tilta

        # initPrimal: global warm start, local copies, local xHat
        x = sys.warm_start(self.warm_start_opt, x, state.v, state.dx_elastic,
                           fixed, x_tilta=x_tilta)
        xhat_g = torch.where(fixed[:, None], x, x_tilta)
        xl_flat = to_flat(x[sys.l2g] * valid)
        xhat_flat = to_flat(xhat_g[sys.l2g] * valid)
        z = x
        u_loc = torch.zeros((P, nmax, 3), dtype=sys.dtype, device=sys.device)

        # global gradient and energy
        e = sys.energy(x, x_tilta, sys.defgrad(x))
        g = sys.gradient(x, x_tilta, fixed)
        e_h, sqn_h = sys.host(e, _vdot(g, g))
        rows = [(0.0, e_h, sqn_h)]

        # initDual; the local deformation gradients at the initial local
        # state seed the F-carry (F(x + a p) = F(x) + a F(p))
        f9 = self._local_defgrad(xl_flat)
        g_loc = self._local_gradient(xl_flat, xhat_flat, z, u_loc, wpack,
                                     fixed, f9)
        u_loc = self._init_dual(g, g_loc, wpack, fixed)
        # the local Hessian factors (refreshed every 20 iterations)
        L, d = self._local_h_factor(xl_flat, wpack, fixed)
        ml = self.mass_local[..., None]
        dt_sq = sys.scalar(sys.dt_sq)
        n_slab = sys.n_elem_p // P
        shared_fixed = fixed[self.shared_ids][:, None]

        it = 0
        while sqn_h > tol and it < ADMM_ITER_CAP:
            if it % H_REFRESH_EVERY == 0 and it > 0:
                L, d = self._local_h_factor(xl_flat, wpack, fixed)

            # --- one local Newton iteration with line search ---------
            gl = self._local_gradient(xl_flat, xhat_flat, z, u_loc, wpack,
                                      fixed, f9)
            r = -gl.reshape(P, n3) / d
            with tracing.span("solve_local"):
                zz = sys.solve_local(L, r)      # dense or block-tridiagonal
            p = (zz.to(sys.dtype) / d).reshape(P, nmax, 3) * free3l

            # linearized local line search: F(xl + a p) = F(xl) + a F(p);
            # the inertia and W-augmentation terms are exact quadratics in
            # a, so a trial is one pass over the elements
            p_flat = to_flat(p)
            fp9 = self._local_defgrad(p_flat)
            d0 = (xl_flat - xhat_flat)[:-1].reshape(P, nmax, 3)
            c0 = 0.5 * torch.sum(ml * d0 * d0, dim=(1, 2))
            c1 = torch.sum(ml * d0 * p, dim=(1, 2))
            c2 = 0.5 * torch.sum(ml * p * p, dim=(1, 2))
            # the W terms: K20's line-search entry, one launch
            aug0 = self._aug_vec(xl_flat, z, u_loc).reshape(-1)
            a0c, a1c, a2c = sys.k.w_quad(wpack[0], wpack[1], aug0,
                                         p.reshape(-1).contiguous(), self.wp,
                                         P)

            def trial_e(alpha):
                e_el = self._slab_energies(f9, fp9, alpha) * dt_sq
                return (e_el + c0 + alpha * (c1 + alpha * c2)
                        + a0c + alpha * (a1c + alpha * a2c))

            e0 = self._slab_energies(f9) * dt_sq + c0 + a0c
            alpha = torch.ones(P, dtype=sys.dtype, device=sys.device)
            ee = trial_e(alpha)
            k = 0
            while k < LS_CAP and sys.host((ee > e0).any())[0]:
                alpha = torch.where(ee > e0, alpha * 0.5, alpha)
                ee = trial_e(alpha)
                k += 1
            xl_flat = xl_flat + alpha[self._alpha_map][:, None] * p_flat
            # F-carry: the accepted step updates the carried deformation
            # gradients without a re-gather
            f9 = f9 + torch.repeat_interleave(alpha, n_slab) * fp9

            # --- boundary consensus solve (relax 1.8) -----------------
            xl = xl_flat[:-1].reshape(P, nmax, 3)
            zg = z[sys.l2g]     # also resultVk: z before this update
            aug = (RELAX * xl + (1.0 - RELAX) * zg + u_loc - zg)
            t = self.w_matvec(wpack[0], wpack[1],
                              aug.reshape(P, n3)).reshape(P * nmax, 3)
            rhs_sh = torch.zeros((self.n_shared + 1, 3), dtype=sys.dtype,
                                 device=sys.device)
            rhs_sh.index_add_(0, self.l2shared.reshape(-1), t)
            rhs_sh = torch.where(shared_fixed, 0.0, rhs_sh[:self.n_shared])
            rhs_full = torch.cat([rhs_sh, torch.zeros(
                (1, 3), dtype=sys.dtype, device=sys.device)]).reshape(self.ns3)
            rc = (rhs_full / dc)[:, None].to(sys._solve_dtype)
            yc = torch.linalg.solve_triangular(Lc, rc, upper=False)
            zc = torch.linalg.solve_triangular(Lc.mT, yc, upper=True)
            dz = (zc[:, 0].to(sys.dtype) / dc).reshape(-1, 3)

            # interior vertices take their owner's local copy
            z_new = torch.where(self.is_shared[:, None], z,
                                xl_flat[self.owner_flat])
            z_new[self.shared_ids] += dz[:self.n_shared]

            # --- dual update (step size 1, relax 1.8) -----------------
            du = (RELAX * xl + (1.0 - RELAX) * zg - z_new[sys.l2g]) \
                * self.is_dual[..., None]
            u_loc = u_loc + du
            z = z_new

            # --- global convergence check ------------------------------
            g = sys.gradient(z, x_tilta, fixed)
            e = sys.energy(z, x_tilta, sys.defgrad(z))
            e_h, sqn_h = sys.host(e, _vdot(g, g))
            it += 1
            push_row(rows, (1.0, e_h, sqn_h))

        # weights and the consensus factor for the next step
        (state.elem_h, state.w_vals, state.cons_chol,
         state.cons_equil) = self.update_weights(z, fixed)
        state, (stats, sys_e) = finish_step(sys, state, z, e_h, sqn_h, tol,
                                            it, 0, False, False, rows, syncs0)
        stats.stopped = it >= ADMM_ITER_CAP     # dot_tpu admm_dd.py:642
        return state, (stats, sys_e)

    def init_state(self):
        sys, sd = self.system, self.script_data
        dtype, dev = sys.dtype, sys.device
        x = torch.as_tensor(sd.x0, dtype=dtype, device=dev)
        fixed = torch.as_tensor(sd.fixed0, device=dev)
        v = torch.zeros((sys.n_vert, 3), dtype=dtype, device=dev)
        elem_h, wv, Lc, dc = self.update_weights(x, fixed)
        return ADMMDDState(
            x=x, x_n=x.clone(), v=v,
            x_tilta=sys.compute_x_tilta(x, v, fixed),
            dx_elastic=torch.zeros_like(x), fixed=fixed,
            vel_sign=sys.scalar(1.0),
            released=torch.zeros((), dtype=torch.bool, device=dev),
            elem_h=elem_h, w_vals=wv, cons_chol=Lc, cons_equil=dc)
