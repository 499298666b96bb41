"""ADMM-PD time stepper (port of dot_tpu/steppers/admm.py:74-373):
per-element consensus ADMM on z ~= Dx (a copy of the deformation gradient),
Overby-style fixed weights.

Reference: src/TimeStepper/ADMMTimeStepper.cpp --
  precompute      :109-201 (global M + D^T W D prefactorized once)
  fullyImplicit   :213-305 (xHat, u = 0, z = Dx, local / global iterations,
                            the ||g||^2 test)
  zuUpdate_SV     :379-479 (per element: a <= 100-iteration projected Newton
                            on the 3 singular values, then the dual update)
  xUpdate         :557-627 (rhs = M xHat + D^T W (z - u), Dirichlet offsets,
                            dimension-separated prefactorized solve)
  initWeights     :655-703 (OVERBYAPD: w_e = dt^2 bulkModulus vol_e)

On the card: the local step is K17 (one thread per element, its Newton and
line-search loops run to their own exit on the device), the rhs and the
matrix-free (M + D^T W D) x of the Dirichlet offsets are K18, the global
matrix is System.build_pd_factor with the Overby weights (K14 and the exact
P = 1 block-tridiagonal factor) and its solve System.pd_solve (K15).
dot_tpu's lax.while_loop over the ADMM iterations is a host loop that reads
E and ||g||^2 once an iteration. The reference forces warmStart 2 for this
stepper (Config.cpp:196-201). `restore` belongs to the restart slice.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import tracing
from ..kernels.admm import bulk_modulus
from ..scripts import make_step_fn
from .quasi_newton import _vdot, finish_step, push_row


@dataclasses.dataclass
class ADMMState:
    """Dynamic state of ADMM-PD (dot_tpu.steppers.admm.ADMMState)."""
    x: torch.Tensor
    x_n: torch.Tensor
    v: torch.Tensor
    x_tilta: torch.Tensor
    dx_elastic: torch.Tensor
    fixed: torch.Tensor
    vel_sign: torch.Tensor
    released: torch.Tensor
    chol: object          # factor of the equilibrated M + D^T W D
    equil: torch.Tensor   # its Jacobi scale


class ADMMPDStepper:
    name = "ADMM"

    def __init__(self, system, script_data, max_iter=1000, warm_start_opt=2):
        self.system = system
        self.script_data = script_data
        self.max_iter = max_iter
        self.warm_start_opt = 2        # forced (Config.cpp:196-201)
        self._anim = make_step_fn(script_data, system.dt)
        sys = system
        # Overby weights dt^2 bulkModulus vol (zero on padded elements)
        self.vol_dtsq = sys.vol_w * sys.scalar(sys.dt_sq)
        self.w_e = (sys.scalar(sys.dt_sq) * sys.vol_w
                    * bulk_modulus(sys.u_e, sys.lam_e))

    def build_factor(self, fixed):
        """The prefactored global matrix M + D^T W D."""
        return self.system.build_pd_factor(fixed, self.w_e)

    @tracing.span("local_step")
    def _local_step(self, f9, u9):
        """(z, du), each (9, nEp), from Dx and the dual u (K17)."""
        sys = self.system
        return sys.k.admm_local_step(f9, u9, self.w_e, self.vol_dtsq,
                                     sys.u_e, sys.lam_e, sys.mat)

    @tracing.span("dtw_scatter")
    def _scatter(self, M9, x, **epilogue):
        """D^T W M9 with the epilogue's terms (K18): the global step's
        right-hand side and the Dirichlet offsets' operator."""
        sys = self.system
        return sys.k.dtw_scatter(M9, sys.g9, self.w_e, sys.scat_perm,
                                 sys.scat_segids, sys.scat_off, x,
                                 **epilogue)

    def _apply_A(self, x):
        """Matrix-free (M + D^T W D) x (the Dirichlet offsets): K18 on
        F(x) with the + mass x epilogue."""
        return self._scatter(self.system.defgrad(x), x, mass=self.system.mass)

    @tracing.span("step")
    def step(self, state, rel_tol=1.0e-5):
        """One full time step. Updates `state` in place and returns
        (state, (StepStats, sysE))."""
        sys = self.system
        syncs0 = sys.n_syncs
        tol = sys.target_g_res(rel_tol)

        x, fixed, vel_sign, released, bc_changed = self._anim(
            state.x, state.fixed, state.vel_sign, state.released)
        state.fixed, state.vel_sign, state.released = fixed, vel_sign, released
        if self.script_data.has_bc_change and sys.host(bc_changed)[0]:
            state.chol, state.equil = self.build_factor(fixed)

        # xHat warm start
        x = sys.warm_start(2, x, state.v, state.dx_elastic, fixed)
        m_xhat = sys.mass[:, None] * x
        free = torch.logical_not(fixed).to(sys.dtype)
        x_fix = x * (1.0 - free[:, None])
        # Dirichlet offset: (A x_fixed), subtracted on free rows
        offset = self._apply_A(x_fix)

        f9 = sys.defgrad(x)
        z = f9
        u9 = torch.zeros_like(f9)
        e = sys.energy(x, state.x_tilta, f9)
        g = sys.gradient(x, state.x_tilta, fixed)
        e_h, sqn_h = sys.host(e, _vdot(g, g))
        rows = [(0.0, e_h, sqn_h)]

        it = 0
        while sqn_h > tol and it < self.max_iter:
            # local step + dual update
            z, du = self._local_step(f9, u9)
            u9 = u9 + du
            # global step: rhs = M xHat + D^T W (z - u) - offsets
            rhs = self._scatter(z - u9, x, base=m_xhat, offset=offset,
                                free=free)
            x = sys.pd_solve(state.chol, state.equil, rhs)
            # exact Dirichlet rows
            x = (x * free[:, None] + x_fix).contiguous()
            f9 = sys.defgrad(x)
            # convergence check on the true gradient
            g = sys.gradient(x, state.x_tilta, fixed)
            e = sys.energy(x, state.x_tilta, f9)
            e_h, sqn_h = sys.host(e, _vdot(g, g))
            it += 1
            push_row(rows, (1.0, e_h, sqn_h))

        state, (stats, sys_e) = finish_step(sys, state, x, e_h, sqn_h, tol,
                                            it, 0, False, False, rows, syncs0)
        stats.stopped = it >= self.max_iter     # dot_tpu admm.py:330
        return state, (stats, sys_e)

    def init_state(self):
        sys, sd = self.system, self.script_data
        dtype, dev = sys.dtype, sys.device
        x = torch.as_tensor(sd.x0, dtype=dtype, device=dev)
        fixed = torch.as_tensor(sd.fixed0, device=dev)
        v = torch.zeros((sys.n_vert, 3), dtype=dtype, device=dev)
        L, d = self.build_factor(fixed)
        return ADMMState(
            x=x, x_n=x.clone(), v=v,
            x_tilta=sys.compute_x_tilta(x, v, fixed),
            dx_elastic=torch.zeros_like(x), fixed=fixed,
            vel_sign=sys.scalar(1.0),
            released=torch.zeros((), dtype=torch.bool, device=dev),
            chol=L, equil=d)
