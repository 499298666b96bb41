"""The LBFGS-{PD, H, HI, JH} time steppers (port of
dot_tpu/steppers/lbfgs.py): L-BFGS with alternative implicit initializers
H0 (reference: src/TimeStepper/LBFGSTimeStepper.cpp, D0Type at
LBFGSTimeStepper.hpp:21-27):

  PD : H0 = M + dt^2 D^T W D with w_e = vol_e (2 mu_e + lambda_e), a fixed
       scalar (per-coordinate) SPD matrix built and factorized once (K14 +
       the exact P = 1 block-tridiagonal factorization); dim-separated
       solves with the three coordinates as right-hand sides (K15).
  H  : H0 = the full start-of-step Hessian, refactorized after each time
       step: the P = 1 plan of the subdomain machinery.
  HI : the same matrix with a cheaper approximate factor: rounded to bf16,
       factorized in f32 (System(factor_dtype=torch.bfloat16)), dot_tpu's
       stand-in for the reference's incomplete Cholesky.
  JH : H0 = block-Jacobi Hessian over a disjoint node partition
       (partition.build_node_plan: dup == 1).

All share the quasi-Newton loop; none uses the DOT alpha-init (the step
size starts at 1).
"""

from __future__ import annotations

import torch

from .core import LBFGS_HISTORY, SimState
from .quasi_newton import QuasiNewtonStepper, RebuildH0Stepper


class LBFGSH(RebuildH0Stepper):
    """LBFGS-H: whole-mesh Hessian initializer (a P = 1 plan)."""
    name = "LBFGSH"


class LBFGSHI(RebuildH0Stepper):
    """LBFGS-HI: the same matrix factorized from its bf16 rounding
    (construct the System with factor_dtype=torch.bfloat16)."""
    name = "LBFGSHI"


class LBFGSJH(RebuildH0Stepper):
    """LBFGS-JH: disjoint node-partition block-Jacobi initializer (a node
    plan from partition.build_node_plan)."""
    name = "LBFGSJH"


class LBFGSPD(QuasiNewtonStepper):
    """LBFGS-PD: fixed Laplacian-type initializer, one scalar Cholesky at
    precompute, reused for all steps and all three coordinates."""
    name = "LBFGSPD"

    def init_state(self):
        sys, sd = self.system, self.script_data
        dtype, dev = sys.dtype, sys.device
        x = torch.as_tensor(sd.x0, dtype=dtype, device=dev)
        fixed = torch.as_tensor(sd.fixed0, device=dev)
        v = torch.zeros((sys.n_vert, 3), dtype=dtype, device=dev)
        L, d = sys.build_pd_factor(fixed)
        m = LBFGS_HISTORY
        return SimState(
            x=x, x_n=x.clone(), v=v,
            x_tilta=sys.compute_x_tilta(x, v, fixed),
            dx_elastic=torch.zeros_like(x), fixed=fixed,
            vel_sign=sys.scalar(1.0),
            released=torch.zeros((), dtype=torch.bool, device=dev),
            elem_h=torch.zeros((1, 1), dtype=dtype, device=dev),  # unused
            chol=L, equil=d,
            lb_s=torch.zeros((m, sys.n_vert, 3), dtype=dtype, device=dev),
            lb_t=torch.zeros((m, sys.n_vert, 3), dtype=dtype, device=dev),
            lb_rho=torch.ones(m, dtype=dtype, device=dev),
            lb_valid=torch.zeros(m, dtype=dtype, device=dev))

    def h0_apply(self, state, q):
        return self.system.pd_solve(state.chol, state.equil, q)

    def end_of_step(self, sys, x, fixed, state):
        return state  # fixed initializer, never refactorized

    def on_bc_change(self, sys, x, fixed, state):
        state.chol, state.equil = sys.build_pd_factor(fixed)
        return state
