"""The DOT time stepper (port of dot_tpu/steppers/dot.py:22-40): L-BFGS
with the decomposed-subdomain implicit initializer H0 = blkdiag(interface-
completed subdomain Hessians), factorized once per time step and applied
by block solves + duplicate averaging.

Reference: src/TimeStepper/DOTTimeStepper.cpp, plus the DOT alpha-init
stepSize = clamp(-g.p / p^T H_tr p, 0.1, 1) (Optimizer.cpp:1075-1093).
"""

from __future__ import annotations

import torch

from .quasi_newton import QuasiNewtonStepper, _vdot


class DOTStepper(QuasiNewtonStepper):
    name = "DOT"

    def h0_apply(self, state, q):
        return self.system.h0_apply(state.chol, state.equil, q,
                                    kc=state.kc_chol, fixed=state.fixed)

    def end_of_step(self, sys, x, fixed, state):
        (state.elem_h, state.chol, state.equil,
         state.kc_chol) = sys.rebuild_h0(x, fixed)
        return state

    def alpha0_and_fp(self, sys, state, g, p):
        # one corner gather of p (K4) feeds both the quadratic form and
        # the line-search direction deformation gradients
        php, Fp = sys.quadratic_form(state.elem_h, p)
        a0 = torch.clamp(-_vdot(g, p) / php, 0.1, 1.0).to(sys.dtype)
        return a0, Fp
