"""Projected-Newton time stepper (port of dot_tpu/steppers/newton.py:25-137;
reference: the Optimizer base class, src/TimeStepper/Optimizer.cpp:702-881).

Every inner iteration rebuilds the SPD-projected Hessian at the current
iterate (K3), assembles it on the P = 1 plan of the shared System (K5 when
that plan is banded), factorizes it exactly (the block scan: no cyclic
reduction, no bf16; a failed factor is NaN, and the NaN-safe line search
then stops the step) and solves H p = -g. dot_tpu's lax.while_loop is a
host loop here, as in quasi_newton.py. dim2.Newton2DStepper runs the same
loop with the dense whole-mesh factor of a System2D (`direction`).
"""

from __future__ import annotations

from .. import tracing
from .core import INNER_ITER_CAP, REL_EDEC_STOP
from .quasi_newton import _vdot, finish_step, line_search, push_row
from ..scripts import make_step_fn


class NewtonStepper:
    name = "Newton"

    def __init__(self, system, script_data, warm_start_opt=2):
        self._check_system(system)
        self.system = system
        self.script_data = script_data
        self.warm_start_opt = warm_start_opt
        self._anim = make_step_fn(script_data, system.dt)

    def _check_system(self, system):
        if system.n_parts != 1:
            raise ValueError("Newton uses the whole-mesh system (a P = 1 "
                             f"plan), not {system.n_parts} parts")

    def init_state(self):
        return self.system.init_state(self.script_data)

    @tracing.span("step")
    def step(self, state, rel_tol=1.0e-5):
        """One full time step. Updates `state` in place and returns
        (state, (StepStats, sysE))."""
        sys = self.system
        syncs0 = sys.n_syncs
        tol = sys.target_g_res(rel_tol)

        x, fixed, vel_sign, released, _bc = self._anim(
            state.x, state.fixed, state.vel_sign, state.released)
        state.fixed, state.vel_sign, state.released = fixed, vel_sign, released

        x = sys.warm_start(self.warm_start_opt, x, state.v, state.dx_elastic,
                           fixed, x_tilta=state.x_tilta)
        F = sys.defgrad(x)
        e = sys.energy(x, state.x_tilta, F)
        g = sys.gradient(x, state.x_tilta, fixed)
        e_h, sqn_h = sys.host(e, _vdot(g, g))
        rows = [(0.0, e_h, sqn_h)]

        it = n_ls = 0
        stopped = failed = False
        while sqn_h > tol and it < INNER_ITER_CAP and not stopped:
            # refactorize at the current iterate (solve_oneStep,
            # Optimizer.cpp:702-749)
            p = self.direction(x, fixed, g)
            Fp = sys.defgrad(p)
            x_new, e_new, alpha, e_new_h, a_h, halv, failed = line_search(
                sys, x, p, e, e_h, state.x_tilta, sys.scalar(1.0), F, Fp)
            n_ls += halv
            it += 1
            if failed:
                stopped = True     # x, E and the gradient stay
                row = (a_h, e_h, sqn_h)
            else:
                g = sys.gradient(x_new, state.x_tilta, fixed)
                rel = (e - e_new) / e < REL_EDEC_STOP
                sqn_h, rel_h = sys.host(_vdot(g, g), rel)
                stopped = bool(rel_h)
                F = F + alpha * Fp
                x, e, e_h = x_new, e_new, e_new_h
                row = (a_h, e_new_h, sqn_h)
            push_row(rows, row)

        return finish_step(sys, state, x, e_h, sqn_h, tol, it, n_ls, stopped,
                           failed, rows, syncs0)

    def direction(self, x, fixed, g):
        """p = -H^{-1} g with H factorized at x."""
        L, d = self.factor(x, fixed)
        return self.system.h0_apply(L, d, -g)

    @tracing.span("newton_factor")
    def factor(self, x, fixed):
        """(L, d): the exact factor of the Hessian at x."""
        sys = self.system
        Hd = sys.assemble_subdomains(sys.element_hessians(x), fixed)
        return sys.factorize(Hd)
