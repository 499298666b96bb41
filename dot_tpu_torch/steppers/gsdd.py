"""GSDD time stepper (port of dot_tpu/steppers/gsdd.py:31-162): sequential
Gauss-Seidel over the DOT subdomains. Per sweep, each subdomain solves its
frozen interface-completed Hessian against the current negative gradient
(K16 gather, K7 on the subdomain's blocks of the factor, K16 scatter),
takes a globally line-searched step from alpha = 1, and the gradient is
refreshed before the next subdomain.

Reference: DOTTimeStepper::solve_oneStep_GSDD (DOTTimeStepper.cpp:506-565).
As dot_tpu keeps it: no L-BFGS history on this path; a failed line search
leaves x, E and the gradient as they were; the 1e-3 relative-decrease stop
is evaluated per sweep, not per subdomain; the inner loop also stops when
every line search of a sweep failed; the subdomain Hessians are rebuilt
once per time step. One inner iteration is one sweep. dot_tpu's
lax.fori_loop over the subdomains is a host loop here.
"""

from __future__ import annotations

from .. import tracing
from .core import INNER_ITER_CAP, REL_EDEC_STOP
from .quasi_newton import (RebuildH0Stepper, _vdot, finish_step, line_search,
                           push_row)


class GSDDStepper(RebuildH0Stepper):
    name = "GSDD"

    @tracing.span("gsdd_sweep")
    def sweep(self, state, x, e, e_h, g, F, fixed):
        """One pass over the subdomains. Returns (x, E, E on the host, g,
        F, halvings of the taken steps, whether every line search
        failed)."""
        sys = self.system
        n_ls, all_failed = 0, True
        one = sys.scalar(1.0)
        for i in range(sys.n_parts):
            p = sys.subdomain_solve(state.chol, state.equil, -g, i)
            Fp = sys.defgrad(p)
            x_new, e_new, alpha, e_new_h, _a_h, halv, failed = line_search(
                sys, x, p, e, e_h, state.x_tilta, one, F, Fp)
            if failed:
                continue
            all_failed = False
            n_ls += halv
            g = sys.gradient(x_new, state.x_tilta, fixed)
            F = F + alpha * Fp
            x, e, e_h = x_new, e_new, e_new_h
        return x, e, e_h, g, F, n_ls, all_failed

    @tracing.span("step")
    def step(self, state, rel_tol=1.0e-5):
        """One full time step: one inner iteration is one sweep. Updates
        `state` in place and returns (state, (StepStats, sysE))."""
        sys = self.system
        sd = self.script_data
        syncs0 = sys.n_syncs
        tol = sys.target_g_res(rel_tol)

        x, fixed, vel_sign, released, bc_changed = self._anim(
            state.x, state.fixed, state.vel_sign, state.released)
        state.fixed, state.vel_sign, state.released = fixed, vel_sign, released
        if sd.has_bc_change and sys.host(bc_changed)[0]:
            state = self.on_bc_change(sys, x, fixed, state)

        x = sys.warm_start(self.warm_start_opt, x, state.v, state.dx_elastic,
                           fixed, x_tilta=state.x_tilta)
        F = sys.defgrad(x)
        e = sys.energy(x, state.x_tilta, F)
        g = sys.gradient(x, state.x_tilta, fixed)
        e_h, sqn_h = sys.host(e, _vdot(g, g))
        rows = [(0.0, e_h, sqn_h)]

        it = n_ls = 0
        stopped = all_failed = False
        while sqn_h > tol and it < INNER_ITER_CAP and not stopped:
            e0 = e
            x, e, e_h, g, F, halv, all_failed = self.sweep(
                state, x, e, e_h, g, F, fixed)
            n_ls += halv
            # sweep-level stop: every local line search failed, or the
            # sweep's total energy decrease fell under the 1e-3 rule
            rel = (e0 - e) / e0 < REL_EDEC_STOP
            sqn_h, rel_h = sys.host(_vdot(g, g), rel)
            stopped = all_failed or bool(rel_h)
            it += 1
            push_row(rows, (1.0, e_h, sqn_h))

        state = self.end_of_step(sys, x, fixed, state)
        return finish_step(sys, state, x, e_h, sqn_h, tol, it, n_ls, stopped,
                           all_failed, rows, syncs0)
