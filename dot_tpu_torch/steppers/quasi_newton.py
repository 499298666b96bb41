"""Quasi-Newton (L-BFGS) stepping machinery, in PyTorch (port of
dot_tpu/steppers/quasi_newton.py:27-298): two-loop recursion around the
implicit H0 apply, Armijo (c = 0) halving line search, curvature history
and the Backward-Euler update.

dot_tpu's lax.while_loops become host loops: each line-search trial and
each inner iteration reads its decision scalars back once (System.host,
counted per step in StepStats.syncs). All other work stays on the device.
The two-loop's vector passes and scalar recurrences are K9
(kernels/csrc/lbfgs.cu; plain versions in kernels/lbfgs.py): 2 launches
per iteration around the H0 apply instead of ~70 0-d torch ops.
"""

from __future__ import annotations

import torch

from .core import (INNER_ITER_CAP, LBFGS_HISTORY, LINE_SEARCH_CAP,
                   REL_EDEC_STOP, STATS_CAP, StepStats)
from ..scripts import make_step_fn


def _vdot(a, b):
    # reductions stay in the field dtype (as dot_tpu)
    return torch.dot(a.reshape(-1), b.reshape(-1))


def line_search(system, x0, p, e0, e0_host, x_tilta, alpha0, F0, Fp):
    """Backtracking Armijo (c = 0: accept any non-increase) from alpha0
    (reference: Optimizer::lineSearch, Optimizer.cpp:751-881).

    F(x0 + a p) = F0 + a F(p) and the inertia term is an exact quadratic in
    a, so each trial is one K1 launch over the elements. A non-finite trial
    energy is rejected (keep halving). Returns (x, E, alpha, E on the host,
    alpha on the host, halvings, failed)."""
    c0, c1, c2 = system.inertia_quad(x0, p, x_tilta)
    alpha = alpha0
    k = 0
    while True:
        e = system.elastic_energy(F0, Fp, alpha) + (c0 + alpha * (c1 + alpha * c2))
        e_h, a_h = system.host(e, alpha)
        if e_h <= e0_host or k >= LINE_SEARCH_CAP:
            break
        alpha = alpha * 0.5
        k += 1
    failed = not e_h <= e0_host
    return x0 + alpha * p, e, alpha, e_h, a_h, k, failed


def push_row(rows, row):
    """Append an iterStats row; past STATS_CAP rows the last is replaced."""
    if len(rows) < STATS_CAP:
        rows.append(row)
    else:
        rows[-1] = row


def finish_step(sys, state, x, e_h, sqn_h, tol, it, n_ls, stopped, failed,
                rows, syncs0):
    """The end of every stepper's time step: the Backward-Euler update, the
    system energy diagnostic and the host-side StepStats. Returns (state,
    (StepStats, sysE))."""
    x_n_prev = state.x_n
    state = sys.be_update(state, x)
    sys_e = sys.host(sys.system_energy(x, x_n_prev,
                                       sys.sigma(sys.defgrad(x))))[0]
    if sqn_h <= tol:
        stop = "tol"
    elif stopped:
        stop = "ls_failed" if failed else "rel_dec"
    else:
        stop = "iter_cap"
    stats = StepStats(energy=e_h, sqn_g=sqn_h, inner_iters=it,
                      ls_halvings=n_ls, stop=stop, rows=rows,
                      syncs=sys.n_syncs - syncs0, stopped=stopped)
    return state, (stats, sys_e)


class QuasiNewtonStepper:
    name = "LBFGS"

    def __init__(self, system, script_data, warm_start_opt=2):
        self.system = system
        self.script_data = script_data
        self.warm_start_opt = warm_start_opt
        self._anim = make_step_fn(script_data, system.dt)

    # ---- subclass hooks ------------------------------------------------
    def h0_apply(self, state, q):
        raise NotImplementedError

    def end_of_step(self, sys, x, fixed, state):
        return state

    def on_bc_change(self, sys, x, fixed, state):
        return self.end_of_step(sys, x, fixed, state)

    def alpha0_and_fp(self, sys, state, g, p):
        """(initial line-search step, F(p))."""
        return sys.scalar(1.0), sys.defgrad(p)

    # --------------------------------------------------------------------
    def _two_loop(self, state, g, bufs):
        """Two-loop recursion around the implicit H0 apply
        (reference: DOTTimeStepper.cpp:386-467), with every inner product
        derived from three contractions -- sq = S q0, G = S T^T,
        tr = T (H0 q) -- plus O(m^2) scalar recurrences, as dot_tpu does,
        in the field dtype with exact f32 accumulation (dot_tpu's
        Precision.HIGHEST). K9 runs them as 2 launches around the H0 apply:
        loop 1 (contractions + recurrence -> k, G) with q = -g - k^T T, and
        loop 2 (T r + recurrence -> c) with r + c^T S."""
        lb_s, lb_t, lb_rho, lb_valid = bufs
        kern = self.system.k
        m = LBFGS_HISTORY
        n = lb_s.shape[1] * lb_s.shape[2]
        S = lb_s.reshape(m, n)
        T = lb_t.reshape(m, n)
        gf = g.reshape(n)
        q, k, G = kern.lbfgs_first(S, T, gf, lb_rho, lb_valid)
        r = self.h0_apply(state, q.reshape(g.shape)).reshape(n)
        return kern.lbfgs_second(T, S, r, k, G, lb_rho,
                                 lb_valid).reshape(g.shape)

    @staticmethod
    def _push_history(bufs, s_new, t_new, rho_new):
        """Append an accepted curvature pair (t.s > 0 is decided by the
        caller, DOTTimeStepper.cpp:474-494): oldest slot out, newest in."""
        lb_s, lb_t, lb_rho, lb_valid = bufs
        one = torch.ones_like(lb_valid[:1])
        return (torch.cat([lb_s[1:], s_new[None]]),
                torch.cat([lb_t[1:], t_new[None]]),
                torch.cat([lb_rho[1:], rho_new.reshape(1)]),
                torch.cat([lb_valid[1:], one]))

    # --------------------------------------------------------------------
    def step(self, state, rel_tol=1.0e-5):
        """One full time step (dot_tpu's _step_impl as a host loop).
        Updates `state` in place and returns (state, (StepStats, sysE))."""
        sys = self.system
        sd = self.script_data
        syncs0 = sys.n_syncs
        tol = sys.target_g_res(rel_tol)

        x, fixed, vel_sign, released, bc_changed = self._anim(
            state.x, state.fixed, state.vel_sign, state.released)
        state.fixed, state.vel_sign, state.released = fixed, vel_sign, released
        if sd.has_bc_change and sys.host(bc_changed)[0]:
            # Dirichlet set changed mid-run -> refresh H0 with new masks
            state = self.on_bc_change(sys, x, fixed, state)

        x = sys.warm_start(self.warm_start_opt, x, state.v, state.dx_elastic,
                           fixed, x_tilta=state.x_tilta)
        F = sys.defgrad(x)
        e = sys.energy(x, state.x_tilta, F)
        g = sys.gradient(x, state.x_tilta, fixed)
        sqn_g = _vdot(g, g)
        e_h, sqn_h = sys.host(e, sqn_g)
        rows = [(0.0, e_h, sqn_h)]

        # fresh history each time step (DOTTimeStepper.cpp:275-285)
        bufs = (torch.zeros_like(state.lb_s), torch.zeros_like(state.lb_t),
                torch.ones_like(state.lb_rho), torch.zeros_like(state.lb_valid))
        it = n_ls = 0
        stopped = failed = False
        while sqn_h > tol and it < INNER_ITER_CAP and not stopped:
            p = self._two_loop(state, g, bufs)
            a0, Fp = self.alpha0_and_fp(sys, state, g, p)
            x_new, e_new, alpha, e_new_h, a_h, halv, failed = line_search(
                sys, x, p, e, e_h, state.x_tilta, a0, F, Fp)
            n_ls += halv
            it += 1
            if failed:
                # x reverts; the pre-step gradient stays and no pair is
                # pushed (t = 0)
                stopped = True
                row = (a_h, e_h, sqn_h)
            else:
                g_new = sys.gradient(x_new, state.x_tilta, fixed)
                s_vec = alpha * p
                t_vec = g_new - g
                rho = _vdot(t_vec, s_vec)
                sqn_new = _vdot(g_new, g_new)
                # relative-decrease early stop (Optimizer.cpp:856-862)
                rel = (e - e_new) / e < REL_EDEC_STOP
                rho_h, sqn_h, rel_h = sys.host(rho, sqn_new, rel)
                stopped = bool(rel_h)
                if rho_h > 0.0:
                    bufs = self._push_history(bufs, s_vec, t_vec, rho)
                F = F + alpha * Fp
                x, e, e_h, g = x_new, e_new, e_new_h, g_new
                row = (a_h, e_new_h, sqn_h)
            push_row(rows, row)

        state.lb_s, state.lb_t, state.lb_rho, state.lb_valid = bufs
        # H0 refresh at the converged x every step (h0Refresh 1,
        # DOTTimeStepper.cpp:343)
        state = self.end_of_step(sys, x, fixed, state)
        return finish_step(sys, state, x, e_h, sqn_h, tol, it, n_ls, stopped,
                           failed, rows, syncs0)

    def init_state(self):
        return self.system.init_state(self.script_data)


class RebuildH0Stepper(QuasiNewtonStepper):
    """H0 = the assembled subdomain Hessians (whatever the plan: an element
    partition, one part, a node partition), factorized once per time step
    and applied by block solves + duplicate averaging."""

    def h0_apply(self, state, q):
        return self.system.h0_apply(state.chol, state.equil, q,
                                    kc=state.kc_chol, fixed=state.fixed)

    def end_of_step(self, sys, x, fixed, state):
        (state.elem_h, state.chol, state.equil,
         state.kc_chol) = sys.rebuild_h0(x, fixed)
        return state
