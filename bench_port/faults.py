"""Faults planted under the timed path, to show that the comparison
catches them: each breaks one layer that a cell's window drives, and a
run with it has to read `correct` false.

    python3 bench_port/faults.py --workload <cell> --fault <name>
                                 --seeds 1,2,3 [--frames 3]

builds the cell once on the card with the fault planted and, for each
seed, runs `--frames` frames from the lap's start and compares them as a
run of the benchmark does: one JSON line a seed, with each number
compared beside its limit. The benchmark's own runs never plant a fault;
tests/test_runs.py plants each at bar_mesh(8, 3, 3) on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _unchanged(setattr_):
    """The step returns the state it was given (every layer skipped)."""
    from dot_tpu_torch.steppers.quasi_newton import QuasiNewtonStepper
    orig = QuasiNewtonStepper.step

    def step(self, state, rel_tol=1.0e-5):
        before = dataclasses.replace(state)
        _, out = orig(self, state, rel_tol)
        return before, out
    setattr_(QuasiNewtonStepper, "step", step)


def _moved_vertex(setattr_):
    """One free vertex of the answer moved by 1 cm where it is produced."""
    import torch
    from dot_tpu_torch.steppers.quasi_newton import QuasiNewtonStepper
    orig = QuasiNewtonStepper.step

    def step(self, state, rel_tol=1.0e-5):
        state, out = orig(self, state, rel_tol)
        free = torch.nonzero(~state.fixed)[0, 0]
        state.x = state.x.clone()
        state.x[free, 1] += 0.01
        return state, out
    setattr_(QuasiNewtonStepper, "step", step)


def _sys_e_altered(setattr_):
    """The reported system energy off by one part in 1e4."""
    from dot_tpu_torch.steppers.quasi_newton import QuasiNewtonStepper
    orig = QuasiNewtonStepper.step

    def step(self, state, rel_tol=1.0e-5):
        state, (stats, sys_e) = orig(self, state, rel_tol)
        return state, (stats, sys_e * (1.0 + 1e-4))
    setattr_(QuasiNewtonStepper, "step", step)


def _half_elements(setattr_):
    """Half of the elements left out of every element pass, the other
    half weighted twice (the mean taken over the rest)."""
    from dot_tpu_torch.steppers.core import System
    orig = System.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        n = self.vol_w.numel() // 2
        w = self.vol_w.clone()
        w[:n] *= 2.0
        w[n:] = 0.0
        self.vol_w = w
    setattr_(System, "__init__", init)


def _one_iteration(setattr_):
    """Each frame stops after one quasi-Newton iteration."""
    from dot_tpu_torch.steppers import quasi_newton
    setattr_(quasi_newton, "INNER_ITER_CAP", 1)


def _identity_h0(setattr_):
    """The H0 apply (DOT's block solves and coarse correction, LBFGS-PD's
    pd_solve) returns its right-hand side."""
    from dot_tpu_torch.steppers.core import System
    setattr_(System, "h0_apply",
             lambda self, L, d, rhs, kc=None, fixed=None: rhs)
    setattr_(System, "pd_solve", lambda self, L, d, rhs: rhs)


def _no_two_loop(setattr_):
    """The two-loop skipped: the direction is -H0 g, no curvature pairs."""
    from dot_tpu_torch.steppers.quasi_newton import QuasiNewtonStepper
    setattr_(QuasiNewtonStepper, "_two_loop",
             lambda self, state, g, bufs:
             self.h0_apply(state, -g).contiguous())


def _half_two_loop(setattr_):
    """The two-loop's second loop left out: the direction is H0 applied
    to the first loop's q, without the curvature pairs' correction."""
    from dot_tpu_torch.steppers.quasi_newton import QuasiNewtonStepper

    def two_loop(self, state, g, bufs):
        lb_s, lb_t, lb_rho, lb_valid = bufs
        n = g.numel()
        q, _, _ = self.system.k.lbfgs_first(
            lb_s.reshape(-1, n), lb_t.reshape(-1, n), g.reshape(n), lb_rho,
            lb_valid)
        return self.h0_apply(state, q.reshape(g.shape)).contiguous()
    setattr_(QuasiNewtonStepper, "_two_loop", two_loop)


FAULTS = {"unchanged": _unchanged, "moved_vertex": _moved_vertex,
          "sys_e_altered": _sys_e_altered, "half_elements": _half_elements,
          "one_iteration": _one_iteration, "identity_h0": _identity_h0,
          "no_two_loop": _no_two_loop, "half_two_loop": _half_two_loop}


def plant(name, setattr_=setattr):
    """Plant fault `name` with `setattr_` (pytest's monkeypatch.setattr in
    the tests)."""
    FAULTS[name](setattr_)


def run_faulted(cell, seeds, frames, device="cuda", work_dir=HERE):
    """One set-up, then per seed `frames` frames from the lap's start and
    their comparison: [{seed, correct, failed, frames, iters, checks}]."""
    from bench_port import driver
    run = driver.Run(cell, seeds[0], device, work_dir)
    run.build(time.perf_counter())
    out = []
    for seed in seeds:
        run.use_seed(seed)
        run.window(float("inf"), max_frames=frames)
        iters = [f["iters"] for f in run.frame_stats]
        run.release(free=False)
        correct, failed, checks = driver.judge(run.compare(), cell.limits)
        out.append({"seed": seed, "correct": correct, "failed": failed,
                    "frames": frames, "iters": iters,
                    "checks": {k: {"value": v, "limit": lim}
                               for k, (v, lim) in checks.items()}})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_port/faults.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "cache", "triton")
    sys.path.insert(0, ROOT)
    from bench_port import driver
    cell = driver.load_cell(ROOT, args.workload)
    plant(args.fault)
    for r in run_faulted(cell, [int(s) for s in args.seeds.split(",")],
                         args.frames):
        print(json.dumps(dict(r, workload=args.workload, fault=args.fault)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
