"""Faults planted under the timed path of an ADMM-PD cell, to show that
the comparison catches them: each breaks one layer that the cell's window
drives (the ADMM-PD step, steppers/admm.py: its local / global
alternation, its stop and the handles' Dirichlet rows), and a run with it
has to read `correct` false.

    python3 bench_port/faults_admm.py --workload <cell> --fault <name>
                                      --seeds 1,2,3 [--frames 3]

runs as faults.py does (one set-up on the card with the fault planted,
then per seed `--frames` frames from the lap's start and their
comparison: one JSON line a seed, with each number beside its limit).
The benchmark's own runs never plant a fault;
tests/test_bar17_admm_bench.py plants each on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port.faults import run_faulted  # noqa: E402


def _step_wrapped(setattr_, before_step=None, after=None):
    """ADMMPDStepper.step with `before_step(stepper)` called before it (it
    returns a function that undoes what it set, run after the step) and
    `after(before, state, out)` applied to what it returns (`before`: a
    copy of the state it was given)."""
    from dot_tpu_torch.steppers.admm import ADMMPDStepper
    orig = ADMMPDStepper.step

    def step(self, state, rel_tol=1.0e-5):
        before = dataclasses.replace(state)
        undo = before_step(self) if before_step else None
        try:
            state, out = orig(self, state, rel_tol)
        finally:
            if undo:
                undo()
        return after(before, state, out) if after else (state, out)
    setattr_(ADMMPDStepper, "step", step)


def _unchanged(setattr_):
    """The step returns the state it was given (every layer skipped)."""
    _step_wrapped(setattr_, after=lambda before, state, out: (before, out))


def _moved_vertex(setattr_):
    """One free vertex of the answer moved by 1 cm where it is produced."""
    def after(before, state, out):
        import torch
        free = torch.nonzero(~state.fixed)[0, 0]
        state.x = state.x.clone()
        state.x[free, 1] += 0.01
        return state, out
    _step_wrapped(setattr_, after=after)


def _sys_e_altered(setattr_):
    """The reported system energy off by one part in 1e4."""
    def after(before, state, out):
        stats, sys_e = out
        return state, (stats, sys_e * (1.0 + 1e-4))
    _step_wrapped(setattr_, after=after)


def _one_iteration(setattr_):
    """Each frame stops after one ADMM iteration (the cap at 1)."""
    def cap(stepper):
        was = stepper.max_iter
        stepper.max_iter = 1
        return lambda: setattr(stepper, "max_iter", was)
    _step_wrapped(setattr_, before_step=cap)


def _free_handles(setattr_):
    """The handles left off their script: the frame's script moves no
    vertex (its handle flags and state as the script says), so the
    Dirichlet rows hold the handles where the frame found them."""
    def still(stepper):
        anim = stepper._anim

        def step_fn(x, fixed, vel_sign, released):
            return (x,) + tuple(anim(x, fixed, vel_sign, released)[1:])
        stepper._anim = step_fn
        return lambda: setattr(stepper, "_anim", anim)
    _step_wrapped(setattr_, before_step=still)


FAULTS = {"unchanged": _unchanged, "moved_vertex": _moved_vertex,
          "sys_e_altered": _sys_e_altered, "one_iteration": _one_iteration,
          "free_handles": _free_handles}


def plant(name, setattr_=setattr):
    """Plant fault `name` with `setattr_` (pytest's monkeypatch.setattr in
    the tests)."""
    FAULTS[name](setattr_)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_port/faults_admm.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "cache", "triton")
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
