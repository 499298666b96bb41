"""Faults planted under the timed path of a Newton cell, to show that the
comparison catches them: each breaks one layer that the cell's window
drives (the projected-Newton step and its direction, steppers/newton.py
and dim2.Newton2DStepper), and a run with it has to read `correct` false.

    python3 bench_port/faults_newton.py --workload <cell> --fault <name>
                                        --seeds 1,2,3 [--frames 3]

runs as faults.py does (one set-up on the card with the fault planted,
then per seed `--frames` frames from the lap's start and their
comparison: one JSON line a seed, with each number beside its limit).
The benchmark's own runs never plant a fault;
tests/test_spikes_newton_bench.py plants each on the CPU.
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


def _step_wrapped(setattr_, after):
    """NewtonStepper.step with `after(before, state, out)` applied to what
    it returns (`before`: a copy of the state it was given)."""
    from dot_tpu_torch.steppers.newton import NewtonStepper
    orig = NewtonStepper.step

    def step(self, state, rel_tol=1.0e-5):
        before = dataclasses.replace(state)
        state, out = orig(self, state, rel_tol)
        return after(before, state, out)
    setattr_(NewtonStepper, "step", step)


def _unchanged(setattr_):
    """The step returns the state it was given (every layer skipped)."""
    _step_wrapped(setattr_, lambda before, state, out: (before, out))


def _moved_vertex(setattr_):
    """One free vertex of the answer moved by 1 cm where it is produced."""
    def after(before, state, out):
        import torch
        free = torch.nonzero(~state.fixed)[0, 0]
        state.x = state.x.clone()
        state.x[free, 1] += 0.01
        return state, out
    _step_wrapped(setattr_, after)


def _sys_e_altered(setattr_):
    """The reported system energy off by one part in 1e4."""
    def after(before, state, out):
        stats, sys_e = out
        return state, (stats, sys_e * (1.0 + 1e-4))
    _step_wrapped(setattr_, after)


def _one_iteration(setattr_):
    """Each frame stops after one Newton iteration."""
    from dot_tpu_torch.steppers import newton
    setattr_(newton, "INNER_ITER_CAP", 1)


def _half_direction(setattr_):
    """The 2D Newton direction halved: -H^{-1} g / 2."""
    from dot_tpu_torch.dim2 import Newton2DStepper
    orig = Newton2DStepper.direction
    setattr_(Newton2DStepper, "direction",
             lambda self, x, fixed, g: 0.5 * orig(self, x, fixed, g))


FAULTS = {"unchanged": _unchanged, "moved_vertex": _moved_vertex,
          "sys_e_altered": _sys_e_altered, "one_iteration": _one_iteration,
          "half_direction": _half_direction}


def plant(name, setattr_=setattr):
    """Plant fault `name` with `setattr_` (pytest's monkeypatch.setattr in
    the tests)."""
    FAULTS[name](setattr_)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_port/faults_newton.py")
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
