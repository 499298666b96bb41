"""The control of a cell's comparison: the plain reference put in the
program's place, computed in a precision below the configuration's, has
to come out as not correct.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3
                                  [--frames 3] [--precision tf32]

From the lap's start with each seed's start velocity, the reference's own
time step (references/<name>.py `Scene.step`, in `--precision`: tf32 is
float32 with TF32 matrix products, the configuration's float32 with TF32
off being f32) produces `--frames` frames on the card; the cell's
comparison (driver.judge on the f64 reference's numbers) then judges them
as it judges the program's. One JSON line a seed. It imports nothing of
the program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_control(cell, seed, frames, precision, device, work_dir=HERE):
    import torch
    from bench_port import driver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mod = driver.reference_module(cell.config)
    scene = driver.scene_kind(cell.config)
    out = os.path.join(work_dir, "out", f"{cell.workload}.control")
    os.makedirs(out, exist_ok=True)
    _, mesh = scene.write(cell.config, cell.traffic,
                          os.path.join(work_dir, "cache"), out)
    ctrl = mod.Scene(cell.config, mesh, device, precision)
    ref = mod.Scene(cell.config, mesh, device, "f64")
    x = ref.x0.to(driver.DTYPES[cell.config["scene_script"]["dtype"]])
    v = scene.seed_velocity(seed, x, ~ref.free,
                            cell.traffic["seed_velocity_m_per_s"])
    starts, vels, nexts, sys_e, sqn_g, iters = [], [], [], [], [], []
    t0 = time.perf_counter()
    xc, vc = x.to(ctrl.p.dtype), v.to(ctrl.p.dtype)
    for _ in range(frames):
        xn, vn, e, gg, it = ctrl.step(xc, vc)
        starts.append(xc)
        vels.append(vc)
        nexts.append(xn)
        sys_e.append(e)
        sqn_g.append(gg)
        iters.append(it)
        xc, vc = xn, vn
    step_s = time.perf_counter() - t0
    f64 = torch.float64
    st = lambda seq: torch.stack([a.to(f64) for a in seq])
    per_frame = {k: v.tolist() for k, v in ref.frame_numbers(
        st(starts), st(vels), st(nexts), sys_e, sqn_g).items()}
    correct, failed, checks = driver.judge(per_frame, cell.limits)
    return {"workload": cell.workload, "seed": seed, "precision": precision,
            "frames": frames, "iters": iters, "step_s": step_s,
            "correct": correct, "failed": failed, "per_frame": per_frame,
            "checks": {k: {"value": a, "limit": b}
                       for k, (a, b) in checks.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_port/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--precision", default="tf32", choices=("tf32", "f32"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from bench_port import driver
    cell = driver.load_cell(ROOT, args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(run_control(cell, int(s), args.frames,
                                     args.precision, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
