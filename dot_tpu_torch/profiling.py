"""Where a frame of the dot_tpu_torch port goes on the GPU.

    python -m dot_tpu_torch.profiling [--cells 56 16 16] [--parts 6]
                                      [--frames 3] [--out output/profile]

Builds the bar twist scene (bar17 by default: 86,016 tets, DOT 6, f32,
relTol 1e-5), runs one warm-up frame, then
1. times `--frames` frames as they run, then `--frames` more with the
   H0 rebuild, the H0 apply, the line search, the quadratic form and the
   gradient wrapped in synchronised host timers (the syncs perturb the
   total a little; the split is what this reads);
2. profiles `--frames` more frames with torch.profiler and prints the
   device time by kernel name, the device busy time per frame and the
   idle share (1 - busy / unwrapped frame time), and writes the chrome
   trace under --out.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import os
import shutil
import sys
import tempfile
import time

import torch

from . import io as meshio
from .config import Config
from .mesh_gen import bar_mesh
from .sim import Simulator
from .steppers import quasi_newton

SCENE = """energy FCR
timeStepper DOT {parts}
warmStart 2
time 5 0.025
density 1000
stiffness 100000 0.4
script twist
shape input {mesh}
"""


def _wrap(obj, name, acc, module=None):
    """Replace obj.name by a synchronised, timed call accumulating into
    acc[name]."""
    owner = module if module is not None else obj
    fn = getattr(owner, name)

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **k)
        torch.cuda.synchronize()
        acc[name] += time.perf_counter() - t0
        return r
    setattr(owner, name, timed)
    return fn


def profile_frames(sim, frames, out):
    """Print the timed split and the device profile of `frames` frames
    (three passes) of a warmed-up CUDA Simulator; write the trace to
    out/frame_trace.json."""
    n0 = len(sim.frames)
    sim.run(frames)
    spf = sum(r["seconds"] for r in sim.frames[n0:]) / frames
    print(f"unwrapped: {spf * 1e3:.2f} ms/frame over {frames} frames")

    acc = collections.Counter()
    sysm = sim.system
    names = ("rebuild_h0", "h0_apply", "gradient", "quadratic_form")
    for name in names:
        _wrap(sysm, name, acc)
    line_search = _wrap(None, "line_search", acc, module=quasi_newton)
    n0 = len(sim.frames)
    t0 = time.perf_counter()
    try:
        sim.run(frames)
    finally:
        for name in names:
            delattr(sysm, name)
        quasi_newton.line_search = line_search
    wall = time.perf_counter() - t0
    iters = sum(r["iters"] for r in sim.frames[n0:])
    print(f"timed split over {frames} frames ({iters} iterations), "
          f"wall {wall / frames * 1e3:.2f} ms/frame:")
    for k, v in acc.most_common():
        print(f"  {k:16s} {v / frames * 1e3:9.2f} ms/frame "
              f"({100 * v / wall:5.1f}%)")
    print(f"  {'rest (host)':16s} "
          f"{(wall - sum(acc.values())) / frames * 1e3:9.2f} ms/frame")

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run(frames)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # kernels are the events on the device; CPU ops only launch them
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_pf = sum(e.self_device_time_total for e in kernels) / 1e6 / frames
    # the profiler's own host cost inflates the profiled wall, so the idle
    # share is taken against the unwrapped frame time
    print(f"profile over {frames} frames (profiled wall {wall:.3f} s): "
          f"device kernel time {dev_pf * 1e3:.2f} ms/frame, idle share "
          f"{1 - dev_pf / spf:.3f} of the unwrapped {spf * 1e3:.2f} ms/frame")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"  {e.self_device_time_total / 1e3 / frames:9.3f} "
              f"ms/frame {e.count / frames:8.1f} launches/frame  "
              f"{e.key[:90]}")
    print(f"  kernel launches per frame: "
          f"{sum(e.count for e in kernels) / frames:.1f}")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "frame_trace.json"))
    print(f"per-frame iterations {[r['iters'] for r in sim.frames]}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dot_tpu_torch.profiling")
    ap.add_argument("--cells", type=int, nargs=3, default=(56, 16, 16))
    ap.add_argument("--parts", type=int, default=6)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", default="output/profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    tmp = tempfile.mkdtemp(prefix="dot_prof_")
    try:
        mesh = bar_mesh(*args.cells, size=(4.0, 1.0, 1.0))
        mp = os.path.join(tmp, "bar.msh")
        meshio.save_tet_mesh(mp, mesh.V, mesh.conn, mesh.SF)
        sp = os.path.join(tmp, "scene.txt")
        with open(sp, "w") as f:
            f.write(SCENE.format(parts=args.parts, mesh=mp))
        sim = Simulator(Config.load(sp), os.path.join(tmp, "out"),
                        dtype=torch.float32, device="cuda", mute=True,
                        save_every=10 ** 9)
        print(f"cells {args.cells}: {sim.mesh.n_elem} tets, "
              f"{sim.mesh.n_vert} verts, P {sim.system.n_parts}, n3 "
              f"{sim.system.n3}, banded {sim.system.banded} (nb "
              f"{sim.system.band_nb}, bs {sim.system.band_bs}); "
              f"{torch.cuda.get_device_name(0)}")
        sim.run(1)
        profile_frames(sim, args.frames, args.out)
        sim.finalize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
