"""Where a frame of the dot_tpu_torch port goes on the GPU.

    python -m dot_tpu_torch.profiling [--scene bar17|bar135] [--frames 3]
                                      [--out output/profile]

Builds a bar twist scene (tools/scalability.py's template, f32, relTol
1e-5): `--scene bar17` (the default: 56x16x16 cells, 86,016 tets,
DOT 6) or `--scene bar135` (131x31x31 cells, 755,346 tets, DOT -1 1024:
133 parts, the coarse space and the chunked bf16 rebuild). It runs one
warm-up frame, then
1. times `--frames` frames as they run, then `--frames` more with the
   H0 rebuild (and inside it the element Hessians, the coarse factor, the
   assembly and the factorization, or on the chunked path the compact,
   the K12 scatter and the scan), the H0 apply (and inside it the coarse
   apply), the line search, the quadratic form and the gradient wrapped
   in synchronised host timers (the syncs perturb the total a little;
   the split is what this reads);
2. profiles `--frames` more frames with torch.profiler and prints the
   device time by kernel name, the device time and launches per frame of
   each hand-written kernel (K1-K12, with the wrappers' launch counts),
   the device busy time per frame and the idle share (1 - busy /
   unwrapped frame time), and writes the chrome trace under --out.
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
from .kernels import ops
from .sim import Simulator
from .steppers import quasi_newton

# device-kernel name fragments of each wrapper's kernel (the second passes
# of K1 and K4, which sum block partials, are left out; K9's dots_kernel
# serves both loops and is counted under lbfgs_loop1)
KERNEL_NAMES = {
    "ls_trial_energy": ("ls_trial_energy_kernel",),
    "elem_gradient": ("elem_gradient_kernel",),
    "elem_hessian": ("elem_hessian_kernel",),
    "direction_pass": ("direction_kernel",),
    "band_assemble": ("band_assemble_kernel",),
    "chol_inv": ("chol_inv_kernel",),
    "block_matvec": ("matvec_kernel", "matvec_t_kernel"),
    "h0_gather": ("h0_gather_kernel",),
    "h0_average": ("h0_average_kernel",),
    "lbfgs_loop1": ("dots_kernel", "loop1_kernel"),
    "lbfgs_loop2": ("loop2_kernel",),
    "lbfgs_combine": ("combine_kernel",),
    "coarse_assemble": ("dotk10::assemble_kernel", "dotk10::reduce_kernel"),
    "coarse_restrict": ("dotk10::restrict_kernel",),
    "coarse_prolong": ("dotk10::prolong_kernel",),
    "band_compact": ("dotk5::band_compact_kernel",),
    "band_equil_scatter": ("dotk12::d_kernel", "dotk12::scatter_kernel"),
}
# spans inside rebuild_h0 and h0_apply (timed, not subtracted from the
# host rest): the unchunked path assembles and factorizes, the chunked one
# builds the compact, scatters it (K12) and scans
REBUILD_SPANS = ("element_hessians", "_coarse_factor", "assemble_subdomains",
                 "factorize", "_band_compact", "_equil_scatter",
                 "_btd_scan_equilibrated")
APPLY_SPANS = ("_coarse_apply",)
SCENES = {"bar17": ((56, 16, 16), "DOT 6"),
          "bar135": ((131, 31, 31), "DOT -1 1024")}

SCENE = """energy FCR
timeStepper {stepper}
warmStart 2
time 5 0.025
density 1000
stiffness 100000 0.4
script twist
shape input {mesh}
"""


def wrap_timed(obj, name, acc, module=None):
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
    names = ("rebuild_h0", "h0_apply", "gradient", "quadratic_form") \
        + REBUILD_SPANS + APPLY_SPANS
    for name in names:
        wrap_timed(sysm, name, acc)
    line_search = wrap_timed(None, "line_search", acc,
                             module=quasi_newton)
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
    inner = {"rebuild_h0": REBUILD_SPANS, "h0_apply": APPLY_SPANS}
    for k, v in acc.most_common():
        if k in REBUILD_SPANS + APPLY_SPANS:
            continue
        print(f"  {k:20s} {v / frames * 1e3:9.2f} ms/frame "
              f"({100 * v / wall:5.1f}%)")
        for j in inner.get(k, ()):
            if j in acc:
                print(f"    {j:22s} {acc[j] / frames * 1e3:9.2f} ms/frame")
    outer = sum(v for k, v in acc.items()
                if k not in REBUILD_SPANS + APPLY_SPANS)
    print(f"  {'rest (host)':20s} {(wall - outer) / frames * 1e3:9.2f} "
          f"ms/frame")

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run(frames)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
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
    print("hand-written kernels (device ms/frame, device launches/frame, "
          "wrapper calls/frame):")
    for kname, frags in KERNEL_NAMES.items():
        mine = [e for e in kernels if any(f in e.key for f in frags)]
        print(f"  {kname:16s} "
              f"{sum(e.self_device_time_total for e in mine) / 1e3 / frames:9.3f}"
              f" {sum(e.count for e in mine) / frames:8.1f}"
              f" {launches[kname] / frames:8.1f}")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "frame_trace.json"))
    print(f"per-frame iterations {[r['iters'] for r in sim.frames]}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dot_tpu_torch.profiling")
    ap.add_argument("--scene", choices=sorted(SCENES), default="bar17")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", default="output/profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device (none found)")
    cells, stepper = SCENES[args.scene]
    tmp = tempfile.mkdtemp(prefix="dot_prof_")
    try:
        mesh = bar_mesh(*cells, size=(4.0, 1.0, 1.0))
        mp = os.path.join(tmp, "bar.msh")
        meshio.save_tet_mesh(mp, mesh.V, mesh.conn, mesh.SF)
        sp = os.path.join(tmp, "scene.txt")
        with open(sp, "w") as f:
            f.write(SCENE.format(stepper=stepper, mesh=mp))
        t0 = time.perf_counter()
        sim = Simulator(Config.load(sp), os.path.join(tmp, "out"),
                        dtype=torch.float32, device="cuda", mute=True,
                        save_every=10 ** 9)
        sysm = sim.system
        print(f"cells {cells} {stepper}: {sim.mesh.n_elem} tets, "
              f"{sim.mesh.n_vert} verts, P {sysm.n_parts}, n3 {sysm.n3}, "
              f"banded {sysm.banded} (nb {sysm.band_nb}, bs "
              f"{sysm.band_bs}), coarse {sysm.use_coarse}, chunked "
              f"{sysm._chunk is not None}; Simulator built in "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.get_device_name(0)}")
        sim.run(1)
        profile_frames(sim, args.frames, args.out)
        sim.finalize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
