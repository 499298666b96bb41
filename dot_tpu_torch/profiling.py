"""Where a frame of the dot_tpu_torch port goes on the GPU.

    python -m dot_tpu_torch.profiling [--scene bar17|bar135|bar17-lbfgs|
                                       bar17-gsdd|bar17-ws5|bar17-newton|
                                       bar17-lbfgsh|bar17-lbfgsjh|
                                       bar17-admm|bar17-admmdd]
                                      [--frames 3] [--out output/profile]
                                      [--no-trace]

Builds a bar twist scene (tools/scalability.py's template, f32, relTol
1e-5): `--scene bar17` (the default: 56x16x16 cells, 86,016 tets,
DOT 6) or `--scene bar135` (131x31x31 cells, 755,346 tets, DOT -1 1024:
133 parts, the coarse space and the chunked bf16 rebuild); the other
scenes are bar17 under `timeStepper LBFGS` (LBFGS-PD), `GSDD 6`, `DOT 6`
with `warmStart 5`, `Newton`, `LBFGSH`, `LBFGSJH 6`, `ADMM` (ADMM-PD) and
`ADMMDD 6` (the two ADMM steppers take hundreds of iterations a frame:
profile them with `--frames 1 --no-trace`, which skips the chrome trace).
It runs one warm-up frame, then
1. times `--frames` frames as they run, then `--frames` more with the
   program's spans on (dot_tpu_torch.tracing: no synchronisation) and
   prints their tree: per span, host ms a frame in it and in none of its
   children, calls a frame, and the time blocked in host reads;
2. profiles `--frames` more frames with torch.profiler and prints the
   device time by kernel name, the device time and launches per frame of
   each hand-written kernel (K1-K20, with the wrappers' launch counts),
   and writes the chrome trace under --out.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import shutil
import sys
import tempfile
import time

import torch

from . import io as meshio
from . import tracing
from .config import Config
from .mesh_gen import bar_mesh
from .kernels import ops
from .sim import Simulator

# device-kernel name fragments of each wrapper's kernel (the second passes
# of K1 and K4, which sum block partials, are left out)
KERNEL_NAMES = {
    "ls_trial_energy": ("ls_trial_energy_kernel",),
    "elem_gradient": ("elem_gradient_kernel",),
    "elem_hessian": ("elem_hessian_kernel",),
    "direction_pass": ("direction_kernel",),
    "band_assemble": ("band_assemble_kernel",),
    "chol_inv": ("chol_inv_kernel",),
    "block_solve": ("solve_kernel",),
    "h0_gather": ("h0_gather_kernel",),
    "h0_average": ("h0_average_kernel",),
    "lbfgs_first": ("lbfgs_first_kernel",),
    "lbfgs_second": ("lbfgs_second_kernel",),
    "coarse_assemble": ("dotk10::assemble_kernel", "dotk10::reduce_kernel"),
    "coarse_restrict": ("dotk10::restrict_kernel",),
    "coarse_prolong": ("dotk10::prolong_kernel",),
    "band_compact": ("dotk5::band_compact_kernel",),
    "band_equil_scatter": ("dotk12::d_kernel", "dotk12::scatter_kernel"),
    "hessian_diag": ("hessian_diag_kernel",),
    "pd_assemble": ("pd_reduce_kernel", "pd_diag_kernel"),
    "local_gather_one": (),     # K8's h0_gather_kernel on one row
    "local_scatter_one": ("local_scatter_kernel",),
    "admm_local_step": ("admm_local_step_kernel",),
    "make_pd3": ("make_pd3_kernel",),       # inside K17 on the main path
    "dtw_scatter": ("dtw_scatter_kernel",),
    # K19's first pass is K5's band_assemble_kernel on the own tables
    "own_band_assemble": ("band_add_w_kernel", "band_add_md_kernel"),
    "w_matvec": ("w_matvec_kernel",),
    "w_diag": (),                           # w_matvec_kernel's diagonal flag
    "w_quad": ("w_quad_kernel",),
    "ls_trial_energy_parts": ("ls_trial_energy_parts_kernel",),
    "elem_gradient_from_F": ("elem_gradient_from_F_kernel",),
    # K24's assembly is K26's one-pass kernel (no 2D scene here)
    "dense_assemble2d": ("dotdd::assemble_kernel",),
}
_B17 = (56, 16, 16)
# scene -> (cells, timeStepper line, warmStart)
SCENES = {"bar17": (_B17, "DOT 6", 2),
          "bar135": ((131, 31, 31), "DOT -1 1024", 2),
          "bar17-lbfgs": (_B17, "LBFGS", 2),
          "bar17-gsdd": (_B17, "GSDD 6", 2),
          "bar17-ws5": (_B17, "DOT 6", 5),
          "bar17-newton": (_B17, "Newton", 2),
          "bar17-lbfgsh": (_B17, "LBFGSH", 2),
          "bar17-lbfgsjh": (_B17, "LBFGSJH 6", 2),
          "bar17-admm": (_B17, "ADMM", 2),
          "bar17-admmdd": (_B17, "ADMMDD 6", 2)}

SCENE = """energy FCR
timeStepper {stepper}
warmStart {warm}
time 5 0.025
density 1000
stiffness 100000 0.4
script twist
shape input {mesh}
"""


def device_kernels(fn, tries=3):
    """{name: count} of the device work one synchronised call of `fn` ran
    (kernels, memsets and copies), from torch.profiler: what a wrapper
    launches, counted by the device rather than by the wrapper. The call
    is profiled `tries` times and each name keeps the most launches a
    trace saw: a trace can lose device events (seen on the card, now and
    then; in a long process, every event of a dozen traces in a row: see
    captured_work), never gain them."""
    from torch.profiler import ProfilerActivity, profile
    most = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                most[e.key] = max(most.get(e.key, 0), e.count)
    return most


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of libcuda's graph API."""
    _fields_ = [("func", ctypes.c_void_p), ("dims", ctypes.c_uint * 7),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_NODE_TYPES = {1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
               6: "event wait", 7: "event record", 10: "mem alloc",
               11: "mem free"}


def captured_work(fn):
    """{name: count} of the device work one call of `fn` enqueues, from a
    CUDA graph capture of the call (torch.cuda.graph; the graph is read
    through the CUDA runtime while it is captured, then dropped unrun):
    kernel nodes by their (mangled) names, the other nodes by kind
    ("memset", "memcpy", ...). It counts what a wrapper launches
    (cooperative launches included) without the profiler's activity
    records, which a trace can lose (device_kernels)."""
    rt = ctypes.CDLL("libcudart.so.12")
    drv = ctypes.CDLL("libcuda.so.1")
    V, P = ctypes.c_void_p, ctypes.POINTER
    # the 6-argument form (the header maps cudaStreamGetCaptureInfo to it;
    # the library's plain symbol is the old 3-argument one)
    info = rt.cudaStreamGetCaptureInfo_v2
    info.argtypes = [V, P(ctypes.c_int), P(ctypes.c_ulonglong), P(V), P(V),
                     P(ctypes.c_size_t)]
    rt.cudaGraphGetNodes.argtypes = [V, V, P(ctypes.c_size_t)]
    rt.cudaGraphNodeGetType.argtypes = [V, P(ctypes.c_int)]
    # kernel names through libcuda: the kernels of the port's libraries
    # belong to their own (static) runtimes, not to this one
    drv.cuGraphKernelNodeGetParams_v2.argtypes = [V, P(_KernelNodeParams)]
    drv.cuFuncGetName.argtypes = [P(ctypes.c_char_p), V]
    drv.cuKernelGetName.argtypes = [P(ctypes.c_char_p), V]

    def ok(err, what):
        if err != 0:
            raise RuntimeError(f"captured_work: {what} failed (cudaError "
                               f"{err})")
    work = {}
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
        stream = V(torch.cuda.current_stream().cuda_stream)
        status, graph = ctypes.c_int(), V()
        ok(info(stream, ctypes.byref(status), None, ctypes.byref(graph),
                None, None), "cudaStreamGetCaptureInfo")
        n = ctypes.c_size_t()
        ok(rt.cudaGraphGetNodes(graph, None, ctypes.byref(n)),
           "cudaGraphGetNodes")
        nodes = (V * n.value)()
        ok(rt.cudaGraphGetNodes(graph, nodes, ctypes.byref(n)),
           "cudaGraphGetNodes")
        for node in nodes:
            kind = ctypes.c_int()
            ok(rt.cudaGraphNodeGetType(node, ctypes.byref(kind)),
               "cudaGraphNodeGetType")
            name = _NODE_TYPES.get(kind.value, f"node type {kind.value}")
            if kind.value == 0:
                prm = _KernelNodeParams()
                ok(drv.cuGraphKernelNodeGetParams_v2(node,
                                                     ctypes.byref(prm)),
                   "cuGraphKernelNodeGetParams")
                cname = ctypes.c_char_p()
                ok(drv.cuFuncGetName(ctypes.byref(cname), prm.func)
                   if prm.func else
                   drv.cuKernelGetName(ctypes.byref(cname), prm.kern),
                   "cuFuncGetName")
                name = cname.value.decode()
            work[name] = work.get(name, 0) + 1
    del g
    return work


def span_tree(recs, frames):
    """Lines of the span tree of `recs` (tracing.records()): per path of
    span names, host ms a frame in the span and in none of its children,
    calls a frame, and the ms a frame blocked in host reads (host_read's
    wait). Children follow their parent, costliest first."""
    by_id = {r["id"]: r for r in recs}
    paths = {}

    def path(r):
        p = paths.get(r["id"])
        if p is None:
            up = by_id.get(r["parent"])
            p = paths[r["id"]] = (path(up) if up else ()) + (r["name"],)
        return p
    total, own = collections.Counter(), collections.Counter()
    calls, wait = collections.Counter(), collections.Counter()
    for r in recs:
        p, d = path(r), r["end_ns"] - r["start_ns"]
        total[p] += d
        own[p] += d
        calls[p] += 1
        wait[p] += r["wait_ns"]
        if len(p) > 1:
            own[p[:-1]] -= d
    f = 1e6 * frames
    lines = []

    def walk(parent):
        kids = [p for p in total if p[:-1] == parent]
        for p in sorted(kids, key=lambda p: -total[p]):
            w = f", wait {wait[p] / f:.3f}" if wait[p] else ""
            lines.append(f"  {'  ' * (len(p) - 1)}{p[-1]:{26 - 2 * len(p)}s}"
                         f" {total[p] / f:9.3f} ms {own[p] / f:9.3f} self "
                         f"{calls[p] / frames:8.2f} calls{w}")
            walk(p)
    walk(())
    return lines


def profile_frames(sim, frames, out, trace=True):
    """Print the span split and the device profile of `frames` frames
    (three passes) of a warmed-up CUDA Simulator; write the trace to
    out/frame_trace.json unless `trace` is False."""
    n0 = len(sim.frames)
    sim.run(frames)
    spf = sum(r["seconds"] for r in sim.frames[n0:]) / frames
    print(f"unwrapped: {spf * 1e3:.2f} ms/frame over {frames} frames")

    n0 = len(sim.frames)
    tracing.reset()
    tracing.enable()
    t0 = time.perf_counter()
    try:
        sim.run(frames)
    finally:
        tracing.disable()
    wall = time.perf_counter() - t0
    iters = sum(r["iters"] for r in sim.frames[n0:])
    print(f"span split over {frames} frames ({iters} iterations), wall "
          f"{wall / frames * 1e3:.2f} ms/frame (host time: total, self, "
          f"calls a frame):")
    for line in span_tree(tracing.records(), frames):
        print(line)
    tracing.reset()

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
    print(f"profile over {frames} frames (profiled wall {wall:.3f} s): "
          f"device kernel time {dev_pf * 1e3:.2f} ms/frame")
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
    if trace:
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "frame_trace.json"))
    print(f"per-frame iterations {[r['iters'] for r in sim.frames]}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dot_tpu_torch.profiling")
    ap.add_argument("--scene", choices=sorted(SCENES), default="bar17")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", default="output/profile")
    ap.add_argument("--no-trace", action="store_true",
                    help="do not write the chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device (none found)")
    cells, stepper, warm = SCENES[args.scene]
    tmp = tempfile.mkdtemp(prefix="dot_prof_")
    try:
        mesh = bar_mesh(*cells, size=(4.0, 1.0, 1.0))
        mp = os.path.join(tmp, "bar.msh")
        meshio.save_tet_mesh(mp, mesh.V, mesh.conn, mesh.SF)
        sp = os.path.join(tmp, "scene.txt")
        with open(sp, "w") as f:
            f.write(SCENE.format(stepper=stepper, warm=warm, mesh=mp))
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
        profile_frames(sim, args.frames, args.out, not args.no_trace)
        sim.finalize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
