"""K32 (ops.tri_solve, csrc/trsolve.cu) on the card: the forward and
backward substitution pair of the 2D dense H0 apply against its plain
version (two batched library triangular solves, dd2d.tri_solve_ref).

- random SPD factors, f32 and f64, row- and column-major, at widths that
  are and are not multiples of 64, P 1-4 and a P = 1 slice L[i:i + 1]:
  error against the plain pair (f64 1e-12 norm-wise), bit for bit from run
  to run;
- the spikes scene's factor (resolution 20,000, DOT 4: P 4, n 5,248, f32,
  System2D.rebuild_h0 at the scene's start): each pair's error against an
  f64 solve of the same f32 factor, the device work of one solve_local
  (a CUDA graph capture: K32's kernel alone), the time of one call (median
  of CUDA-event timings) and back to back, beside the library pair and the
  bound dense_solve_roofline counts (one read of the lower triangles).

    python3 tools/torch_trsolve_bench.py [--out chiprun_out/trsolve.json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dot_tpu_torch import dim2, plan2d, profiling, scripts  # noqa: E402
from dot_tpu_torch.config import Config  # noqa: E402
from dot_tpu_torch.kernels import dd2d, ops  # noqa: E402
from dot_tpu_torch.kernels.csrc import build  # noqa: E402

HBM_BYTES_S = 3.35e12


def rel(a, b):
    return float((a - b).norm() / b.norm())


def median_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def back_to_back_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def spd_factor(P, n, dtype, rng):
    a = torch.as_tensor(rng.normal(size=(P, n, n)), dtype=torch.float64,
                        device="cuda")
    A = a @ a.mT / n + torch.eye(n, dtype=torch.float64, device="cuda")
    return torch.linalg.cholesky(A).to(dtype)


def random_cases(rng, bad):
    out = []
    for dtype in (torch.float64, torch.float32):
        for P, n in ((4, 130), (1, 64), (3, 7), (2, 1000), (4, 5248)):
            Lc = spd_factor(P, n, dtype, rng)
            r = torch.as_tensor(rng.normal(size=(P, n)), dtype=dtype,
                                device="cuda")
            for layout, L in (("row", Lc.contiguous()),
                              ("column", Lc.mT.contiguous().mT),
                              ("slice", Lc.mT.contiguous().mT[P - 1:P])):
                rr = r[P - 1:P].contiguous() if layout == "slice" else r
                z = ops.tri_solve(L, rr)
                z2 = ops.tri_solve(L, rr)
                ref = dd2d.tri_solve_ref(L, rr)
                e = rel(z, ref)
                same = torch.equal(z, z2)
                lim = 1e-12 if dtype == torch.float64 else 1e-4
                row = dict(dtype=str(dtype)[6:], P=int(L.shape[0]), n=n,
                           layout=layout, rel_vs_plain=e, bit_for_bit=same)
                out.append(row)
                print("random", row, flush=True)
                if not (e <= lim and same):
                    bad.append(row)
    return out


def spikes_case(bad):
    cfg = Config(energy="FCR", time_stepper="DOT", shape="spikes",
                 resolution=20000, ym=1e5, pr=0.4, rho=1000.0,
                 handle_ratio=0.03, dt=0.025, script="stretch",
                 partition_amt=4)
    mesh = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(mesh, cfg.script)
    mesh.fixed_mask = sd.fixed0.copy()
    plan = plan2d.build_plan_2d(mesh, 4)
    sysm = dim2.System2D(mesh, cfg, dtype=torch.float32, device="cuda",
                         plan=plan)
    x = torch.as_tensor(sd.x0, dtype=torch.float32, device="cuda")
    fixed = torch.as_tensor(sd.fixed0, device="cuda")
    _, L, d, _ = sysm.rebuild_h0(x, fixed)
    P, n = L.shape[0], L.shape[-1]
    rng = np.random.default_rng(5)
    g = torch.as_tensor(rng.normal(size=(sysm.n_vert, 3)),
                        dtype=torch.float32, device="cuda")
    r = ops.h0_gather2d(g, sysm.l2g, sysm.local_valid, d)
    z = sysm.solve_local(L, r)
    z2 = sysm.solve_local(L, r)
    lib = dd2d.tri_solve_ref(L, r)
    z64 = dd2d.tri_solve_ref(L.double(), r.double())
    e_k, e_lib = rel(z.double(), z64), rel(lib.double(), z64)
    i = 2
    zi = sysm.solve_local(L[i:i + 1], r[i:i + 1])
    e_slice = rel(zi.double(), z64[i:i + 1])
    work = profiling.captured_work(lambda: sysm.solve_local(L, r))
    entries = P * n * (n + 1) / 2
    bound_ms = (entries * 4 + 2 * P * n * 4) / HBM_BYTES_S * 1e3
    res = dict(P=P, n=n, layout="column" if not L.is_contiguous() else "row",
               rel_vs_f64=e_k, library_rel_vs_f64=e_lib,
               slice_rel_vs_f64=e_slice, ratio=e_k / e_lib,
               bit_for_bit=torch.equal(z, z2), device_work=work,
               ms=median_ms(lambda: sysm.solve_local(L, r)),
               back_to_back_ms=back_to_back_ms(
                   lambda: sysm.solve_local(L, r)),
               library_ms=median_ms(lambda: dd2d.tri_solve_ref(L, r)),
               library_back_to_back_ms=back_to_back_ms(
                   lambda: dd2d.tri_solve_ref(L, r)),
               slice_ms=median_ms(
                   lambda: sysm.solve_local(L[i:i + 1], r[i:i + 1])),
               bound_ms=bound_ms)
    res["roofline_pct"] = 100.0 * bound_ms / res["ms"]
    print("spikes", json.dumps(res), flush=True)
    if not (e_k <= 2 * e_lib and res["bit_for_bit"]
            and all("tri_solve" in k for k in work)
            and sum(work.values()) == 1):
        bad.append(res)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/trsolve.json")
    ap.add_argument("--no-spikes", action="store_true")
    a = ap.parse_args()
    dev = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("device", torch.cuda.get_device_name(0), "|", dev, flush=True)
    t0 = time.perf_counter()
    ops._load()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    with open(build.log_path("trsolve")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("ptxas", line.strip(), flush=True)
    bad = []
    rng = np.random.default_rng(20261018)
    out = dict(device=dev, random=random_cases(rng, bad))
    if not a.no_spikes:
        out["spikes"] = spikes_case(bad)
    out["bad"] = [str(b) for b in bad]
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print("ok" if not bad else f"FAILED {bad}", flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
