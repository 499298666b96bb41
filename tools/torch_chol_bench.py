"""K33 (ops.dense_chol, csrc/dense_chol.cu) on the card: the batched
dense Cholesky of the 2D H0 rebuild against its plain version (the
batched library Cholesky and its NaN passes, dd2d.dense_chol_ref).

- random SPD batches, f64 and f32, at widths on and off the tiles, P 1-4:
  error against the plain version (f64) or, in f32, against an f64
  factor of the same matrices beside the library's, bit for bit from run
  to run, exact zeros above the diagonal, one launch a call; a batch with
  one indefinite matrix (that one all NaN, the flag set, the others
  equal to the batch without it);
- the spikes scene's matrices (resolution 20,000, DOT 4: P 4, n 5,248,
  f32, at the scene's start): the same checks, the device work of one
  call (a CUDA graph capture), the time of one call (median of CUDA-event
  timings) and back to back, beside the plain version and the bound
  (P n^3 / 3 at the f32 rate); the P = 1, n 10,171 shape of the 2D PD
  factor timed too;
- nvcc's time for dense_chol.cu's two libraries (f32, f64) and for
  elem2d.cu (the longest source of the build), each alone with build.py's
  flags.

    python3 tools/torch_chol_bench.py [--out chiprun_out/chol.json] [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dot_tpu_torch import dim2, plan2d, profiling, scripts  # noqa: E402
from dot_tpu_torch.config import Config  # noqa: E402
from dot_tpu_torch.kernels import dd2d, ops  # noqa: E402
from dot_tpu_torch.kernels.csrc import build  # noqa: E402

F32_FLOP_S = 66.9e12


def rel(a, b):
    return float((a - b).norm() / b.norm())


def median_ms(fn, reps=10):
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


def back_to_back_ms(fn, reps=10):
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


def spd(P, n, rng):
    """(P, n, n) f64 SPD matrices on the card, Jacobi-equilibrated, with a
    garbage upper triangle (the kernel reads the lower one)."""
    a = torch.as_tensor(rng.normal(size=(P, n, n)), dtype=torch.float64,
                        device="cuda")
    A = a @ a.mT / n + 0.05 * torch.eye(n, dtype=torch.float64,
                                        device="cuda")
    d = torch.sqrt(A.diagonal(dim1=1, dim2=2))
    A = A / d[:, :, None] / d[:, None, :]
    return A + torch.triu(torch.full_like(A, 7.0), 1)


def checks(A, dtype, tag, bad, out, timed=False):
    """K33 on A (P, n, n) in `dtype` against the plain version."""
    Ad = A.to(dtype)
    P, n = Ad.shape[0], Ad.shape[-1]
    ops.reset_launches()
    L, flag = ops.dense_chol(Ad)
    L2, _ = ops.dense_chol(Ad)
    torch.cuda.synchronize()
    launches = ops.launches["dense_chol"]
    ref, ref_flag = dd2d.dense_chol_ref(Ad)
    row = dict(tag=tag, dtype=str(dtype)[6:], P=P, n=n,
               flag=bool(flag), plain_flag=bool(ref_flag),
               bit_for_bit=torch.equal(L, L2),
               upper_zero=bool((torch.triu(L, 1) == 0).all()),
               column_major=L.mT.is_contiguous(), launches=launches)
    if dtype == torch.float64:
        row["rel_vs_plain"] = rel(L, ref)
        ok = row["rel_vs_plain"] <= 1e-12
    else:
        L64, _ = dd2d.dense_chol_ref(torch.tril(Ad.double()))
        row["rel_vs_f64"] = rel(L.double(), L64)
        row["library_rel_vs_f64"] = rel(ref.double(), L64)
        row["ratio"] = row["rel_vs_f64"] / row["library_rel_vs_f64"]
        ok = row["ratio"] <= 1.5
        del L64
    ok = (ok and row["bit_for_bit"] and row["upper_zero"]
          and row["column_major"] and launches == 2 and not row["flag"]
          and not row["plain_flag"])
    if timed:
        row["device_work"] = profiling.captured_work(
            lambda: ops.dense_chol(Ad))
        row["ms"] = median_ms(lambda: ops.dense_chol(Ad))
        row["back_to_back_ms"] = back_to_back_ms(lambda: ops.dense_chol(Ad))
        row["plain_ms"] = median_ms(lambda: dd2d.dense_chol_ref(Ad))
        row["plain_back_to_back_ms"] = back_to_back_ms(
            lambda: dd2d.dense_chol_ref(Ad))
        row["bound_ms"] = P * n ** 3 / 3.0 / F32_FLOP_S * 1e3
        row["pct_of_f32_peak"] = 100.0 * row["bound_ms"] / row["ms"]
    print(tag, json.dumps(row), flush=True)
    out.append(row)
    if not ok:
        bad.append(row)
    del L, L2, ref


def indefinite(A, dtype, tag, bad, out):
    """One indefinite matrix in the batch: it alone all NaN, the flag set,
    the others bit for bit the batch without it."""
    Ad = A.to(dtype)
    Ai = Ad.clone()
    k = Ai.shape[-1] // 3
    Ai[1, k, k] = -1.0
    L, flag = ops.dense_chol(Ai)
    L0, flag0 = ops.dense_chol(Ad)
    others = [i for i in range(Ad.shape[0]) if i != 1]
    row = dict(tag=tag, dtype=str(dtype)[6:], flag=bool(flag),
               flag_without=bool(flag0),
               nan_all=bool(torch.isnan(L[1]).all()),
               others_equal=torch.equal(L[others], L0[others]))
    print(tag, json.dumps(row), flush=True)
    out.append(row)
    if not (row["flag"] and not row["flag_without"] and row["nan_all"]
            and row["others_equal"]):
        bad.append(row)


def spikes_matrices():
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
    eh = sysm.element_hessians(x)
    Hd, d = sysm.assemble_subdomains(eh, fixed)
    return sysm.k.subdomain_scale2d(Hd, d, sysm.asm_tab)


def compile_seconds(names=("dense_chol", "dense_chol64", "elem2d")):
    """{library: seconds} of each library's nvcc build alone, one after the
    other, with build.py's flags."""
    tmp = tempfile.mkdtemp()
    out = {}
    try:
        for name in names:
            src = os.path.join(os.path.dirname(build.__file__),
                               build.LIBRARIES[name][0][0])
            cmd = [build.nvcc_path(), *build._flags(name), "-o",
                   os.path.join(tmp, name + ".so"), src]
            t0 = time.perf_counter()
            subprocess.run(cmd, check=True, capture_output=True)
            out[name] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/chol.json")
    ap.add_argument("--quick", action="store_true",
                    help="small batches and the spikes shape only")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("device", dev, "|", smi, flush=True)
    ops._load()
    print("build s", build.last_build_seconds, flush=True)
    for lib in ("dense_chol", "dense_chol64", "elem2d"):
        with open(build.log_path(lib)) as f:
            lines = [ln.strip() for ln in f if "registers" in ln
                     or "spill" in ln or "Compiling entry" in ln]
        print(lib, "ptxas:", " | ".join(lines[-8:]), flush=True)
    rng = np.random.default_rng(33)
    bad, out = [], []
    small = ((2, 200), (1, 1000), (3, 333), (4, 128), (1, 7))
    for P, n in small:
        A = spd(P, n, rng)
        for dtype in (torch.float64, torch.float32):
            checks(A, dtype, f"random P{P} n{n}", bad, out)
    A = spd(4, 700, rng)
    for dtype in (torch.float64, torch.float32):
        indefinite(A, dtype, "indefinite P4 n700", bad, out)
    if not bad:
        Hn = spikes_matrices()
        checks(Hn, torch.float32, "spikes", bad, out, timed=True)
        indefinite(Hn, torch.float32, "spikes indefinite", bad, out)
        del Hn
        if not args.quick:
            A = spd(4, 5248, rng)
            checks(A, torch.float64, "random P4 n5248", bad, out, timed=True)
            checks(A, torch.float32, "random P4 n5248", bad, out, timed=True)
            del A
            A = spd(1, 10171, rng)
            checks(A, torch.float32, "random P1 n10171", bad, out,
                   timed=True)
            del A
    nvcc_s = None if args.quick else compile_seconds()
    print("nvcc s alone", nvcc_s, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=dev, smi=smi, rows=out, bad=bad,
                       nvcc_s=nvcc_s), f, indent=1)
    print("ok" if not bad else f"FAILED {len(bad)}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
