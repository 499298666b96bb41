#!/usr/bin/env python3
"""Smoke run of the dot_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases probe,build,kernels,golden,main,steppers,scale]

Phases (each prints its lines; any failure exits non-zero before the
result line):
  probe    device name, `nvidia-smi` name and power limit, nvcc and triton
  build    the CUDA sources of csrc/ (K1-K3 elem.cu, K5 band_asm.cu, K6
           chol_inv.cu, K7 and K15 block_matvec.cu, K8 and K16 h0.cu,
           K10-K11 coarse.cu, K12 band_equil.cu, K13 hdiag.cu, K14 and
           K15's permute passes pd.cu) with nvcc for sm_90a, one nvcc per
           source, all at once; K4 and K9 with Triton
  kernels  each kernel against its plain PyTorch version on the card at the
           bar17 shapes, f64 and f32, with max errors against the
           tolerances, median times, the time of one PyTorch library call
           computing the same function where there is one, and the bound
           (the larger of bytes / 3.35 TB/s and operations / the unit's
           peak): K1-K4 on random, inverted and near-degenerate
           deformations of the bar17 mesh (86,016 tets, 16,473 vertices)
           from a seed; K5-K8 on the real bar17 plan (P 6, nb 13, bs 768)
           and its assembled blocks: the band, the 36 odd diagonal blocks
           of the first cyclic-reduction level (K6 symmetrized, and its
           6-block root batch lower-only; one indefinite block must come
           back flagged and NaN), the factor's level blocks (K7 on bf16 and
           f32 storage in f32 runs; one subdomain's strided blocks read in
           place), the vertex gather and averaging; K13 on the same element
           Hessians, K16 on the same plan; K14 and K15 on the bar17 PD band
           (bs 512, nb 33): the assembled band, the solve's block products
           with 3 right-hand sides (each column equal to K7's) and its
           permute / scale passes
  golden   bar 8x3x3, DOT with 4 parts, f64, 5 frames: sysE against the
           recorded golden trace (rtol 2e-4)
  main     bar17 twist, DOT 6, f32, relTol 1e-5 through sim.Simulator:
           1 warm-up + 10 timed frames; convergence, the H0 factor's kind
           (cyclic reduction, 2 levels, bf16 leaves), kernel launch counts
           (K1-K9), output files; 3 more frames with the H0 rebuild and
           apply timed (synchronised); then 3 frames with the plain
           versions of the kernels on the same card (sysE rtol 1e-3)
  steppers bar17 twist, f32, relTol 1e-5, through sim.Simulator, 3 frames
           each (Newton 2): DOT 6 (the yardstick), LBFGS (LBFGS-PD: exact
           f32 P = 1 BTDFactor of the PD band; K14, K15), GSDD 6 (K16 and K7
           on one subdomain's blocks: 2 launches of K16 per subdomain per
           sweep), DOT 6 with warmStart 5 (K13 once a frame), Newton (one
           exact P = 1 banded factorization per inner iteration), LBFGSH,
           LBFGSHI (factor from a matrix rounded through bf16), LBFGSJH 6
           (node plan, dense blocks). Each run: finite sysE, stopped by tol
           or rel_dec, the factor's kind, its kernels launched, sysE against
           the plain-path run of the same frames (rtol 1e-3) and against
           DOT's (rtol 1e-3; LBFGSJH and GSDD 5e-3)
  scale    bar135 twist (131x31x31 cells, 755,346 tets, 135,168 vertices),
           `timeStepper DOT -1 1024` (tools/scalability.py's protocol),
           f32: mesh and plan built once (P 133, nb 8, bs 768; the coarse
           space and the chunked bf16 rebuild engage). Through
           sim.Simulator: 1 warm-up + 3 timed frames (P, coarse, chunked
           BTDFactor with bf16 leaves and kc_chol checked; every frame
           finite and stopped by tol or rel_dec; K9-K12 and K5's compact
           entry point launched), 2 more frames with the rebuild (elem H /
           coarse factor / compact / K12 / scan) and the apply (fine /
           coarse) timed; K9-K12 and K5's compact entry point against their
           plain versions on the real plan, owner map, element Hessians and
           L-BFGS history, and K6 and K7 at this path's own shapes (the
           (6P)^2 coarse block, the scan's lower-only (133, 768, 768)
           stage, the two mat-vecs on Lc^{-1}), f64 and f32, timed with
           library and bound; the first 2 frames again with the plain
           versions (sysE rtol 1e-3)
The last three lines are nvidia-smi's name and power limit, the kernels'
JSON record (per kernel: launches of all paths' runs and
launches_by_path {main, steppers, scale}; times at the bar17 shapes, and
under "bar135" K6's and K7's at the bar135 shapes) and {"ok": true, "device": {...}}. Exits
non-zero without a result line when no CUDA device is present.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# Recorded golden sysE trace of the bar 8x3x3 DOT twist (f64), copied from
# tests/test_golden.py:23-29 (the tests import jax, so this script cannot
# import them).
GOLDEN_SYS_E = [
    7.529949140714e+01,
    7.420914838503e+01,
    7.326224468377e+01,
    7.243233402989e+01,
    7.174690962232e+01,
]

BAR17 = (56, 16, 16)
SCENE_TMPL = """energy FCR
timeStepper DOT 6
warmStart 2
resolution 1000
size 1
time 5 0.025
density 1000
stiffness 100000 0.4
script twist
shape input {mesh_path}
"""
# kernel vs plain tolerances: f64 on sigma, Psi, the sums, F(p) and the
# gradient 1e-10, on H 1e-9; f32 1e-5 on sigma, Psi, the sums and F(p), and
# norm-wise 1e-4 on the gradient (atomics reorder its sums) and on H
TOL = {"float64": dict(elem=1e-10, grad=1e-10, hess=1e-9),
       "float32": dict(elem=1e-5, grad=1e-4, hess=1e-4)}
SOURCES = {
    "ls_trial_energy": ("cuda", "dot_tpu_torch/kernels/csrc/elem.cu",
                        "dot_tpu/steppers/quasi_newton.py:32"),
    "elem_gradient": ("cuda", "dot_tpu_torch/kernels/csrc/elem.cu",
                      "dot_tpu/kernels/soa.py:450"),
    "elem_hessian": ("cuda", "dot_tpu_torch/kernels/csrc/elem.cu",
                     "dot_tpu/kernels/soa.py:458"),
    "direction_pass": ("triton", "dot_tpu_torch/kernels/triton_qf.py",
                       "dot_tpu/steppers/core.py:1604"),
    "band_assemble": ("cuda", "dot_tpu_torch/kernels/csrc/band_asm.cu",
                      "dot_tpu/steppers/core.py:750"),
    "chol_inv": ("cuda", "dot_tpu_torch/kernels/csrc/chol_inv.cu",
                 "dot_tpu/steppers/core.py:904"),
    "block_matvec": ("cuda", "dot_tpu_torch/kernels/csrc/block_matvec.cu",
                     "dot_tpu/steppers/core.py:1061"),
    "h0_gather": ("cuda", "dot_tpu_torch/kernels/csrc/h0.cu",
                  "dot_tpu/steppers/core.py:1263"),
    "h0_average": ("cuda", "dot_tpu_torch/kernels/csrc/h0.cu",
                   "dot_tpu/steppers/core.py:1263"),
    "lbfgs_loop1": ("triton", "dot_tpu_torch/kernels/triton_lbfgs.py",
                    "dot_tpu/steppers/quasi_newton.py:116"),
    "lbfgs_loop2": ("triton", "dot_tpu_torch/kernels/triton_lbfgs.py",
                    "dot_tpu/steppers/quasi_newton.py:116"),
    "lbfgs_combine": ("triton", "dot_tpu_torch/kernels/triton_lbfgs.py",
                      "dot_tpu/steppers/quasi_newton.py:116"),
    "coarse_assemble": ("cuda", "dot_tpu_torch/kernels/csrc/coarse.cu",
                        "dot_tpu/steppers/core.py:1319"),
    "coarse_restrict": ("cuda", "dot_tpu_torch/kernels/csrc/coarse.cu",
                        "dot_tpu/steppers/core.py:1296"),
    "coarse_prolong": ("cuda", "dot_tpu_torch/kernels/csrc/coarse.cu",
                       "dot_tpu/steppers/core.py:1296"),
    "band_compact": ("cuda", "dot_tpu_torch/kernels/csrc/band_asm.cu",
                     "dot_tpu/steppers/core.py:733"),
    "band_equil_scatter": ("cuda", "dot_tpu_torch/kernels/csrc/band_equil.cu",
                           "dot_tpu/steppers/core.py:1465"),
    "hessian_diag": ("cuda", "dot_tpu_torch/kernels/csrc/hdiag.cu",
                     "dot_tpu/steppers/core.py:1587"),
    "pd_assemble": ("cuda", "dot_tpu_torch/kernels/csrc/pd.cu",
                    "dot_tpu/steppers/core.py:1656"),
    "block_matvec_k": ("cuda", "dot_tpu_torch/kernels/csrc/block_matvec.cu",
                       "dot_tpu/steppers/core.py:1224"),
    "pd_gather": ("cuda", "dot_tpu_torch/kernels/csrc/pd.cu",
                  "dot_tpu/steppers/core.py:1704"),
    "pd_scatter": ("cuda", "dot_tpu_torch/kernels/csrc/pd.cu",
                   "dot_tpu/steppers/core.py:1704"),
    "local_gather_one": ("cuda", "dot_tpu_torch/kernels/csrc/h0.cu",
                         "dot_tpu/steppers/core.py:1282"),
    "local_scatter_one": ("cuda", "dot_tpu_torch/kernels/csrc/h0.cu",
                          "dot_tpu/steppers/core.py:1287"),
}
# the card's peaks (H100 SXM data sheet)
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
# operations per element of K1-K3, counted from kernels/csrc/elem.cuh
# (the 3x3 SVD's Jacobi sweeps dominate); an estimate: these kernels are
# bound by their bytes by a wide margin either way
ELEM_FLOPS = dict(ls_trial_energy=900, elem_gradient=1100,
                  elem_hessian=4000)
BAR135 = (131, 31, 31)
SCALE_SCENE = SCENE_TMPL.replace("timeStepper DOT 6",
                                 "timeStepper DOT -1 1024")
# the entry points each path must launch (bar17: no coarse space, no
# chunked band; bar135 takes the chunked band instead of K5's band)
MAIN_KERNELS = ("ls_trial_energy", "elem_gradient", "elem_hessian",
                "direction_pass", "band_assemble", "chol_inv",
                "block_matvec", "h0_gather", "h0_average", "lbfgs_loop1",
                "lbfgs_loop2", "lbfgs_combine")
SCALE_KERNELS = tuple(k for k in MAIN_KERNELS if k != "band_assemble") + (
    "coarse_assemble", "coarse_restrict", "coarse_prolong", "band_compact",
    "band_equil_scatter")
# the steppers phase: (scene's timeStepper line, warmStart, frames, sysE rtol
# against DOT, the kernels the run must launch beyond the shared per-element
# passes). sysE against DOT: 1e-3 as tests/test_lbfgs_variants.py, 5e-3 for
# the block-Jacobi LBFGS-JH (there too) and for GSDD, whose sweeps meet the
# same gradient tolerance with more low-frequency error left (dot_tpu's own
# tests/test_admm.py:63 holds it at 3e-3 after 2 frames; it grows by frame)
_QN = ("lbfgs_loop1", "lbfgs_loop2", "lbfgs_combine")
_H0 = ("elem_hessian", "chol_inv", "block_matvec", "h0_gather", "h0_average")
STEPPER_RUNS = {
    "LBFGS": ("LBFGS", 2, 3, 1e-3, _QN + (
        "pd_assemble", "chol_inv", "block_matvec_k", "pd_gather",
        "pd_scatter")),
    "GSDD6": ("GSDD 6", 2, 3, 5e-3, (
        "elem_hessian", "band_assemble", "chol_inv", "block_matvec",
        "local_gather_one", "local_scatter_one")),
    "DOT6ws5": ("DOT 6", 5, 3, 1e-3, _QN + _H0 + ("band_assemble",
                                                  "hessian_diag")),
    "Newton": ("Newton", 2, 2, 1e-3, _H0 + ("band_assemble",)),
    "LBFGSH": ("LBFGSH", 2, 3, 1e-3, _QN + _H0 + ("band_assemble",)),
    "LBFGSHI": ("LBFGSHI", 2, 3, 1e-3, _QN + _H0 + ("band_assemble",)),
    "LBFGSJH6": ("LBFGSJH 6", 2, 3, 5e-3, _QN + (
        "elem_hessian", "chol_inv", "h0_gather", "h0_average")),
}
STEPPER_KERNELS = ("hessian_diag", "pd_assemble", "block_matvec_k",
                   "pd_gather", "pd_scatter", "local_gather_one",
                   "local_scatter_one")
# K9-K16 vs plain: f64 1e-12, f32 1e-5 max-rel and 1e-4 norm-wise (sums
# in another order); K12's bf16 band: at most 1 bf16 ulp apart
TOL_SCALE = {"float64": dict(elem=1e-12, sum=1e-12),
             "float32": dict(elem=1e-5, sum=1e-4)}
# K5-K8 vs plain: f64 1e-12 on K5, K7, K8 and 1e-10 on K6's L and L^{-1}
# (norm-wise); f32 1e-4 norm-wise (the plain versions' index_add_ and
# cuBLAS/cuSOLVER sum in other orders)
TOL_H0 = {"float64": dict(exact=1e-12, chol=1e-10),
          "float32": dict(exact=1e-4, chol=1e-4)}


class Fail(Exception):
    pass


def say(*a):
    print(*a, flush=True)


def nvidia_smi():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() \
            else f"nvidia-smi rc {r.returncode}"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def phase_probe(torch):
    import platform
    from dot_tpu_torch.kernels.csrc import build
    say(f"probe: device {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, python {platform.python_version()}")
    say(f"probe: nvidia-smi: {nvidia_smi()}")
    r = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                       text=True, timeout=60)
    rel = [ln for ln in r.stdout.splitlines() if "release" in ln]
    say(f"probe: nvcc: {rel[0].strip() if rel else r.stdout.strip()}")
    import triton
    say(f"probe: triton {triton.__version__}; g++ "
        f"{'present' if shutil.which('g++') else 'absent'}")


def phase_build(torch):
    from dot_tpu_torch.kernels import ops, triton_lbfgs, triton_qf
    from dot_tpu_torch.kernels.csrc import build
    t0 = time.perf_counter()
    ops._load()
    t1 = time.perf_counter()
    for lib in build.LIBRARIES:
        log = build.log_path(lib)
        if not os.path.exists(log):   # absent when already built
            continue
        name, spill = "?", ""
        with open(log) as f:
            for ln in f:
                m = re.search(r"Function properties for (_Z\w+)", ln)
                if m:
                    name = m.group(1)[:60]
                elif "spill stores" in ln:
                    spill = ln.strip()
                elif "Used" in ln and "registers" in ln:
                    regs = re.search(r"Used (\d+) registers", ln).group(1)
                    smem = re.search(r"(\d+) bytes smem", ln)
                    say(f"build: ptxas {lib} {name}: {regs} registers, "
                        f"{smem.group(1) if smem else 0} B static smem; "
                        f"{spill}")
    # K4: compile on a tiny input (the first launch of each variant
    # compiles it)
    dev = torch.device("cuda")
    for dt in (torch.float32, torch.float64):
        p = torch.zeros((4, 3), dtype=dt, device=dev)
        conn = torch.zeros((4, 2), dtype=torch.int32, device=dev)
        g9 = torch.zeros((9, 2), dtype=dt, device=dev)
        h = torch.zeros((144, 2), dtype=dt, device=dev)
        triton_qf.launch(p, conn, g9, None)
        triton_qf.launch(p, conn, g9, h)
        # K9: both dot variants, both finishers, both combine signs
        S = torch.zeros((5, 8), dtype=dt, device=dev)
        v = torch.zeros(8, dtype=dt, device=dev)
        rho = torch.ones(5, dtype=dt, device=dev)
        k, G = triton_lbfgs.launch_loop1(S, S, v, rho, rho)
        triton_lbfgs.launch_loop2(S, v, k, G, rho, rho)
        triton_lbfgs.launch_combine(v, k, S, True, True)
        triton_lbfgs.launch_combine(v, k, S, False, False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    say(f"build: nvcc {len(build.LIBRARIES)} sources in parallel "
        f"{t1 - t0:.1f} s (sm_90a), triton K4 and K9 {t2 - t1:.1f} s")


def _bar17_inputs(torch, dtype, rng):
    """Element statics of the bar17 mesh and deformed states: a third of
    the vertices jittered (random and inverted elements), a third squashed
    flat (near-degenerate F), the rest at rest (repeated sigma = 1)."""
    from dot_tpu_torch.mesh_gen import bar_mesh
    mesh = bar_mesh(*BAR17, size=(4.0, 1.0, 1.0))
    mesh.set_lame(1e5, 0.4)
    dev = torch.device("cuda")
    n, nv = mesh.n_elem, mesh.n_vert

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    x = mesh.V.copy()
    sel = rng.permutation(nv)
    a, b = sel[:nv // 3], sel[nv // 3: 2 * nv // 3]
    x[a] += rng.normal(scale=0.05, size=(len(a), 3))
    x[b, 1] = x[b, 1] * 1e-3
    f0 = np.empty((9, n))
    third = n // 3
    f0[:, :third] = rng.normal(size=(9, third))                   # random
    inv = np.eye(3).reshape(9, 1) + 0.1 * rng.normal(size=(9, third))
    inv[[0, 3, 6]] *= -1.0                                         # det < 0
    f0[:, third:2 * third] = inv
    m = n - 2 * third                                              # rank ~1
    uv = rng.normal(size=(3, m))[:, None] * rng.normal(size=(3, m))[None]
    f0[:, 2 * third:] = uv.reshape(9, m) + 1e-7 * rng.normal(size=(9, m))
    return dict(
        conn=t(mesh.conn.T, torch.int32),
        g9=t(mesh.rest_tri_inv.reshape(-1, 9).T),
        u=t(mesh.u), lam=t(mesh.lam), w=t(mesh.vol),
        x=t(x), p=t(rng.normal(scale=0.01, size=(nv, 3))),
        F0=t(f0), Fp=t(rng.normal(size=(9, n))),
        alpha=torch.tensor(0.5, dtype=dtype, device=dev))


def _median_ms(torch, fn, reps=15):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _time_pair(torch, kernel, plain):
    """(kernel ms, plain ms): medians, better of two rounds in the order
    plain, kernel, kernel, plain."""
    p1 = _median_ms(torch, plain)
    k1 = _median_ms(torch, kernel)
    k2 = _median_ms(torch, kernel)
    p2 = _median_ms(torch, plain)
    return min(k1, k2), min(p1, p2)


def _rel_max(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-300)


def _bound(nbytes, flops, rate=F32_FLOP_S):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the unit's peak."""
    tb = nbytes / HBM_BYTES_S * 1e3
    tf = flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _report(torch, tag, kname, checks, fns, cost, bad, record):
    """Time kernel / plain / library (fns: (kernel, plain, library or
    None)), print the checks against their limits and the times, and keep
    the f32 record (max_abs_err, ms, plain_ms, library_ms, bound)."""
    ms, plain_ms = _time_pair(torch, fns[0], fns[1])
    lib_ms = _median_ms(torch, fns[2]) if fns[2] is not None else None
    bound_ms, bound_by = _bound(*cost)
    parts = []
    for what, err, lim, _abs in checks:
        parts.append(f"{what} rel {err:.3e} (tol {lim:g})")
        if not err <= lim:
            bad.append(f"{kname} {tag} {what}: {err:.3e} > {lim:g}")
    lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
    say(f"kernels: {tag} {kname}: " + ", ".join(parts)
        + f"; {ms:.4f} ms vs plain {plain_ms:.4f} ms, library {lib}, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {cost[0] / 1e6:.1f} MB, "
        f"{cost[1] / 1e9:.3f} GFLOP)")
    if tag == "float32":
        abs_err = max(a for _, _, _, a in checks if a is not None)
        record[kname] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=lib_ms)


def phase_kernels(torch, record):
    from dot_tpu_torch.kernels import ops, soa
    mat = soa.FCR_SOA
    rng = np.random.default_rng(20261016)
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        d = _bar17_inputs(torch, dtype, rng)
        conn, g9, u, lam, w = d["conn"], d["g9"], d["u"], d["lam"], d["w"]
        dt_sq = 0.025 ** 2
        res = {}

        k = ops.ls_trial_energy(d["F0"], d["Fp"], d["alpha"], u, lam, w, mat,
                                want_sigma=True)
        r = soa.ls_trial_energy_ref(d["F0"], d["Fp"], d["alpha"], u, lam, w,
                                    mat, want_sigma=True)
        ps_k = mat.psi(tuple(k[1]), u, lam)
        ps_r = mat.psi(tuple(r[1]), u, lam)
        res["ls_trial_energy"] = [
            ("sum", _rel_max(k[0], r[0]), tol["elem"],
             float((k[0] - r[0]).abs())),
            ("sigma", _rel_max(k[1], r[1]), tol["elem"],
             float((k[1] - r[1]).abs().max())),
            ("psi", _rel_max(ps_k, ps_r), tol["elem"], None)]

        args = (d["x"], conn, conn, g9, u, lam, w, mat)
        gk, gr = ops.elem_gradient(*args), soa.elem_gradient_ref(*args)
        res["elem_gradient"] = [("grad", _rel_norm(gk, gr), tol["grad"],
                                 float((gk - gr).abs().max()))]

        hargs = (d["x"], conn, g9, u, lam, w, mat, dt_sq)
        hk, hr = ops.elem_hessian(*hargs), soa.elem_hessian_ref(*hargs)
        res["elem_hessian"] = [("H", _rel_norm(hk, hr), tol["hess"],
                                float((hk - hr).abs().max()))]

        fk, qk = ops.direction_pass(d["p"], conn, g9, hr)
        fr, qr = soa.direction_pass_ref(d["p"], conn, g9, hr)
        res["direction_pass"] = [
            ("F(p)", _rel_max(fk, fr), tol["elem"],
             float((fk - fr).abs().max())),
            ("pHp", _rel_max(qk, qr), tol["elem"], float((qk - qr).abs()))]
        torch.cuda.synchronize()

        # library yardstick of K2: the scatter of per-corner forces alone
        n, nv, sz = conn.shape[1], d["x"].shape[0], d["x"].element_size()
        forces = torch.randn((4 * n, 3), dtype=dtype, device="cuda")
        cidx = conn.reshape(-1).long()
        acc = torch.zeros((nv + 1, 3), dtype=dtype, device="cuda")
        times = {
            "ls_trial_energy": (
                lambda: ops.ls_trial_energy(d["F0"], d["Fp"], d["alpha"], u,
                                            lam, w, mat),
                lambda: soa.ls_trial_energy_ref(d["F0"], d["Fp"], d["alpha"],
                                                u, lam, w, mat), None),
            "elem_gradient": (lambda: ops.elem_gradient(*args),
                              lambda: soa.elem_gradient_ref(*args),
                              lambda: acc.index_add_(0, cidx, forces)),
            "elem_hessian": (lambda: ops.elem_hessian(*hargs),
                             lambda: soa.elem_hessian_ref(*hargs), None),
            "direction_pass": (
                lambda: ops.direction_pass(d["p"], conn, g9, hr),
                lambda: soa.direction_pass_ref(d["p"], conn, g9, hr), None),
        }
        # (bytes each input read once + outputs written once, operations)
        costs = {
            "ls_trial_energy": ((21 * n + 2) * sz,
                                ELEM_FLOPS["ls_trial_energy"] * n),
            "elem_gradient": ((3 * nv + 12 * n + 3 * (nv + 1)) * sz
                              + 32 * n, ELEM_FLOPS["elem_gradient"] * n),
            "elem_hessian": ((3 * nv + 12 * n + 144 * n) * sz + 16 * n,
                             ELEM_FLOPS["elem_hessian"] * n),
            "direction_pass": ((3 * nv + 9 * n + 144 * n + 9 * n + 1) * sz
                               + 16 * n, (144 * 3 + 2 * 27 + 9) * n),
        }
        bad = []
        for kname, checks in res.items():
            _report(torch, name, kname, checks, times[kname], costs[kname],
                    bad, record)
        if bad:
            raise Fail("kernel disagrees with its plain version: "
                       + "; ".join(bad))


def phase_golden(torch):
    from dot_tpu_torch import partition, scripts
    from dot_tpu_torch.config import Config
    from dot_tpu_torch.mesh_gen import bar_mesh
    from dot_tpu_torch.steppers import DOTStepper, System
    mesh = bar_mesh(8, 3, 3)
    cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script="twist", handle_ratio=0.05)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = scripts.init_script(mesh, "twist")
    mesh.fixed_mask = sd.fixed0.copy()
    plan = partition.build_plan(mesh, 4, pad_elem_to=16, pad_n3_to=48)
    stepper = DOTStepper(System(mesh, cfg, plan, dtype=torch.float64,
                                device="cuda"), sd)
    st = stepper.init_state()
    vals = []
    for _ in GOLDEN_SYS_E:
        st, (_stats, sys_e) = stepper.step(st)
        vals.append(sys_e)
    rel = np.abs(np.asarray(vals) / np.asarray(GOLDEN_SYS_E) - 1.0)
    say(f"golden: bar 8x3x3 DOT4 f64 sysE {['%.10e' % v for v in vals]}, "
        f"max rel {rel.max():.3e} (tol 2e-4)")
    if not rel.max() <= 2e-4:
        raise Fail(f"golden sysE off by {rel.max():.3e}")


def _bar_scene(tmp, cells=BAR17, tmpl=SCENE_TMPL, name="bar17"):
    """Write a bar mesh and its twist scene under tmp; return the scene
    path."""
    from dot_tpu_torch import io as meshio
    from dot_tpu_torch.mesh_gen import bar_mesh
    mesh = bar_mesh(*cells, size=(4.0, 1.0, 1.0))
    mesh_path = os.path.join(tmp, f"{name}.msh")
    meshio.save_tet_mesh(mesh_path, mesh.V, mesh.conn, mesh.SF)
    scene = os.path.join(tmp, f"{name}_twist.txt")
    with open(scene, "w") as f:
        f.write(tmpl.format(mesh_path=mesh_path))
    return scene



def _simulator(torch, scene, out_root, suffix="", **kw):
    """The Simulator run_script would build for `scene` (f32 on the card)."""
    from dot_tpu_torch.config import Config
    from dot_tpu_torch.sim import Simulator
    cfg = Config.load(scene)
    name = cfg.output_folder_name() + (f"_{suffix}" if suffix else "")
    return Simulator(cfg, os.path.join(out_root, name), dtype=torch.float32,
                     device="cuda", mute=True,
                     search_dirs=(os.path.dirname(scene),), **kw)


def phase_h0_kernels(torch, record):
    """K5-K8, K13 and K16 against their plain versions on the bar17 plan
    and blocks."""
    from dot_tpu_torch.kernels import band, ops, pd
    from dot_tpu_torch.steppers import System
    tmp = tempfile.mkdtemp(prefix="dot_smoke_k_")
    try:
        sim = _simulator(torch, _bar_scene(tmp), os.path.join(tmp, "out"))
        mesh, cfg, plan = sim.mesh, sim.cfg, sim.system.plan
        x0 = sim.state.x.detach().cpu().numpy().astype(np.float64)
        fixed = sim.state.fixed
        sim.finalize()
        del sim
        rng = np.random.default_rng(20261017)
        x_np = x0 + 0.01 * rng.normal(size=x0.shape)
        bad = []
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split(".")[-1]
            tol, ts = TOL_H0[name], TOL_SCALE[name]
            sysm = System(mesh, cfg, plan, dtype=dtype, device="cuda")
            x = torch.as_tensor(x_np, dtype=dtype, device="cuda")
            eh = sysm.element_hessians(x)
            freef = sysm._free(fixed).to(dtype).reshape(-1)
            res, times = {}, {}

            # K5
            bp = sysm.band_plan
            fk = ops.band_assemble(eh, freef, sysm.mass_flat, bp)
            fr = band.band_assemble_ref(eh, freef, sysm.mass_flat, bp)
            res["band_assemble"] = [("band", _rel_norm(fk, fr), tol["exact"],
                                     float((fk - fr).abs().max()))]
            times["band_assemble"] = (
                lambda: ops.band_assemble(eh, freef, sysm.mass_flat, bp),
                lambda: band.band_assemble_ref(eh, freef, sysm.mass_flat, bp),
                None)
            sz = eh.element_size()
            n_ub, n_asm = bp.ub_row.shape[0], bp.src_block.shape[0]
            costs = {"band_assemble": (
                eh.numel() * sz + 16 * n_asm + 8 * (n_ub + 1) + 16 * n_ub
                + 2 * freef.numel() * sz + 72 * n_ub
                + 8 * bp.pad_diag.numel() + bp.total * sz, 9 * n_asm)}
            P, nb, bs = sysm.n_parts, sysm.band_nb, sysm.band_bs
            diag = fk[:P * nb * bs * bs].view(nb, P, bs, bs)
            sub = fk[P * nb * bs * bs:].view(nb - 1, P, bs, bs)
            del fr

            # K6: the first CR level's odd blocks (symmetrized) and the
            # root-size batch (lower only), equilibrated as the rebuild does
            dsq = torch.sqrt(diag.diagonal(dim1=-2, dim2=-1))
            dg = diag / dsq[..., :, None] / dsq[..., None, :]
            A_odd = dg[1::2].reshape(-1, bs, bs).contiguous()
            A_root = dg[0].contiguous()
            Lk, Xk, bk = ops.chol_inv(A_odd, True)
            Lr, Xr, br = band.chol_inv_ref(A_odd, True)
            Lk2, Xk2, _ = ops.chol_inv(A_root, False)
            Lr2, Xr2, _ = band.chol_inv_ref(A_root, False)
            res["chol_inv"] = [
                ("L", _rel_norm(Lk, Lr), tol["chol"],
                 float((Lk - Lr).abs().max())),
                ("Linv", _rel_norm(Xk, Xr), tol["chol"],
                 float((Xk - Xr).abs().max())),
                ("L root", _rel_norm(Lk2, Lr2), tol["chol"], None),
                ("Linv root", _rel_norm(Xk2, Xr2), tol["chol"], None)]
            if bool(bk.any()) or bool(br.any()):
                bad.append(f"chol_inv {name}: an SPD block was flagged")
            indef = A_root.clone()
            indef[3, 5, 5] = -1.0
            Li_, Xi_, bi = ops.chol_inv(indef, False)
            _, _, bi_ref = band.chol_inv_ref(indef, False)
            flag_ok = (bi.tolist() == [k == 3 for k in range(P)]
                       and bi_ref.tolist() == bi.tolist()
                       and bool(torch.isnan(Li_[3]).all())
                       and bool(torch.isnan(Xi_[3]).all())
                       and bool(torch.isfinite(Li_[:3]).all()))
            say(f"kernels: {name} chol_inv indefinite block: flags "
                f"{bi.tolist()} (plain {bi_ref.tolist()}), NaN block "
                f"{bool(torch.isnan(Li_[3]).all())}")
            if not flag_ok:
                bad.append(f"chol_inv {name}: indefinite block not flagged")
            eye_b = torch.eye(bs, dtype=dtype, device="cuda")

            def lib_chol():
                Lq = torch.linalg.cholesky(A_odd)
                return torch.linalg.solve_triangular(Lq, eye_b, upper=False)
            times["chol_inv"] = (lambda: ops.chol_inv(A_odd, True),
                                 lambda: band.chol_inv_ref(A_odd, True),
                                 lib_chol)
            costs["chol_inv"] = (3 * A_odd.numel() * sz,
                                 A_odd.shape[0] * 2 * bs ** 3 / 3)
            del Lk, Xk, Lr, Xr, Li_, Xi_, indef

            # K7 on the factor's first level (bf16 leaves in f32 runs)
            fac, d = sysm.factorize((diag, sub), fast=True)
            Li0, G_lo = fac.levels[0][0], fac.levels[0][1]
            n_odd = Li0.shape[0]
            A7 = G_lo.reshape(-1, bs, bs)
            v = torch.as_tensor(rng.normal(size=(n_odd * P, bs)),
                                dtype=dtype, device="cuda")
            c = torch.as_tensor(rng.normal(size=(n_odd * P, bs)),
                                dtype=dtype, device="cuda")
            checks = []
            stores = [A7] + ([A7.to(torch.float32)] if dtype ==
                             torch.float32 else [])
            for A in stores:
                for trans in (False, True):
                    k_ = ops.block_matvec(A, v, c, trans)
                    r_ = band.block_matvec_ref(A, v, c, trans)
                    checks.append((f"{str(A.dtype).split('.')[-1]}"
                                   f"{'^T' if trans else ''}",
                                   _rel_norm(k_, r_), tol["exact"],
                                   float((k_ - r_).abs().max())))
            # one subdomain's blocks of the scan-major leaf, read in place
            # (the GSDD sweep): equal to K7 on a contiguous copy of them
            part_i = P - 2
            A_s = G_lo[:, part_i]
            v_s, c_s = v[:n_odd].contiguous(), c[:n_odd].contiguous()
            for trans in (False, True):
                k_ = ops.block_matvec(A_s, v_s, c_s, trans)
                r_ = ops.block_matvec(A_s.contiguous(), v_s, c_s, trans)
                checks.append((f"strided{'^T' if trans else ''} "
                               f"(batch stride {A_s.stride(0)})",
                               _rel_max(k_, r_), 0.0,
                               float((k_ - r_).abs().max())))
            if A_s.is_contiguous() or A_s.data_ptr() != (
                    G_lo.data_ptr() + part_i * bs * bs * G_lo.element_size()):
                bad.append(f"block_matvec {name}: the subdomain slice is "
                           "not a view of the leaf")
            res["block_matvec"] = checks
            A7_up = A7.to(dtype)
            times["block_matvec"] = (
                lambda: ops.block_matvec(A7, v, c, True),
                lambda: band.block_matvec_ref(A7, v, c, True),
                lambda: torch.bmm(A7_up.mT, v[..., None]))
            costs["block_matvec"] = (A7.numel() * A7.element_size()
                                     + 3 * v.numel() * sz, 2 * A7.numel())

            # K8
            rhs = torch.as_tensor(rng.normal(size=(sysm.n_vert, 3)),
                                  dtype=dtype, device="cuda")
            z = torch.as_tensor(rng.normal(size=(P, sysm.n3)), dtype=dtype,
                                device="cuda")
            g_args = (rhs, sysm.l2g, sysm.local_valid, d)
            a_args = (z, d, sysm.gath_perm, sysm.gath_segids, sysm.gath_off,
                      sysm.dup)
            gk, gr = ops.h0_gather(*g_args), band.h0_gather_ref(*g_args)
            ak, ar = ops.h0_average(*a_args), band.h0_average_ref(*a_args)
            res["h0_gather"] = [("r", _rel_norm(gk, gr), tol["exact"],
                                 float((gk - gr).abs().max()))]
            res["h0_average"] = [("p", _rel_norm(ak, ar), tol["exact"],
                                  float((ak - ar).abs().max()))]
            pl = (z / d).reshape(-1, 3)[sysm.gath_perm]
            acc8 = torch.zeros((sysm.n_vert + 1, 3), dtype=dtype,
                               device="cuda")
            times["h0_gather"] = (lambda: ops.h0_gather(*g_args),
                                  lambda: band.h0_gather_ref(*g_args), None)
            times["h0_average"] = (
                lambda: ops.h0_average(*a_args),
                lambda: band.h0_average_ref(*a_args),
                lambda: acc8.index_add_(0, sysm.gath_segids, pl))
            nl = sysm.l2g.numel()
            costs["h0_gather"] = ((rhs.numel() + 6 * nl) * sz + 9 * nl,
                                  6 * nl)
            costs["h0_average"] = ((6 * nl + 4 * sysm.n_vert) * sz + 8 * nl
                                   + 8 * (sysm.n_vert + 2), 6 * nl)

            # K13 on the same element Hessians
            h_args = (eh, sysm.scat_perm, sysm.scat_segids, sysm.scat_off,
                      sysm.mass)
            hk, hr = ops.hessian_diag(*h_args), pd.hessian_diag_ref(*h_args)
            res["hessian_diag"] = [("diag", _rel_max(hk, hr), ts["elem"],
                                    float((hk - hr).abs().max()))]
            n_ep, nv = eh.shape[1], sysm.n_vert
            rows12 = torch.stack([eh[(cc * 4 + cc) * 9 + 4 * i]
                                  for cc in range(4) for i in range(3)]
                                 ).view(4, 3, n_ep).permute(2, 0, 1) \
                .reshape(-1, 3).contiguous()
            cidx = sysm.conn_s.t().reshape(-1).long()
            acc13 = torch.zeros((nv + 1, 3), dtype=dtype, device="cuda")
            times["hessian_diag"] = (
                lambda: ops.hessian_diag(*h_args),
                lambda: pd.hessian_diag_ref(*h_args),
                lambda: acc13.index_add_(0, cidx, rows12))
            costs["hessian_diag"] = (
                12 * n_ep * sz + 8 * 4 * n_ep + 8 * (nv + 2) + 4 * nv * sz,
                12 * n_ep + 3 * nv)

            # K16 on one subdomain of the same plan
            nloc = sysm.n3 // 3
            z1 = z[part_i].contiguous()
            lg_args = (rhs, sysm.l2g, sysm.local_valid, d, part_i)
            ls_args = (z1, d, sysm.l2g, sysm.local_valid, part_i, nv)
            gk1 = ops.local_gather_one(*lg_args)
            gr1 = pd.local_gather_one_ref(*lg_args)
            sk1 = ops.local_scatter_one(*ls_args)
            sr1 = pd.local_scatter_one_ref(*ls_args)
            res["local_gather_one"] = [
                ("r", _rel_max(gk1, gr1), ts["elem"],
                 float((gk1 - gr1).abs().max())),
                ("row of K8's gather", _rel_max(gk1, gk[part_i]), 0.0, None)]
            res["local_scatter_one"] = [("p", _rel_max(sk1, sr1), ts["elem"],
                                         float((sk1 - sr1).abs().max()))]
            times["local_gather_one"] = (
                lambda: ops.local_gather_one(*lg_args),
                lambda: pd.local_gather_one_ref(*lg_args), None)
            times["local_scatter_one"] = (
                lambda: ops.local_scatter_one(*ls_args),
                lambda: pd.local_scatter_one_ref(*ls_args), None)
            costs["local_gather_one"] = (9 * nloc * sz + 9 * nloc, 6 * nloc)
            costs["local_scatter_one"] = ((6 * nloc + 3 * nv) * sz + 9 * nloc,
                                          3 * nloc)
            torch.cuda.synchronize()

            for kname, checks in res.items():
                _report(torch, name, kname, checks, times[kname],
                        costs[kname], bad, record)
            say(f"kernels: {name} shapes: band {tuple(diag.shape)} + "
                f"{tuple(sub.shape)}, K6 batches {tuple(A_odd.shape)} and "
                f"{tuple(A_root.shape)}, K7 {tuple(A7.shape)} "
                f"{A7.dtype}, K8 rhs {tuple(rhs.shape)} -> r "
                f"{tuple(gk.shape)}")
            del sysm, fac, eh, fk, diag, sub, dg, A_odd
            torch.cuda.empty_cache()
        if bad:
            raise Fail("kernel disagrees with its plain version: "
                       + "; ".join(bad))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _h0_split(sim, frames, names=("rebuild_h0", "h0_apply")):
    """ms/frame of each System method in `names` over `frames` more frames,
    each call wrapped in synchronised host timers."""
    import collections
    from dot_tpu_torch.profiling import wrap_timed
    acc = collections.Counter()
    for name in names:
        wrap_timed(sim.system, name, acc)
    try:
        sim.run(frames)
    finally:
        for name in names:
            delattr(sim.system, name)
    return {k: acc[k] / frames * 1e3 for k in names}


def phase_main(torch, launches_out):
    from dot_tpu_torch.kernels import ops
    from dot_tpu_torch.steppers.core import CRFactor, factor_leaves
    tmp = tempfile.mkdtemp(prefix="dot_smoke_")
    try:
        scene = _bar_scene(tmp)
        out_root = os.path.join(tmp, "out")

        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        sim = _simulator(torch, scene, out_root)
        sim.run(11)
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        launches_out["main"] = launches
        fac = sim.state.chol
        kind = type(fac).__name__
        n_levels = len(fac.levels) if isinstance(fac, CRFactor) else 0
        leaf_dt = sorted({str(t.dtype).split(".")[-1]
                          for t in factor_leaves(fac)})
        split = _h0_split(sim, 3)
        sim.finalize()

        fr = sim.frames
        timed = fr[1:11]
        spf = float(np.mean([r["seconds"] for r in timed]))
        say(f"main: bar17 twist DOT{sim.system.n_parts} f32: "
            f"{sim.mesh.n_elem} tets, {sim.mesh.n_vert} verts, "
            f"n3 {sim.system.n3}, banded {sim.system.banded} "
            f"(nb {sim.system.band_nb}, bs {sim.system.band_bs}); "
            f"Simulator + 11 frames wall {wall:.2f} s")
        say(f"main: H0 factor {kind}, {n_levels} cyclic-reduction levels, "
            f"leaves {leaf_dt}")
        say(f"main: s/frame {spf:.5f} (10 timed frames after 1 warm-up; "
            f"warm-up {fr[0]['seconds']:.3f} s); iters/frame "
            f"{np.mean([r['iters'] for r in timed]):.2f}; LS halvings/frame "
            f"{np.mean([r['halvings'] for r in timed]):.2f}; syncs/frame "
            f"{np.mean([r['syncs'] for r in timed]):.2f}; peak device memory "
            f"{peak / 2**20:.1f} MiB")
        say(f"main: synchronised split over 3 more frames: rebuild_h0 "
            f"{split['rebuild_h0']:.2f} ms/frame, h0_apply "
            f"{split['h0_apply']:.2f} ms/frame (iters "
            f"{[r['iters'] for r in fr[11:]]})")
        say("main: per frame (iters, halvings, syncs, stop, s): "
            + "; ".join(f"{r['iters']},{r['halvings']},{r['syncs']},"
                        f"{r['stop']},{r['seconds']:.3f}" for r in fr))
        say("main: sysE " + " ".join("%.10e" % r["sys_e"] for r in fr))
        say(f"main: kernel launches {launches}")
        problems = []
        for r in fr:
            if not np.isfinite(r["sys_e"]):
                problems.append(f"frame {r['frame']} sysE not finite")
            if r["stop"] not in ("tol", "rel_dec"):
                problems.append(f"frame {r['frame']} stopped by {r['stop']}")
        for k in MAIN_KERNELS:
            if launches[k] <= 0:
                problems.append(f"kernel {k} never launched on the main path")
        if kind != "CRFactor" or n_levels != 2 or leaf_dt != ["bfloat16"]:
            problems.append(f"H0 factor {kind} with {n_levels} levels and "
                            f"{leaf_dt} leaves, not CR with 2 and bf16")
        out = sim.out
        need = ["config.txt", "iterStats.txt", "log.txt", "info.txt",
                "finalResult_mesh.msh", "status0", "0.obj",
                f"status{sim.frame}", f"{sim.frame}.obj"]
        missing = [f for f in need if not os.path.exists(os.path.join(out, f))]
        if missing:
            problems.append(f"missing outputs {missing}")
        with open(os.path.join(out, "log.txt")) as f:
            n_syse = sum(1 for ln in f if ln.startswith("sysE = "))
        if n_syse != len(fr):
            problems.append(f"log.txt has {n_syse} sysE lines")
        if problems:
            raise Fail("main path: " + "; ".join(problems))

        # the same 3 first frames with the plain versions on the card
        ref = _simulator(torch, scene, out_root, suffix="plain",
                         use_kernels=False)
        ref.run(3)
        ref.finalize()
        a = np.asarray([r["sys_e"] for r in fr[:3]])
        b = np.asarray([r["sys_e"] for r in ref.frames])
        rel = np.abs(a / b - 1.0)
        say(f"main: plain-path sysE {' '.join('%.10e' % v for v in b)}; "
            f"max rel vs kernels {rel.max():.3e} (tol 1e-3); plain "
            f"s/frame {np.mean([r['seconds'] for r in ref.frames]):.5f}; "
            f"plain iters {[r['iters'] for r in ref.frames]}")
        if not rel.max() <= 1e-3:
            raise Fail(f"kernel path and plain path disagree: {rel.max():.3e}")
        return spf
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _scene_variant(scene, name, stepper, warm=2):
    """A copy of the DOT 6 scene file with another timeStepper line and
    warmStart; returns its path."""
    with open(scene) as f:
        text = f.read()
    text = text.replace("timeStepper DOT 6", f"timeStepper {stepper}") \
        .replace("warmStart 2", f"warmStart {warm}")
    path = os.path.join(os.path.dirname(scene), f"{name}.txt")
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_pd_kernels(torch, record):
    """K14 and K15 against their plain versions on the bar17 PD band."""
    from dot_tpu_torch.kernels import ops, pd
    from dot_tpu_torch.steppers import System
    from dot_tpu_torch.steppers.core import BTDFactor
    tmp = tempfile.mkdtemp(prefix="dot_smoke_pd_")
    try:
        sim = _simulator(torch, _scene_variant(_bar_scene(tmp), "pd", "LBFGS"),
                         os.path.join(tmp, "out"))
        mesh, cfg, fixed = sim.mesh, sim.cfg, sim.state.fixed
        sim.finalize()
        del sim
        rng = np.random.default_rng(20261018)
        bad = []
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split(".")[-1]
            tol = TOL_SCALE[name]
            sysm = System(mesh, cfg, None, dtype=dtype, device="cuda")
            bp = sysm.pd_band_plan
            w = sysm._pd_weights()
            free = torch.logical_not(fixed).to(dtype)
            sz = w.element_size()
            res, times, costs = {}, {}, {}

            a_args = (sysm.g9, sysm.conn, w, free, sysm.mass, bp)
            fk, fr = ops.pd_assemble(*a_args), pd.pd_assemble_ref(*a_args)
            res["pd_assemble"] = [
                ("band", _rel_norm(fk, fr), tol["sum"],
                 float((fk - fr).abs().max())),
                ("band max", _rel_max(fk, fr), tol["elem"], None)]
            vals = pd.pd_pair_vals_ref(sysm.g9, sysm.conn, w, free
                                       ).reshape(-1)
            acc = torch.zeros(bp.total + 1, dtype=dtype, device="cuda")
            times["pd_assemble"] = (
                lambda: ops.pd_assemble(*a_args),
                lambda: pd.pd_assemble_ref(*a_args),
                lambda: acc.index_add_(0, bp.dest, vals))
            n_ep, nv, n_it = sysm.n_elem_p, sysm.n_vert, bp.items.numel()
            # the kept items once (8 B), each element's g9, w and conn once,
            # free and mass, the run tables, and the band written once
            costs["pd_assemble"] = (
                8 * n_it + (10 * sz + 16) * n_ep + 2 * nv * sz
                + 16 * bp.udest.numel() + 8 * nv + 8 * bp.pad_dest.numel()
                + bp.total * sz, 20 * n_it)
            del fr

            L, d = sysm.build_pd_factor(fixed)
            if not isinstance(L, BTDFactor) or L.linv.shape[1] != 1 \
                    or L.linv.dtype != dtype:
                bad.append(f"pd factor {name}: {type(L).__name__}")
            nb, bs = L.linv.shape[0], L.linv.shape[2]
            # K15 at the solve's shape: one block, 3 right-hand sides
            A1 = L.linv[nb // 2]                                 # (1, bs, bs)
            v3 = torch.as_tensor(rng.normal(size=(1, bs, 3)), dtype=dtype,
                                 device="cuda")
            c3 = torch.as_tensor(rng.normal(size=(1, bs, 3)), dtype=dtype,
                                 device="cuda")
            checks = []
            Aall = L.linv.view(nb, bs, bs)
            vall = torch.as_tensor(rng.normal(size=(nb, bs, 3)), dtype=dtype,
                                   device="cuda")
            for trans in (False, True):
                k_ = ops.block_matvec_k(Aall, vall, vall, trans)
                r_ = pd.block_matvec_k_ref(Aall, vall, vall, trans)
                checks.append(("A^T" if trans else "A", _rel_norm(k_, r_),
                               tol["sum"], float((k_ - r_).abs().max())))
                k1 = ops.block_matvec_k(A1, v3, c3, trans)
                worst = 0.0
                for j in range(3):
                    col = ops.block_matvec(A1, v3[..., j].contiguous(),
                                           c3[..., j].contiguous(), trans)
                    worst = max(worst, float((k1[..., j] - col).abs().max()))
                checks.append((f"columns vs K7{'^T' if trans else ''}",
                               worst, 0.0, None))
            if dtype == torch.float32:
                Ab = Aall.to(torch.bfloat16)
                k_ = ops.block_matvec_k(Ab, vall, None, True)
                r_ = pd.block_matvec_k_ref(Ab, vall, None, True)
                checks.append(("bf16^T", _rel_norm(k_, r_), tol["sum"], None))
            res["block_matvec_k"] = checks
            times["block_matvec_k"] = (
                lambda: ops.block_matvec_k(A1, v3, c3, True),
                lambda: pd.block_matvec_k_ref(A1, v3, c3, True),
                lambda: torch.bmm(A1.mT, v3))
            costs["block_matvec_k"] = ((bs * bs + 9 * bs) * sz, 6 * bs * bs)

            rhs = torch.as_tensor(rng.normal(size=(nv, 3)), dtype=dtype,
                                  device="cuda")
            zz = torch.as_tensor(rng.normal(size=(bp.nv_p, 3)), dtype=dtype,
                                 device="cuda")
            gk, gr = ops.pd_gather(rhs, bp.inv, d[0]), \
                pd.pd_gather_ref(rhs, bp.inv, d[0])
            sk, sr = ops.pd_scatter(zz, bp.perm, d[0]), \
                pd.pd_scatter_ref(zz, bp.perm, d[0])
            res["pd_gather"] = [("r", _rel_max(gk, gr), tol["elem"],
                                 float((gk - gr).abs().max()))]
            res["pd_scatter"] = [("p", _rel_max(sk, sr), tol["elem"],
                                  float((sk - sr).abs().max()))]
            times["pd_gather"] = (lambda: ops.pd_gather(rhs, bp.inv, d[0]),
                                  lambda: pd.pd_gather_ref(rhs, bp.inv, d[0]),
                                  None)
            times["pd_scatter"] = (
                lambda: ops.pd_scatter(zz, bp.perm, d[0]),
                lambda: pd.pd_scatter_ref(zz, bp.perm, d[0]), None)
            costs["pd_gather"] = ((3 * nv + 4 * bp.nv_p) * sz + 8 * bp.nv_p,
                                  3 * bp.nv_p)
            costs["pd_scatter"] = ((3 * nv + 4 * bp.nv_p) * sz + 8 * nv,
                                   3 * nv)

            # the whole solve: kernels against the plain versions
            plain = System(mesh, cfg, None, dtype=dtype, device="cuda",
                           use_kernels=False)
            plain._pd_plan = bp
            zk = sysm.pd_solve(L, d, rhs)
            zr = plain.pd_solve(L, d, rhs)
            solve_err = _rel_norm(zk, zr)
            if not solve_err <= tol["sum"]:
                bad.append(f"pd_solve {name}: {solve_err:.3e}")
            torch.cuda.synchronize()
            for kname, checks in res.items():
                _report(torch, name, kname, checks, times[kname],
                        costs[kname], bad, record)
            say(f"kernels: {name} PD band: bs {bs}, nb {nb}, nv_p {bp.nv_p}, "
                f"{n_it} items into {bp.udest.numel()} slots of "
                f"{bp.total}; factor {type(L).__name__} {L.linv.dtype}; "
                f"pd_solve kernels vs plain rel {solve_err:.3e}")
            del sysm, plain, L, fk, Aall, vals, acc
            torch.cuda.empty_cache()
        if bad:
            raise Fail("kernel disagrees with its plain version: "
                       + "; ".join(bad))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _factor_kind(fac):
    from dot_tpu_torch.steppers.core import factor_leaves
    dts = sorted({str(t.dtype).split(".")[-1] for t in factor_leaves(fac)})
    shape = tuple(factor_leaves(fac)[0].shape)
    return type(fac).__name__, dts, shape


def phase_steppers(torch, launches_out):
    """The non-ADMM steppers and warmStart 5 at bar17 through Simulator."""
    from dot_tpu_torch.kernels import ops
    tmp = tempfile.mkdtemp(prefix="dot_steppers_")
    try:
        base = _bar_scene(tmp)
        out_root = os.path.join(tmp, "out")
        dot = _simulator(torch, base, out_root, suffix="ref",
                         save_every=10 ** 9)
        dot.run(3)
        dot.finalize()
        e_dot = np.asarray([r["sys_e"] for r in dot.frames])
        say(f"steppers: DOT6 warmStart 2 yardstick: iters "
            f"{[r['iters'] for r in dot.frames]}, sysE "
            + " ".join("%.10e" % v for v in e_dot))
        del dot
        torch.cuda.empty_cache()
        total = dict.fromkeys(ops.KERNELS, 0)
        problems = []
        for tag, (stepper, warm, frames, e_tol, need) in STEPPER_RUNS.items():
            scene = _scene_variant(base, tag, stepper, warm)
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            sim = _simulator(torch, scene, out_root, save_every=10 ** 9)
            t1 = time.perf_counter()
            sim.run(frames)
            launches = dict(ops.launches)
            peak = torch.cuda.max_memory_allocated()
            for k, v in launches.items():
                total[k] += v
            sysm, fr = sim.system, sim.frames
            fac = sim.state.chol
            if tag == "Newton":   # its per-iteration factor, built once more
                fac = sim.stepper.factor(sim.state.x, sim.state.fixed)[0]
            kind, leaf_dt, shape = _factor_kind(fac)
            del fac
            sim.finalize()
            timed = fr[1:] or fr
            say(f"steppers: {tag}: {type(sim.stepper).__name__}, P "
                f"{sysm.n_parts}, n3 {sysm.n3}, banded {sysm.banded} (nb "
                f"{sysm.band_nb}, bs {sysm.band_bs}), factor {kind} "
                f"{leaf_dt} {shape}; Simulator {t1 - t0:.2f} s; s/frame "
                f"{np.mean([r['seconds'] for r in timed]):.5f} "
                f"({len(timed)} frames after 1 warm-up of "
                f"{fr[0]['seconds']:.3f} s); peak {peak / 2**20:.1f} MiB")
            say(f"steppers: {tag}: per frame (iters, halvings, syncs, stop, "
                "s): " + "; ".join(
                    f"{r['iters']},{r['halvings']},{r['syncs']},{r['stop']},"
                    f"{r['seconds']:.3f}" for r in fr))
            say(f"steppers: {tag}: launches "
                f"{ {k: v for k, v in launches.items() if v} }")
            for r in fr:
                if not np.isfinite(r["sys_e"]):
                    problems.append(f"{tag} frame {r['frame']} sysE not "
                                    "finite")
                if r["stop"] not in ("tol", "rel_dec"):
                    problems.append(f"{tag} frame {r['frame']} stopped by "
                                    f"{r['stop']}")
            for k in need + ("ls_trial_energy", "elem_gradient",
                             "direction_pass"):
                if launches[k] <= 0:
                    problems.append(f"{tag}: kernel {k} never launched")
            iters = sum(r["iters"] for r in fr)
            if tag == "LBFGS":
                bp = sysm.pd_band_plan
                say(f"steppers: LBFGS: PD band bs {bp.bs}, nb {bp.nb}; "
                    f"K14 {launches['pd_assemble']} launch, K15 "
                    f"{launches['block_matvec_k'] / max(iters, 1):.1f} "
                    f"products and {launches['pd_gather'] / max(iters, 1):.1f}"
                    " gather per iteration")
                if (kind != "BTDFactor" or leaf_dt != ["float32"]
                        or shape[1] != 1 or launches["pd_assemble"] != 1
                        or launches["pd_gather"] != iters):
                    problems.append(f"LBFGS: factor {kind} {leaf_dt} "
                                    f"{shape}, launches {launches}")
            if tag == "GSDD6":
                want = 2 * sysm.n_parts * iters
                got = launches["local_gather_one"] \
                    + launches["local_scatter_one"]
                say(f"steppers: GSDD6: {iters} sweeps, K16 launches {got} "
                    f"(2 P per sweep: {want})")
                if got != want:
                    problems.append(f"GSDD6: K16 launches {got} != {want}")
            if tag == "DOT6ws5":
                if launches["hessian_diag"] != frames:
                    problems.append(f"DOT6ws5: K13 launched "
                                    f"{launches['hessian_diag']} times in "
                                    f"{frames} frames")
            if tag == "Newton":
                # the exact factorization: f32 scan factor of the P = 1 band
                if (kind != "BTDFactor" or shape[1] != 1
                        or leaf_dt != ["float32"]):
                    problems.append(f"Newton: factor {kind} {leaf_dt} "
                                    f"{shape}")
            if tag == "LBFGSHI" and (
                    sysm.factor_dtype != torch.bfloat16
                    or sysm._solve_dtype != torch.float32):
                problems.append("LBFGSHI: factor dtype "
                                f"{sysm.factor_dtype}")
            if tag == "LBFGSJH6" and (sysm.banded or sysm.plan.part
                                      is not None):
                problems.append("LBFGSJH6: not a dense node plan")
            a = np.asarray([r["sys_e"] for r in fr])
            rel_dot = np.abs(a / e_dot[:len(a)] - 1.0).max()
            del sim, sysm
            torch.cuda.empty_cache()

            ref = _simulator(torch, scene, out_root, suffix="plain",
                             use_kernels=False, save_every=10 ** 9)
            ref.run(frames)
            ref.finalize()
            b = np.asarray([r["sys_e"] for r in ref.frames])
            rel = np.abs(a / b - 1.0).max()
            say(f"steppers: {tag}: sysE "
                + " ".join("%.10e" % v for v in a)
                + f"; vs plain path max rel {rel:.3e} (tol 1e-3; plain "
                f"iters {[r['iters'] for r in ref.frames]}, s/frame "
                f"{np.mean([r['seconds'] for r in ref.frames]):.5f}); vs "
                f"DOT6 max rel {rel_dot:.3e} (tol {e_tol:g})")
            if not rel <= 1e-3:
                problems.append(f"{tag}: kernel and plain paths disagree: "
                                f"{rel:.3e}")
            if not rel_dot <= e_tol:
                problems.append(f"{tag}: sysE off DOT's by {rel_dot:.3e}")
            del ref
            torch.cuda.empty_cache()
        launches_out["steppers"] = total
        for k in STEPPER_KERNELS:
            if total[k] <= 0:
                problems.append(f"kernel {k} never launched on the steppers "
                                "path")
        if problems:
            raise Fail("steppers path: " + "; ".join(problems))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _check_scale_kernels(torch, sysm, x, fixed, hist, record):
    """K9-K12 and K5's compact entry point against their plain versions on
    the bar135 plan (f64 and f32), timed with library call and bound."""
    from dot_tpu_torch.kernels import band, coarse, lbfgs, ops
    from dot_tpu_torch.steppers import System
    mesh, cfg, plan = sysm.mesh, sysm.cfg, sysm.plan
    bad = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        tol = TOL_SCALE[name]
        sm = System(mesh, cfg, plan, dtype=dtype, device="cuda")
        xx = x.to(dtype)
        eh = sm.element_hessians(xx)
        sz = eh.element_size()
        res, times, costs = {}, {}, {}

        # K9 on the run's last L-BFGS history and the gradient at x
        S, T, rho, valid = (h.to(dtype) for h in hist)
        m, nv = S.shape[0], sm.n_vert
        S, T = S.reshape(m, -1).contiguous(), T.reshape(m, -1).contiguous()
        n = S.shape[1]
        g = sm.gradient(xx, xx, fixed).reshape(-1).contiguous()
        r = torch.randn(n, dtype=dtype, device="cuda")
        k_, G_ = ops.lbfgs_loop1(S, T, g, rho, valid)
        kr, Gr = lbfgs.lbfgs_loop1_ref(S, T, g, rho, valid)
        c_ = ops.lbfgs_loop2(T, r, kr, Gr, rho, valid)
        cr = lbfgs.lbfgs_loop2_ref(T, r, kr, Gr, rho, valid)
        q_ = ops.lbfgs_combine(g, kr, T, True, True)
        qr = lbfgs.lbfgs_combine_ref(g, kr, T, True, True)
        # the scalars to the scale of their sums (|s_i| |t_j| etc.)
        sn, tn = S.norm(dim=1), T.norm(dim=1)
        gscale = float((sn[:, None] * tn[None, :]).max())
        kscale = float((kr.abs().max() + 1e-300))
        res["lbfgs_loop1"] = [
            ("G", float((G_ - Gr).abs().max()) / gscale, tol["sum"],
             float((G_ - Gr).abs().max())),
            ("k", float((k_ - kr).abs().max()) / kscale, tol["sum"],
             float((k_ - kr).abs().max()))]
        res["lbfgs_loop2"] = [("c", _rel_max(c_, cr), tol["sum"],
                               float((c_ - cr).abs().max()))]
        res["lbfgs_combine"] = [("q", _rel_max(q_, qr), tol["elem"],
                                 float((q_ - qr).abs().max()))]
        stk = torch.cat([g[None], T]).T.contiguous()
        times["lbfgs_loop1"] = (
            lambda: ops.lbfgs_loop1(S, T, g, rho, valid),
            lambda: lbfgs.lbfgs_loop1_ref(S, T, g, rho, valid),
            lambda: torch.matmul(S, stk))
        times["lbfgs_loop2"] = (
            lambda: ops.lbfgs_loop2(T, r, kr, Gr, rho, valid),
            lambda: lbfgs.lbfgs_loop2_ref(T, r, kr, Gr, rho, valid),
            lambda: torch.matmul(T, r))
        times["lbfgs_combine"] = (
            lambda: ops.lbfgs_combine(g, kr, T, True, True),
            lambda: lbfgs.lbfgs_combine_ref(g, kr, T, True, True),
            lambda: torch.addmv(g, T.T, kr))
        costs["lbfgs_loop1"] = ((2 * m * n + n) * sz,
                                2 * (m + m * m) * n)
        costs["lbfgs_loop2"] = ((m * n + n) * sz, 2 * m * n)
        costs["lbfgs_combine"] = ((m * n + 2 * n) * sz, 2 * m * n + n)

        # K10, K11 on the real owner map and element Hessians
        cp = sm.coarse_plan
        freev = torch.logical_not(fixed).to(dtype)
        kk = ops.coarse_assemble(eh, sm.conn, freev, sm.mass, cp)
        kr_ = coarse.coarse_assemble_ref(eh, sm.conn, freev, sm.mass, cp)
        res["coarse_assemble"] = [("Kc", _rel_norm(kk, kr_), tol["sum"],
                                   float((kk - kr_).abs().max()))]
        del kr_
        times["coarse_assemble"] = (
            lambda: ops.coarse_assemble(eh, sm.conn, freev, sm.mass, cp),
            lambda: coarse.coarse_assemble_ref(eh, sm.conn, freev, sm.mass,
                                               cp), None)
        cnt, P = cp.counts, sm.n_parts
        n_mixed = cnt["pairs"] // 16
        costs["coarse_assemble"] = (
            (cnt["uniform"] * 144 + n_mixed * 90) * sz
            + 16 * (cnt["uniform"] + n_mixed) + 5 * nv * sz
            + 8 * cp.items.numel() + P * P * 36 * sz,
            cnt["uniform"] * 16 * 324 + cnt["pairs"] * 324
            + cnt["vertices"] * 60)
        rhs = torch.randn((nv, 3), dtype=dtype, device="cuda")
        y = torch.randn(6 * P, dtype=dtype, device="cuda")
        dc = torch.rand(6 * P, dtype=dtype, device="cuda") + 0.5
        rk = ops.coarse_restrict(rhs, freev, dc, cp)
        rr = coarse.coarse_restrict_ref(rhs, freev, dc, cp)
        pk = ops.coarse_prolong(y, dc, freev, cp, rhs)
        pr = coarse.coarse_prolong_ref(y, dc, freev, cp, rhs)
        res["coarse_restrict"] = [("rc", _rel_norm(rk, rr), tol["sum"],
                                   float((rk - rr).abs().max()))]
        res["coarse_prolong"] = [("p", _rel_max(pk, pr), tol["elem"],
                                  float((pk - pr).abs().max()))]
        six = torch.cat([rhs * freev[:, None],
                         torch.linalg.cross(cp.xc, rhs * freev[:, None])],
                        1)
        acc6 = torch.zeros((P, 6), dtype=dtype, device="cuda")
        times["coarse_restrict"] = (
            lambda: ops.coarse_restrict(rhs, freev, dc, cp),
            lambda: coarse.coarse_restrict_ref(rhs, freev, dc, cp),
            lambda: acc6.index_add_(0, cp.own, six))
        times["coarse_prolong"] = (
            lambda: ops.coarse_prolong(y, dc, freev, cp, rhs),
            lambda: coarse.coarse_prolong_ref(y, dc, freev, cp, rhs), None)
        costs["coarse_restrict"] = ((7 * nv + 12 * P) * sz + 8 * nv,
                                    18 * nv)
        costs["coarse_prolong"] = ((12 * P + 10 * nv) * sz + 8 * nv,
                                   30 * nv)

        # K5 (compact) and K12 on the real band tables
        freef = sm._free(fixed).to(dtype).reshape(-1)
        bp = sm.band_plan
        ck = ops.band_compact(eh, freef, sm.mass_flat, bp)
        cr_ = band.band_compact_ref(eh, freef, sm.mass_flat, bp)
        res["band_compact"] = [("compact", _rel_norm(ck, cr_), tol["sum"],
                                float((ck - cr_).abs().max()))]
        n_ub, n_asm = bp.ub_row.shape[0], bp.src_block.shape[0]
        rows = eh.t().reshape(-1, 9)[bp.src_block]
        acc9 = torch.zeros((n_ub, 9), dtype=dtype, device="cuda")
        times["band_compact"] = (
            lambda: ops.band_compact(eh, freef, sm.mass_flat, bp),
            lambda: band.band_compact_ref(eh, freef, sm.mass_flat, bp),
            lambda: acc9.index_add_(0, bp.stage1, rows))
        costs["band_compact"] = (
            eh.numel() * sz + 8 * n_asm + 8 * (n_ub + 1) + 16 * n_ub
            + 2 * freef.numel() * sz + 9 * n_ub * sz, 9 * n_asm)
        lp = band.low_plan(plan, bp, "cuda")
        bdt = torch.bfloat16 if dtype == torch.float32 else dtype
        fk, dk = ops.band_equil_scatter(cr_, lp, bdt)
        # the scan's first stage: the P diagonal blocks of the band's first
        # row, upcast as _btd_scan_equilibrated does (upper half zero)
        P, bs = sm.n_parts, sm.band_bs
        A0 = fk[:P * bs * bs].view(P, bs, bs).to(dtype).clone()
        fr, dr = band.band_equil_scatter_ref(cr_, lp, bdt)
        if bdt == torch.bfloat16:
            # ulps apart: bf16 bit patterns of same-sign values
            ik = fk.view(torch.int16).to(torch.int32)
            ir = fr.view(torch.int16).to(torch.int32)
            same = (fk == fr) | ((ik - ir).abs() <= 1) & (
                torch.sign(fk) == torch.sign(fr))
            n_off = int((fk != fr).sum())
            band_err = 0.0 if bool(same.all()) else 1.0
        else:
            n_off = int((fk != fr).sum())
            band_err = _rel_max(fk, fr)
        del fr
        res["band_equil_scatter"] = [
            (f"band ({n_off} entries differ; ulp rule)", band_err,
             0.0 if bdt == torch.bfloat16 else tol["elem"], band_err),
            ("d", _rel_max(dk, dr), tol["elem"],
             float((dk - dr).abs().max()))]
        n_low = lp.sel.shape[0]
        times["band_equil_scatter"] = (
            lambda: ops.band_equil_scatter(cr_, lp, bdt),
            lambda: band.band_equil_scatter_ref(cr_, lp, bdt), None)
        costs["band_equil_scatter"] = (
            9 * n_ub * sz + 8 * lp.diag_slot.numel() + 16 * n_ub
            + 80 * n_low + 8 * lp.pad_diag.numel()
            + lp.total * fk.element_size() + 3 * lp.diag_slot.numel() * sz,
            3 * 9 * n_low)
        del fk

        # K6 and K7 at this path's shapes: the coarse factor (one (6P)^2
        # block of the run's Kn + 1e-4 I, symmetrized; 0.05 where the plain
        # version flags it, as the path's tier), the scan's first stage
        # (lower triangle read), and the coarse solve's two mat-vecs on
        # Lc^{-1} (op A, then A^T)
        ch = TOL_H0[name]
        Kn, _ = sm._coarse_matrix(eh, fixed)
        n6 = Kn.shape[0]
        eye6 = torch.eye(n6, dtype=dtype, device="cuda")
        Ac = (Kn + 1e-4 * eye6)[None].contiguous()
        if bool(band.chol_inv_ref(Ac, True)[2].any()):
            Ac = (Kn + 0.05 * eye6)[None].contiguous()
        eye_b = torch.eye(bs, dtype=dtype, device="cuda")
        plain_inv = {}
        for kname, A, sym, eye_n in (("chol_inv@coarse", Ac, True, eye6),
                                     ("chol_inv@scan", A0, False, eye_b)):
            Lk, Xk, bk = ops.chol_inv(A, sym)
            Lr, Xr, br = band.chol_inv_ref(A, sym)
            plain_inv[kname] = Xr
            if bool(bk.any()) or bool(br.any()):
                bad.append(f"{kname} {name}: an SPD block was flagged")
            res[kname] = [("L", _rel_norm(Lk, Lr), ch["chol"],
                           float((Lk - Lr).abs().max())),
                          ("Linv", _rel_norm(Xk, Xr), ch["chol"],
                           float((Xk - Xr).abs().max()))]

            def lib_chol(A=A, eye_n=eye_n):
                Lq = torch.linalg.cholesky(A)
                return torch.linalg.solve_triangular(Lq, eye_n, upper=False)
            times[kname] = (lambda A=A, sym=sym: ops.chol_inv(A, sym),
                            lambda A=A, sym=sym: band.chol_inv_ref(A, sym),
                            lib_chol)
            costs[kname] = (3 * A.numel() * sz,
                            A.shape[0] * 2 * A.shape[-1] ** 3 / 3)
        li = plain_inv["chol_inv@coarse"].contiguous()
        v6 = torch.randn((1, n6), dtype=dtype, device="cuda")
        checks = []
        for trans in (False, True):
            k_ = ops.block_matvec(li, v6, None, trans)
            r_ = band.block_matvec_ref(li, v6, None, trans)
            checks.append(("A^T" if trans else "A", _rel_norm(k_, r_),
                           ch["exact"], float((k_ - r_).abs().max())))
        res["block_matvec@coarse"] = checks
        li0 = li[0]
        times["block_matvec@coarse"] = (
            lambda: ops.block_matvec(li, ops.block_matvec(li, v6), None,
                                     True),
            lambda: band.block_matvec_ref(
                li, band.block_matvec_ref(li, v6), None, True),
            lambda: torch.mv(li0.T, torch.mv(li0, v6[0])))
        costs["block_matvec@coarse"] = (2 * (n6 * n6 + 2 * n6) * sz,
                                        4 * n6 * n6)
        torch.cuda.synchronize()
        for kname, checks in res.items():
            _report(torch, name, kname, checks, times[kname], costs[kname],
                    bad, record)
        say(f"kernels: {name} bar135 shapes: S, T {tuple(S.shape)}, elem_h "
            f"{tuple(eh.shape)}, Kc ({P * P}, 36) from {cp.items.numel()} "
            f"items ({cnt}), compact ({n_ub}, 9), {n_low} lower blocks, band "
            f"{lp.total} x {bdt}; K6 {tuple(Ac.shape)} (shift "
            f"{float(Ac[0, 0, 0] - Kn[0, 0]):.2g}) and {tuple(A0.shape)} "
            f"lower-only, K7 {tuple(li.shape)} x {tuple(v6.shape)}")
        del sm, eh, cr_, rows, stk, six, A0, Ac, Kn, li, Lk, Xk, Lr, Xr
        del plain_inv
        torch.cuda.empty_cache()
    if bad:
        raise Fail("kernel disagrees with its plain version: "
                   + "; ".join(bad))


def phase_scale(torch, record, launches_out):
    """bar135 DOT -1 1024 f32: the main path, K9-K12 against their plain
    versions on its plan, and the plain path's first 2 frames."""
    from dot_tpu_torch.kernels import ops
    from dot_tpu_torch.steppers.core import BTDFactor, CoarseFactor
    tmp = tempfile.mkdtemp(prefix="dot_scale_")
    try:
        t0 = time.perf_counter()
        scene = _bar_scene(tmp, BAR135, SCALE_SCENE, "bar135")
        t1 = time.perf_counter()
        out_root = os.path.join(tmp, "out")
        torch.cuda.reset_peak_memory_stats()
        sim = _simulator(torch, scene, out_root, save_every=10 ** 9)
        sysm = sim.system
        t2 = time.perf_counter()
        say(f"scale: bar135 {sim.mesh.n_elem} tets, {sim.mesh.n_vert} "
            f"verts; P {sysm.n_parts}, n3 {sysm.n3}, nb {sysm.band_nb}, bs "
            f"{sysm.band_bs}, f32 band "
            f"{(2 * sysm.band_nb - 1) * sysm.band_bs ** 2 * 4 * sysm.n_parts / 2**30:.2f}"
            f" GiB; coarse {sysm.use_coarse}, chunked {sysm._chunk}; mesh "
            f"{t1 - t0:.1f} s, Simulator (load, partition, System, first "
            f"rebuild) {t2 - t1:.1f} s")
        ops.reset_launches()
        sim.run(4)
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        launches_out["scale"] = launches
        fac, kc = sim.state.chol, sim.state.kc_chol
        split = _h0_split(sim, 2, (
            "rebuild_h0", "element_hessians", "_band_compact",
            "_equil_scatter", "_btd_scan_equilibrated", "_coarse_factor",
            "h0_apply", "_coarse_apply"))
        fr = sim.frames
        timed = fr[1:4]
        spf = float(np.mean([r["seconds"] for r in timed]))
        say(f"scale: s/frame {spf:.5f} (3 timed frames after 1 warm-up; "
            f"warm-up {fr[0]['seconds']:.3f} s); iters/frame "
            f"{np.mean([r['iters'] for r in timed]):.2f}; LS halvings/frame "
            f"{np.mean([r['halvings'] for r in timed]):.2f}; syncs/frame "
            f"{np.mean([r['syncs'] for r in timed]):.2f}; peak device memory "
            f"{peak / 2**20:.1f} MiB")
        say(f"scale: synchronised split over 2 more frames (iters "
            f"{[r['iters'] for r in fr[4:]]}), ms/frame: rebuild_h0 "
            f"{split['rebuild_h0']:.2f} (elem H {split['element_hessians']:.2f}"
            f", coarse factor {split['_coarse_factor']:.2f}, compact "
            f"{split['_band_compact']:.2f}, K12 {split['_equil_scatter']:.2f}"
            f", scan {split['_btd_scan_equilibrated']:.2f}); h0_apply "
            f"{split['h0_apply']:.2f} (fine "
            f"{split['h0_apply'] - split['_coarse_apply']:.2f}, coarse "
            f"{split['_coarse_apply']:.2f})")
        say("scale: per frame (iters, halvings, syncs, stop, s): "
            + "; ".join(f"{r['iters']},{r['halvings']},{r['syncs']},"
                        f"{r['stop']},{r['seconds']:.3f}" for r in fr))
        say("scale: sysE " + " ".join("%.10e" % r["sys_e"] for r in fr))
        say(f"scale: kernel launches {launches}")
        problems = []
        if sysm.n_parts != 133 or not sysm.use_coarse:
            problems.append(f"P {sysm.n_parts}, coarse {sysm.use_coarse}")
        leaf_dt = {str(t.dtype) for t in fac} if isinstance(
            fac, BTDFactor) else set()
        if (sysm._chunk is not True or not isinstance(fac, BTDFactor)
                or fac.linv.shape[0] != 8 or fac.linv.shape[-1] != 768
                or leaf_dt != {"torch.bfloat16"}
                or not isinstance(kc, CoarseFactor)):
            problems.append(f"chunked rebuild not engaged: {type(fac)}, "
                            f"{leaf_dt}, kc {type(kc)}")
        for r in fr:
            if not np.isfinite(r["sys_e"]):
                problems.append(f"frame {r['frame']} sysE not finite")
            if r["stop"] not in ("tol", "rel_dec"):
                problems.append(f"frame {r['frame']} stopped by {r['stop']}")
        for k in SCALE_KERNELS:
            if launches[k] <= 0:
                problems.append(f"kernel {k} never launched on the bar135 "
                                "path")
        if problems:
            raise Fail("scale path: " + "; ".join(problems))

        x = sim.state.x.detach().clone()
        fixed = sim.state.fixed.clone()
        hist = (sim.state.lb_s, sim.state.lb_t, sim.state.lb_rho,
                sim.state.lb_valid)
        sim.finalize()
        plan = sysm.plan
        del sim, fac, kc
        torch.cuda.empty_cache()
        _check_scale_kernels(torch, sysm, x, fixed, hist, record)
        del sysm, hist
        torch.cuda.empty_cache()

        ref = _simulator(torch, scene, out_root, suffix="plain",
                         use_kernels=False, plan=plan, save_every=10 ** 9)
        ref.run(2)
        ref.finalize()
        a = np.asarray([r["sys_e"] for r in fr[:2]])
        b = np.asarray([r["sys_e"] for r in ref.frames])
        rel = np.abs(a / b - 1.0)
        say(f"scale: plain-path sysE {' '.join('%.10e' % v for v in b)}; "
            f"max rel vs kernels {rel.max():.3e} (tol 1e-3); plain "
            f"s/frame {np.mean([r['seconds'] for r in ref.frames]):.5f}; "
            f"plain iters {[r['iters'] for r in ref.frames]}")
        if not rel.max() <= 1e-3:
            raise Fail(f"bar135 kernel path and plain path disagree: "
                       f"{rel.max():.3e}")
        return spf
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="probe,build,kernels,golden,main,steppers,"
                            "scale")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        say("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "dot_tpu_torch")):
        say("FAIL: dot_tpu_torch not found beside chip_smoke.py")
        return 1
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    record = {}
    launches = {}
    try:
        if "probe" in phases:
            phase_probe(torch)
        if "build" in phases:
            phase_build(torch)
        if "kernels" in phases:
            phase_kernels(torch, record)
            phase_h0_kernels(torch, record)
            phase_pd_kernels(torch, record)
        if "golden" in phases:
            phase_golden(torch)
        if "main" in phases:
            phase_main(torch, launches)
        if "steppers" in phases:
            phase_steppers(torch, launches)
        if "scale" in phases:
            phase_scale(torch, record, launches)
    except Exception as exc:  # report the phase's failure and exit non-zero
        import traceback
        traceback.print_exc()
        say(f"FAIL: {type(exc).__name__}: {exc}")
        return 1
    if set(phases) != {"probe", "build", "kernels", "golden", "main",
                       "steppers", "scale"}:
        say(f"partial run ({args.phases}): no result line")
        return 0

    # launches: all paths' runs together, and each path's own count;
    # the times are at the bar17 shapes, K6 and K7 also at bar135's own
    kernels = []
    for name, (route, source, replaces) in SOURCES.items():
        by_path = {path: launches[path][name]
                   for path in ("main", "steppers", "scale")}
        at_scale = {k.split("@")[1]: v for k, v in record.items()
                    if k.startswith(name + "@")}
        kernels.append(dict(name=name, route=route, source=source,
                            replaces=replaces,
                            launches=sum(by_path.values()),
                            launches_by_path=by_path, **record[name],
                            **({"bar135": at_scale} if at_scale else {})))
    say(f"smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(nvidia_smi())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
