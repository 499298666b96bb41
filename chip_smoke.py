#!/usr/bin/env python3
"""Smoke run of the dot_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases probe,build,kernels,golden,main]

Phases (each prints its lines; any failure exits non-zero before the
result line):
  probe    device name, `nvidia-smi` name and power limit, nvcc and triton
  build    K1-K3 (csrc/elem.cu) with nvcc for sm_90a, K4 with Triton
  kernels  each kernel against its plain PyTorch version on the card at the
           bar17 shapes (86,016 tets, 16,473 vertices), f64 and f32, on
           random, inverted and near-degenerate deformations from a seed;
           max errors against the tolerances and median times
  golden   bar 8x3x3, DOT with 4 parts, f64, 5 frames: sysE against the
           recorded golden trace (rtol 2e-4)
  main     bar17 twist, DOT 6, f32, relTol 1e-5 through sim.run_script:
           1 warm-up + 10 timed frames; convergence, kernel launch counts,
           output files; then 3 frames with the plain versions of the
           kernels on the same card (sysE rtol 1e-3)
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}; the line before them is nvidia-smi's name
and power limit. Exits non-zero without a result line when no CUDA device
is present.
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
}


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
    from dot_tpu_torch.kernels import ops, triton_qf
    from dot_tpu_torch.kernels.csrc import build
    t0 = time.perf_counter()
    ops._load()
    t1 = time.perf_counter()
    log = os.path.join(build.BUILD_DIR, "elem_build.log")
    if os.path.exists(log):   # absent when the library was already built
        name, spill = "?", ""
        with open(log) as f:
            for ln in f:
                m = re.search(r"Function properties for _ZN4dotk\d+(\w+?_kernel)"
                              r"I([fd])(?:Li(\d)E)?", ln)
                if m:
                    name = (f"{m.group(1)}<{m.group(2)}"
                            + (f",mat{m.group(3)}>" if m.group(3) else ">"))
                elif "spill stores" in ln:
                    spill = ln.strip()
                elif "Used" in ln and "registers" in ln:
                    regs = re.search(r"Used (\d+) registers", ln).group(1)
                    say(f"build: ptxas {name}: {regs} registers; {spill}")
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
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    say(f"build: nvcc K1-K3 {t1 - t0:.1f} s (sm_90a), triton K4 "
        f"{t2 - t1:.1f} s")


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


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _rel_norm(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


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

        times = {
            "ls_trial_energy": (
                lambda: ops.ls_trial_energy(d["F0"], d["Fp"], d["alpha"], u,
                                            lam, w, mat),
                lambda: soa.ls_trial_energy_ref(d["F0"], d["Fp"], d["alpha"],
                                                u, lam, w, mat)),
            "elem_gradient": (lambda: ops.elem_gradient(*args),
                              lambda: soa.elem_gradient_ref(*args)),
            "elem_hessian": (lambda: ops.elem_hessian(*hargs),
                             lambda: soa.elem_hessian_ref(*hargs)),
            "direction_pass": (
                lambda: ops.direction_pass(d["p"], conn, g9, hr),
                lambda: soa.direction_pass_ref(d["p"], conn, g9, hr)),
        }
        bad = []
        for kname, checks in res.items():
            fk_, fr_ = times[kname]
            # plain, kernel, kernel, plain
            p1 = _median_ms(torch, fr_)
            k1 = _median_ms(torch, fk_)
            k2 = _median_ms(torch, fk_)
            p2 = _median_ms(torch, fr_)
            ms, plain_ms = min(k1, k2), min(p1, p2)
            parts = []
            for what, err, lim, _abs in checks:
                parts.append(f"{what} rel {err:.3e} (tol {lim:g})")
                if not err <= lim:
                    bad.append(f"{kname} {name} {what}: {err:.3e} > {lim:g}")
            say(f"kernels: {name} {kname}: " + ", ".join(parts)
                + f"; {ms:.4f} ms vs plain {plain_ms:.4f} ms")
            if dtype == torch.float32:
                abs_err = max(a for _, _, _, a in checks if a is not None)
                record[kname] = dict(max_abs_err=abs_err, ms=ms,
                                     plain_ms=plain_ms)
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


def phase_main(torch, launches_out):
    from dot_tpu_torch import io as meshio
    from dot_tpu_torch.kernels import ops
    from dot_tpu_torch.mesh_gen import bar_mesh
    from dot_tpu_torch.sim import run_script
    tmp = tempfile.mkdtemp(prefix="dot_smoke_")
    try:
        mesh = bar_mesh(*BAR17, size=(4.0, 1.0, 1.0))
        mesh_path = os.path.join(tmp, "bar17.msh")
        meshio.save_tet_mesh(mesh_path, mesh.V, mesh.conn, mesh.SF)
        scene = os.path.join(tmp, "bar17_twist_DOT6.txt")
        with open(scene, "w") as f:
            f.write(SCENE_TMPL.format(mesh_path=mesh_path))
        out_root = os.path.join(tmp, "out")

        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        sim, _ = run_script(scene, frames=11, output_root=out_root,
                            dtype="f32", device="cuda", mute=True)
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        launches_out.update(launches)

        fr = sim.frames
        timed = fr[1:]
        spf = float(np.mean([r["seconds"] for r in timed]))
        say(f"main: bar17 twist DOT{sim.system.n_parts} f32: "
            f"{sim.mesh.n_elem} tets, {sim.mesh.n_vert} verts, "
            f"n3 {sim.system.n3}, banded {sim.system.banded} "
            f"(nb {sim.system.band_nb}, bs {sim.system.band_bs}); "
            f"run_script wall {wall:.2f} s")
        say(f"main: s/frame {spf:.5f} (10 timed frames after 1 warm-up; "
            f"warm-up {fr[0]['seconds']:.3f} s); iters/frame "
            f"{np.mean([r['iters'] for r in timed]):.2f}; LS halvings/frame "
            f"{np.mean([r['halvings'] for r in timed]):.2f}; syncs/frame "
            f"{np.mean([r['syncs'] for r in timed]):.2f}; peak device memory "
            f"{peak / 2**20:.1f} MiB")
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
        for k, v in launches.items():
            if v <= 0:
                problems.append(f"kernel {k} never launched on the main path")
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
        ref, _ = run_script(scene, frames=3, output_root=out_root,
                            suffix="plain", dtype="f32", device="cuda",
                            mute=True, use_kernels=False)
        a = np.asarray([r["sys_e"] for r in fr[:3]])
        b = np.asarray([r["sys_e"] for r in ref.frames])
        rel = np.abs(a / b - 1.0)
        say(f"main: plain-path sysE {' '.join('%.10e' % v for v in b)}; "
            f"max rel vs kernels {rel.max():.3e} (tol 1e-3); plain "
            f"s/frame {np.mean([r['seconds'] for r in ref.frames]):.5f}")
        if not rel.max() <= 1e-3:
            raise Fail(f"kernel path and plain path disagree: {rel.max():.3e}")
        return spf
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="probe,build,kernels,golden,main")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

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
        if "golden" in phases:
            phase_golden(torch)
        if "main" in phases:
            phase_main(torch, launches)
    except Exception as exc:  # report the phase's failure and exit non-zero
        import traceback
        traceback.print_exc()
        say(f"FAIL: {type(exc).__name__}: {exc}")
        return 1
    if set(phases) != {"probe", "build", "kernels", "golden", "main"}:
        say(f"partial run ({args.phases}): no result line")
        return 0

    kernels = []
    for name, (route, source, replaces) in SOURCES.items():
        kernels.append(dict(name=name, route=route, source=source,
                            replaces=replaces, launches=launches[name],
                            **record[name]))
    say(nvidia_smi())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
