#!/usr/bin/env python3
"""Smoke run of the dot_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases probe,build,kernels,golden,main]

Phases (each prints its lines; any failure exits non-zero before the
result line):
  probe    device name, `nvidia-smi` name and power limit, nvcc and triton
  build    the CUDA sources of csrc/ (K1-K3 elem.cu, K5 band_asm.cu, K6
           chol_inv.cu, K7 block_matvec.cu, K8 h0.cu) with nvcc for sm_90a,
           one nvcc per source, all at once; K4 with Triton
  kernels  each kernel against its plain PyTorch version on the card at the
           bar17 shapes, f64 and f32, with max errors against the
           tolerances and median times: K1-K4 on random, inverted and
           near-degenerate deformations of the bar17 mesh (86,016 tets,
           16,473 vertices) from a seed; K5-K8 on the real bar17 plan (P 6,
           nb 13, bs 768) and its assembled blocks: the band, the 36
           odd diagonal blocks of the first cyclic-reduction level (K6
           symmetrized, and its 6-block root batch lower-only; one
           indefinite block must come back flagged and NaN), the factor's
           level blocks (K7 on bf16 and f32 storage in f32 runs), the
           vertex gather and averaging
  golden   bar 8x3x3, DOT with 4 parts, f64, 5 frames: sysE against the
           recorded golden trace (rtol 2e-4)
  main     bar17 twist, DOT 6, f32, relTol 1e-5 through sim.Simulator:
           1 warm-up + 10 timed frames; convergence, the H0 factor's kind
           (cyclic reduction, 2 levels, bf16 leaves), kernel launch counts
           (all nine entry points), output files; 3 more frames with the
           H0 rebuild and apply timed (synchronised); then 3 frames with
           the plain versions of the kernels on the same card (sysE rtol
           1e-3)
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
}
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
    from dot_tpu_torch.kernels import ops, triton_qf
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
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    say(f"build: nvcc {len(build.LIBRARIES)} sources in parallel "
        f"{t1 - t0:.1f} s (sm_90a), triton K4 {t2 - t1:.1f} s")


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
            ms, plain_ms = _time_pair(torch, *times[kname])
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


def _bar17_scene(tmp):
    """Write the bar17 mesh and the twist DOT6 scene under tmp; return the
    scene path."""
    from dot_tpu_torch import io as meshio
    from dot_tpu_torch.mesh_gen import bar_mesh
    mesh = bar_mesh(*BAR17, size=(4.0, 1.0, 1.0))
    mesh_path = os.path.join(tmp, "bar17.msh")
    meshio.save_tet_mesh(mesh_path, mesh.V, mesh.conn, mesh.SF)
    scene = os.path.join(tmp, "bar17_twist_DOT6.txt")
    with open(scene, "w") as f:
        f.write(SCENE_TMPL.format(mesh_path=mesh_path))
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
    """K5-K8 against their plain versions on the bar17 plan and blocks."""
    from dot_tpu_torch.kernels import band, ops
    from dot_tpu_torch.steppers import System
    tmp = tempfile.mkdtemp(prefix="dot_smoke_k_")
    try:
        sim = _simulator(torch, _bar17_scene(tmp), os.path.join(tmp, "out"))
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
            tol = TOL_H0[name]
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
                lambda: band.band_assemble_ref(eh, freef, sysm.mass_flat, bp))
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
            times["chol_inv"] = (lambda: ops.chol_inv(A_odd, True),
                                 lambda: band.chol_inv_ref(A_odd, True))
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
            res["block_matvec"] = checks
            times["block_matvec"] = (
                lambda: ops.block_matvec(A7, v, c, True),
                lambda: band.block_matvec_ref(A7, v, c, True))

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
            times["h0_gather"] = (lambda: ops.h0_gather(*g_args),
                                  lambda: band.h0_gather_ref(*g_args))
            times["h0_average"] = (lambda: ops.h0_average(*a_args),
                                   lambda: band.h0_average_ref(*a_args))
            torch.cuda.synchronize()

            for kname, checks in res.items():
                ms, plain_ms = _time_pair(torch, *times[kname])
                parts = []
                for what, err, lim, _abs in checks:
                    parts.append(f"{what} rel {err:.3e} (tol {lim:g})")
                    if not err <= lim:
                        bad.append(f"{kname} {name} {what}: {err:.3e} > "
                                   f"{lim:g}")
                say(f"kernels: {name} {kname}: " + ", ".join(parts)
                    + f"; {ms:.4f} ms vs plain {plain_ms:.4f} ms")
                if dtype == torch.float32:
                    abs_err = max(a for _, _, _, a in checks
                                  if a is not None)
                    record[kname] = dict(max_abs_err=abs_err, ms=ms,
                                         plain_ms=plain_ms)
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


def _h0_split(sim, frames):
    """ms/frame of rebuild_h0 and h0_apply over `frames` more frames, each
    call wrapped in synchronised host timers."""
    import collections
    from dot_tpu_torch.profiling import wrap_timed
    acc = collections.Counter()
    names = ("rebuild_h0", "h0_apply")
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
        scene = _bar17_scene(tmp)
        out_root = os.path.join(tmp, "out")

        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        sim = _simulator(torch, scene, out_root)
        sim.run(11)
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        launches_out.update(launches)
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
        for k, v in launches.items():
            if v <= 0:
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
            phase_h0_kernels(torch, record)
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
