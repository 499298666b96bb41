"""Time the 2D dense slot assemblies of one checkout on the card, entry by
entry, with the device kernels each call runs.

    python tools/torch_dd2d_ab.py [TREE] [--out FILE]

TREE (default: the checkout holding this script) is a checkout of the repo
whose dot_tpu_torch is imported and built. To compare two trees on one card,
unpack the other with `git archive` into a directory .gitignore lists and
run both on the same machine, in turns:

    for t in .refbuild/parent . . .refbuild/parent; do
        python3 tools/torch_dd2d_ab.py $t; done

At the full-size spikes scene (resolution 20,000, f32), on the 4-part
element plan (the dim2dd / dim2admm paths' shapes, as chip_smoke.py's
kernels2d phase), for K26 subdomain_assemble2d and subdomain_scale2d, the
ADMM-DD entries w_assemble2d and local_h_assemble2d, and K28 pd_assemble2d
on the (nV)^2 matrix, it prints
- ms: the median of 15 CUDA-event timings of the wrapper, better of two
  rounds; library ms: zeros + index_add_ of the same values (none for the
  scaling);
- the device work of one call from torch.profiler: each kernel's name,
  launches and device microseconds (the split of a multi-kernel design).
The last line is one JSON object of the same numbers, also written to
--out when given. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

RESOLUTION = 20000
PARTS = 4


def median_ms(torch, fn, reps=15):
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


def device_split(torch, fn):
    """[(kernel name, launches, device us)] of one synchronised call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=here)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    from dot_tpu_torch import dim2, plan2d, scripts
    from dot_tpu_torch.config import Config
    from dot_tpu_torch.kernels import dd2d, ops
    assert dd2d.__file__ == os.path.join(tree, "dot_tpu_torch", "kernels",
                                         "dd2d.py")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dt = torch.float32
    cfg = Config(energy="FCR", time_stepper="ADMMDD", shape="spikes",
                 resolution=RESOLUTION, ym=1e5, pr=0.4, rho=1000.0,
                 handle_ratio=0.03, dt=0.025, script="stretch",
                 partition_amt=PARTS)
    mesh = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(mesh, cfg.script)
    mesh.fixed_mask = sd.fixed0.copy()
    plan = plan2d.build_plan_2d(mesh, PARTS)
    sysm = dim2.System2D(mesh, cfg, dtype=dt, device="cuda", plan=plan)
    dd = dim2.ADMMDD2D(sysm, sd)
    rng = np.random.default_rng(20261017)
    nv = mesh.n_vert
    h = float(np.sqrt(mesh.area.mean()))
    x0 = np.asarray(sd.x0, np.float64).copy()
    x0[:, :2] += rng.normal(scale=0.3 * h, size=(nv, 2))
    x = torch.as_tensor(x0, dtype=dt, device="cuda")
    fixed = torch.as_tensor(sd.fixed0, device="cuda")
    ops._load()

    eh = sysm.element_hessians(x)
    free = dd._free(fixed)
    tab = sysm.asm_tab
    P, n = tab.n_parts, tab.n
    Hk, dk = ops.subdomain_assemble2d(eh, free, sysm.mass_img, tab)
    Hs = Hk.clone()
    sfree = torch.cat([torch.logical_not(fixed[dd.shared_ids]).to(dt),
                       torch.zeros(1, dtype=dt, device="cuda")])
    w_args = (eh, free, sfree, dd.md_sh, dd.w_tab, dd.c_tab)
    Wm = ops.w_assemble2d(*w_args)[0]
    xl = dd._to_flat(x[sysm.l2g][:, :, :2] * sysm.local_valid[..., None])
    ehl = sysm.k.elem_hessian2d(xl, dd.conn_local, dd.lg4, dd.lu, dd.llam,
                                dd.lw, sysm.mat, sysm.dt_sq)
    h_args = (ehl, Wm, free, dd.mass_local + dd.mass_dif * free, dd.own_tab)
    w = sysm.scalar(sysm.dt_sq) * sysm.vol_w * (2.0 * sysm.u_e + sysm.lam_e)
    ptab = dd2d.pd_tables(mesh.conn, nv, "cuda")
    fv = torch.logical_not(fixed).to(dt)

    def lib(total, dest, vals):
        return lambda: torch.zeros(total, dtype=dt, device="cuda") \
            .index_add_(0, dest, vals)
    wt, o = dd.w_tab, dd.own_tab
    entries = {
        "subdomain_assemble2d": (
            lambda: ops.subdomain_assemble2d(eh, free, sysm.mass_img, tab),
            lib(P * n * n, tab.dest, eh.reshape(-1)[tab.src])),
        "subdomain_scale2d": (lambda: ops.subdomain_scale2d(Hs, dk, tab),
                              None),
        "w_assemble2d": (lambda: ops.w_assemble2d(*w_args),
                         lib(P * n * n, wt.dest, eh.reshape(-1)[wt.src])),
        "local_h_assemble2d": (lambda: ops.local_h_assemble2d(*h_args),
                               lib(P * n * n, o.dest,
                                   ehl.reshape(-1)[o.src])),
        "pd_assemble2d": (
            lambda: ops.pd_assemble2d(sysm.g4, w, fv, sysm.mass, ptab),
            lib(nv * nv, ptab.dest,
                dd2d.pd_pair_vals2d(sysm.g4, w).reshape(-1)[ptab.src])),
    }
    out = {"tree": tree, "card": card, "entries": {}}
    print(f"dd2d_ab: {tree} on {card}: spikes {RESOLUTION}, P {P}, n2p {n},"
          f" PD {nv}^2, f32")
    for name, (fn, lfn) in entries.items():
        k1 = median_ms(torch, fn)
        lb = median_ms(torch, lfn) if lfn is not None else None
        k2 = median_ms(torch, fn)
        split = device_split(torch, fn)
        rec = dict(ms=min(k1, k2), library_ms=lb,
                   device=[dict(kernel=k[:70], launches=c, us=u)
                           for k, c, u in split])
        out["entries"][name] = rec
        lib_s = "none" if lb is None else f"{lb:.4f}"
        parts = "; ".join(f"{k[:60]} x{c} {u:.1f} us" for k, c, u in split)
        print(f"dd2d_ab: {name}: {rec['ms']:.4f} ms, library {lib_s} ms; "
              f"device: {parts}")
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
