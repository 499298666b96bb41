"""K7's solve entry at the paths' factor shapes, on one GPU.

    python3 tools/torch_solve_bench.py [TREE]

TREE (default: this checkout) holds the dot_tpu_torch to import. For the
factor shapes of the paths, with random leaves from a seed (the solve's
time does not depend on the values; the inverse factors lower
triangular, as K6 writes them): bar17's cyclic-reduction factor (P 6,
nb 13, bs 768, bf16 leaves, f32 solve), bar135's block scan (P 133, nb 8,
bs 768, bf16 leaves in f32, f64 leaves in f64), the P = 1 scan of Newton /
LBFGS-H (nb 43, bs 1152, f32) and the 798^2 coarse pair (f32). Prints, per
shape: the norm-wise error against the plain version (band.block_solve_ref)
and whether two calls agree bit for bit, the single timed call (median of
15, CUDA events) and the time a call back to back (20 calls between two
events), the bytes bound (band.solve_cost: each leaf read once, the
inverse factors' lower triangles only, r and z, at 3.35 TB/s); at bar135
each stage's time in the one launch (the program cut after it less the
program cut before it, back to back) beside a program of that stage
alone; the card's name and power limit, the
time of a launch of 29 grid barriers with next to no work and of bar135's
scan on grids of 132, 264, 396 and 528 blocks (or that the launch was
refused: a grid above the co-resident blocks), and the solve kernel's
registers from the build log.
"""

import os
import subprocess
import sys

import numpy as np


def main():
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from dot_tpu_torch.kernels import band, ops
    from dot_tpu_torch.kernels.csrc import build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261017)

    def leaf(m, P, n, dt, lower=False):
        a = torch.randn((m, P, n, n), generator=gen, device=dev)
        # an inverse factor: exact zeros above the diagonal, as K6's
        return ((torch.tril(a) if lower else a) * (0.5 / n ** 0.5)).to(dt)

    def cr(P, nb, n, dt):
        out, m = [], nb
        while m > 4:
            n_odd = m // 2
            out += [leaf(n_odd, P, n, dt, True), leaf(n_odd, P, n, dt),
                    leaf(n_odd, P, n, dt)]
            m -= n_odd
        return out + [leaf(m, P, n, dt, True), leaf(m - 1, P, n, dt)]

    def single(fn, reps=15):
        fn()
        torch.cuda.synchronize()
        t = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            t.append(a.elapsed_time(b))
        return float(np.median(t))

    def stage_times(prog, lv, r):
        """Where the one launch's time goes, stage by stage: the back-to-
        back time of the program cut after stage s (s = 1 .. all) less the
        time cut after s - 1, beside the back-to-back time of a program of
        that stage alone (the one launch's item walk without the stages
        around it)."""
        prev, tot = 0.0, [0.0, 0.0]
        for s in range(1, len(prog.stages) + 1):
            cut = prog._replace(stages=prog.stages[:s],
                                table=prog.table[:s])
            t = b2b(lambda: ops.block_solve(cut, lv, r))
            one = prog._replace(stages=prog.stages[s - 1:s],
                                table=prog.table[s - 1:s])
            t1 = b2b(lambda: ops.block_solve(one, lv, r))
            st = prog.stages[s - 1]
            print(f"  stage {s - 1}: op {int(st[band.F_OP])}, lower "
                  f"{int(st[band.F_LOWER])}, barrier {int(st[band.F_SYNC])}"
                  f": {t - prev:.4f} ms in the one launch, {t1:.4f} ms as a "
                  f"one-stage program", flush=True)
            tot[0] += t - prev
            tot[1] += t1
            prev = t
        print(f"  sum: {tot[0]:.4f} ms in the one launch, {tot[1]:.4f} ms "
              f"as one-stage programs", flush=True)

    def b2b(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / calls

    cases = [("bar17 CR", "cr", cr(6, 13, 768, torch.bfloat16), 6, 13 * 768),
             ("bar135 scan", "btd", [leaf(8, 133, 768, torch.bfloat16, True),
                                     leaf(7, 133, 768, torch.bfloat16)],
              133, 8 * 768),
             ("bar135 scan f64", "btd", [leaf(8, 133, 768, torch.float64,
                                              True),
                                         leaf(7, 133, 768, torch.float64)],
              133, 8 * 768),
             ("P=1 scan", "btd", [leaf(43, 1, 1152, torch.float32, True),
                                  leaf(42, 1, 1152, torch.float32)],
              1, 43 * 1152),
             ("coarse pair", "pair",
              [leaf(1, 1, 798, torch.float32, True)[0, 0]],
              1, 798)]
    for name, kind, lv, P, width in cases:
        r = torch.randn((P, width), generator=gen, device=dev,
                        dtype=torch.float64 if "f64" in name
                        else torch.float32)
        prog = band.solve_program(kind, lv)
        z = ops.block_solve(prog, lv, r)
        ref = band.block_solve_ref(prog, lv, r)
        err = float(torch.linalg.norm(z - ref) / torch.linalg.norm(ref))
        same = torch.equal(z, ops.block_solve(prog, lv, r))
        fn = (lambda prog=prog, lv=lv, r=r: ops.block_solve(prog, lv, r))
        times = [single(fn), b2b(fn)]
        nbytes = band.solve_cost(prog, lv, r)[0]
        print(f"{name}: {len(prog.stages)} stages, vs plain rel {err:.3e}, "
              f"two calls bit for bit {same}; one launch {times[0]:.4f} ms "
              f"single, {times[1]:.4f} back to back; bytes bound "
              f"{nbytes / 3.35e12 * 1e3:.4f} ms", flush=True)
        if name.startswith("bar135"):
            stage_times(prog, lv, r)
        del z, ref
    # the grid barriers alone: a scan of 8 blocks of 32^2 (30 stages, 29
    # barriers, next to no work), and bar135's scan, on grids of 132 k
    # blocks (a grid above the co-resident blocks is refused)
    small = [leaf(8, 1, 32, torch.float32, True),
             leaf(7, 1, 32, torch.float32)]
    big = cases[1][2]
    for tag, lv, P, width in (("29 barriers", small, 1, 8 * 32),
                              ("bar135 scan", big, 133, 8 * 768)):
        prog = band.solve_program("btd", lv)
        r = torch.randn((P, width), generator=gen, device=dev)
        for k in (1, 2, 3, 4):
            try:
                t = b2b(lambda k=k: ops._block_solve(prog, lv, r, 132 * k))
            except RuntimeError as e:
                print(f"grid {132 * k}: refused ({tag}: {e})", flush=True)
                continue
            print(f"grid {132 * k}: {t:.4f} ms a launch ({tag})",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    entry = ""
    with open(build.log_path("block_matvec")) as f:
        for line in f:
            if "Compiling entry function" in line:
                entry = line
            elif "registers" in line and "solve_kernel" in entry:
                print(entry.split("'")[1], line.split(":", 1)[1].strip())


if __name__ == "__main__":
    main()
