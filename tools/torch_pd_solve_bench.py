"""LBFGS-PD's and ADMM-PD's pd_solve as one launch of K7's solve entry
(program kind "pd"), on one GPU.

    python3 tools/torch_pd_solve_bench.py [TREE ...]

Each TREE (default: this checkout) holds a dot_tpu_torch to import; each
runs in its own process, in the order given (pass two trees as A B B A to
compare them on one card). At bar17's PD shape (P 1, nb 33, bs 512, 16,473
vertices), with random leaves from a seed (the inverse factors lower
triangular, as K6 writes them; a random permutation with padding rows; a
scale d in [0.5, 2]), in f32 and f64: the norm-wise error against the
plain version (band.block_solve_ref: the gather, 130 3-column products,
the scatter) and whether two calls agree bit for bit, the single timed
call (median of 15, CUDA events) and the time a call back to back (20
calls between two events), the bytes bound (band.solve_cost at 3.35
TB/s), the time by stage kind in the one launch (the program cut after
each stage, back to back, less the program cut before it: the gather,
the op = A and op = A^T products, the scatter) and the same program's
stage count on 8-wide blocks (the grid barriers with next to no work);
then the card's name and power limit.
"""

import os
import subprocess
import sys

import numpy as np


def bench(tree):
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from dot_tpu_torch.kernels import band, ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261017)
    rng = np.random.default_rng(20261017)
    nb, n, nv = 33, 512, 16473

    def leaves(dt, n=n, nv=nv):
        a = torch.randn((nb, 1, n, n), generator=gen, device=dev)
        linv = (torch.tril(a) * (0.5 / n ** 0.5)).to(dt)
        sub = (torch.randn((nb - 1, 1, n, n), generator=gen, device=dev)
               * (0.5 / n)).to(dt)
        perm = rng.permutation(nb * n)[:nv]
        inv = np.full(nb * n, -1)
        inv[perm] = np.arange(nv)
        d = torch.as_tensor(rng.uniform(0.5, 2.0, size=nb * n), dtype=dt,
                            device=dev)
        return [linv, sub, torch.as_tensor(inv, device=dev),
                torch.as_tensor(perm, device=dev), d]

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

    for dt in (torch.float32, torch.float64):
        lv = leaves(dt)
        r = torch.randn((nv, 3), generator=gen, device=dev, dtype=dt)
        prog = band.solve_program("pd", lv)
        z = ops.block_solve(prog, lv, r)
        ref = band.block_solve_ref(prog, lv, r)
        err = float(torch.linalg.norm(z - ref) / torch.linalg.norm(ref))
        same = torch.equal(z, ops.block_solve(prog, lv, r))

        def one():
            return ops.block_solve(prog, lv, r)
        t = [single(one), b2b(one)]
        nbytes = band.solve_cost(prog, lv, r)[0]
        name = str(dt).split(".")[-1]
        print(f"{tree}: {name}: {len(prog.stages)} stages, vs plain rel "
              f"{err:.3e}, two calls bit for bit {same}; one launch "
              f"{t[0]:.4f} ms single, {t[1]:.4f} back to back; bytes bound "
              f"{nbytes / 3.35e12 * 1e3:.4f} ms", flush=True)
        kinds = {band.OP_GATHER: "gather", band.OP_A: "op A",
                 band.OP_AT: "op A^T", band.OP_SCATTER: "scatter"}
        by, cnt, prev = dict.fromkeys(kinds.values(), 0.0), \
            dict.fromkeys(kinds.values(), 0), 0.0
        for s in range(1, len(prog.stages) + 1):
            cut = prog._replace(stages=prog.stages[:s],
                                table=prog.table[:s])
            ts = b2b(lambda: ops.block_solve(cut, lv, r))
            k = kinds[int(prog.stages[s - 1, band.F_OP])]
            by[k] += ts - prev
            cnt[k] += 1
            prev = ts
        print(f"{tree}: {name}: by stage kind in the one launch: "
              + "; ".join(f"{k} {by[k]:.4f} ms in {cnt[k]} "
                          f"({by[k] / max(cnt[k], 1) * 1e3:.2f} us each)"
                          for k in by), flush=True)
        small = leaves(dt, n=8, nv=200)
        rs = torch.randn((200, 3), generator=gen, device=dev, dtype=dt)
        ps = band.solve_program("pd", small)
        tb = b2b(lambda: ops.block_solve(ps, small, rs))
        print(f"{tree}: {name}: the same {len(ps.stages)} stages on 8-wide "
              f"blocks: {tb:.4f} ms a launch", flush=True)
        del z, ref, lv, small


def main():
    trees = [os.path.abspath(t) for t in (sys.argv[1:] or ["."])]
    if len(trees) == 1:
        bench(trees[0])
        return
    for t in trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), t],
                       check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
