"""K31 (schur_update) against the route it replaced, on one GPU.

    python3 tools/torch_schur_bench.py [TREE ...]

Each TREE (default: this checkout) holds the dot_tpu_torch to import; the
trees are measured in the order given, each in a process of its own. For
the block scan's update D - Ls Ls^T at the shapes of the paths (bar135's
scan step: 133 blocks of 768; a P = 1 scan; 6 blocks of 768; bar17's
Newton width 1152) with random inputs from a seed: D in bf16 (the chunked
band), Ls in f32. Prints, per shape: the kernel's time (median of 15
single calls between CUDA events, and a call back to back over 20), the
route it replaced (D upcast, Ls rounded to bf16 and upcast twice, an f32
GEMM, a subtraction; K31 is timed on the bf16 Ls, which the scan stores
as the leaf anyway), the library call where the card's torch has
one (torch.bmm(..., out_dtype=torch.float32) on the bf16 Ls, then the
subtraction), the bound (max of the lower triangle's bytes over 3.35 TB/s
and its operations over 989 TFLOP/s), the norm-wise error of the lower
triangle against the f32 product, and whether two calls agree bit for
bit; then the card's name and power limit and the kernel's registers from
the build log. A tree without K31 prints its route's times alone.
"""

import os
import subprocess
import sys

SHAPES = ((133, 768), (1, 768), (6, 768), (1, 1152))


def _ms(torch, fn, reps=15):
    fn()
    torch.cuda.synchronize()
    t = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        t.append(a.elapsed_time(b))
    return sorted(t)[len(t) // 2]


def _back_to_back(torch, fn, calls=20):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def bound_ms(B, n):
    """(ms, "bytes" or "ops") of the lower triangle's work."""
    low = B * n * (n + 1) // 2
    nbytes = B * n * n * 2 + low * 2 + low * 4
    flops = 2.0 * low * n
    tb, tf = nbytes / 3.35e12 * 1e3, flops / 989.4e12 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "ops")


def run(tree):
    sys.path.insert(0, tree)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from dot_tpu_torch.kernels import ops
    dev = torch.device("cuda")
    b16, f32 = torch.bfloat16, torch.float32
    has_k31 = hasattr(ops, "schur_update")
    print(f"tree {tree}: torch {torch.__version__}, CUDA {torch.version.cuda}"
          f", K31 {'present' if has_k31 else 'absent'}", flush=True)
    for B, n in SHAPES:
        g = torch.Generator(device=dev).manual_seed(20261018 + n + B)
        Ls = 0.5 / n ** 0.5 * torch.randn((B, n, n), generator=g,
                                          device=dev)
        N = 0.01 * torch.randn((B, n, n), generator=g, device=dev)
        D = (3.0 * torch.eye(n, device=dev) + N + N.mT).to(b16)
        del N
        Lsb = Ls.to(b16)

        def route():
            return D.to(f32) - Ls.to(b16).to(f32) @ Ls.mT.to(b16).to(f32)

        line = (f"  ({B}, {n}): route {_ms(torch, route):.4f} ms (back to "
                f"back {_back_to_back(torch, route):.4f})")
        try:
            torch.bmm(Lsb, Lsb.mT, out_dtype=f32)

            def lib():
                return D.to(f32) - torch.bmm(Lsb, Lsb.mT, out_dtype=f32)
            line += (f", library bmm(out_dtype) {_ms(torch, lib):.4f} (back "
                     f"to back {_back_to_back(torch, lib):.4f})")
        except (TypeError, RuntimeError) as e:
            line += f", library none ({type(e).__name__})"
        if has_k31:
            out = torch.empty((B, n, n), device=dev)

            def k31():
                return ops.schur_update(D, Lsb, out)
            ms = _ms(torch, k31)
            bb = _back_to_back(torch, k31)
            a = torch.tril(ops.schur_update(D, Lsb).clone())
            b = torch.tril(ops.schur_update(D, Lsb))
            ref = torch.tril(D.to(f32) - Lsb.to(f32) @ Lsb.mT.to(f32))
            err = float((a - ref).norm() / ref.norm())
            bd, by = bound_ms(B, n)
            line += (f"; K31 {ms:.4f} ms (back to back {bb:.4f}), bound "
                     f"{bd:.4f} ({by}), err {err:.3e}, repeats bit for bit "
                     f"{bool(torch.equal(a, b))}")
        print(line, flush=True)
        del Ls, Lsb, D
        torch.cuda.empty_cache()
    if has_k31:
        from dot_tpu_torch.kernels.csrc import build
        log = build.log_path("schur")
        if os.path.exists(log):
            for ln in open(log):
                if "registers" in ln or "spill" in ln:
                    print("  ptxas: " + ln.strip())


def main():
    trees = [os.path.abspath(t) for t in sys.argv[1:]] or [
        os.path.abspath(".")]
    if len(trees) > 1:
        for t in trees:
            subprocess.run([sys.executable, os.path.abspath(__file__), t],
                           check=True)
        return
    run(trees[0])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
