"""CLI entry: `python -m dot_tpu_torch <mode> <script.txt> [suffix]`

Modes 0/10/100 simulate the scene script headless (mode 0's interactive
viewer is not ported). Modes 1 and 2 of dot_tpu (diagnostics, mesh
processing) are queue 1 of ROADMAP.md.

Flags: --frames N, --dtype {f32,f64}, --save-every K, --output-root DIR,
--device {cuda,cpu} (default: cuda; without a GPU the run stops with an
error unless --device cpu is given).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dot_tpu_torch")
    ap.add_argument("mode", help="0/10/100 simulate")
    ap.add_argument("script", help="scene script .txt")
    ap.add_argument("suffix", nargs="?", default="", help="output folder tag")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--dtype", choices=["f32", "f64"], default=None)
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--output-root", default="output")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None)
    args = ap.parse_args(argv)

    if args.mode not in ("0", "10", "100"):
        print(f"mode {args.mode} is not ported (dot_tpu_torch runs modes "
              "0/10/100; see ROADMAP.md queue 1)")
        sys.exit(1)
    from .sim import run_script
    sim, spf = run_script(args.script, suffix=args.suffix, frames=args.frames,
                          dtype=args.dtype, output_root=args.output_root,
                          save_every=args.save_every, device=args.device)
    print(f"done: {sim.frame}/{sim.frame_amt} frames, {spf:.4f} s/frame "
          f"on {sim.device}")
    print(f"output: {sim.out}")


if __name__ == "__main__":
    main()
