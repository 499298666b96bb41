"""CLI entry: `python -m dot_tpu_torch <mode> <script.txt> [suffix]`

Modes 0/10/100 simulate the scene script headless (mode 0's interactive
viewer is not ported). A scene whose `shape` is a 2D primitive (grid,
square, rectangle, cylinder, spikes, Sharkey) runs the 2D pipeline
(dim2.run_script_2d): `timeStepper Newton` only so far, the other 2D
steppers raise until ROADMAP.md queue 1 items 1b / 1c. Every other scene
runs the 3D pipeline with all nine steppers. Modes 1 and 2 of dot_tpu
(diagnostics, mesh processing) are queue 1 of ROADMAP.md.

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
    from .config import Config
    from .dim2 import is_2d_shape, run_script_2d
    from .sim import run_script
    # a 2D primitive scene takes the DIM = 2 pipeline (dot_tpu/__main__.py:34-48)
    two_d = is_2d_shape(Config.load(args.script).shape)
    run = run_script_2d if two_d else run_script
    sim, spf = run(args.script, suffix=args.suffix, frames=args.frames,
                   dtype=args.dtype, output_root=args.output_root,
                   save_every=args.save_every, device=args.device)
    print(f"done: {sim.frame}/{sim.frame_amt} {'2D ' if two_d else ''}frames, "
          f"{spf:.4f} s/frame on {sim.device}")
    print(f"output: {sim.out}")


if __name__ == "__main__":
    main()
