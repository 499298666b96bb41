"""The benchmark of dot_tpu_torch (the PyTorch / CUDA port) on one card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`) names
a configuration (configs/<name>.json) and a traffic mix
(traffic/<name>.json); its limits are limits/<cell>.json and each metric
it reports is read by metrics/<metric>.py. See driver.py for the run
itself. --trace 0 measures the cell's end-to-end metrics over `--seconds`;
--trace 1 profiles one lap (or its first `trace_frames`) and reads its
per-layer metrics. Either way the frames the window produced are compared
with the configuration's plain reference once the window has closed.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device[, breakdown], checks); the numbers compared, each
beside its limit, are also the last lines of standard error. Without a
CUDA device, or with fewer than the cell asks for, it prints no result
and exits with 2.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse                                    # noqa: E402
import importlib                                   # noqa: E402
import json                                        # noqa: E402
import math                                        # noqa: E402
import os                                          # noqa: E402
import subprocess                                  # noqa: E402
import sys                                         # noqa: E402
import types                                       # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TRACE_ATTEMPTS = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def metric_module(name):
    return importlib.import_module(f"bench_port.metrics.{name}")


def nvidia_smi():
    """The card's name, power limit, SM clocks, draw and temperature."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    return out


def run_cell(cell, seed, seconds, trace, device="cuda", work_dir=HERE,
             t_process=None):
    """One run of `cell` (driver.Cell); returns the result object."""
    import torch
    from bench_port import driver, tracing

    t_process = T_PROCESS if t_process is None else t_process
    names = cell.per_layer if trace else cell.end_to_end
    mods = {n: metric_module(n) for n in names}
    run = driver.Run(cell, seed, device, work_dir)
    run.build(t_process)
    sim = run.sim
    s = sim.system
    shapes = {"P": s.n_parts, "nb": s.band_nb if s.banded else 1,
              "bs": s.band_bs if s.banded else s.n3,
              "field": driver.DTYPE_NAMES[s.dtype],
              "factor": driver.DTYPE_NAMES[s.apply_dtype or s.dtype],
              "coarse_n": 6 * s.n_parts if s.use_coarse else 0,
              "stepper": sim.stepper.name}
    if sim.stepper.name == "LBFGSPD" and s.pd_band_plan is not None:
        shapes["pd"] = {"nb": s.pd_band_plan.nb, "bs": s.pd_band_plan.bs,
                        "n_vert": s.n_vert}
    log(f"cell {cell.workload} seed {seed}: {s.mesh.n_elem} tets, "
        f"{s.n_vert} vertices, {sim.stepper.name}, shapes {shapes}")
    on_card = device == "cuda"
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    log("set-up split (s): " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in run.setup.items()))
    tr = None
    if trace:
        from dot_tpu_torch.kernels import ops
        from torch.profiler import ProfilerActivity, profile
        spans, needs = {}, []
        for m in mods.values():
            spans.update(getattr(m, "SPANS", {}))
            needs += m.needs(shapes) if hasattr(m, "needs") else []
        # a lap of more device operations than a profile keeps whole
        # (dot6's 200 frames, ~135K, lost a marker kernel on an H100)
        # traces only its first `trace_frames`
        n_traced = int(cell.traffic.get("trace_frames",
                                        cell.traffic["lap_frames"]))
        torch.cuda._sleep(0)
        torch.cuda.synchronize()
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            # from the lap's start; a profile that lost events is retaken
            # from the start, at most TRACE_ATTEMPTS times
            tracer = tracing.Tracer(sim, spans)
            tracer.install()
            launches0 = sum(ops.launches.values())
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tracer.mark(tracing.WINDOW, 1)
                times = run.window(math.inf, max_frames=n_traced)
                tracer.mark(tracing.WINDOW, -1)
                torch.cuda.synchronize()
            tracer.uninstall()
            tracing.check_needs(needs, tracer.calls, {
                "frame": len(times),
                "iter": sum(f["iters"] for f in run.frame_stats)})
            launched = sum(ops.launches.values()) - launches0
            dev, left_out = tracing.kineto_events(prof)
            del prof
            try:
                tr = tracing.reduce_trace(dev, tracer.log, launched)
                break
            except tracing.TraceLost as e:
                log(f"trace attempt {attempt}: {e}")
                if attempt == TRACE_ATTEMPTS:
                    raise
        log(f"trace: {len(dev)} device events ({left_out} left out), "
            f"{tr.kernels} kernels, {launched} wrapper launches, busy "
            f"{tr.busy_s!r} s of {tr.window_s!r} s")
    else:
        times = run.window(seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    smi = nvidia_smi() if on_card else "no card"
    log(f"nvidia-smi: {smi}")
    power = smi.split(",")[1].strip() if smi.count(",") >= 1 else "unknown"
    for i, lap in enumerate(run.lap_summary()):
        log(f"lap {i}: {lap}")
    slow = sorted(range(len(times)), key=times.__getitem__)[-3:]
    log("slowest frames (ms, frame, lap position): " + ", ".join(
        f"{times[i] * 1e3:.1f} {i} {run.records[i][0]}" for i in slow[::-1]))
    ctx = types.SimpleNamespace(
        frames=len(times), frame_times=times, wall=run.wall, setup_s=setup_s,
        frame_stats=run.frame_stats, trace=tr, shapes=shapes,
        power_limit=power, log=log)
    metrics = {}
    for n, m in mods.items():
        v = m.read(ctx)
        if v is not None:
            metrics[n] = {"value": v, "unit": m.UNIT}
    run.release()
    t = time.perf_counter()
    per_frame = run.compare()
    correct, failed, checks = driver.judge(per_frame, cell.limits)
    log(f"comparison: {len(times)} frames in {time.perf_counter() - t:.3f} s")
    for k, vals in per_frame.items():
        q = sorted(vals)
        log(f"per frame {k}: median {q[len(q) // 2]!r}, p90 "
            f"{q[int(0.9 * (len(q) - 1))]!r}, max {q[-1]!r} (frame "
            f"{vals.index(q[-1])}, lap position "
            f"{run.records[vals.index(q[-1])][0]})")
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(times), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": l}
                        for k, (v, l) in checks.items()}
    for k, (v, l) in checks.items():
        log(f"check {k} {v!r} limit {l!r}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "cache", "triton")
    sys.path.insert(0, ROOT)
    import torch
    from bench_port import driver
    cell = driver.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards; "
            f"{torch.cuda.device_count()} found")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
