"""Set-up, the measured window and the comparison of one run of a cell.

A cell is a configuration (configs/<name>.json: the mesh, the scene, its
scene kind (scenes/<kind>.py) and the plain reference that judges it
(references/<name>.py)) under a traffic mix (traffic/<name>.json: the
time stepper, its warm start, the lap of frames, the frames a traced run
profiles, the size of the seeded start velocity). The program is driven through its own entry, the scene
kind's Simulator: the window calls Simulator.run(1) frame after frame over
laps of `lap_frames` frames from the scene's start, and puts the run back
to that start (the state Simulator built, with the seed's start
velocity) at the end of each lap.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DTYPES = {"f32": torch.float32, "f64": torch.float64}
DTYPE_NAMES = {torch.float32: "f32", torch.float64: "f64",
               torch.bfloat16: "bf16"}


@dataclasses.dataclass
class Cell:
    workload: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list     # metric names the cell reports with --trace 0
    per_layer: list      # and with --trace 1
    chips: int = 1


def _load(path):
    with open(path) as f:
        return json.load(f)


def load_cell(root, workload):
    """The cell `workload` of root/BENCHMARK.json with its configuration,
    traffic and limits files (found by their names)."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r} (BENCHMARK.json "
                         f"has {', '.join(cells)})")
    w = cells[workload]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    e2e = [m["name"] for m in bench["end_to_end"]]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if workload in m["workloads"]]
    return Cell(workload=workload, chips=int(w["chips"]), end_to_end=e2e,
                per_layer=per_layer,
                config=_load(os.path.join(root, cfg_file)),
                traffic=_load(os.path.join(HERE, "traffic",
                                           f"{w['traffic']}.json")),
                limits=_load(os.path.join(HERE, "limits",
                                          f"{workload}.json")))


def scene_kind(cfg):
    return importlib.import_module(f"bench_port.scenes.{cfg['scene']}")


def reference_module(cfg):
    return importlib.import_module(f"bench_port.references.{cfg['reference']}")


class Run:
    """One run of a cell on `device` ("cuda" on the card; "cpu" in the
    harness's own tests)."""

    def __init__(self, cell, seed, device, work_dir):
        self.cell, self.seed, self.device = cell, seed, device
        self.work_dir = work_dir
        self.setup = {}

    # ---- set-up ---------------------------------------------------------
    def build(self, t_process):
        cfg, tr = self.cell.config, self.cell.traffic
        self.scene = scene_kind(cfg)
        t = time.perf_counter()
        self.setup["imports"] = t - t_process
        if self.device == "cuda":
            from dot_tpu_torch.kernels.csrc import build
            build.build()
        self.setup["nvcc"] = time.perf_counter() - t
        t = time.perf_counter()
        out = os.path.join(self.work_dir, "out", self.cell.workload)
        os.makedirs(out, exist_ok=True)
        scene, self.mesh_data = self.scene.write(
            cfg, tr, os.path.join(self.work_dir, "cache"), out)
        self.setup["mesh_data"] = time.perf_counter() - t
        t = time.perf_counter()
        sim = self.scene.simulator(scene, cfg, tr, self.device, out)
        self.setup["simulator"] = time.perf_counter() - t
        for k, v in sim.timer.acc.items():   # the program's own buckets
            self.setup[f"simulator.{k}"] = v
        # the frame counter runs on through the laps (its scene's 200
        # frames end its own runs); frame 0's save is the warm-up's
        sim.frame_amt = sys.maxsize
        self.sim = sim
        self.init = sim.state
        self.use_seed(self.seed)
        t = time.perf_counter()
        self.reset()
        sim.run(1)
        self.reset()
        self._sync()
        self.setup["warm_up"] = time.perf_counter() - t

    def use_seed(self, seed):
        """The start velocity of `seed` for every lap from here on."""
        self.seed = seed
        self.v0 = self.scene.seed_velocity(
            seed, self.init.x, self.init.fixed,
            self.cell.traffic["seed_velocity_m_per_s"])

    def reset(self):
        """Back to the scene's start: the state Simulator built (its
        tensors are never written in place), with the seed's velocity."""
        s = self.init
        self.sim.state = dataclasses.replace(
            s, v=self.v0,
            x_tilta=self.sim.system.compute_x_tilta(s.x, self.v0, s.fixed))

    def _sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    # ---- the window -----------------------------------------------------
    def window(self, seconds, max_frames=None):
        """Frames of Simulator.run(1) from the lap's start until `seconds`
        have passed (or `max_frames` ran). Returns the frames' host times;
        keeps each frame's lap position, positions and sysE."""
        sim, lap = self.sim, int(self.cell.traffic["lap_frames"])
        self.reset()
        self.records = []
        times = []
        pos = 0
        n0 = len(sim.frames)
        t_start = time.perf_counter()
        while True:
            if pos == lap:
                self.reset()
                pos = 0
            t0 = time.perf_counter()
            sim.run(1)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            self.records.append((pos, sim.state.x))
            pos += 1
            if t1 - t_start >= seconds or len(times) == max_frames:
                break
        self.wall = t1 - t_start
        self.frame_stats = sim.frames[n0:]
        return times

    def lap_summary(self):
        """Iterations of each whole lap and of the last partial one."""
        laps, cur = [], []
        for (pos, _), fr in zip(self.records, self.frame_stats):
            if pos == 0 and cur:
                laps.append(cur)
                cur = []
            cur.append(fr)
        laps.append(cur)
        return [dict(frames=len(l), iters=sum(f["iters"] for f in l),
                     halvings=sum(f["halvings"] for f in l),
                     syncs=sum(f["syncs"] for f in l),
                     stops={s: sum(f["stop"] == s for f in l)
                            for s in sorted({f["stop"] for f in l})})
                for l in laps]

    # ---- the comparison -------------------------------------------------
    def release(self, free=True):
        """Keep what the comparison reads (the start state, each frame's
        positions and reports) and, with `free`, drop the program (its
        Simulator and System)."""
        self.x_start = self.init.x
        self.sys_e = [fr["sys_e"] for fr in self.frame_stats]
        self.sqn_g = [fr["sqn_g"] for fr in self.frame_stats]
        if not free:
            return
        del self.sim, self.init
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def compare(self):
        """Per frame (the reference's numbers), each frame judged from the
        positions the window produced before it."""
        dt = float(self.cell.config["scene_script"]["dt"])
        ref = reference_module(self.cell.config).Scene(
            self.cell.config, self.mesh_data, self.device, "f64")
        f64 = torch.float64
        xs = [x for _, x in self.records]
        starts, vels = [], []
        for i, (pos, _) in enumerate(self.records):
            x_n = self.x_start if pos == 0 else xs[i - 1]
            if pos == 0:
                v_n = self.v0
            else:
                x_nm1 = self.x_start if pos == 1 else xs[i - 2]
                v_n = (x_n.to(f64) - x_nm1.to(f64)) / dt
            starts.append(x_n)
            vels.append(v_n)
        batch = max(1, 4_000_000 // ref.n_elem)
        out = {}
        for b in range(0, len(xs), batch):
            sl = slice(b, b + batch)
            st = lambda seq: torch.stack([a.to(f64) for a in seq[sl]])
            nums = ref.frame_numbers(st(starts), st(vels), st(xs),
                                     self.sys_e[sl], self.sqn_g[sl])
            for k, n in nums.items():
                out.setdefault(k, []).extend(n.tolist())
        return out


def judge(per_frame, limits):
    """(correct, failed frames, {number: (value, limit)}): each compared
    number, the largest over the window's frames of one of the
    reference's per-frame numbers, against its limit."""
    checks = {}
    failed = set()
    for name, lim in limits["numbers"].items():
        vals = per_frame[lim["of"]]
        checks[name] = (max(vals), lim["limit"])
        failed.update(i for i, v in enumerate(vals) if not v <= lim["limit"])
    return not failed, len(failed), checks
