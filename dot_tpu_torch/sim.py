"""Frame-loop simulator driver (port of dot_tpu/sim.py): owns the per-run
output contract of the reference binary (reference: main.cpp:92-132
proceedOptimization, main.cpp:318-358 saveInfo, Optimizer.cpp:1095-1162
saveStatus).

Per run directory:
  config.txt        round-tripped config
  <n>.obj           surface mesh per step (compacted surface vertices)
  status<n>         restartable plain-text state (timestep/position/
                    velocity/dx_Elastic — same token format as reference)
  iterStats.txt     per-iteration rows (step, alpha, E, ||g||^2)
  info.txt          mesh size, iteration totals, timing buckets (the lines
                    of dot_tpu's info.txt)
  log.txt           tolerances, inner iter counts, sysE per step
  finalResult_mesh.msh

2D scenes (a primitive `shape`) go through dim2.Sim2D, which shares this
frame loop and writes the same files but the .msh and, as dot_tpu's 2D
run, an info.txt without the timing block; it runs Newton, DOT, GSDD and
the four LBFGS steppers.

This port runs all nine steppers at dim 3: `timeStepper DOT | GSDD | Newton
| LBFGS | LBFGSH | LBFGSHI | LBFGSJH | ADMM | ADMMDD`, the quasi-Newton ones
with `h0Refresh 1` (the reference's per-step refactorization; the key does
not apply to Newton and the two ADMM steppers, which own their factors'
lifetimes, and is ignored for them as dot_tpu ignores it). The other
h0Refresh policies, restart and the viewer raise NotImplementedError: they
are queue 1 of ROADMAP.md.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import io as meshio
from . import partition, scripts
from .device import resolve_device
from .config import Config
from .mesh import Mesh
from .steppers import (ADMMDDStepper, ADMMPDStepper, DOTStepper, GSDDStepper,
                       LBFGSH, LBFGSHI, LBFGSJH, LBFGSPD, NewtonStepper,
                       System)
from .steppers.core import APPLY_DTYPES

DEFAULT_REL_TOL = 1.0e-5   # README: "1e-5 CN ... used in all experiments"


class Timer:
    """Named-activity wall-clock accumulator (reference: Timer.hpp)."""

    def __init__(self):
        self.acc = {}
        self._cur = None
        self._t0 = None

    def start(self, name):
        self.stop()
        self._cur = name
        self._t0 = time.perf_counter()

    def stop(self):
        if self._cur is not None:
            self.acc[self._cur] = (self.acc.get(self._cur, 0.0)
                                   + time.perf_counter() - self._t0)
            self._cur = None

    def report(self):
        total = sum(self.acc.values())
        lines = [f"{k} {v:.6f}" for k, v in self.acc.items()]
        lines.append(f"total {total:.6f}")
        return "\n".join(lines)


def pick_dtype(name=None, device="cpu"):
    if name == "f64":
        return torch.float64
    if name == "f32":
        return torch.float32
    return torch.float64 if torch.device(device).type == "cpu" \
        else torch.float32


def _unsupported(what):
    return NotImplementedError(
        f"{what} is not ported to dot_tpu_torch yet (ROADMAP.md queue 1); "
        "the port runs 'timeStepper DOT, GSDD, Newton, LBFGS, LBFGSH, "
        "LBFGSHI, LBFGSJH, ADMM, ADMMDD' at dim 3 and on the 2D shapes "
        "(grid, square, rectangle, cylinder, spikes, Sharkey; warmStart "
        "0-4 there), the quasi-Newton steppers with 'h0Refresh 1'; no "
        "restart at either dimension")


STEPPERS = {"DOT": DOTStepper, "GSDD": GSDDStepper, "Newton": NewtonStepper,
            "LBFGS": LBFGSPD, "LBFGSH": LBFGSH, "LBFGSHI": LBFGSHI,
            "LBFGSJH": LBFGSJH, "ADMM": ADMMPDStepper, "ADMMDD": ADMMDDStepper}
# the steppers the h0Refresh key applies to (dot_tpu/sim.py:212-218)
QUASI_NEWTON = ("DOT", "GSDD", "LBFGS", "LBFGSH", "LBFGSHI", "LBFGSJH")


class Simulator:
    timing_in_info = True     # dot_tpu's 3D info.txt ends in the timing block

    def __init__(self, cfg: Config, output_dir: str, dtype=None, device=None,
                 search_dirs=(), save_every=1, mute=False, use_kernels=True,
                 plan=None):
        """`device`: None runs on the card (and raises without one);
        "cpu" runs on the CPU. `use_kernels=False` runs the plain PyTorch
        versions of the kernels instead (a comparison run; the main path
        keeps the default). `plan`: a SubdomainPlan already built for this
        scene's mesh, stepper and partition count (reused instead of
        partitioning again)."""
        device = resolve_device(device)
        if cfg.time_stepper not in STEPPERS:
            raise NotImplementedError(
                f"timeStepper {cfg.time_stepper} is unknown (the port runs "
                + ", ".join(STEPPERS) + ")")
        if cfg.h0_refresh != 1 and cfg.time_stepper in QUASI_NEWTON:
            raise _unsupported(f"h0Refresh {cfg.h0_refresh}")
        if cfg.restart:
            raise _unsupported("restart")
        self._begin(cfg, output_dir, device, save_every, mute)

        self.timer.start("load")
        self.mesh = Mesh.from_config(cfg, search_dirs)
        self.script_data = scripts.init_script(self.mesh, cfg.script)
        self.mesh.fixed_mask = self.script_data.fixed0.copy()

        # surface output maps (compacted surface vertices, main.cpp:800-834)
        sf = self.mesh.SF
        surf_verts = np.unique(sf.ravel())
        remap = np.full(self.mesh.n_vert, -1, np.int64)
        remap[surf_verts] = np.arange(len(surf_verts))
        self._surf_verts = surf_verts
        self._surf_faces = remap[sf]

        # dot_tpu's name for this bucket: on the card it also holds the
        # kernels' build at their first launch (the first H0)
        self.timer.start("partition+compile")
        dtype = dtype if dtype is not None else pick_dtype(None, self.device)
        # the plan each stepper runs on (dot_tpu/sim.py:131-196): DOT and
        # GSDD the element partition, Newton and LBFGS-H/HI the whole mesh
        # as one part, LBFGS-JH a disjoint node partition, LBFGS-PD and
        # ADMM-PD none, ADMM-DD the element partition with its own-element
        # tables and the ADMM-DD plan on top
        st = cfg.time_stepper
        if st in ("DOT", "GSDD", "LBFGSJH", "ADMMDD"):
            n_parts = partition.partition_amt_from_config(cfg,
                                                          self.mesh.n_vert)
        else:
            n_parts = 0 if st in ("LBFGS", "ADMM") else 1
        if plan is not None and plan.n_parts != n_parts:
            raise ValueError(f"plan has {plan.n_parts} parts; the scene "
                             f"asks for {n_parts}")
        if plan is None and st == "LBFGSJH":
            plan = partition.build_node_plan(self.mesh, n_parts)
        elif plan is None and st in ("DOT", "GSDD"):
            plan = partition.build_plan(self.mesh, n_parts,
                                        scheme=cfg.partition_scheme)
        elif plan is None and st == "ADMMDD":
            plan = partition.build_plan(self.mesh, n_parts, own_plan=True,
                                        scheme=cfg.partition_scheme)
        elif plan is None and n_parts == 1:
            plan = partition.build_plan(self.mesh, 1)
        # applyDtype -> System.apply_dtype (dot_tpu/sim.py:126-136); GSDD's
        # sweep never applies the coarse correction, so it is not built
        self.system = System(
            self.mesh, cfg, plan, dtype=dtype, device=self.device,
            use_kernels=use_kernels,
            apply_dtype=APPLY_DTYPES[cfg.apply_dtype],
            factor_dtype=torch.bfloat16 if st == "LBFGSHI" else None,
            use_coarse=False if st == "GSDD" else None)
        if st == "ADMMDD":
            if plan.n_own == 0 or (plan.own_udest is None
                                   and plan.own_band_dest is None):
                raise ValueError("ADMMDD needs a plan built with "
                                 "own_plan=True")
            self.stepper = ADMMDDStepper(
                self.system, self.script_data,
                partition.build_admm_dd_plan(self.mesh, plan),
                warm_start_opt=cfg.warm_start)
        elif st == "ADMM":
            self.stepper = ADMMPDStepper(self.system, self.script_data,
                                         max_iter=cfg.max_iter_apd)
        else:
            self.stepper = STEPPERS[st](self.system, self.script_data,
                                        warm_start_opt=cfg.warm_start)
        if (plan is not None and plan.part is not None
                and plan.n_parts > 1):
            meshio.write_partition_debug(output_dir, self.mesh, plan.part)

        self._start()

    def _begin(self, cfg, output_dir, device, save_every, mute):
        """The run's bookkeeping, before the mesh is loaded (shared with
        dim2.Sim2D)."""
        self.cfg = cfg
        self.out = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.save_every = save_every
        self.mute = mute
        self.timer = Timer()
        self.device = device
        # the two-loop's scalars drive convergence decisions: float32
        # matrix products must not drop to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def _start(self):
        """The initial state, the counters and the run's open files, once
        the stepper stands."""
        self.state = self.stepper.init_state()
        self.frame = 0
        self.frame_amt = int(self.cfg.duration / self.cfg.dt)
        self.inner_iter_total = 0
        self.ls_total = 0
        # per-frame host records: dicts of seconds, iters, halvings,
        # syncs, stop, sqn_g, tol, sysE
        self.frames = []
        self.timer.stop()

        self.cfg.save(os.path.join(self.out, "config.txt"))
        self._iter_stats = open(os.path.join(self.out, "iterStats.txt"), "w")
        self._log = open(os.path.join(self.out, "log.txt"), "w")

    # ------------------------------------------------------------------
    def _rel_tol(self, frame):
        tol = self.cfg.tol
        if not tol:
            return DEFAULT_REL_TOL
        return tol[min(frame, len(tol) - 1)]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, frames=None):
        """Advance `frames` frames; returns the mean seconds per frame."""
        n = self.frame_amt if frames is None else min(frames,
                                                      self.frame_amt - self.frame)
        t_begin = time.perf_counter()
        for _ in range(n):
            if self.frame % self.save_every == 0:
                self.timer.start("save")
                self.save_status()
                self.timer.stop()
            self.timer.start("step")
            self._sync()
            t0 = time.perf_counter()
            rel = self._rel_tol(self.frame)
            tol = self.system.target_g_res(rel)
            self.state, (stats, sys_e) = self.stepper.step(self.state, rel)
            self._sync()
            sec = time.perf_counter() - t0
            self.timer.stop()
            self._record(self.frame, stats, sys_e, tol, sec)
            self.frame += 1
        wall = time.perf_counter() - t_begin
        if not self.mute:
            print(f"ran {n} frames on {self.device} in {wall:.3f}s "
                  f"({wall / max(n, 1):.4f} s/frame)")
        return wall / max(n, 1)

    def _record(self, frame, stats, sys_e, tol, sec):
        it = stats.inner_iters
        self.inner_iter_total += it
        self.ls_total += stats.ls_halvings
        self.frames.append(dict(frame=frame, seconds=sec, iters=it,
                                halvings=stats.ls_halvings, syncs=stats.syncs,
                                stop=stats.stop, sqn_g=stats.sqn_g, tol=tol,
                                sys_e=sys_e))
        for r in stats.rows[:it + 1]:
            self._iter_stats.write(
                f"{frame} {r[0]:.6g} {r[1]:.10e} {r[2]:.10e}\n")
        self._log.write(
            f"Timestep{frame} innerIterAmt = {self.inner_iter_total}, "
            f"accumulated line search steps {self.ls_total}\n")
        self._log.write(f"{frame}th tol: {tol:.6e}\n")
        self._log.write(f"sysE = {float(sys_e):.10e}\n")
        if stats.stopped and it == 0:
            # dot_tpu/sim.py:370-371 (reachable with `timeStepper ADMM 0`)
            self._log.write("\tline search with Armijo's rule failed!!!\n")
        self._log.flush()
        self._iter_stats.flush()

    # ------------------------------------------------------------------
    def save_status(self):
        x = self.state.x.detach().to("cpu", torch.float64).numpy()
        v = self.state.v.detach().to("cpu", torch.float64).numpy().reshape(-1)
        dxe = self.state.dx_elastic.detach().to("cpu", torch.float64).numpy()
        n = self.frame
        with open(os.path.join(self.out, f"status{n}"), "w") as f:
            f.write(f"timestep {n}\n")
            f.write(f"\nposition {x.shape[0]} 3\n")
            for r in x:
                f.write("%le %le %le\n" % (r[0], r[1], r[2]))
            f.write(f"\nvelocity {v.size}\n")
            for val in v:
                f.write("%le\n" % val)
            f.write(f"\ndx_Elastic {dxe.shape[0]} 3\n")
            for r in dxe:
                f.write("%le %le %le\n" % (r[0], r[1], r[2]))
        self._write_obj(os.path.join(self.out, f"{n}.obj"), x)

    def _write_obj(self, path, x):
        meshio.write_obj(path, x[self._surf_verts], self._surf_faces)

    def _write_final_mesh(self, x):
        meshio.save_tet_mesh(os.path.join(self.out, "finalResult_mesh.msh"),
                             x, self.mesh.conn, self.mesh.SF)

    # ------------------------------------------------------------------
    def finalize(self):
        self.save_status()
        x = self.state.x.detach().to("cpu", torch.float64).numpy()
        self._write_final_mesh(x)
        with open(os.path.join(self.out, "info.txt"), "w") as f:
            f.write(f"vertAmt {self.mesh.n_vert}\n"
                    f"elemAmt {self.mesh.n_elem}\n")
            f.write(f"frames {self.frame}\n")
            f.write(f"innerIterTotal {self.inner_iter_total}\n")
            f.write(f"lineSearchTotal {self.ls_total}\n")
            if self.timing_in_info:
                f.write("--- timing (s) ---\n")
                f.write(self.timer.report() + "\n")
        self._iter_stats.close()
        self._log.close()


def parse_status(path):
    """Parse a plain-text status<n> checkpoint into (x, v, dx_elastic,
    frame) — same token format as the reference (Optimizer.cpp:126-177)."""
    with open(path) as f:
        toks = f.read().split()
    i = 0
    x = v = dxe = None
    frame = 0
    while i < len(toks):
        t = toks[i]
        if t == "timestep":
            frame = int(toks[i + 1]); i += 2
        elif t == "position":
            r, c = int(toks[i + 1]), int(toks[i + 2])
            x = np.asarray(toks[i + 3: i + 3 + r * c],
                           np.float64).reshape(r, c)
            i += 3 + r * c
        elif t == "velocity":
            nvals = int(toks[i + 1])
            v = np.asarray(toks[i + 2: i + 2 + nvals],
                           np.float64).reshape(-1, 3)
            i += 2 + nvals
        elif t == "dx_Elastic":
            r, c = int(toks[i + 1]), int(toks[i + 2])
            dxe = np.asarray(toks[i + 3: i + 3 + r * c],
                             np.float64).reshape(r, c)
            i += 3 + r * c
        else:
            i += 1
    return x, v, dxe, frame


def run_script(script_path, suffix="", frames=None, output_root="output",
               dtype=None, save_every=1, device=None, use_kernels=True,
               mute=False):
    """Load a scene script, simulate `frames` frames, write the output
    contract. `dtype` is "f32", "f64" or None (f64 on the CPU, f32 on a
    GPU); `device` None runs on the card and raises without one."""
    device = resolve_device(device)
    cfg = Config.load(script_path)
    name = cfg.output_folder_name()
    if suffix:
        name += "_" + suffix
    out = os.path.join(output_root, name)
    sim = Simulator(cfg, out, dtype=pick_dtype(dtype, device), device=device,
                    save_every=save_every, use_kernels=use_kernels, mute=mute,
                    search_dirs=(os.path.dirname(script_path),
                                 os.path.dirname(os.path.dirname(script_path))))
    sec_per_frame = sim.run(frames)
    sim.finalize()
    return sim, sec_per_frame
