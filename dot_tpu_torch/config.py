# Copied from dot_tpu/config.py: the port cannot import dot_tpu, whose package import pulls in jax.
"""Scene-script configuration: the same whitespace-token .txt grammar the
reference parses (reference: src/Config.cpp:43-302, grammar quick reference
in README "Script Settings").

Keys: energy {FCR|SNH|SNHWL} | timeIntegration BE | timeStepper {Newton|ADMM n|
ADMMDD n|LBFGS|LBFGSH|LBFGSHI|LBFGSJH n|DOT {n | -1 blockSize}|GSDD n} |
inexactSolve {0|1} | warmStart 0-5 | resolution n | size s | time dur dt |
density rho | stiffness E nu | turnOffGravity | script <type> |
handleRatio r | shape {...|input <path>} | rotateModel ax ay az deg |
tol k v1..vk | restart <statusPath> | view {orthographic|perspective} |
zoom z | appendStr s | disableCout | tuning k v1..vk
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

TIME_STEPPERS = ("Newton", "ADMM", "ADMMDD", "LBFGS", "LBFGSH", "LBFGSHI",
                 "LBFGSJH", "DOT", "GSDD")
ANIM_SCRIPTS = ("null", "scaleF", "hang", "stretch", "squash",
                "stretchnsquash", "bend", "twist", "twistnstretch",
                "twistnsns", "twistnsns_old", "rubberBandPull", "onepoint",
                "random", "fall")
SHAPES = ("grid", "square", "rectangle", "spikes", "Sharkey", "cylinder",
          "input")
# steppers that take a partition-count argument (Config.cpp:66-81)
_PARTITIONED = ("ADMMDD", "DOT", "LBFGSJH", "GSDD")


@dataclasses.dataclass
class Config:
    energy: str = "FCR"
    time_integration: str = "BE"
    time_stepper: str = "Newton"
    partition_amt: int = -1
    block_size: int = -1
    max_iter_apd: int = 1000
    inexact_solve: int = 0
    warm_start: int = 2
    resolution: int = 100
    size: float = 1.0
    duration: float = 10.0
    dt: float = 0.025
    rho: float = 1.0
    ym: float = 100.0
    pr: float = 0.4
    with_gravity: bool = True
    script: str = "null"
    handle_ratio: float = 0.01
    shape: str = "grid"
    input_shape_path: str = ""
    rot_axis: tuple = (0.0, 0.0, 1.0)
    rot_deg: float = 0.0
    tol: List[float] = dataclasses.field(default_factory=list)
    tuning: List[float] = dataclasses.field(default_factory=list)
    restart: bool = False
    status_path: str = ""
    orthographic: bool = False
    zoom: float = 1.0
    append_str: str = ""
    disable_cout: bool = False
    # dot_tpu extension (not in the reference grammar): storage dtype of
    # the quasi-Newton H0 factors for per-iteration applies — "" (auto:
    # bf16 for f32 runs), "f32", "f64", or "bf16". See System.apply_dtype.
    apply_dtype: str = ""
    # dot_tpu extension: element-partition scheme, the reference's
    # compile-time USE_METIS selector surfaced as a config key
    # (ADMMDDTimeStepper.cpp:88-152): 1 uniform k-way (default), 2 axis
    # slabs (partMesh_slice), 3 distance-to-surface weights, 4 valence
    # weights. See partition.element_partition.
    partition_scheme: int = 1
    # dot_tpu extension: two-level H0 — add a per-subdomain rigid-mode
    # coarse-space correction to the quasi-Newton H0 apply (classic
    # two-level domain decomposition; no reference counterpart — it is
    # what keeps DOT iteration counts flat as the subdomain count grows
    # in blockSize mode). -1 auto (on when n_parts >= 16), 0 off, 1 on.
    coarse: int = -1
    # dot_tpu extension: H0 rebuild cadence for the quasi-Newton steppers
    # (DOT/GSDD/LBFGS-H/HI/JH). The reference refactorizes every time
    # step (DOTTimeStepper.cpp:343) — cheap for CHOLMOD relative to its
    # iteration cost; on TPU the rebuild+factorization is ~62% of a
    # bar17K frame, so the frozen preconditioner may live across frames.
    # 1 = every step (reference semantics, default); k > 1 = refresh
    # every k frames; -1 = adaptive (refresh when the lagged iteration
    # count regresses past 1.5x the post-refresh baseline + 2, or after
    # 32 frames, or on any Dirichlet-set change). Tolerance is untouched.
    h0_refresh: int = 1

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            lines = f.read().splitlines()
        return cls.parse_lines(lines)

    @classmethod
    def parse_lines(cls, lines) -> "Config":
        cfg = cls()
        li = 0

        def take_values(count, li):
            """Consume `count` numbers from the following lines (the
            reference reads them from the file stream, Config.cpp:135-141)."""
            vals: List[float] = []
            while len(vals) < count and li < len(lines):
                toks = lines[li].split()
                li += 1
                for t in toks:
                    if len(vals) < count:
                        vals.append(float(t))
            return vals, li

        while li < len(lines):
            toks = lines[li].split()
            li += 1
            if not toks:
                continue
            key = toks[0]
            if key == "energy":
                cfg.energy = toks[1]
            elif key == "timeIntegration":
                cfg.time_integration = toks[1]
            elif key == "timeStepper":
                cfg.time_stepper = toks[1]
                if cfg.time_stepper not in TIME_STEPPERS:
                    # the reference falls back silently (Config.cpp:378-387);
                    # e.g. the shipped otherMethods "ADMMPD" scene actually
                    # runs projected Newton there
                    print(f"unknown timeStepper {cfg.time_stepper!r}, "
                          "use default: Newton")
                    cfg.time_stepper = "Newton"
                if cfg.time_stepper in _PARTITIONED:
                    cfg.partition_amt = int(toks[2])
                    if cfg.partition_amt < 0:
                        cfg.block_size = int(toks[3])
                        assert cfg.block_size >= 3
                    elif cfg.partition_amt < 2:
                        cfg.partition_amt = 4
                elif cfg.time_stepper == "ADMM":
                    cfg.max_iter_apd = int(toks[2]) if len(toks) > 2 else 1000
                    if cfg.max_iter_apd < 1:
                        cfg.max_iter_apd = 10
            elif key == "inexactSolve":
                cfg.inexact_solve = int(toks[1])
            elif key == "resolution":
                cfg.resolution = int(toks[1])
            elif key == "size":
                cfg.size = float(toks[1])
            elif key == "time":
                cfg.duration, cfg.dt = float(toks[1]), float(toks[2])
            elif key == "density":
                cfg.rho = float(toks[1])
            elif key == "stiffness":
                cfg.ym, cfg.pr = float(toks[1]), float(toks[2])
            elif key == "turnOffGravity":
                cfg.with_gravity = False
            elif key == "script":
                cfg.script = toks[1]
            elif key == "shape":
                cfg.shape = toks[1]
                if cfg.shape == "input":
                    cfg.input_shape_path = toks[2]
            elif key == "tol":
                amt = int(toks[1])
                cfg.tol, li = take_values(amt, li)
            elif key == "warmStart":
                cfg.warm_start = int(toks[1])
            elif key == "view":
                cfg.orthographic = (toks[1] == "orthographic")
            elif key == "zoom":
                cfg.zoom = float(toks[1])
            elif key == "appendStr":
                cfg.append_str = toks[1]
            elif key == "applyDtype":
                if toks[1] not in ("f32", "f64", "bf16"):
                    raise ValueError(f"applyDtype {toks[1]} (use f32/f64/bf16)")
                cfg.apply_dtype = toks[1]
            elif key == "partitionScheme":
                if int(toks[1]) not in (1, 2, 3, 4):
                    raise ValueError(f"partitionScheme {toks[1]} (use 1-4)")
                cfg.partition_scheme = int(toks[1])
            elif key == "coarse":
                if int(toks[1]) not in (-1, 0, 1):
                    raise ValueError(f"coarse {toks[1]} (use -1/0/1)")
                cfg.coarse = int(toks[1])
            elif key == "h0Refresh":
                v = int(toks[1])
                if v == 0 or v < -1:
                    raise ValueError(
                        f"h0Refresh {toks[1]} (use -1 adaptive or k >= 1)")
                cfg.h0_refresh = v
            elif key == "restart":
                cfg.restart = True
                cfg.status_path = toks[1]
            elif key == "disableCout":
                cfg.disable_cout = True
            elif key == "rotateModel":
                cfg.rot_axis = (float(toks[1]), float(toks[2]), float(toks[3]))
                cfg.rot_deg = float(toks[4])
            elif key == "handleRatio":
                cfg.handle_ratio = float(toks[1])
                assert 0.0 < cfg.handle_ratio < 0.5
            elif key == "tuning":
                amt = int(toks[1])
                cfg.tuning, li = take_values(amt, li)
            # unknown keys are silently ignored, as in the reference

        if cfg.time_stepper == "ADMM" and cfg.warm_start != 2:
            cfg.warm_start = 2  # forced (Config.cpp:196-201)
        return cfg

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Round-trip save (reference: Config::saveToFile, Config.cpp:209-302)."""
        out = []
        out.append(f"energy {self.energy}")
        out.append(f"timeIntegration {self.time_integration}")
        ts = f"timeStepper {self.time_stepper}"
        if self.time_stepper in _PARTITIONED:
            if self.block_size > 0:
                ts += f" -1 {self.block_size}"
            else:
                ts += f" {self.partition_amt}"
        elif self.time_stepper == "ADMM":
            ts += f" {self.max_iter_apd}"
        out.append(ts)
        out.append(f"inexactSolve {self.inexact_solve}")
        out.append(f"warmStart {self.warm_start}")
        out.append(f"resolution {self.resolution}")
        out.append(f"size {self.size:g}")
        out.append(f"time {self.duration:g} {self.dt:g}")
        out.append(f"density {self.rho:g}")
        out.append(f"stiffness {self.ym:g} {self.pr:g}")
        if not self.with_gravity:
            out.append("turnOffGravity")
        out.append(f"script {self.script}")
        if self.handle_ratio != 0.01:
            out.append(f"handleRatio {self.handle_ratio:g}")
        shape = f"shape {self.shape}"
        if self.shape == "input":
            shape += f" {self.input_shape_path}"
        out.append(shape)
        if self.rot_deg != 0.0:
            out.append("rotateModel %g %g %g %g"
                       % (*self.rot_axis, self.rot_deg))
        if self.restart:
            out.append(f"restart {self.status_path}")
        if self.tuning:
            out.append(f"tuning {len(self.tuning)}")
            out.extend(f"{v:g}" for v in self.tuning)
        out.append("view " + ("orthographic" if self.orthographic else "perspective"))
        out.append(f"zoom {self.zoom:g}")
        if self.append_str:
            out.append(f"appendStr {self.append_str}")
        if self.apply_dtype:
            out.append(f"applyDtype {self.apply_dtype}")
        if self.partition_scheme != 1:
            out.append(f"partitionScheme {self.partition_scheme}")
        if self.coarse != -1:
            out.append(f"coarse {self.coarse}")
        if self.h0_refresh != 1:
            out.append(f"h0Refresh {self.h0_refresh}")
        if self.disable_cout:
            out.append("disableCout")
        if self.tol:
            out.append(f"tol {len(self.tol)}")
            out.extend(f"{v:g}" for v in self.tol)
        with open(path, "w") as f:
            f.write("\n".join(out) + "\n")

    # ------------------------------------------------------------------
    def output_folder_name(self) -> str:
        """Synthesized run-folder name fragment mirroring
        Config::appendInfoStr (Config.cpp:304-346)."""
        if self.shape == "input":
            base = self.input_shape_path.rsplit("/", 1)[-1]
            shape_name = base.rsplit(".", 1)[0]
        else:
            shape_name = self.shape
        name = (f"{shape_name}_{self.script}_{self.energy}_"
                f"{self.time_stepper}")
        if self.time_stepper in _PARTITIONED:
            name += f"{self.block_size if self.block_size > 0 else self.partition_amt}"
        if self.append_str:
            name += f"_{self.append_str}"
        return name
