# Copied from dot_tpu/scripts.py (ScriptData, init_script); make_step_fn is ported to torch.
"""Scripted Dirichlet-BC animation — the reference's AnimScripter
(src/AnimScripter.cpp:29-453) re-cast as data + a pure per-step transform.

`init_script` selects handle vertices (from the x-extreme border slabs,
IglUtils::findBorderVerts) and builds dense per-vertex velocity fields;
`make_step_fn` returns a jit-safe function moving the handles by v*dt /
one rotation increment per step, with the turning-point flips and the
rubberBandPull release expressed as carried state.

Script state carried on device:
  vel_sign : scalar +-1, flips when the turning vertex crosses a bound
             (stretchnsquash / twistnsns*, AnimScripter.cpp:312-453)
  released : scalar bool, rubberBandPull waist release
  fixed    : (nV,) bool — changes only for rubberBandPull
"""

from __future__ import annotations

import dataclasses
import numpy as np

SCRIPTS = ("null", "scaleF", "hang", "stretch", "squash", "stretchnsquash",
           "bend", "twist", "twistnstretch", "twistnsns", "twistnsns_old",
           "rubberBandPull", "onepoint", "random", "fall")


@dataclasses.dataclass
class ScriptData:
    kind: str
    fixed0: np.ndarray          # (nV,) initial fixed mask
    lin_vel: np.ndarray         # (nV, 3) handle linear velocity
    flip_mask: np.ndarray       # (nV, 3) which lin_vel components flip sign
    ang_vel: np.ndarray         # (nV,) angular velocity (rad/s)
    rot_center: np.ndarray      # (nV, 3) per-vertex rotation center
    rot_axis: int               # 0=x (twist*), 2=z (bend)
    turning_vert: int           # vertex watched for velocity turning
    turning_lo: float
    turning_hi: float
    release_group: np.ndarray   # (nV,) bool — verts released (rubberBandPull)
    has_bc_change: bool         # does the fixed set ever change mid-run?
    x0: np.ndarray              # (nV, 3) possibly script-modified initial V


def init_script(mesh, kind: str) -> ScriptData:
    """Reference: AnimScripter::initAnimScript (AnimScripter.cpp:29-289)."""
    if kind not in SCRIPTS:
        raise ValueError(f"unknown script {kind!r}")
    nv = mesh.n_vert
    V = mesh.V.copy()
    fixed = np.zeros(nv, dtype=bool)
    lin_vel = np.zeros((nv, 3))
    flip_mask = np.zeros((nv, 3))
    ang_vel = np.zeros(nv)
    rot_center = np.zeros((nv, 3))
    rot_axis = 0
    turning_vert = 0
    lo, hi = -np.inf, np.inf
    release = np.zeros(nv, dtype=bool)
    has_bc_change = False
    border = mesh.border_verts

    def fix_borders():
        for b in border:
            fixed[b] = True

    if kind == "null":
        fixed[0] = True  # mesh default (Mesh.cpp:592-598)
    elif kind == "scaleF":
        V *= 1.5
    elif kind == "hang":
        for b in border:
            if len(b):
                fixed[b[-1]] = True
    elif kind in ("stretch", "squash", "stretchnsquash"):
        fix_borders()
        speed = {"stretch": -0.1, "squash": 0.03, "stretchnsquash": -0.9}[kind]
        for bi, b in enumerate(border):
            lin_vel[b, 0] = (-1.0) ** bi * speed
        if kind == "stretchnsquash":
            flip_mask[fixed] = [1.0, 0.0, 0.0]  # whole velocity flips (v is x-only)
            turning_vert = int(border[0][0])
            lo = V[turning_vert, 0] - 0.8
            hi = V[turning_vert, 0] + 0.4
    elif kind == "bend":
        fix_borders()
        rot_axis = 2
        for bi, b in enumerate(border):
            if len(b):
                # all but the last border vert rotate about the last one
                ang_vel[b[:-1]] = (-1.0) ** bi * -0.05 * np.pi
                rot_center[b[:-1]] = V[b[-1]]
    elif kind in ("twist", "twistnstretch", "twistnsns", "twistnsns_old"):
        fix_borders()
        rot_center[:] = mesh.bbox.mean(axis=0)
        rot_axis = 0
        ang = {"twist": -0.1, "twistnstretch": -0.1,
               "twistnsns": -0.4, "twistnsns_old": -0.4}[kind] * np.pi
        vx = {"twist": 0.0, "twistnstretch": -0.1,
              "twistnsns": -1.2, "twistnsns_old": -0.9}[kind]
        for bi, b in enumerate(border):
            ang_vel[b] = (-1.0) ** bi * ang
            lin_vel[b, 0] = (-1.0) ** bi * vx
        if kind in ("twistnsns", "twistnsns_old"):
            flip_mask[fixed] = [1.0, 0.0, 0.0]
            turning_vert = int(border[0][0])
            d = 1.2 if kind == "twistnsns" else 0.8
            lo = V[turning_vert, 0] - d
            hi = V[turning_vert, 0] + 0.4
    elif kind == "rubberBandPull":
        bl = V.min(axis=0)
        tr = V.max(axis=0)
        rng = tr - bl
        bottom = V[:, 1] < bl[1] + rng[1] * 0.02
        top = V[:, 1] > tr[1] - rng[1] * 0.02
        waist = ((V[:, 1] < tr[1] - rng[1] * 0.48)
                 & (V[:, 1] > bl[1] + rng[1] * 0.48))
        fixed[:] = bottom | top | waist
        lin_vel[bottom, 1] = -0.2
        lin_vel[top, 1] = 0.2
        lin_vel[waist, 0] = -2.5
        release[:] = waist
        widx = np.where(waist)[0]
        turning_vert = int(widx[0]) if len(widx) else 0
        lo = V[turning_vert, 0] - 5.0
        has_bc_change = True
    elif kind == "onepoint":
        center = mesh.bbox.mean(axis=0)
        V[:] = center
        V[:, 1] += (mesh.bbox[1, 1] - mesh.bbox[0, 1]) / 2.0
        fixed[0] = True
    elif kind == "random":
        rs = np.random.RandomState(0)
        V = rs.uniform(-0.5, 0.5, size=V.shape)
        offset = mesh.bbox.mean(axis=0)
        offset[1] += (mesh.bbox[1, 1] - mesh.bbox[0, 1]) / 2.0
        V += offset - V[0]
        fixed[0] = True
    elif kind == "fall":
        V[:, 1] += 0.5 * np.linalg.norm(np.ptp(V, axis=0))
        # no fixed verts

    return ScriptData(
        kind=kind, fixed0=fixed, lin_vel=lin_vel, flip_mask=flip_mask,
        ang_vel=ang_vel, rot_center=rot_center, rot_axis=rot_axis,
        turning_vert=turning_vert, turning_lo=float(lo), turning_hi=float(hi),
        release_group=release, has_bc_change=has_bc_change, x0=V,
    )


def make_step_fn(sd: ScriptData, dt: float):
    """Returns step(x, fixed, vel_sign, released) ->
    (x', fixed', vel_sign', released', bc_changed) on torch tensors.

    Mirrors AnimScripter::stepAnimScript (AnimScripter.cpp:291-453), as
    dot_tpu.scripts.make_step_fn does; the per-vertex script fields are
    moved to x's device and dtype once, at the first call.
    """
    import torch

    kind = sd.kind
    axis = sd.rot_axis
    has_rot = bool(np.any(sd.ang_vel != 0.0))
    has_lin = bool(np.any(sd.lin_vel != 0.0))
    has_turning = np.isfinite(sd.turning_lo) or np.isfinite(sd.turning_hi)
    tp = sd.turning_vert
    fields = {}

    def field(name, x):
        key = (name, x.device, x.dtype)
        if key not in fields:
            if name == "ang":
                val = torch.as_tensor(sd.ang_vel * dt, dtype=x.dtype)
            elif name == "release":
                val = torch.as_tensor(sd.release_group)
            else:
                val = torch.as_tensor(getattr(sd, name), dtype=x.dtype)
            fields[key] = val.to(x.device)
        return fields[key]

    def rot_increment(x):
        """Rotation of each handle vertex about `center` by ang[v] around
        the unit axis (reference uses AngleAxis about UnitX/UnitZ)."""
        ang = field("ang", x)
        center = field("rot_center", x)
        c = torch.cos(ang)
        s = torch.sin(ang)
        r = x - center
        if axis == 0:  # x-axis: rotate (y, z)
            ry = c * r[:, 1] - s * r[:, 2]
            rz = s * r[:, 1] + c * r[:, 2]
            rot = torch.stack([r[:, 0], ry, rz], dim=-1)
        else:  # z-axis: rotate (x, y)
            rx = c * r[:, 0] - s * r[:, 1]
            ry = s * r[:, 0] + c * r[:, 1]
            rot = torch.stack([rx, ry, r[:, 2]], dim=-1)
        return rot + center - x

    def step(x, fixed, vel_sign, released):
        bc_changed = torch.zeros((), dtype=torch.bool, device=x.device)
        disp = torch.zeros_like(x)
        lin_vel = field("lin_vel", x)
        flip_mask = field("flip_mask", x)

        if kind == "rubberBandPull":
            hit = x[tp, 0] <= sd.turning_lo
            newly = torch.logical_and(hit, torch.logical_not(released))
            released_n = torch.logical_or(released, hit)
            fixed = torch.where(newly, torch.logical_and(
                fixed, ~field("release", x)), fixed)
            bc_changed = newly
            active = torch.where(released_n, 0.0, 1.0).to(x.dtype)
            # the reference zeroes ALL velocities on release (handleVerts[0]
            # and [1]) — motion stops entirely
            disp = disp + lin_vel * dt * active
            return (x + disp * fixed[:, None], fixed, vel_sign, released_n,
                    bc_changed)

        if has_turning:
            flip = torch.logical_or(x[tp, 0] <= sd.turning_lo,
                                    x[tp, 0] >= sd.turning_hi)
            vel_sign = torch.where(flip, -vel_sign, vel_sign)

        if has_rot:
            disp = disp + rot_increment(x)
        if has_lin:
            v = lin_vel * torch.where(flip_mask > 0, vel_sign,
                                      torch.ones_like(vel_sign))
            disp = disp + v * dt

        return x + disp * fixed[:, None], fixed, vel_sign, released, bc_changed

    return step
