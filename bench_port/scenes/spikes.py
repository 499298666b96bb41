"""Scene kind "spikes": the reference's 2D P_SPIKES shape (Mesh.cpp:289-340)
under a scene script, run by dot_tpu_torch.dim2.Sim2D.

The same three functions as scenes/bar.py: `write(cfg, traffic,
cache_dir, out_dir)` -> (scene script path, (V, F, handles): the mesh
data the reference takes), `simulator(scene_path, cfg, traffic, device,
out_dir)` -> the program's Sim2D, and `seed_velocity(seed, x0, fixed,
amp)`.

`spikes_2d` is dot_tpu_torch.mesh_gen.spikes_2d (the concave 7-corner
polygon, its boundary resampled at the target spacing, a staggered
lattice inside, scipy's Delaunay, triangles kept by their centroids; the
handles are the boundary chains 5 -> 6 -> 0 (left) and 1 -> 2 -> 3
(right)), copied with the helpers it calls, so that the yardstick does
not move with the program. The program triangulates the shape itself
from the scene script's `shape spikes` and `resolution`; the copy gives
the reference the same mesh.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

SCENE = """energy {energy}
timeStepper {stepper}
warmStart {warm_start}
resolution {resolution}
size {size!r}
time {duration!r} {dt!r}
density {density!r}
stiffness {youngs!r} {poisson!r}
script {script}
shape spikes
"""

SPIKES_POLY = np.asarray([
    [0.0, 0.0], [1.0, 0.0], [0.8, 0.7], [1.0, 1.0],
    [0.7, 0.9], [0.0, 1.0], [0.25, 0.4]])


def _point_in_polygon(pts, poly):
    """Even-odd ray test, pts (n, 2) against poly (m, 2)."""
    x, y = pts[:, 0:1], pts[:, 1:2]
    x0, y0 = poly[:, 0][None, :], poly[:, 1][None, :]
    x1, y1 = np.roll(poly[:, 0], -1)[None, :], np.roll(poly[:, 1], -1)[None, :]
    cross = (y0 > y) != (y1 > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xin = x0 + (y - y0) * (x1 - x0) / (y1 - y0)
    hits = cross & (x < xin)
    return (hits.sum(axis=1) % 2).astype(bool)


def _dist_to_segments(pts, a, b):
    """Least distance from each point to the segments a[i] -> b[i]."""
    ab = b - a
    den = np.maximum((ab * ab).sum(axis=1), 1e-30)
    ap = pts[:, None, :] - a[None, :, :]
    t = np.clip((ap * ab[None]).sum(axis=2) / den[None], 0.0, 1.0)
    d = ap - t[..., None] * ab[None]
    return np.sqrt((d * d).sum(axis=2).min(axis=1))


def _resample_polygon(poly, h):
    """Points along each edge at most h apart, corners kept."""
    out = []
    for i in range(len(poly)):
        a, b = poly[i], poly[(i + 1) % len(poly)]
        n = max(int(np.ceil(np.linalg.norm(b - a) / h)), 1)
        for k in range(n):
            out.append(a + (b - a) * (k / n))
    return np.asarray(out)


def triangulate_polygon(poly, elem_amt):
    """(V (n, 2), F (m, 3)): about elem_amt CCW triangles filling the CCW
    polygon."""
    from scipy.spatial import Delaunay

    x, y = poly[:, 0], poly[:, 1]
    area = 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
    h = float(np.sqrt(area / elem_amt * 4.0 / np.sqrt(3.0)))
    bnd = _resample_polygon(poly, h)
    lo, hi = poly.min(axis=0), poly.max(axis=0)
    nx = int((hi[0] - lo[0]) / h) + 2
    ny = int((hi[1] - lo[1]) / (h * np.sqrt(3.0) / 2.0)) + 2
    gx = lo[0] + np.arange(nx) * h
    gy = lo[1] + np.arange(ny) * (h * np.sqrt(3.0) / 2.0)
    X, Y = np.meshgrid(gx, gy, indexing="xy")
    X[1::2] += 0.5 * h
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)
    keep = _point_in_polygon(pts, poly)
    keep &= _dist_to_segments(pts, poly, np.roll(poly, -1, axis=0)) > 0.6 * h
    allp = np.concatenate([bnd, pts[keep]], axis=0)
    F = Delaunay(allp).simplices.astype(np.int64)
    F = F[_point_in_polygon(allp[F].mean(axis=1), poly)]
    e1 = allp[F[:, 1]] - allp[F[:, 0]]
    e2 = allp[F[:, 2]] - allp[F[:, 0]]
    cw = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) < 0
    F[cw, 1], F[cw, 2] = F[cw, 2].copy(), F[cw, 1].copy()
    used = np.unique(F.ravel())
    remap = np.full(len(allp), -1, np.int64)
    remap[used] = np.arange(len(used))
    return allp[used], remap[F]


def spikes_2d(size=1.0, elem_amt=200):
    """(V (nV, 3) with z = 0, F (nE, 3), [left, right] handle vertex
    ids): the boundary vertices within 0.3 h of each chain."""
    V2, F = triangulate_polygon(SPIKES_POLY * size, elem_amt)
    V = np.concatenate([V2, np.zeros((len(V2), 1))], axis=1)
    h = float(np.sqrt(0.725 * size * size / elem_amt * 4.0 / np.sqrt(3.0)))
    chains = []
    for ids in ([5, 6, 0], [1, 2, 3]):
        c = SPIKES_POLY[ids] * size
        d = _dist_to_segments(V2, c[:-1], c[1:])
        chains.append(np.flatnonzero(d < 0.3 * h))
    return V, F, chains


def cached_mesh(cfg, cache_dir):
    """(V, F, [left, right]) of cfg["mesh"], generated once into
    `cache_dir` under a name made of the mesh's parameters."""
    m = cfg["mesh"]
    if float(m["size"]) != float(cfg["scene_script"]["size"]):
        raise ValueError("mesh size and scene size differ")
    path = os.path.join(cache_dir, f"spikes-r{int(m['resolution'])}"
                                   f"-s{float(m['size'])!r}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["V"], z["F"], [z["left"], z["right"]]
    V, F, (left, right) = spikes_2d(float(m["size"]), int(m["resolution"]))
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, V=V, F=F, left=left, right=right)
    os.replace(tmp, path)
    return V, F, [left, right]


def write_scene(path, cfg, traffic, mesh_path=None):
    """The scene script of a cell: the configuration's shape and scene and
    the traffic's time stepper and warm start (a generated shape: no mesh
    file, `mesh_path` is not read)."""
    with open(path, "w") as f:
        f.write(SCENE.format(stepper=traffic["time_stepper"],
                             warm_start=traffic["warm_start"],
                             resolution=int(cfg["mesh"]["resolution"]),
                             **cfg["scene_script"]))


def write(cfg, traffic, cache_dir, out_dir):
    """(the cell's scene script, (V, F, handles) of its mesh)."""
    mesh = cached_mesh(cfg, cache_dir)
    scene = os.path.join(out_dir, "scene.txt")
    write_scene(scene, cfg, traffic)
    return scene, mesh


def simulator(scene_path, cfg, traffic, device, out_dir):
    """The program's 2D entry on the scene; it writes a frame's status
    every `save_every` frames of the traffic (none by default)."""
    from dot_tpu_torch.config import Config
    from dot_tpu_torch.dim2 import Sim2D
    from bench_port.driver import DTYPES
    return Sim2D(Config.load(scene_path), out_dir,
                 dtype=DTYPES[cfg["scene_script"]["dtype"]],
                 device=device, mute=True,
                 save_every=int(traffic.get("save_every", 10 ** 9)))


def seed_velocity(seed, x0, fixed, amp):
    """The start velocity of seed `seed`: one smooth wave in x and in y
    across the shape (amplitude amp * U(0.5, 1), random sign, wave numbers
    1-2 along x and y, random phase), z = 0, zero at the handles. Every
    seed gives the same work: the same mesh, frames and script."""
    rng = np.random.default_rng(seed)
    a = amp * rng.uniform(0.5, 1.0, 2) * rng.choice([-1.0, 1.0], 2)
    k = rng.integers(1, 3, size=(2, 2)).astype(np.float64)
    ph = rng.uniform(0.0, 2.0 * math.pi, 2)
    x = x0.to(torch.float64)[:, :2]
    lo, hi = x.min(dim=0).values, x.max(dim=0).values
    t = lambda a_: torch.as_tensor(a_, dtype=torch.float64, device=x.device)
    v = t(a) * torch.sin(2.0 * math.pi * (((x - lo) / (hi - lo)) @ t(k).T)
                         + t(ph))
    v = torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)
    return torch.where(fixed[:, None], 0.0, v).to(x0.dtype)
