"""Scene kind "bar": a structured tet bar under a scene script, run by
dot_tpu_torch.sim.Simulator (3D).

What a scene kind offers the driver: `write(cfg, traffic, cache_dir,
out_dir)` -> (scene script path, the mesh data the reference takes),
`simulator(scene_path, cfg, traffic, device, out_dir)` -> the program's
Simulator,
and `seed_velocity(seed, x0, fixed, amp)`.

`bar_mesh` is dot_tpu_torch.mesh_gen.bar_mesh (nx*ny*nz cubes, 6 Kuhn tets
each, in the same tet order and orientation) computed without the
per-tet Python loop, so that bar135's 755,346 tets take a second, and
returning plain arrays. `SCENE` is tools/scalability.py's twist template,
filled from a configuration's `scene_script`.
Both are copies, so that the yardstick does not move with the program.
"""

from __future__ import annotations

import itertools
import math
import os

import numpy as np
import torch

SCENE = """energy {energy}
timeStepper {stepper}
warmStart {warm_start}
resolution 1000
size {size!r}
time {duration!r} {dt!r}
density {density!r}
stiffness {youngs!r} {poisson!r}
script {script}
shape input {mesh_path}
"""


def bar_mesh(nx, ny, nz, size=(1.0, 0.25, 0.25)):
    """(V (nV, 3) float64, TT (nE, 4) int64): the cubes in (i, j, k) order,
    each split along its main diagonal into the 6 tets of the axis
    permutations, every tet with a positive signed volume."""
    xs = np.linspace(0, size[0], nx + 1)
    ys = np.linspace(0, size[1], ny + 1)
    zs = np.linspace(0, size[2], nz + 1)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    V = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    base = np.stack([i, j, k], axis=-1).reshape(-1, 1, 1, 3)
    paths = []
    for perm in itertools.permutations(range(3)):
        cur = np.zeros(3, np.int64)
        path = [cur.copy()]
        for ax in perm:
            cur[ax] = 1
            path.append(cur.copy())
        paths.append(path)
    ijk = base + np.asarray(paths)[None]                 # (cells, 6, 4, 3)
    TT = ((ijk[..., 0] * (ny + 1) + ijk[..., 1]) * (nz + 1)
          + ijk[..., 2]).reshape(-1, 4)

    p = V[TT]
    X = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]],
                 axis=-1)
    neg = np.linalg.det(X) < 0
    TT[neg, 2], TT[neg, 3] = TT[neg, 3].copy(), TT[neg, 2].copy()
    return V, TT


def surface_tris(TT):
    """Faces of exactly one tet, oriented outward (the reference's
    findSurfaceTris)."""
    TT = np.asarray(TT, dtype=np.int64)
    faces = np.concatenate([TT[:, [1, 2, 3]], TT[:, [0, 3, 2]],
                            TT[:, [0, 1, 3]], TT[:, [0, 2, 1]]], axis=0)
    key = np.sort(faces, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                               return_counts=True)
    return faces[counts[inv.reshape(-1)] == 1]


def write_msh(path, V, TT):
    """The reference's .msh flavour ($Nodes, $Elements, $Surface), node
    coordinates with 17 significant digits so that a reader gets V back
    exactly. Written to a temporary name and renamed."""
    SF = surface_tris(TT)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write("$MeshFormat\n4 0 8\n$EndMeshFormat\n")
        f.write("$Entities\n0 0 0 1\n")
        mn, mx = V.min(axis=0), V.max(axis=0)
        f.write("0 %le %le %le %le %le %le 0 0\n$EndEntities\n"
                % (mn[0], mn[1], mn[2], mx[0], mx[1], mx[2]))
        f.write("$Nodes\n1 %d\n0 3 0 %d\n" % (len(V), len(V)))
        ids = np.arange(1, len(V) + 1)[:, None]
        np.savetxt(f, np.hstack([ids, V]), fmt=["%d"] + ["%.17g"] * 3)
        f.write("$EndNodes\n$Elements\n1 %d\n0 3 4 %d\n" % (len(TT), len(TT)))
        ids = np.arange(1, len(TT) + 1)[:, None]
        np.savetxt(f, np.hstack([ids, TT + 1]), fmt="%d")
        f.write("$EndElements\n$Surface\n%d\n" % len(SF))
        np.savetxt(f, SF + 1, fmt="%d")
        f.write("$EndSurface\n")
    os.replace(tmp, path)


def cached_mesh(cfg, cache_dir):
    """(path of the configuration's .msh, V, TT): the bar generated from
    cfg["mesh"] and written once into `cache_dir` (the data set; a fixed
    path, so that every later run of the checkout reads it)."""
    m = cfg["mesh"]
    V, TT = bar_mesh(*m["cells"], size=tuple(m["size"]))
    path = os.path.join(cache_dir, f"{cfg['name']}.msh")
    if not os.path.exists(path):
        os.makedirs(cache_dir, exist_ok=True)
        write_msh(path, V, TT)
    return path, V, TT


def write_scene(path, cfg, traffic, mesh_path):
    """The scene script of a cell: the configuration's scene and the
    traffic's time stepper and warm start."""
    with open(path, "w") as f:
        f.write(SCENE.format(stepper=traffic["time_stepper"],
                             warm_start=traffic["warm_start"],
                             mesh_path=mesh_path, **cfg["scene_script"]))


def write(cfg, traffic, cache_dir, out_dir):
    """(the cell's scene script, (V, TT) of its mesh)."""
    mesh_path, V, TT = cached_mesh(cfg, cache_dir)
    scene = os.path.join(out_dir, "scene.txt")
    write_scene(scene, cfg, traffic, os.path.abspath(mesh_path))
    return scene, (V, TT)


def simulator(scene_path, cfg, traffic, device, out_dir):
    """The program's entry on the scene; it writes a frame's status and
    surface every `save_every` frames of the traffic (none by default)."""
    from dot_tpu_torch.config import Config
    from dot_tpu_torch.sim import Simulator
    from bench_port.driver import DTYPES
    return Simulator(Config.load(scene_path), out_dir,
                     dtype=DTYPES[cfg["scene_script"]["dtype"]],
                     device=device, mute=True,
                     save_every=int(traffic.get("save_every", 10 ** 9)))


def seed_velocity(seed, x0, fixed, amp):
    """The start velocity of seed `seed`: one smooth wave a coordinate
    across the bar (amplitude amp * U(0.5, 1), random sign, wave numbers
    1-2 along each axis, random phase), zero at the handles. Every seed
    gives the same work: the same mesh, frames and script."""
    rng = np.random.default_rng(seed)
    a = amp * rng.uniform(0.5, 1.0, 3) * rng.choice([-1.0, 1.0], 3)
    k = rng.integers(1, 3, size=(3, 3)).astype(np.float64)
    ph = rng.uniform(0.0, 2.0 * math.pi, 3)
    x = x0.to(torch.float64)
    lo, hi = x.min(dim=0).values, x.max(dim=0).values
    t = lambda a_: torch.as_tensor(a_, dtype=torch.float64, device=x.device)
    v = t(a) * torch.sin(2.0 * math.pi * (((x - lo) / (hi - lo)) @ t(k).T)
                         + t(ph))
    return torch.where(fixed[:, None], 0.0, v).to(x0.dtype)
