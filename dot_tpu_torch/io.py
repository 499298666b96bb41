# Copied from dot_tpu/io.py: the port cannot import dot_tpu, whose package import pulls in jax.
"""Mesh file I/O: the reference's Gmsh-4.0-flavored .msh (with its
nonstandard $Surface section), TetGen .node/.ele, OBJ surface output.

Reference: IglUtils::readTetMesh/saveTetMesh/readNodeEle
(src/Utils/IglUtils.cpp:627-789) and findSurfaceTris
(src/Utils/IglUtils.cpp:558-626).
"""

from __future__ import annotations

import io as _io
import numpy as np


def _load_block(lines, start, count, cols):
    """Parse `count` whitespace-separated numeric rows starting at lines[start]."""
    text = "\n".join(lines[start:start + count])
    arr = np.loadtxt(_io.StringIO(text), ndmin=2)
    assert arr.shape == (count, cols), (arr.shape, count, cols)
    return arr


def read_tet_mesh(path):
    """Read the DOT .msh flavor. Returns (V (nV,3) f64, TT (nE,4) i32,
    SF (nS,3) i32); SF is derived from face counts when absent."""
    with open(path) as f:
        lines = f.read().splitlines()

    V = TT = SF = None
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        if line.startswith("$Nodes"):
            # header: "1 <nV>" then one entity line
            n_v = int(lines[i + 1].split()[1])
            block = _load_block(lines, i + 3, n_v, 4)
            V = block[:, 1:4].astype(np.float64)
            i += 3 + n_v
        elif line.startswith("$Elements"):
            n_e = int(lines[i + 1].split()[1])
            block = _load_block(lines, i + 3, n_e, 5)
            TT = block[:, 1:5].astype(np.int64) - 1
            i += 3 + n_e
        elif line.startswith("$Surface"):
            n_s = int(lines[i + 1].split()[0])
            if n_s > 0:
                block = _load_block(lines, i + 2, n_s, 3)
                SF = block.astype(np.int64) - 1
            i += 2 + max(n_s, 0)
        else:
            i += 1

    if V is None or TT is None:
        raise ValueError(f"no $Nodes/$Elements found in {path}")
    if SF is None:
        SF = find_surface_tris(TT)
    return V, TT.astype(np.int32), SF.astype(np.int32)


def read_node_ele(path_prefix):
    """TetGen .node + .ele pair (reference: IglUtils.cpp:750-789)."""
    node = np.loadtxt(path_prefix + ".node", skiprows=1, ndmin=2)
    V = node[:, 1:4].astype(np.float64)
    ele = np.loadtxt(path_prefix + ".ele", skiprows=1, ndmin=2)
    TT = ele[:, 1:5].astype(np.int64)
    SF = find_surface_tris(TT)
    return V, TT.astype(np.int32), SF.astype(np.int32)


def find_surface_tris(TT):
    """Faces that appear in exactly one tet are surface triangles, oriented
    outward using the tet's fourth vertex (reference: IglUtils.cpp:558-626)."""
    TT = np.asarray(TT, dtype=np.int64)
    # local faces opposite each corner, oriented outward for positive tets
    faces = np.concatenate([
        TT[:, [1, 2, 3]],
        TT[:, [0, 3, 2]],
        TT[:, [0, 1, 3]],
        TT[:, [0, 2, 1]],
    ], axis=0)
    key = np.sort(faces, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    return faces[counts[inv] == 1].astype(np.int32)


def save_tet_mesh(path, V, TT, SF=None):
    """Write the DOT .msh flavor (reference: IglUtils.cpp:627-680)."""
    V = np.asarray(V)
    TT = np.asarray(TT)
    if SF is None:
        SF = find_surface_tris(TT)
    with open(path, "w") as f:
        f.write("$MeshFormat\n4 0 8\n$EndMeshFormat\n")
        f.write("$Entities\n0 0 0 1\n")
        mn, mx = V.min(axis=0), V.max(axis=0)
        f.write("0 %le %le %le %le %le %le 0 0\n$EndEntities\n"
                % (mn[0], mn[1], mn[2], mx[0], mx[1], mx[2]))
        f.write("$Nodes\n1 %d\n0 3 0 %d\n" % (len(V), len(V)))
        for i, v in enumerate(V):
            f.write("%d %le %le %le\n" % (i + 1, v[0], v[1], v[2]))
        f.write("$EndNodes\n$Elements\n1 %d\n0 3 4 %d\n" % (len(TT), len(TT)))
        for i, t in enumerate(TT):
            f.write("%d %d %d %d %d\n" % (i + 1, t[0] + 1, t[1] + 1, t[2] + 1, t[3] + 1))
        f.write("$EndElements\n$Surface\n%d\n" % len(SF))
        for t in SF:
            f.write("%d %d %d\n" % (t[0] + 1, t[1] + 1, t[2] + 1))
        f.write("$EndSurface\n")


def write_obj(path, V, F):
    """Surface OBJ (per-frame output contract, reference: main.cpp:318-358)."""
    with open(path, "w") as f:
        for v in np.asarray(V):
            f.write("v %.10g %.10g %.10g\n" % (v[0], v[1], v[2]))
        for t in np.asarray(F):
            f.write("f %d %d %d\n" % (t[0] + 1, t[1] + 1, t[2] + 1))


def read_obj(path):
    """Read a surface OBJ (v/f lines only) -> (V (n,3) f64, F (m,3) i64)."""
    vs, fs = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "f":
                fs.append([int(x.split("/")[0]) - 1 for x in t[1:4]])
    return np.asarray(vs, np.float64), np.asarray(fs, np.int64)


def stri2tet(TT, SF):
    """(nSF,) index of the tet containing each surface triangle
    (reference: buildSTri2Tet, main.cpp:748)."""
    TT = np.asarray(TT, np.int64)
    faces = np.concatenate([TT[:, [1, 2, 3]], TT[:, [0, 3, 2]],
                            TT[:, [0, 1, 3]], TT[:, [0, 2, 1]]], axis=0)
    tet_of = np.tile(np.arange(TT.shape[0], dtype=np.int64), 4)
    nv = int(TT.max()) + 1
    assert nv ** 3 < 2 ** 62

    def key(tri):
        s = np.sort(np.asarray(tri, np.int64), axis=1)
        return (s[:, 0] * nv + s[:, 1]) * nv + s[:, 2]

    fk = key(faces)
    forder = np.argsort(fk, kind="stable")
    sk = key(SF)
    pos = np.searchsorted(fk[forder], sk)
    if np.any(pos >= len(fk)) or np.any(fk[forder[pos]] != sk):
        bad = np.where((pos >= len(fk))
                       | (fk[forder[np.minimum(pos, len(fk) - 1)]] != sk))[0]
        raise ValueError(
            f"{len(bad)} surface triangles are not faces of any tet "
            f"(first bad SF row: {bad[0]}) — inconsistent $Surface section")
    return tet_of[forder[pos]].astype(np.int32)


def write_partition_debug(out_dir, mesh, part):
    """label.obj (per-surface-face subdomain label) + wire.poly (surface
    wireframe) — reference: ADMMDDTimeStepper.cpp:375-442."""
    import os
    s2t = stri2tet(mesh.conn, mesh.SF)
    with open(os.path.join(out_dir, "label.obj"), "w") as f:
        for t in s2t:
            f.write("v %d 0 0\n" % int(part[t]))
    surf = np.unique(mesh.SF.ravel())
    remap = np.full(mesh.n_vert, -1, np.int64)
    remap[surf] = np.arange(len(surf))
    Vs = mesh.V_rest[surf]
    Fs = remap[mesh.SF]
    with open(os.path.join(out_dir, "wire.poly"), "w") as f:
        f.write("POINTS\n")
        for i, v in enumerate(Vs):
            f.write("%d: %le %le %le\n" % (i + 1, v[0], v[1], v[2]))
        f.write("POLYS\n")
        for fi, t in enumerate(Fs):
            s = fi * 3
            f.write("%d: %d %d\n" % (s + 1, t[0] + 1, t[1] + 1))
            f.write("%d: %d %d\n" % (s + 2, t[1] + 1, t[2] + 1))
            f.write("%d: %d %d\n" % (s + 3, t[2] + 1, t[0] + 1))
        f.write("END\n")
