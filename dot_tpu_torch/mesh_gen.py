# Copied from dot_tpu/mesh_gen.py: the port cannot import dot_tpu, whose package import pulls in jax.
"""Procedural meshes: structured bars (tests, benchmarks, multi-chip dry
run), the reference's six 2D primitives, and surface tetrahedralization.

The reference generates 2D primitives with Triangle (Mesh.cpp:110-435)
and tetrahedralizes surfaces with TetGen (MeshProcessing.hpp:106-186) —
both external tools. Their roles are played from scratch here:
`triangulate_polygon` (boundary resampling + hex-lattice interior points
+ Delaunay + concavity filter) meshes the analytic and polygon
primitives including spikes/Sharkey, and `tet_from_surface` stuffs a
closed surface with lattice Kuhn tetrahedra (voxelized boundary,
documented) for the mode-2 tetrahedralization case.
"""

from __future__ import annotations

import itertools
import numpy as np

from .mesh import Mesh


def bar_mesh(nx=8, ny=2, nz=2, size=(1.0, 0.25, 0.25), ym=1.0e5, pr=0.4,
             rho=1000.0):
    """Structured bar of nx*ny*nz cubes -> 6 tets each."""
    xs = np.linspace(0, size[0], nx + 1)
    ys = np.linspace(0, size[1], ny + 1)
    zs = np.linspace(0, size[2], nz + 1)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    V = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    tets = []
    corners = {}
    for (di, dj, dk) in itertools.product((0, 1), repeat=3):
        corners[(di, dj, dk)] = (di, dj, dk)
    perms = list(itertools.permutations(range(3)))
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                base = np.array([i, j, k])
                for perm in perms:
                    path = [np.array([0, 0, 0])]
                    cur = np.array([0, 0, 0])
                    for ax in perm:
                        cur = cur.copy()
                        cur[ax] = 1
                        path.append(cur)
                    ids = [vid(*(base + p)) for p in path]
                    tets.append(ids)
    TT = np.asarray(tets, dtype=np.int64)

    # orientation fix: positive signed volume
    p = V[TT]
    X = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]],
                 axis=-1)
    neg = np.linalg.det(X) < 0
    TT[neg, 2], TT[neg, 3] = TT[neg, 3].copy(), TT[neg, 2].copy()

    return Mesh(V, TT, ym=ym, pr=pr, rho=rho)


# ---------------------------------------------------------------------------
# 2D primitive generators (reference: Mesh.cpp:110-435, DIM == 2 builds).
# P_GRID is reproduced exactly (it is analytic in the reference too); the
# Triangle-meshed primitives (square/rectangle/cylinder) are generated as
# structured triangulations of the same domains with the same target
# element count and the same border-vertex semantics (left/right handle
# columns). Spikes/Sharkey (concave polygons the reference meshes with
# Triangle's PSLG mode, Mesh.cpp:289-435) are meshed by the from-scratch
# quality triangulator below (boundary resampling + hex-lattice interior
# points + Delaunay + inside filter). Returns (V_rest (n, 3; z = 0),
# F (m, 3) CCW, border_verts [left list, right list]).
# ---------------------------------------------------------------------------
def _grid_tris(rows, cols):
    """Two CCW triangles per cell over a (rows x cols) vertex lattice,
    reference diagonal convention (Mesh.cpp:146-156)."""
    tris = []
    for r in range(rows - 1):
        for c in range(cols - 1):
            v = r * cols + c
            tris.append([v, v + cols + 1, v + cols])
            tris.append([v, v + 1, v + cols + 1])
    return np.asarray(tris, np.int64)


def grid_2d(size=1.0, elem_amt=200):
    """P_GRID (Mesh.cpp:121-158): square lattice, spacing derived from the
    target element count; border columns are the two handles."""
    spacing = size / np.sqrt(elem_amt / 2.0)
    gs = int(size / spacing) + 1
    xs = np.linspace(0.0, size, gs)
    # row-major (rowI * gs + colI), x = spacing * col, y = spacing * row
    V = np.stack([np.tile(xs, gs), np.repeat(xs, gs),
                  np.zeros(gs * gs)], axis=-1)
    F = _grid_tris(gs, gs)
    left = list(range(0, gs * gs, gs))
    right = list(range(gs - 1, gs * gs, gs))
    return V, F, [left, right]


def square_2d(size=1.0, elem_amt=200):
    """P_SQUARE domain (same square; reference meshes it with Triangle,
    Mesh.cpp:160-233) — structured triangulation substitution."""
    return grid_2d(size, elem_amt)


def rectangle_2d(size=1.0, elem_amt=200):
    """P_RECTANGLE (Mesh.cpp:235-290): width size/2, height size."""
    spacing = size / np.sqrt(float(elem_amt))
    rows = int(size / spacing) + 1
    cols = max(rows // 2, 2)
    xs = np.linspace(0.0, size / 2.0, cols)
    ys = np.linspace(0.0, size, rows)
    V = np.stack([np.tile(xs, rows), np.repeat(ys, cols),
                  np.zeros(rows * cols)], axis=-1)
    F = _grid_tris(rows, cols)
    left = list(range(0, rows * cols, cols))
    right = list(range(cols - 1, rows * cols, cols))
    return V, F, [left, right]


def cylinder_2d(size=1.0, elem_amt=200):
    """P_CYLINDER (Mesh.cpp:341-417): annulus (outer radius size, inner
    size/2) as a structured ring mesh; handles = inner/outer rims."""
    r_in, r_out = 0.5 * size, size
    area = np.pi * (r_out ** 2 - r_in ** 2)
    spacing = np.sqrt(area / elem_amt * 2.0)
    n_r = max(int((r_out - r_in) / spacing) + 1, 2)
    n_t = max(int(2.0 * np.pi * r_out / spacing), 8)
    rs = np.linspace(r_in, r_out, n_r)
    ts = np.arange(n_t) * (2.0 * np.pi / n_t)
    R, T = np.meshgrid(rs, ts, indexing="ij")
    V = np.stack([(R * np.cos(T)).reshape(-1), (R * np.sin(T)).reshape(-1),
                  np.zeros(n_r * n_t)], axis=-1)
    tris = []
    for i in range(n_r - 1):
        for j in range(n_t):
            j1 = (j + 1) % n_t
            a, b = i * n_t + j, i * n_t + j1
            c, d = (i + 1) * n_t + j, (i + 1) * n_t + j1
            tris.append([a, c, d])
            tris.append([a, d, b])
    F = np.asarray(tris, np.int64)
    inner = list(range(n_t))
    outer = list(range((n_r - 1) * n_t, n_r * n_t))
    return V, F, [inner, outer]


# ---------------------------------------------------------------------------
# Concave-polygon quality triangulation (the igl::triangle::triangulate
# role for P_SPIKES / P_SHARKEY, Mesh.cpp:289-435). From-scratch scheme:
# resample the boundary polygon at the target spacing, seed interior
# points on a hexagonal lattice clipped away from the boundary, Delaunay-
# triangulate the point set, and keep triangles whose centroid lies
# inside the polygon (handles concavity; the dense boundary sampling
# makes the Delaunay conform to the polygon edges).
# ---------------------------------------------------------------------------
def _point_in_polygon(pts, poly):
    """Even-odd ray test, vectorized over pts (n, 2) x poly (m, 2)."""
    x, y = pts[:, 0:1], pts[:, 1:2]
    x0, y0 = poly[:, 0][None, :], poly[:, 1][None, :]
    x1, y1 = np.roll(poly[:, 0], -1)[None, :], np.roll(poly[:, 1], -1)[None, :]
    cross = (y0 > y) != (y1 > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xin = x0 + (y - y0) * (x1 - x0) / (y1 - y0)
    hits = cross & (x < xin)
    return (hits.sum(axis=1) % 2).astype(bool)


def _dist_to_boundary(pts, poly):
    """Min distance from each point to the polygon's edges (vectorized)."""
    a = poly
    b = np.roll(poly, -1, axis=0)
    ab = b - a                                        # (m, 2)
    den = np.maximum((ab * ab).sum(axis=1), 1e-30)    # (m,)
    ap = pts[:, None, :] - a[None, :, :]              # (n, m, 2)
    t = np.clip((ap * ab[None]).sum(axis=2) / den[None], 0.0, 1.0)
    d = ap - t[..., None] * ab[None]
    return np.sqrt((d * d).sum(axis=2).min(axis=1))


def _resample_polygon(poly, h):
    """Insert points along each polygon edge so segments are <= h
    (IglUtils::sampleSegment role, corners preserved)."""
    out = []
    for i in range(len(poly)):
        a, b = poly[i], poly[(i + 1) % len(poly)]
        n = max(int(np.ceil(np.linalg.norm(b - a) / h)), 1)
        for k in range(n):
            out.append(a + (b - a) * (k / n))
    return np.asarray(out)


def triangulate_polygon(poly, elem_amt):
    """Quality-triangulate the CCW polygon to ~elem_amt CCW triangles.
    Returns (V (n, 2), F (m, 3))."""
    from scipy.spatial import Delaunay

    x, y = poly[:, 0], poly[:, 1]
    area = 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
    assert area > 0, "polygon must be CCW"
    # equilateral-lattice spacing for the target count (same formula the
    # reference uses for its boundary sampling, Mesh.cpp:301)
    h = float(np.sqrt(area / elem_amt * 4.0 / np.sqrt(3.0)))
    bnd = _resample_polygon(poly, h)

    lo, hi = poly.min(axis=0), poly.max(axis=0)
    nx = int((hi[0] - lo[0]) / h) + 2
    ny = int((hi[1] - lo[1]) / (h * np.sqrt(3.0) / 2.0)) + 2
    gx = lo[0] + np.arange(nx) * h
    gy = lo[1] + np.arange(ny) * (h * np.sqrt(3.0) / 2.0)
    X, Y = np.meshgrid(gx, gy, indexing="xy")
    X[1::2] += 0.5 * h                                # hex stagger
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)
    keep = _point_in_polygon(pts, poly)
    keep &= _dist_to_boundary(pts, poly) > 0.6 * h
    allp = np.concatenate([bnd, pts[keep]], axis=0)

    tri = Delaunay(allp)
    F = tri.simplices.astype(np.int64)
    cent = allp[F].mean(axis=1)
    # drop triangles outside the (concave) polygon; centroid test with a
    # tiny inward nudge is robust because boundary sampling bounds every
    # sliver's size to ~h
    F = F[_point_in_polygon(cent, poly)]
    # orientation: CCW
    e1 = allp[F[:, 1]] - allp[F[:, 0]]
    e2 = allp[F[:, 2]] - allp[F[:, 0]]
    cw = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) < 0
    F[cw, 1], F[cw, 2] = F[cw, 2].copy(), F[cw, 1].copy()
    # compact unused points (interior points can be dropped by the filter)
    used = np.unique(F.ravel())
    remap = np.full(len(allp), -1, np.int64)
    remap[used] = np.arange(len(used))
    return allp[used], remap[F]


SPIKES_POLY = np.asarray([   # Mesh.cpp:291-298 (P_SPIKES corner polygon)
    [0.0, 0.0], [1.0, 0.0], [0.8, 0.7], [1.0, 1.0],
    [0.7, 0.9], [0.0, 1.0], [0.25, 0.4]])


def spikes_2d(size=1.0, elem_amt=200):
    """P_SPIKES (Mesh.cpp:289-340): concave 7-corner polygon; handles are
    the two boundary chains 1->2->3 (right) and 5->6->0 (left)."""
    V2, F = triangulate_polygon(SPIKES_POLY * size, elem_amt)
    V = np.concatenate([V2, np.zeros((len(V2), 1))], axis=1)
    # handle chains: boundary vertices within a tolerance of the sampled
    # reference chains (the boundary resampler keeps corners exact)
    h = float(np.sqrt(0.725 * size * size / elem_amt * 4.0 / np.sqrt(3.0)))
    left = _near_chain(V2, SPIKES_POLY[[5, 6, 0]] * size, 0.3 * h)
    right = _near_chain(V2, SPIKES_POLY[[1, 2, 3]] * size, 0.3 * h)
    return V, F, [left, right]


def _near_chain(V2, chain, tol):
    return list(np.where(_dist_to_boundary_open(V2, chain) < tol)[0])


def _dist_to_boundary_open(pts, chain):
    a, b = chain[:-1], chain[1:]
    ab = b - a
    den = np.maximum((ab * ab).sum(axis=1), 1e-30)
    ap = pts[:, None, :] - a[None, :, :]
    t = np.clip((ap * ab[None]).sum(axis=2) / den[None], 0.0, 1.0)
    d = ap - t[..., None] * ab[None]
    return np.sqrt((d * d).sum(axis=2).min(axis=1))


def sharkey_2d(size=1.0, elem_amt=200):
    """P_SHARKEY (Mesh.cpp:367-435): the hardcoded shark shape, remeshed
    to the target element count and scaled so its width equals `size`;
    border verts by coordinate extremes (IglUtils::findBorderVerts 0.01),
    matching the reference's post-remesh handle detection. The boundary
    polygon is a shape ASSET extracted from the reference's vertex data
    (assets/sharkey_boundary.txt)."""
    import os
    poly = np.loadtxt(os.path.join(os.path.dirname(__file__), "assets",
                                   "sharkey_boundary.txt"))
    V2, F = triangulate_polygon(poly, elem_amt)
    scale = size / (V2[:, 0].max() - V2[:, 0].min())
    V2 = V2 * scale
    V = np.concatenate([V2, np.zeros((len(V2), 1))], axis=1)
    # findBorderVerts(V, 0.01): handles = verts within 1% of x extremes
    xr = V2[:, 0].max() - V2[:, 0].min()
    left = list(np.where(V2[:, 0] < V2[:, 0].min() + 0.01 * xr)[0])
    right = list(np.where(V2[:, 0] > V2[:, 0].max() - 0.01 * xr)[0])
    return V, F, [left, right]


# ---------------------------------------------------------------------------
# Surface-mesh tetrahedralization (the igl::copyleft::tetgen role of the
# reference's MeshProcessing mode-2 case 3, MeshProcessing.hpp:106-186).
# From-scratch lattice stuffing: ray-parity inside test on a cubic
# lattice sized for the target element count, 6 Kuhn tets per interior
# cube (the simple-and-robust end of the isosurface-stuffing family —
# boundary is voxelized rather than snapped, which the docstring and the
# element-count contract make explicit).
# ---------------------------------------------------------------------------
def _column_crossings(V, F, xs, ys):
    """For every (x, y) lattice column, the sorted z values where the
    vertical line crosses the surface (watertight triangle soup)."""
    crossings = [[[] for _ in ys] for _ in xs]
    p0, p1, p2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    for t in range(len(F)):
        a, b, c = p0[t], p1[t], p2[t]
        ix0 = np.searchsorted(xs, min(a[0], b[0], c[0]))
        ix1 = np.searchsorted(xs, max(a[0], b[0], c[0]), side="right")
        iy0 = np.searchsorted(ys, min(a[1], b[1], c[1]))
        iy1 = np.searchsorted(ys, max(a[1], b[1], c[1]), side="right")
        if ix0 == ix1 or iy0 == iy1:
            continue
        gx, gy = np.meshgrid(xs[ix0:ix1], ys[iy0:iy1], indexing="ij")
        # 2D barycentric in the xy projection
        d = ((b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1]))
        if abs(d) < 1e-30:
            continue
        w0 = ((b[1] - c[1]) * (gx - c[0]) + (c[0] - b[0]) * (gy - c[1])) / d
        w1 = ((c[1] - a[1]) * (gx - c[0]) + (a[0] - c[0]) * (gy - c[1])) / d
        w2 = 1.0 - w0 - w1
        # half-open rule on the projected triangle avoids double-counting
        # shared edges between the two adjacent triangles
        inside = (w0 > 1e-12) & (w1 > 1e-12) & (w2 >= -1e-12)
        zi = w0 * a[2] + w1 * b[2] + w2 * c[2]
        ii, jj = np.nonzero(inside)
        for i, j, z in zip(ii, jj, zi[inside]):
            crossings[ix0 + i][iy0 + j].append(z)
    return crossings


def tet_from_surface(V, F, elem_amt=10000, ym=1.0e5, pr=0.4, rho=1000.0):
    """Tetrahedralize a closed triangle surface to ~elem_amt tets
    (MeshProcessing mode-2 case 3; TetGen's role). Returns a Mesh."""
    V = np.asarray(V, np.float64)
    lo, hi = V.min(axis=0), V.max(axis=0)
    # interior volume via the divergence theorem
    p0, p1, p2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    vol = abs(float(np.sum(np.einsum("ij,ij->i", p0,
                                     np.cross(p1, p2))))) / 6.0
    h = (6.0 * vol / max(elem_amt, 6)) ** (1.0 / 3.0)
    xs = np.arange(lo[0] - 0.5 * h, hi[0] + h, h)
    ys = np.arange(lo[1] - 0.5 * h, hi[1] + h, h)
    zs = np.arange(lo[2] - 0.5 * h, hi[2] + h, h)
    cr = _column_crossings(V, F, xs, ys)
    nx, ny, nz = len(xs), len(ys), len(zs)
    inside = np.zeros((nx, ny, nz), bool)
    for i in range(nx):
        for j in range(ny):
            zlist = np.sort(np.asarray(cr[i][j]))
            if len(zlist) < 2:
                continue
            below = np.searchsorted(zlist, zs)
            inside[i, j] = (below % 2) == 1
    # keep cubes with ALL EIGHT corners inside (conservative: no sliver
    # protrusions outside the surface)
    cube = (inside[:-1, :-1, :-1] & inside[1:, :-1, :-1]
            & inside[:-1, 1:, :-1] & inside[1:, 1:, :-1]
            & inside[:-1, :-1, 1:] & inside[1:, :-1, 1:]
            & inside[:-1, 1:, 1:] & inside[1:, 1:, 1:])
    if not cube.any():
        raise ValueError("no interior cubes at this resolution — raise "
                         "elem_amt or check that the surface is closed")
    ci, cj, ck = np.nonzero(cube)

    # vertex ids over the lattice (only used corners get ids)
    vid = np.full((nx, ny, nz), -1, np.int64)
    corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                   indexing="ij"), axis=-1).reshape(8, 3)
    for (di, dj, dk) in corners:
        vid[ci + di, cj + dj, ck + dk] = 0
    used = np.nonzero(vid == 0)
    vid[used] = np.arange(len(used[0]))
    Vt = np.stack([xs[used[0]], ys[used[1]], zs[used[2]]], axis=-1)

    # 6 Kuhn tets per cube (same split as bar_mesh)
    perms = list(itertools.permutations(range(3)))
    tets = []
    base = np.stack([ci, cj, ck], axis=-1)
    for perm in perms:
        path = [np.zeros(3, np.int64)]
        cur = np.zeros(3, np.int64)
        for ax in perm:
            cur = cur.copy()
            cur[ax] = 1
            path.append(cur)
        ids = [vid[tuple((base + p).T)] for p in path]
        tets.append(np.stack(ids, axis=-1))
    TT = np.concatenate(tets, axis=0)
    p = Vt[TT]
    X = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]],
                 axis=-1)
    neg = np.linalg.det(X) < 0
    TT[neg, 2], TT[neg, 3] = TT[neg, 3].copy(), TT[neg, 2].copy()
    return Mesh(Vt, TT, ym=ym, pr=pr, rho=rho)
