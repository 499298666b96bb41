# Copied from dot_tpu/mesh.py: the port cannot import dot_tpu, whose package import pulls in jax.
# One change: the data root is searched only when DOT_DATA_ROOT is set.
"""Host-side mesh state and precompute (numpy).

The TPU-native analog of the reference's Mesh<3> (src/Mesh.{hpp,cpp}):
everything static — rest-shape inverses, volumes, lumped masses, Lame
fields, scatter plans, characteristic-tolerance geometry — is computed
once on the host as plain numpy arrays, then shipped to the device as
padded/static-shape buffers.

Reference semantics carried over exactly:
- restTriInv = X0^{-1}, vol = det(X0)/6 (Mesh.cpp:620-640)
- barycentric lumped mass |vol|/4 per corner x density (Mesh.cpp:552-585
  via libigl massmatrix)
- Lame: u = E/(2(1+nu)), lam = E nu/((1+nu)(1-2nu)) (Mesh.cpp:740-745)
- default fixed vertex 0 (Mesh.cpp:592-598)
- model load transform: rotate -> scale so max bbox extent == size ->
  translate min corner to origin (main.cpp:692-748)
- findBorderVerts: x-extreme slabs of width handleRatio*range
  (IglUtils.cpp:909-926)
"""

from __future__ import annotations

import os
import numpy as np

from . import io as meshio


class Mesh:
    def __init__(self, V, TT, SF=None, ym=100.0, pr=0.4, rho=1.0):
        V = np.asarray(V, dtype=np.float64)
        TT = np.asarray(TT, dtype=np.int32)
        if SF is None:
            SF = meshio.find_surface_tris(TT)
        self.V_rest = V.copy()
        self.V = V.copy()
        self.conn = TT
        self.SF = np.asarray(SF, dtype=np.int32)
        self.n_vert = V.shape[0]
        self.n_elem = TT.shape[0]

        # rest shape: X0 columns are edge vectors from corner 0
        xc = V[TT]  # (nE, 4, 3)
        X0 = np.stack([xc[:, 1] - xc[:, 0],
                       xc[:, 2] - xc[:, 0],
                       xc[:, 3] - xc[:, 0]], axis=-1)
        det = np.linalg.det(X0)
        if np.any(det <= 0):
            raise ValueError(f"{int((det <= 0).sum())} inverted/degenerate rest tets")
        self.rest_tri_inv = np.linalg.inv(X0)
        self.vol = det / 6.0  # triArea in the reference (det/dim/(dim-1))
        self.tri_weight = np.ones(self.n_elem)

        # barycentric lumped mass
        self.rho = rho
        self.mass = np.zeros(self.n_vert)
        np.add.at(self.mass, TT.ravel(),
                  np.repeat(np.abs(det) / 6.0 / 4.0 * rho, 4))

        self.set_lame(ym, pr)

        self.fixed_mask = np.zeros(self.n_vert, dtype=bool)
        self.fixed_mask[0] = True  # reference default

        self.bbox = np.stack([V.min(axis=0), V.max(axis=0)])

        # adjacency sanity (isolated nodes, Mesh.cpp:693-699)
        used = np.zeros(self.n_vert, dtype=bool)
        used[TT.ravel()] = True
        if not used.all():
            raise ValueError("isolated nodes detected")

        # vertex scatter plan: sorted segment-sum over (elem, corner) pairs
        flat = TT.ravel().astype(np.int32)
        self.scatter_perm = np.argsort(flat, kind="stable").astype(np.int32)
        self.scatter_segids = flat[self.scatter_perm]

        # boundary (surface) vertices
        self.is_boundary_vert = np.zeros(self.n_vert, dtype=bool)
        self.is_boundary_vert[self.SF.ravel()] = True

        # per-vertex face-area sums for the characteristic tolerance
        # (Optimizer::computeCharNormSq, Optimizer.cpp:612-651; igl::face_areas
        # puts face i opposite corner i)
        areas = self._tet_face_areas(V, TT)
        ls = np.zeros(self.n_vert)
        np.add.at(ls, TT.ravel(), areas.ravel())
        self.sqnorm_face_area_sums = float(np.sum(ls * ls))

        self.border_verts = [np.empty(0, np.int32), np.empty(0, np.int32)]

    # ------------------------------------------------------------------
    @staticmethod
    def _tet_face_areas(V, TT):
        """(nE, 4) area of the face opposite each corner."""
        p = V[TT]  # (nE, 4, 3)
        out = np.zeros((TT.shape[0], 4))
        for c, (i, j, k) in enumerate(((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))):
            n = np.cross(p[:, j] - p[:, i], p[:, k] - p[:, i])
            out[:, c] = 0.5 * np.linalg.norm(n, axis=-1)
        return out

    def set_lame(self, ym, pr):
        self.ym, self.pr = ym, pr
        self.u = np.full(self.n_elem, ym / (2.0 * (1.0 + pr)))
        self.lam = np.full(self.n_elem, ym * pr / ((1.0 + pr) * (1.0 - 2.0 * pr)))

    def find_border_verts(self, handle_ratio):
        """x-extreme slabs (reference: IglUtils::findBorderVerts)."""
        lo = self.V[:, 0].min()
        hi = self.V[:, 0].max()
        rng = hi - lo
        self.border_verts = [
            np.where(self.V[:, 0] < lo + rng * handle_ratio)[0].astype(np.int32),
            np.where(self.V[:, 0] > hi - rng * handle_ratio)[0].astype(np.int32),
        ]
        return self.border_verts

    def check_inversion(self, V=None):
        V = self.V if V is None else V
        xc = V[self.conn]
        X = np.stack([xc[:, 1] - xc[:, 0], xc[:, 2] - xc[:, 0],
                      xc[:, 3] - xc[:, 0]], axis=-1)
        return bool(np.all(np.linalg.det(X) > 0))

    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, cfg, search_dirs=()):
        """Load + transform the scene mesh as the reference driver does
        (main.cpp:665-790)."""
        if cfg.shape != "input":
            raise NotImplementedError(
                f"primitive shape {cfg.shape!r} is a 2D scene: it runs through "
                "dim2.Sim2D / run_script_2d (3D builds of the reference also "
                "only accept 'input', main.cpp:676-678)")
        path = resolve_input_path(cfg.input_shape_path, search_dirs)
        if path.endswith(".msh"):
            V, TT, SF = meshio.read_tet_mesh(path)
        else:
            V, TT, SF = meshio.read_node_ele(path)

        if cfg.rot_deg != 0.0:
            V = V @ _axis_angle(cfg.rot_axis, np.deg2rad(cfg.rot_deg)).T

        V = V * (cfg.size / np.ptp(V, axis=0).max())
        V = V - V.min(axis=0)

        mesh = cls(V, TT, SF, ym=cfg.ym, pr=cfg.pr, rho=cfg.rho)
        mesh.find_border_verts(cfg.handle_ratio)
        return mesh


def resolve_input_path(path, search_dirs=()):
    cands = [path]
    for d in search_dirs:
        cands.append(os.path.join(d, path))
    root = os.environ.get("DOT_DATA_ROOT")
    if root:
        cands.append(os.path.join(root, path))
    for c in cands:
        probe = c if not c.endswith(".node") else c
        if os.path.exists(probe) or os.path.exists(probe + ".node"):
            return c
    raise FileNotFoundError(f"mesh not found: {path} (searched {cands})")


def _axis_angle(axis, angle):
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
