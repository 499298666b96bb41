"""2D (DIM = 2) simulation pipeline (port of dot_tpu/dim2.py's core):
triangle meshes, sigma-space energies, projected-Newton time stepping and
the per-run output contract.

- `Mesh2D` (host numpy, copied from dot_tpu/dim2.py:57-135) builds the 2D
  primitives (grid / square / rectangle / cylinder / spikes / Sharkey) of
  mesh_gen; positions stay (nV, 3) with a frozen z = 0, so the scene
  scripts and the OBJ / status writers are shared with the 3D pipeline.
- `System2D` is the whole-mesh part of dot_tpu's System2D (dim2.py:353-508,
  520-541, 742-772) behind the surface the port's steppers call
  (steppers/core.System): defgrad / sigma / energy / gradient /
  elastic_energy / inertia_quad / warm_start 0-4 / system_energy /
  be_update, plus the dense equilibrated `factorize(x, fixed)` and
  `solve(L, d, g)` of the 2 nV in-plane dofs. The per-element passes and
  the dense assembly are the kernels K21-K24 of kernels/ops.py (plain
  versions: kernels/soa2d.py); the dense Cholesky and the two triangular
  solves are library calls, as they are in dot_tpu.
- `Newton2DStepper` is steppers/newton.py's host loop with that factor:
  one dense factorization per inner iteration (dim2.py:835-966).
- `Sim2D` / `run_script_2d` write `<n>.obj` (all vertices, the triangles),
  `status<n>`, `iterStats.txt`, `log.txt`, `info.txt` and `config.txt`; no
  `.msh`. The PNG / GIF render of dot_tpu's Sim2D.finalize is not ported.

Not ported yet (ROADMAP.md queue 1, items 1b and 1c): the 2D subdomain
plans and System2D's decomposed part (DOT, GSDD, LBFGS, LBFGSH, LBFGSHI,
LBFGSJH at dim 2), ADMM and ADMMDD at dim 2, restart: they raise
NotImplementedError. warmStart 5 is refused at dim 2, as in dot_tpu.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import io as meshio
from . import mesh_gen, scripts
from .config import Config
from .kernels import ops, soa2d
from .sim import Simulator, _unsupported, pick_dtype, resolve_device
from .steppers.core import GRAVITY_Y, SystemBase
from .steppers.newton import NewtonStepper

_GEN_2D = {
    "grid": mesh_gen.grid_2d,
    "square": mesh_gen.square_2d,
    "rectangle": mesh_gen.rectangle_2d,
    "cylinder": mesh_gen.cylinder_2d,
    "spikes": mesh_gen.spikes_2d,
    "Sharkey": mesh_gen.sharkey_2d,
}


def is_2d_shape(shape: str) -> bool:
    return shape in _GEN_2D


class Mesh2D:
    """Triangle mesh state (reference: Mesh<2>, Mesh.cpp:110-435,
    552-700 for the dim-generic features)."""

    def __init__(self, V, F, border=None, ym=1.0e5, pr=0.4, rho=1000.0):
        V = np.asarray(V, np.float64)
        if V.shape[1] == 2:
            V = np.concatenate([V, np.zeros((len(V), 1))], axis=1)
        F = np.asarray(F, np.int64)
        # positive orientation (reference checks det > 0, Mesh.cpp:788+)
        e1 = V[F[:, 1], :2] - V[F[:, 0], :2]
        e2 = V[F[:, 2], :2] - V[F[:, 0], :2]
        det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        flip = det < 0
        F[flip] = F[flip][:, [0, 2, 1]]

        self.V = V
        self.V_rest = V.copy()
        self.conn = F
        self.SF = F                    # surface == the mesh itself in 2D
        self.n_vert = len(V)
        self.n_elem = len(F)

        X0 = np.stack([V[F[:, 1], :2] - V[F[:, 0], :2],
                       V[F[:, 2], :2] - V[F[:, 0], :2]], axis=-1)
        det = np.linalg.det(X0)
        assert (det > 0).all(), "degenerate triangle in 2D mesh"
        self.rest_tri_inv = np.linalg.inv(X0)
        self.area = det / 2.0          # vol analog (Mesh.cpp:620-640)
        self.rho = rho
        self.mass = np.zeros(self.n_vert)
        np.add.at(self.mass, F.ravel(),
                  np.repeat(self.area * rho / 3.0, 3))
        self.set_lame(ym, pr)

        # characteristic-tolerance length field: per-vertex sums of
        # opposite-edge lengths (the dim-2 "face areas",
        # computeCharNormSq analog, Optimizer.cpp:612-651)
        p = V[F]
        ls = np.zeros(self.n_vert)
        for c, (i, j) in enumerate(((1, 2), (2, 0), (0, 1))):
            ls_e = np.linalg.norm(p[:, j, :2] - p[:, i, :2], axis=-1)
            np.add.at(ls, F[:, c], ls_e)
        self.sqnorm_face_area_sums = float(np.sum(ls * ls))

        self.border_verts = (border if border is not None
                             else [np.empty(0, np.int64)] * 2)
        self.fixed_mask = np.zeros(self.n_vert, bool)

    def set_lame(self, ym, pr):
        self.ym, self.pr = ym, pr
        self.u = np.full(self.n_elem, ym / (2.0 * (1.0 + pr)))
        self.lam = np.full(self.n_elem,
                           ym * pr / ((1.0 + pr) * (1.0 - 2.0 * pr)))

    @property
    def bbox(self):
        return np.stack([self.V.min(axis=0), self.V.max(axis=0)])

    def find_border_verts(self, handle_ratio):
        lo, hi = self.V[:, 0].min(), self.V[:, 0].max()
        rng = hi - lo
        self.border_verts = [
            np.where(self.V[:, 0] < lo + rng * handle_ratio)[0],
            np.where(self.V[:, 0] > hi - rng * handle_ratio)[0],
        ]
        return self.border_verts

    @classmethod
    def from_config(cls, cfg):
        """Build the scene's 2D primitive (reference: Mesh.cpp:110-435
        via main.cpp shape dispatch; `resolution` = target element
        count, `size` = extent)."""
        gen = _GEN_2D[cfg.shape]
        V, F, border = gen(size=cfg.size, elem_amt=cfg.resolution)
        mesh = cls(V, F, border=border, ym=cfg.ym, pr=cfg.pr, rho=cfg.rho)
        if not len(border[0]):
            mesh.find_border_verts(cfg.handle_ratio)
        return mesh


@dataclasses.dataclass
class Sim2DState:
    """Dynamic state of a 2D run (dot_tpu.dim2.Sim2DState)."""
    x: torch.Tensor           # (nV, 3) positions, z frozen at 0
    x_n: torch.Tensor         # (nV, 3) previous step positions
    v: torch.Tensor           # (nV, 3) velocities
    x_tilta: torch.Tensor     # (nV, 3) inertia predictor
    dx_elastic: torch.Tensor  # (nV, 3)
    fixed: torch.Tensor       # (nV,) bool
    vel_sign: torch.Tensor    # () script turning sign
    released: torch.Tensor    # () bool rubberBandPull release happened


class System2D(SystemBase):
    """Batched triangle-element energy / gradient / Hessian and the dense
    whole-mesh factor (reference roles: Energy at dim 2 +
    Optimizer::computePrecondMtr / computeGradient at dim 2)."""

    def __init__(self, mesh: Mesh2D, cfg, dtype=torch.float64, device="cpu",
                 use_kernels=True):
        """`use_kernels=False` runs the plain PyTorch versions of K21-K24
        on any device (a comparison run; the main path keeps the default)."""
        self.mesh = mesh
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.use_kernels = use_kernels
        self.k = ops if use_kernels else ops.plain
        self.mat = soa2d.SOA2D_MATERIALS[cfg.energy]
        self.dt = float(cfg.dt)
        self.dt_sq = self.dt * self.dt
        self.n_vert = mesh.n_vert
        self.n_elem = mesh.n_elem
        self.n2 = 2 * mesh.n_vert
        self.n_syncs = 0

        def t(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=self.device)

        # (3, nE) int32 corner ids and (4, nE) restTriInv: the kernels' layout
        self.conn = t(mesh.conn.T, torch.int32)
        self.g4 = t(mesh.rest_tri_inv.reshape(-1, 4).T)
        self.vol_w = t(mesh.area)      # per-element weight (dot_tpu: w)
        self.u_e = t(mesh.u)
        self.lam_e = t(mesh.lam)
        self.mass = t(mesh.mass)
        grav = np.asarray([0.0, GRAVITY_Y, 0.0])
        self.gravity = t(grav)
        self.grav_dt_sq = t(grav * self.dt_sq)
        # the gradient's vertex-sorted incidences and the dense assembly's
        # slot-sorted runs (dot_tpu's _gdest / _hdest), built once
        self.scatter_plan = soa2d.scatter2d_plan(mesh.conn, mesh.n_vert,
                                                 self.device)

        # characteristic tolerance pieces (Optimizer.cpp:612-651)
        self._sqnorm_l = mesh.sqnorm_face_area_sums
        self._sqnorm_H_rest = self._compute_sqnorm_h_rest()

    def _compute_sqnorm_h_rest(self):
        """||dP/dF(I)||_F^2 at dim 2 with the first element's Lame
        parameters, no SPD projection: A on the (00, 11) entries of the
        rotated-basis M, and the (01, 10) pair block [[L+R, L-R],
        [L-R, L+R]]."""
        one = torch.ones(1, dtype=torch.float64)
        u0 = torch.tensor([self.mesh.u[0]], dtype=torch.float64)
        l0 = torch.tensor([self.mesh.lam[0]], dtype=torch.float64)
        s1 = (one, one)
        h00, h01, h11 = self.mat.d2psi(s1, u0, l0)
        dpsi = self.mat.dpsi(s1, u0, l0)
        L = float(self.mat.b_left(s1, u0, l0)[0])
        R = float((dpsi[0] + dpsi[1])[0]) / 4.0
        a = float(h00[0]) ** 2 + float(h11[0]) ** 2 + 2 * float(h01[0]) ** 2
        return a + 2 * (L + R) ** 2 + 2 * (L - R) ** 2

    # ------------------------------------------------------------------
    def defgrad(self, x):
        """(4, nE) deformation gradients at positions (or directions) x."""
        return self.k.defgrad2d(x, self.conn, self.g4)

    def elastic_energy(self, F0, Fp=None, alpha=None):
        """dt^2 sum area Psi(sigma(F0 + alpha Fp)) (the line-search trial,
        K21)."""
        e, _ = self.k.ls_trial_energy2d(F0, Fp, alpha, self.u_e, self.lam_e,
                                        self.vol_w, self.mat)
        return self.dt_sq * e

    def sigma(self, F):
        """(2, nE) signed singular values of F."""
        _, s = self.k.ls_trial_energy2d(F, None, None, self.u_e, self.lam_e,
                                        self.vol_w, self.mat, want_sigma=True)
        return s

    def _free(self, fixed):
        return torch.logical_not(fixed).to(self.dtype)

    def gradient(self, x, x_tilta, fixed):
        """(nV, 3) with z = 0, zero at fixed vertices (K22)."""
        return self.k.elem_gradient2d(
            x, x_tilta, self._free(fixed), self.mass, self.conn, self.g4,
            self.u_e, self.lam_e, self.vol_w, self.mat, self.dt_sq,
            self.scatter_plan)

    def factorize(self, x, fixed):
        """(L, d): the dense Jacobi-equilibrated Cholesky factor of the
        projected Hessian M + dt^2 sum H_e with unit rows at fixed dofs
        (K23, K24, then the library Cholesky, NaN where it fails). The
        assembled matrix is symmetric bit for bit (each slot and its mirror
        sum the same values in the same order), so the factorization reads
        its lower triangle and no symmetrized copy is made."""
        H36 = self.k.elem_hessian2d(x, self.conn, self.g4, self.u_e,
                                    self.lam_e, self.vol_w, self.mat,
                                    self.dt_sq)
        H, d = self.k.dense_assemble2d(H36, self._free(fixed), self.mass,
                                       self.scatter_plan)
        Hn = self.k.dense_scale2d(H, d, self.scatter_plan)
        del H
        L, info = torch.linalg.cholesky_ex(Hn)
        nan = torch.where(info != 0, torch.nan, 0.0).to(self.dtype)
        return L.add_(nan), d

    def solve(self, L, d, g):
        """p = -H^{-1} g for the (nV, 3) gradient; z column zero."""
        r = (-g[:, :2].reshape(self.n2) / d)[:, None]
        y = torch.linalg.solve_triangular(L, r, upper=False)
        z = torch.linalg.solve_triangular(L.mT, y, upper=True)
        p2 = (z[:, 0] / d).reshape(self.n_vert, 2)
        return torch.cat([p2, torch.zeros((self.n_vert, 1), dtype=self.dtype,
                                          device=self.device)], dim=1)

    def warm_start(self, option, x, v, dx_elastic, fixed, x_tilta=None):
        if option not in (0, 1, 2, 3, 4):
            raise NotImplementedError(f"warmStart {option} (2D)")
        return super().warm_start(option, x, v, dx_elastic, fixed)

    def init_state(self, script_data):
        dtype, dev = self.dtype, self.device
        x = torch.as_tensor(script_data.x0, dtype=dtype, device=dev)
        fixed = torch.as_tensor(script_data.fixed0, device=dev)
        v = torch.zeros((self.n_vert, 3), dtype=dtype, device=dev)
        return Sim2DState(
            x=x, x_n=x.clone(), v=v,
            x_tilta=self.compute_x_tilta(x, v, fixed),
            dx_elastic=torch.zeros_like(x), fixed=fixed,
            vel_sign=self.scalar(1.0),
            released=torch.zeros((), dtype=torch.bool, device=dev))


class Newton2DStepper(NewtonStepper):
    """Projected Newton at dim 2 -- the reference Optimizer's solve /
    fullyImplicit / solve_oneStep / lineSearch loop (Optimizer.cpp:326-881)
    over 6-dof triangle elements: NewtonStepper's host loop with
    System2D's dense whole-mesh factor, rebuilt every inner iteration. Its
    line search rejects a non-finite trial energy, as the port's and
    dot_tpu's 3D search do (dot_tpu's 2D loop, dim2.py:923-931, accepts a
    NaN trial; on finite energies the two agree)."""

    name = "Newton2D"

    def _check_system(self, system):
        if not isinstance(system, System2D):
            raise ValueError("Newton2DStepper needs a System2D")

    def direction(self, x, fixed, g):
        sys = self.system
        L, d = sys.factorize(x, fixed)
        return sys.solve(L, d, g)


class Sim2D(Simulator):
    """The 2D frame loop, with the per-run output contract of dot_tpu's
    Sim2D (config.txt, <n>.obj with all vertices and the triangles,
    status<n>, iterStats.txt, log.txt, info.txt; reference:
    main.cpp:318-358). Only `timeStepper Newton` runs at dim 2 so far."""

    def __init__(self, cfg: Config, output_dir: str, dtype=None, device=None,
                 save_every=1, mute=False, use_kernels=True):
        device = resolve_device(device)
        if cfg.time_stepper != "Newton":
            raise _unsupported(f"2D timeStepper {cfg.time_stepper}")
        if cfg.restart:
            raise _unsupported("restart")
        self._begin(cfg, output_dir, device, save_every, mute)
        self.timer.start("load")
        self.mesh = Mesh2D.from_config(cfg)
        self.script_data = scripts.init_script(self.mesh, cfg.script)
        # target_g_res reads the mask: set it before the first step
        self.mesh.fixed_mask = self.script_data.fixed0.copy()
        self.timer.start("partition+build")
        dtype = dtype if dtype is not None else pick_dtype(None, self.device)
        self.system = System2D(self.mesh, cfg, dtype=dtype,
                               device=self.device, use_kernels=use_kernels)
        self.stepper = Newton2DStepper(self.system, self.script_data,
                                       warm_start_opt=cfg.warm_start)
        self._start()

    def _write_obj(self, path, x):
        meshio.write_obj(path, x, self.mesh.conn)

    def _write_final_mesh(self, x):
        """No finalResult_mesh.msh at dim 2 (dot_tpu's Sim2D writes none)."""


def run_script_2d(script_path, suffix="", frames=None, output_root="output",
                  dtype=None, save_every=1, device=None, use_kernels=True,
                  mute=False):
    """Load a 2D scene script, simulate `frames` frames, write the output
    contract. `dtype` is "f32", "f64" or None (f64 on the CPU, f32 on a
    GPU); `device` None runs on the card and raises without one."""
    device = resolve_device(device)
    cfg = Config.load(script_path)
    name = cfg.output_folder_name()
    if suffix:
        name += "_" + suffix
    sim = Sim2D(cfg, os.path.join(output_root, name),
                dtype=pick_dtype(dtype, device), device=device,
                save_every=save_every, use_kernels=use_kernels, mute=mute)
    sec_per_frame = sim.run(frames)
    sim.finalize()
    return sim, sec_per_frame
