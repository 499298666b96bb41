"""2D (DIM = 2) simulation pipeline (port of dot_tpu/dim2.py): triangle
meshes, sigma-space energies, the 2D steppers and the per-run output
contract.

- `Mesh2D` (host numpy, copied from dot_tpu/dim2.py:57-135) builds the 2D
  primitives (grid / square / rectangle / cylinder / spikes / Sharkey) of
  mesh_gen; positions stay (nV, 3) with a frozen z = 0, so the scene
  scripts and the OBJ / status writers are shared with the 3D pipeline.
- `System2D` (dot_tpu's System2D, dim2.py:353-772) offers the surface the
  port's steppers call (steppers/core.System): defgrad / sigma / energy /
  gradient / elastic_energy / inertia_quad / warm_start 0-4 /
  system_energy / be_update; Newton's dense equilibrated whole-mesh
  `factorize(x, fixed)` and `solve(L, d, g)`; and, given a plan2d.Plan2D,
  the decomposed H0 of DOT / GSDD / LBFGS-H / HI / JH (`element_hessians`,
  `quadratic_form`, `assemble_subdomains`, `factorize_fast`, `h0_apply`,
  `subdomain_solve`, `rebuild_h0`) plus LBFGS-PD's scalar factor
  (`build_pd_factor`, `pd_solve`) and `hessian_diag`. It states its H0
  layout in System's terms (`n_parts` dense blocks of `n3` = the plan's
  n2 dofs, `banded` and `use_coarse` off) and its H0 methods open
  System's spans (tracing.py; `factorize_fast`'s 1e-4 refactorization
  `h0_refactor`). The per-element passes, the assemblies and the vertex
  gathers are the kernels K21-K28 of kernels/ops.py (plain versions:
  kernels/soa2d.py, kernels/dd2d.py); the decomposed H0's solve pairs
  are K32 (`solve_local`), its Cholesky factorizations K33; Newton's
  whole-mesh Cholesky and the other triangular solves are library calls,
  as they all are in dot_tpu. Built for Newton (`whole_mesh`), it states
  the whole-mesh factor as its layout (one block of 2 nV dofs), and
  `factorize` and `solve` open the spans `dense_factor` and
  `dense_solve`.
- `Newton2DStepper` is steppers/newton.py's host loop with that factor:
  one dense factorization per inner iteration (dim2.py:835-966), inside
  the stepper's `newton_factor` span. DOT, GSDD and the LBFGS steppers
  are the 3D ones (steppers/), unchanged.
- `ADMMPD2D` (dim2.py:780-832) is steppers/admm.py's host loop with the
  2D local step (K29) and the 2D D^T W scatter (K30) over LBFGS-PD's dense
  (nV)^2 factor with the Overby weights. `ADMMDD2D` (dim2.py:969-1459) is
  its own host loop over batched dense subdomain matrices: W and the
  consensus matrix (K26's w_assemble2d), the augmented local Hessian
  (K23 on the local positions, K26's local_h_assemble2d and its scaling),
  the per-slab line search (K21 per slab) and the local gradient from the
  carried local F (K22 from F); its Cholesky factorizations, triangular
  solves, W mat-vecs (bmm) and initDual's diagonal glue are library calls
  and plain torch, as they are library calls or plain jnp in dot_tpu.
- `Sim2D` / `run_script_2d` write `<n>.obj` (all vertices, the triangles),
  `status<n>`, `iterStats.txt`, `log.txt`, `info.txt` (the five counts) and
  `config.txt`; no `.msh`. The PNG / GIF render of dot_tpu's
  Sim2D.finalize is not ported.

Not ported yet: restart at dim 2 (it raises NotImplementedError).
warmStart 5 is refused at dim 2, as in dot_tpu.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import io as meshio
from . import mesh_gen, scripts, tracing
from .config import Config
from .kernels import admm2d, dd2d, ops, soa2d
from .partition import partition_amt_from_config
from .plan2d import build_node_plan_2d, build_plan_2d
from .sim import STEPPERS, Simulator, _unsupported, pick_dtype, resolve_device
from .steppers.admm import ADMMPDStepper
from .steppers.core import (GRAVITY_Y, LBFGS_HISTORY, LINE_SEARCH_CAP,
                            SimState, SystemBase)
from .steppers.newton import NewtonStepper
from .steppers.quasi_newton import _vdot, finish_step, push_row

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
    """Batched triangle-element energy / gradient / Hessian, the dense
    whole-mesh factor, and with a plan the decomposed H0 (reference roles:
    Energy at dim 2 + Optimizer::computePrecondMtr / computeGradient at
    dim 2, DOTTimeStepper / LBFGSTimeStepper at DIM = 2)."""

    def __init__(self, mesh: Mesh2D, cfg, dtype=torch.float64, device=None,
                 use_kernels=True, plan=None, factor_dtype=None,
                 whole_mesh=False):
        """`device`: None for the card (raises without one: pass "cpu" to
        run on the CPU). `use_kernels=False` runs the plain PyTorch
        versions of K21-K28 and K32 on any device (a comparison run; the
        main path keeps the default).
        `plan`: a plan2d.Plan2D (an element plan for DOT / GSDD, one part
        for LBFGS-H / HI, a node plan for LBFGS-JH) or None (Newton,
        LBFGS-PD). `factor_dtype=torch.bfloat16`: the subdomain matrices
        are rounded to bf16 and factorized in f32 (LBFGS-HI).
        `whole_mesh=True` (Newton, no plan): the H0 layout states
        `factorize`'s dense whole-mesh factor, one block of 2 nV dofs."""
        self.mesh = mesh
        self.cfg = cfg
        self.dtype = dtype
        self.factor_dtype = factor_dtype or dtype
        self.device = resolve_device(device)
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
        # the gradient's vertex-sorted incidences (dot_tpu's _gdest) and
        # the dense assembly's slot tables (its _hdest), built once
        self.scatter_plan = soa2d.scatter2d_plan(mesh.conn, mesh.n_vert,
                                                 self.device)
        self.dense_tab = dd2d.dense_tables(mesh.conn, mesh.n_vert,
                                           self.device)

        # characteristic tolerance pieces (Optimizer.cpp:612-651)
        self._sqnorm_l = mesh.sqnorm_face_area_sums
        self._sqnorm_H_rest = self._compute_sqnorm_h_rest()

        # the decomposition plan's tables (dot_tpu/dim2.py:409-421); K26's
        # slot runs and K27's vertex-sorted gather derived once here. The
        # H0 layout (SystemBase): P dense blocks of the padded subdomain
        # width (Newton: the whole mesh as one block), no band, no coarse
        # space
        self.plan = plan
        self.n_parts, self.n3 = (1, self.n2) if whole_mesh else (0, 0)
        self._pd_tab = None
        if plan is not None:
            self.n_parts, self.n3 = plan.n_parts, plan.n2
            self.l2g = t(plan.local_to_global, torch.int64)
            self.local_valid = t(plan.local_valid, torch.bool)
            self.dup = t(plan.dup.astype(np.float64))
            self.mass_img = t(mesh.mass[plan.local_to_global]
                              * plan.local_valid)
            self.asm_tab = dd2d.subdomain_tables(plan, mesh.n_elem,
                                                 self.device)
            segids = plan.gath_segids.astype(np.int64)
            self.gath_perm = t(plan.gath_perm, torch.int64)
            self.gath_segids = t(segids, torch.int64)
            self.gath_off = t(np.searchsorted(
                segids, np.arange(mesh.n_vert + 2)), torch.int64)

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

    @tracing.span("gradient")
    def gradient(self, x, x_tilta, fixed):
        """(nV, 3) with z = 0, zero at fixed vertices (K22)."""
        return self.k.elem_gradient2d(
            x, x_tilta, self._free(fixed), self.mass, self.conn, self.g4,
            self.u_e, self.lam_e, self.vol_w, self.mat, self.dt_sq,
            self.scatter_plan)

    @tracing.span("element_hessians")
    def element_hessians(self, x):
        """(36, nE) SPD-projected 6x6 element Hessians at x, dt^2-scaled,
        row-major over the (corner, xy) dofs (K23; dot_tpu keeps them
        block-major, dim2.py:543-555: kernels/dd2d.BLOCK_TO_ROW maps one
        order to the other)."""
        return self.k.elem_hessian2d(x, self.conn, self.g4, self.u_e,
                                     self.lam_e, self.vol_w, self.mat,
                                     self.dt_sq)

    @tracing.span("dense_factor")
    def factorize(self, x, fixed):
        """(L, d): the dense Jacobi-equilibrated Cholesky factor of the
        projected Hessian M + dt^2 sum H_e with unit rows at fixed dofs
        (K23, K24, then K34: the whole-mesh Cholesky in one launch, all NaN
        where it fails; its flag is not read, the line search rejects a NaN
        direction). The assembled matrix is symmetric bit for bit (each
        slot and its mirror sum the same values in the same order), so the
        factorization reads its lower triangle and no symmetrized copy is
        made."""
        H36 = self.element_hessians(x)
        H, d = self.k.dense_assemble2d(H36, self._free(fixed), self.mass,
                                       self.dense_tab)
        Hn = self.k.dense_scale2d(H, d, self.dense_tab)
        del H
        L, _ = self.k.whole_chol(Hn)
        return L, d

    @tracing.span("dense_solve")
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

    def sim2d_state(self, script_data):
        """The Sim2DState of a run's start (Newton, ADMM-DD)."""
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

    def init_state(self, script_data):
        """Newton's Sim2DState without a plan; with one, the quasi-Newton
        SimState with the first H0 (dot_tpu/dim2.py:671-688)."""
        st = self.sim2d_state(script_data)
        if self.plan is None:
            return st
        dtype, dev = self.dtype, self.device
        common = dict(vars(st))
        x, fixed = st.x, st.fixed
        elem_h, L, d, kc = self.rebuild_h0(x, fixed)
        m = LBFGS_HISTORY
        return SimState(
            elem_h=elem_h, chol=L, equil=d,
            lb_s=torch.zeros((m, self.n_vert, 3), dtype=dtype, device=dev),
            lb_t=torch.zeros((m, self.n_vert, 3), dtype=dtype, device=dev),
            lb_rho=torch.ones(m, dtype=dtype, device=dev),
            lb_valid=torch.zeros(m, dtype=dtype, device=dev), kc_chol=kc,
            **common)

    # ------------------------------------------------------------------
    # the quasi-Newton surface at dim 2 (dot_tpu/dim2.py:510-739): DOT's
    # alpha-init, the decomposed H0, LBFGS-PD's scalar factor
    # ------------------------------------------------------------------
    def quadratic_form(self, elem_h, p):
        """(p^T H_tr p including the mass diagonal, F(p)) from one corner
        gather of p (K25; the DOT alpha-init, Optimizer.cpp:1075-1093)."""
        return self.k.quadratic_form2d(p.contiguous(), self.conn, self.g4,
                                       elem_h, self.mass)

    @tracing.span("hessian_diag")
    def hessian_diag(self, elem_h):
        """(nV, 3) diagonal of mass + dt^2 H, z column 1 (K28's second
        entry; dot_tpu/dim2.py:567-580). No 2D path calls it: warmStart 5
        is refused at dim 2."""
        return self.k.hessian_diag2d(elem_h, self.mass, self.scatter_plan)

    @tracing.span("assemble")
    def assemble_subdomains(self, elem_h, fixed):
        """(Hd (P, n3, n3), d (P, n3)): the subdomain Hessians with
        interface completion, lumped mass on free dofs, unit rows at fixed
        and padding dofs (K26; reference: fillInDecomposedHessians), and
        their sqrt-diagonals."""
        free = torch.logical_and(self.local_valid,
                                 torch.logical_not(fixed[self.l2g]))
        return self.k.subdomain_assemble2d(elem_h, free.to(self.dtype),
                                           self.mass_img, self.asm_tab)

    def _cholesky_nan(self, Hn):
        """(L, 0-d bool): the lower Cholesky factors of Hn (P, n, n) or
        (n, n), read from its lower triangle, exact zeros above the
        diagonal, all NaN in every matrix whose factorization failed, and
        whether any did, on the device (K33 in one launch; its plain
        version, the batched library Cholesky and its NaN passes, on the
        CPU)."""
        L, bad = self.k.dense_chol(Hn.reshape((-1,) + Hn.shape[-2:]))
        return L.reshape(Hn.shape), bad

    @tracing.span("h0_factor")
    def factorize_fast(self, Hd, d):
        """(L, d): the Jacobi-equilibrated, symmetrized matrices (K26's
        second entry; Hd is scaled in place on the card), rounded through
        bf16 for LBFGS-HI, then the batched Cholesky (K33). If any factor
        fails, all P are refactored with 1e-4 on the diagonal, as dot_tpu's
        global tier does (dim2.py:604-621): one host read."""
        Hn = self._to_factor_dtype(
            self.k.subdomain_scale2d(Hd, d, self.asm_tab))
        L, bad = self._cholesky_nan(Hn)
        if self.host(bad)[0]:
            with tracing.span("h0_refactor"):
                Hn.diagonal(dim1=1, dim2=2).add_(1.0e-4)
                L, _ = self._cholesky_nan(Hn)
        return L, d

    @tracing.span("solve_local")
    def solve_local(self, L, r):
        """The factored subdomain systems against equilibrated right-hand
        sides r (P, n3): forward and backward substitution in one launch
        of K32 (plain version: two batched library triangular solves)."""
        z = self.k.tri_solve(L, r.to(self._solve_dtype))
        return z.to(self.dtype)

    @tracing.span("h0_apply")
    def h0_apply(self, L, d, rhs, kc=None, fixed=None):
        """Per-subdomain backsolve + duplicate averaging (K27's gather, the
        solves, K27's averaging; DOTTimeStepper.cpp:406-450 at DIM = 2).
        There is no coarse space at dim 2: `kc` and `fixed` are unused."""
        r = self.k.h0_gather2d(rhs.contiguous(), self.l2g, self.local_valid,
                               d)
        z = self.solve_local(L, r).contiguous()
        return self.k.h0_average2d(z, d, self.gath_perm, self.gath_segids,
                                   self.gath_off, self.dup)

    def subdomain_solve(self, L, d, q, i):
        """Subdomain i's factor against the global vector q (nV, 3),
        scattered into a zero (nV, 3) direction (the GSDD sweep; K27's
        one-subdomain gather and scatter around the solve of L[i])."""
        r = self.k.local_gather_one2d(q.contiguous(), self.l2g,
                                      self.local_valid, d, i)
        z = self.solve_local(L[i:i + 1], r[None])[0].contiguous()
        return self.k.local_scatter_one2d(z, d, self.l2g, self.local_valid,
                                          i, self.n_vert)

    @tracing.span("rebuild_h0")
    def rebuild_h0(self, x, fixed):
        """(elem_h, L, d, None): element Hessians at x, assembled and
        factorized (dot_tpu/dim2.py:660-669)."""
        elem_h = self.element_hessians(x)
        L, d = self.factorize_fast(*self.assemble_subdomains(elem_h, fixed))
        return elem_h, L, d, None

    def build_pd_factor(self, fixed, w=None):
        """(L, d) of M + dt^2 D^T W D on the (nV)^2 scalar matrix with unit
        rows at fixed vertices (K28, K26's scaling entry on its slots, K33's
        Cholesky, NaN where it fails; dot_tpu/dim2.py:698-729). `w`:
        (nE,) element weights (default: LBFGS-PD's dt^2 area (2 mu +
        lambda))."""
        if self._pd_tab is None:
            self._pd_tab = dd2d.pd_tables(self.mesh.conn, self.n_vert,
                                          self.device)
        if w is None:
            w = self.scalar(self.dt_sq) * self.vol_w \
                * (2.0 * self.u_e + self.lam_e)
        S, d = self.k.pd_assemble2d(self.g4, w, self._free(fixed), self.mass,
                                    self._pd_tab)
        Sn = self.k.subdomain_scale2d(S[None], d[None], self._pd_tab)
        L, _ = self._cholesky_nan(Sn[0].to(self._solve_dtype))
        return L, d

    @tracing.span("pd_solve")
    def pd_solve(self, L, d, rhs):
        """The two in-plane columns of rhs (nV, 3) against the PD factor;
        z = 0 (dot_tpu/dim2.py:731-739)."""
        r = (rhs[:, :2] / d[:, None]).to(self._solve_dtype)
        y = torch.linalg.solve_triangular(L, r, upper=False)
        z = torch.linalg.solve_triangular(L.mT, y, upper=True)
        p2 = z.to(self.dtype) / d[:, None]
        return torch.cat([p2, torch.zeros((self.n_vert, 1), dtype=self.dtype,
                                          device=self.device)], dim=1)


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
        L, d = self.factor(x, fixed)
        return self.system.solve(L, d, g)

    @tracing.span("newton_factor")
    def factor(self, x, fixed):
        """(L, d): the dense whole-mesh factor of the Hessian at x."""
        return self.system.factorize(x, fixed)


class ADMMPD2D(ADMMPDStepper):
    """ADMM-PD at dim 2 (dot_tpu/dim2.py:780-832): the reference's
    dimension-templated ADMMTimeStepper (ADMMTimeStepper.cpp:736) at DIM =
    2, steppers/admm.py's host loop with 3-corner triangles, the 2-dof
    sigma-space local Newton (K29), the 2D D^T W scatter (K30) and
    System2D's dense (nV)^2 factor of M + D^T W D with the Overby weights
    dt^2 area bulkModulus (K28; bulkModulus is the 3D formula lambda +
    2 mu / 3, as dot_tpu computes it at dim 2)."""

    def _local_step(self, f4, u4):
        """(z, du), each (4, nE), from Dx and the dual u (K29)."""
        sys = self.system
        return sys.k.admm_local_step2d(f4, u4, self.w_e, self.vol_dtsq,
                                       sys.u_e, sys.lam_e, sys.mat)

    def _scatter(self, M4, x, **epilogue):
        sys = self.system
        return sys.k.dtw_scatter2d(M4, sys.g4, self.w_e, sys.scatter_plan, x,
                                   **epilogue)


ADMM_DD_ITER_CAP = 1000    # ADMMDDTimeStepper.cpp:632
ADMM_DD_H_REFRESH = 20     # ADMMDDTimeStepper.cpp:637
ADMM_DD_RELAX = 1.8        # boundaryConsensusSolve over-relaxation


class ADMMDD2D:
    """ADMM-DD at dim 2 (dot_tpu/dim2.py:969-1459): overlapping-subdomain
    consensus ADMM with batched dense (P, n2p, n2p) subdomain matrices
    (reference: ADMMDDTimeStepper.cpp:595-701 fullyImplicit,
    initWeights_fast :894-1033, subdomainSolve :1107-1232,
    boundaryConsensusSolve :1254-1344, at DIM = 2). The weights are
    refreshed once a time step from the incoming positions.

    dot_tpu's lax.while_loops are host loops: one read of ||g||^2 an
    iteration and one of any(E_trial > E_0) a line-search trial. The local
    positions stay (P N + 1, 3) with z = 0 and a zero dump row, so K23 and
    defgrad2d read them as global positions; the local factor is refreshed
    from them every 20 iterations (dot_tpu: from the carried local F, the
    same values up to rounding)."""

    name = "ADMMDD"

    def __init__(self, system, script_data, warm_start_opt=2):
        sys_ = self.system = system
        self.script_data = script_data
        self.warm_start_opt = warm_start_opt
        self._anim = scripts.make_step_fn(script_data, system.dt)
        mesh, plan = sys_.mesh, sys_.plan
        P, N, n2p = plan.n_parts, plan.n_local_max, plan.n2
        self.P, self.N, self.n2p = P, N, n2p
        dev, dt = sys_.device, sys_.dtype
        self.tables = tb = admm2d.admm_dd2d_tables(mesh, plan)
        self.epad = tb.epad

        def t(a, dtype=dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)
        # the (P epad) slab triangles' statics; padding slots have area 0
        # and corners at the dump row P N
        es, ev = tb.elem_src, tb.elem_valid
        g = np.asarray(mesh.rest_tri_inv)[es] * ev[:, None, None]
        self.lg4 = t(g.reshape(-1, 4).T)
        self.lw = t(np.asarray(mesh.area)[es] * ev)
        self.lu = t(np.asarray(mesh.u)[es])
        self.llam = t(np.asarray(mesh.lam)[es])
        self.conn_local = t(tb.conn_local.T, torch.int32)
        self.rows = admm2d.row_incidences(tb.conn_local, P * N, dev)
        self.mass_local = t(tb.mass_local)
        self.mass_dif = t(tb.mass_dif)
        self.is_dual = t(tb.is_dual, torch.bool)
        self.owner_flat = t(tb.owner_flat, torch.int64)
        self.shared_ids = t(tb.shared_ids, torch.int64)
        self.n_shared, self.ns2 = tb.n_shared, tb.ns2
        self.l2shared = t(tb.l2shared, torch.int64)
        is_sh = np.zeros(mesh.n_vert, bool)
        is_sh[tb.shared_ids] = True
        self.is_shared = t(is_sh, torch.bool)
        # the mass difference summed per shared vertex (static: a CPU sum
        # in dot_tpu's order, once)
        md_sh = torch.zeros(self.n_shared + 1, dtype=dt).index_add_(
            0, torch.as_tensor(tb.l2shared.reshape(-1)),
            torch.as_tensor(tb.mass_dif.reshape(-1), dtype=dt))
        self.md_sh = md_sh.to(dev)
        # K26's slot runs: W and C from the completion tuples, the own
        # triangles' blocks over slots that also cover W's (K26's scaling
        # then reaches every nonzero of the augmented local Hessian)
        w_src = admm2d.row_major_src(tb.comp_gather, mesh.n_elem)
        self.w_tab = dd2d.slot_tables(w_src, tb.w_dest, P, N, 2, dev)
        self.c_tab = dd2d.slot_tables(w_src, tb.c_dest, 1, self.n_shared + 1,
                                      2, dev)
        keep = tb.own_dest < P * n2p * n2p
        own_src = admm2d.row_major_src(tb.own_src, P * tb.epad)[keep]
        self.own_tab = dd2d.slot_tables(own_src, tb.own_dest[keep], P, N, 2,
                                        dev, slots=tb.w_dest)

    # ------------------------------------------------------------------
    def _free(self, fixed):
        """(P, N) free mask per local vertex (valid and not fixed)."""
        sys = self.system
        return torch.logical_and(sys.local_valid, torch.logical_not(
            fixed[sys.l2g])).to(sys.dtype)

    def weights(self, x, fixed):
        """(Wm, Lc, dc): the masked dense W (P, n2p, n2p) and the factor of
        the Jacobi-equilibrated consensus matrix at x (initWeights_fast and
        boundaryConsensusSolve's matrix; K23, K26's w_assemble2d, K26's
        scaling, K33's Cholesky)."""
        sys = self.system
        sfree = torch.cat([torch.logical_not(fixed[self.shared_ids]).to(
            sys.dtype), torch.zeros(1, dtype=sys.dtype, device=sys.device)])
        Wm, C, dc = sys.k.w_assemble2d(sys.element_hessians(x),
                                       self._free(fixed), sfree, self.md_sh,
                                       self.w_tab, self.c_tab)
        Cn = sys.k.subdomain_scale2d(C[None], dc[None], self.c_tab)
        Lc, _ = sys._cholesky_nan(Cn)
        return Wm, Lc[0], dc

    def _w_matvec(self, Wm, md2f, a):
        """W a + the masked mass-difference diagonal, (P, n2p)."""
        return torch.bmm(Wm, a[..., None])[..., 0] + md2f * a

    def _to_flat(self, xl):
        """(P, N, 2) -> the flat (P N + 1, 3) local rows, z = 0, a zero
        dump row."""
        sys = self.system
        flat = torch.zeros((self.P * self.N + 1, 3), dtype=sys.dtype,
                           device=sys.device)
        flat[:-1, :2] = xl.reshape(-1, 2)
        return flat

    def _rows2(self, flat):
        return flat[:-1, :2].reshape(self.P, self.N, 2)

    def _local_defgrad(self, flat):
        return self.system.k.defgrad2d(flat, self.conn_local, self.lg4)

    def slab_psi(self, f4, fp4=None, alpha=None):
        """(P,) dt^2 sum area Psi per subdomain slab at f4 + alpha_p fp4
        (K21 per slab)."""
        sys = self.system
        e = sys.k.ls_trial_energy2d_parts(f4, fp4, alpha, self.lu, self.llam,
                                          self.lw, sys.mat, self.P)
        return e * sys.scalar(sys.dt_sq)

    def aug_vec(self, xl_flat, z, u_loc):
        zg = z[self.system.l2g][:, :, :2]
        return (self._rows2(xl_flat) - zg + u_loc).reshape(self.P, self.n2p)

    def local_gradient(self, xl_flat, xhat_flat, z, u_loc, Wm, free2f, md2f,
                       f4):
        """(P, N, 2) gradient of the augmented local energies; the element
        part from the carried local F (K22 from F)."""
        sys = self.system
        P, N = self.P, self.N
        acc = sys.k.elem_gradient2d_from_F(f4, self.conn_local, self.lg4,
                                           self.lu, self.llam, self.lw,
                                           sys.mat, self.rows)
        g = acc.reshape(P, N, 2) * sys.scalar(sys.dt_sq)
        g = g + self.mass_local[..., None] * (self._rows2(xl_flat)
                                              - self._rows2(xhat_flat))
        aug = self.aug_vec(xl_flat, z, u_loc)
        g = g + self._w_matvec(Wm, md2f, aug).reshape(P, N, 2)
        return g * free2f.reshape(P, N, 2)

    def local_h_factor(self, xl_flat, Wm, free):
        """(L, d): the factor of the Jacobi-equilibrated augmented local
        Hessian: own triangles' elasticity at the local positions + local
        mass + W, identity at fixed and padding rows
        (computeHessianProxy_subdomain; K23, K26's local_h_assemble2d and
        its scaling over the union of own and W slots, K33's batched
        Cholesky with NaN where it fails)."""
        sys = self.system
        eh = sys.k.elem_hessian2d(xl_flat, self.conn_local, self.lg4,
                                  self.lu, self.llam, self.lw, sys.mat,
                                  sys.dt_sq)
        mass = self.mass_local + self.mass_dif * free
        H, d = sys.k.local_h_assemble2d(eh, Wm, free, mass, self.own_tab)
        L, _ = sys._cholesky_nan(sys.k.subdomain_scale2d(H, d, self.own_tab))
        return L, d

    def _solve(self, L, d, r):
        """(L L^T)^-1 applied to r / d, then / d: two batched library
        triangular solves. r (P, n2p)."""
        y = torch.linalg.solve_triangular(L, (r / d)[..., None], upper=False)
        zz = torch.linalg.solve_triangular(L.mT, y, upper=True)
        return zz[..., 0] / d

    def init_dual(self, g, g_loc, Wm, free2f, md2f):
        """u = W^-1 (g_global - g_local) on the interface dofs: the dense
        batched solve of W + I off the dual dofs (ADMMDDTimeStepper.cpp:
        736-796); K33's Cholesky of the equilibrated, symmetrized matrix
        (jnp.linalg.cholesky in dot_tpu)."""
        sys = self.system
        P, N, n2p = self.P, self.N, self.n2p
        rhs_u = (g[sys.l2g][:, :, :2] * sys.local_valid[..., None]
                 - g_loc) * self.is_dual[..., None]
        dual2 = torch.repeat_interleave(self.is_dual.to(sys.dtype), 2,
                                        dim=-1) * free2f
        wdg = Wm.diagonal(dim1=1, dim2=2) + md2f
        fix1 = ((wdg == 0.0) & (dual2 > 0.0)).to(sys.dtype)
        Ws = Wm.clone()
        Ws.diagonal(dim1=1, dim2=2).add_(md2f + (1.0 - dual2) + fix1)
        dw = torch.sqrt(Ws.diagonal(dim1=1, dim2=2))
        Ws = Ws / dw[:, :, None] / dw[:, None, :]
        Lw, _ = sys._cholesky_nan((Ws + Ws.mT) / 2)
        del Ws
        yw = torch.linalg.solve_triangular(
            Lw, (rhs_u.reshape(P, n2p) / dw)[..., None], upper=False)
        zw = torch.linalg.solve_triangular(Lw.mT, yw, upper=True)
        return ((zw[..., 0] / dw).reshape(P, N, 2)
                * dual2.reshape(P, N, 2))

    # ------------------------------------------------------------------
    def init_state(self):
        return self.system.sim2d_state(self.script_data)

    def step(self, state, rel_tol=1.0e-5):
        """One full time step. Updates `state` in place and returns
        (state, (StepStats, sysE))."""
        sys = self.system
        P, N, n2p = self.P, self.N, self.n2p
        syncs0 = sys.n_syncs
        tol = sys.target_g_res(rel_tol)
        x0, fixed, vel_sign, released, _bc = self._anim(
            state.x, state.fixed, state.vel_sign, state.released)
        state.fixed, state.vel_sign, state.released = fixed, vel_sign, released
        # weights at the incoming positions (the reference's step-end
        # refresh sees the same converged state)
        Wm, Lc, dc = self.weights(x0, fixed)
        free = self._free(fixed)
        free2f = torch.repeat_interleave(free, 2, dim=-1)       # (P, n2p)
        md2f = torch.repeat_interleave(self.mass_dif, 2, dim=-1) * free2f
        x_tilta = state.x_tilta

        # initPrimal
        x = sys.warm_start(self.warm_start_opt, x0, state.v,
                           state.dx_elastic, fixed)
        xhat_g = torch.where(fixed[:, None], x, x_tilta)
        valid = sys.local_valid[..., None]
        xl_flat = self._to_flat(x[sys.l2g][:, :, :2] * valid)
        xhat_flat = self._to_flat(xhat_g[sys.l2g][:, :, :2] * valid)
        z = x
        u_loc = torch.zeros((P, N, 2), dtype=sys.dtype, device=sys.device)

        e = sys.energy(x, x_tilta, sys.defgrad(x))
        g = sys.gradient(x, x_tilta, fixed)
        e_h, sqn_h = sys.host(e, _vdot(g, g))
        rows = [(0.0, e_h, sqn_h)]

        # initDual; the local F at the initial local state seeds the carry
        f4 = self._local_defgrad(xl_flat)
        g_loc = self.local_gradient(xl_flat, xhat_flat, z, u_loc, Wm, free2f,
                                    md2f, f4)
        u_loc = self.init_dual(g, g_loc, Wm, free2f, md2f)
        L, d = self.local_h_factor(xl_flat, Wm, free)
        ml = self.mass_local[..., None]
        ae_rows = torch.repeat_interleave(
            torch.arange(P, device=sys.device), N)
        shared_fixed = fixed[self.shared_ids][:, None]

        it = 0
        while sqn_h > tol and it < ADMM_DD_ITER_CAP:
            if it % ADMM_DD_H_REFRESH == 0 and it > 0:
                L, d = self.local_h_factor(xl_flat, Wm, free)

            # one local Newton iteration + linearized line search
            gl = self.local_gradient(xl_flat, xhat_flat, z, u_loc, Wm,
                                     free2f, md2f, f4)
            p = (self._solve(L, d, -gl.reshape(P, n2p)).reshape(P, N, 2)
                 * free2f.reshape(P, N, 2))
            p_flat = self._to_flat(p)
            fp4 = self._local_defgrad(p_flat)
            d0v = self._rows2(xl_flat) - self._rows2(xhat_flat)
            c0 = 0.5 * torch.sum(ml * d0v * d0v, dim=(1, 2))
            c1 = torch.sum(ml * d0v * p, dim=(1, 2))
            c2 = 0.5 * torch.sum(ml * p * p, dim=(1, 2))
            aug0 = self.aug_vec(xl_flat, z, u_loc)
            pa = p.reshape(P, n2p)
            Wa0 = self._w_matvec(Wm, md2f, aug0)
            Wpa = self._w_matvec(Wm, md2f, pa)
            a0c = 0.5 * torch.sum(aug0 * Wa0, dim=1)
            a1c = 0.5 * (torch.sum(pa * Wa0, dim=1)
                         + torch.sum(aug0 * Wpa, dim=1))
            a2c = 0.5 * torch.sum(pa * Wpa, dim=1)

            def trial_e(alpha):
                return (self.slab_psi(f4, fp4, alpha)
                        + c0 + alpha * (c1 + alpha * c2)
                        + a0c + alpha * (a1c + alpha * a2c))

            e0 = self.slab_psi(f4) + c0 + a0c
            alpha = torch.ones(P, dtype=sys.dtype, device=sys.device)
            ee = trial_e(alpha)
            k = 0
            while k < LINE_SEARCH_CAP and sys.host((ee > e0).any())[0]:
                alpha = torch.where(ee > e0, 0.5 * alpha, alpha)
                ee = trial_e(alpha)
                k += 1
            xl_flat[:-1] += alpha[ae_rows][:, None] * p_flat[:-1]
            f4 = f4 + torch.repeat_interleave(alpha, self.epad) * fp4

            # boundary consensus solve (relax 1.8)
            xl = self._rows2(xl_flat)
            zg = z[sys.l2g][:, :, :2]
            aug = (ADMM_DD_RELAX * xl + (1.0 - ADMM_DD_RELAX) * zg + u_loc
                   - zg).reshape(P, n2p)
            tw = self._w_matvec(Wm, md2f, aug).reshape(P * N, 2)
            rhs_sh = torch.zeros((self.n_shared + 1, 2), dtype=sys.dtype,
                                 device=sys.device)
            rhs_sh.index_add_(0, self.l2shared.reshape(-1), tw)
            rhs_sh = torch.where(shared_fixed, 0.0, rhs_sh[:self.n_shared])
            rhs = torch.cat([rhs_sh, torch.zeros(
                (1, 2), dtype=sys.dtype, device=sys.device)]).reshape(-1)
            yc = torch.linalg.solve_triangular(Lc, (rhs / dc)[:, None],
                                               upper=False)
            zc = torch.linalg.solve_triangular(Lc.mT, yc, upper=True)
            dz = (zc[:, 0] / dc).reshape(-1, 2)

            # interior vertices take their owner's local copy
            z2 = torch.where(self.is_shared[:, None], z[:, :2],
                             xl_flat[self.owner_flat, :2])
            z2[self.shared_ids] += dz[:self.n_shared]
            z_new = torch.cat([z2, torch.zeros(
                (sys.n_vert, 1), dtype=sys.dtype, device=sys.device)], dim=1)

            # dual update (step 1, relax 1.8)
            u_loc = u_loc + (ADMM_DD_RELAX * xl + (1.0 - ADMM_DD_RELAX) * zg
                             - z_new[sys.l2g][:, :, :2]) \
                * self.is_dual[..., None]
            z = z_new

            # global convergence check
            g = sys.gradient(z, x_tilta, fixed)
            e = sys.energy(z, x_tilta, sys.defgrad(z))
            e_h, sqn_h = sys.host(e, _vdot(g, g))
            it += 1
            push_row(rows, (1.0, e_h, sqn_h))

        state, (stats, sys_e) = finish_step(sys, state, z, e_h, sqn_h, tol,
                                            it, 0, False, False, rows, syncs0)
        stats.stopped = it >= ADMM_DD_ITER_CAP     # dot_tpu dim2.py:1457
        return state, (stats, sys_e)


class Sim2D(Simulator):
    """The 2D frame loop, with the per-run output contract of dot_tpu's
    Sim2D (config.txt, <n>.obj with all vertices and the triangles,
    status<n>, iterStats.txt, log.txt, info.txt with the five counts;
    reference: main.cpp:318-358). Runs `timeStepper Newton | DOT n | DOT -1
    blockSize | GSDD n | LBFGS | LBFGSH | LBFGSHI | LBFGSJH n | ADMM
    [maxIter] | ADMMDD n`."""

    timing_in_info = False    # dot_tpu's Sim2D.finalize writes no timing

    def __init__(self, cfg: Config, output_dir: str, dtype=None, device=None,
                 save_every=1, mute=False, use_kernels=True):
        device = resolve_device(device)
        st = cfg.time_stepper
        if cfg.restart:
            raise _unsupported("restart")
        self._begin(cfg, output_dir, device, save_every, mute)
        self.timer.start("load")
        self.mesh = Mesh2D.from_config(cfg)
        self.script_data = scripts.init_script(self.mesh, cfg.script)
        # target_g_res reads the mask: set it before the first step
        self.mesh.fixed_mask = self.script_data.fixed0.copy()
        self.timer.start("partition+compile")
        dtype = dtype if dtype is not None else pick_dtype(None, self.device)
        # the plan of each stepper (dot_tpu/dim2.py:1495-1544): DOT, GSDD
        # and ADMM-DD the element partition, LBFGS-H / HI the whole mesh as
        # one part (HI: bf16-rounded matrix), LBFGS-JH a disjoint node
        # partition, Newton, LBFGS-PD and ADMM-PD none
        plan, fdt = None, None
        if st in ("DOT", "GSDD", "ADMMDD"):
            plan = build_plan_2d(self.mesh, partition_amt_from_config(
                cfg, self.mesh.n_vert))
        elif st in ("LBFGSH", "LBFGSHI"):
            plan = build_plan_2d(self.mesh, 1)
            fdt = torch.bfloat16 if st == "LBFGSHI" else None
        elif st == "LBFGSJH":
            plan = build_node_plan_2d(self.mesh, partition_amt_from_config(
                cfg, self.mesh.n_vert))
        self.system = System2D(self.mesh, cfg, dtype=dtype,
                               device=self.device, use_kernels=use_kernels,
                               plan=plan, factor_dtype=fdt,
                               whole_mesh=st == "Newton")
        if st == "ADMM":
            self.stepper = ADMMPD2D(self.system, self.script_data,
                                    max_iter=cfg.max_iter_apd)
        else:
            cls = {"Newton": Newton2DStepper, "ADMMDD": ADMMDD2D}.get(st) \
                or STEPPERS[st]
            self.stepper = cls(self.system, self.script_data,
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
