"""Device-side system assembly for the time steppers, in PyTorch (port of
dot_tpu/steppers/core.py).

`System` holds the static buffers of one mesh + subdomain plan (an element
partition, a disjoint node partition, the whole mesh as one part, or no
plan at all for LBFGS-PD) as tensors on an explicit device and offers the
functions the steppers compose:
incremental-potential energy, gradient, element Hessians, subdomain
assembly (dense or RCM-banded block-tridiagonal), the Jacobi-equilibrated
H0 factorization (block cyclic reduction on deep bands, the block scan
otherwise, blocked or plain Cholesky on dense plans), the H0 apply
(solve + duplicate averaging) and, as dot_tpu has them:
- the two-level coarse space (P >= 16, or `coarse 1`): a Galerkin matrix
  Kc = Z^T (dt^2 K + M) Z over 6 rigid modes per part, factored with the
  fine H0 and added to its apply (core.py:289-352, 1296-1449);
- the chunked low-memory rebuild (`_chunk`: f32, P > 1, an f32 band over
  2 GiB): the compact unique blocks equilibrated, rounded to bf16 and
  scattered once into a bf16 band, factored by one lower-triangle block
  scan with bf16 SYRKs (core.py:277-282, 1465-1559). The gate is
  dot_tpu's, so the port builds the preconditioner dot_tpu builds for
  the same plan.

The per-element passes go through the hand-written kernels K1-K4 of
kernels/ops.py; the banded H0 rebuild and apply through K5-K8 (band
assembly, diagonal-block Cholesky + inverse, the block solves: K7's
products, one launch a solve, the vertex gather / averaging); the coarse
space through K10 (Kc assembly) and K11 (restriction, prolongation), with
its (6P)^2 factor on K6 and its solve pair on K7 (one launch); the
chunked band through K5's compact entry point and K12 (equilibrate + bf16
scatter). The other steppers add K13 (the Hessian
diagonal of warmStart 5), K14 (the LBFGS-PD matrix M + dt^2 D^T W D in its
banded storage), K15 (its solve: block products against the three
coordinates at once, and the permute / scale passes) and K16 (the GSDD
sweep's one-subdomain gather and scatter; its solve is K7 on the
subdomain's blocks, read in place). The large GEMMs of the factorizations stay
torch.matmul, as dot_tpu leaves them to XLA. `use_kernels=False` swaps in
the kernels' plain PyTorch versions on any device, for comparison runs.
The dense-plan assembly and the dense triangular solves are plain torch
(dense plans are not the main path). dot_tpu's per-subdomain packing of
the scan assembly (core.py:602-666) and its uniform/mixed element split
of the coarse build are TPU layout and are not ported: K5 and K10 reduce
the same sums in a fixed order.

Precision, as dot_tpu (core.py:180-195, 776-788, 853-1203): fields and
reductions in `dtype`; the system energy diagnostic in float64. In f32 the
quasi-Newton H0 factors are preconditioner-grade: the trailing updates
are bf16-input GEMMs with f32 results, and every factor leaf is stored in
bf16 (`apply_dtype`, "applyDtype" in a scene file); the per-iteration
solves upcast them to f32. f64 runs factorize exactly. `factor_dtype=
torch.bfloat16` (LBFGS-HI) rounds the equilibrated matrix to bf16 and
factorizes in f32.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import partition, tracing
from ..device import resolve_device
from ..kernels import band, coarse, ops, pd, soa

# Reference constants (dot_tpu/steppers/core.py:112-117)
GRAVITY_Y = -9.80665           # Optimizer.cpp:109
LBFGS_HISTORY = 5              # DOTTimeStepper.cpp:45
INNER_ITER_CAP = 10000         # Optimizer.cpp:662
LINE_SEARCH_CAP = 64           # reference halves literally to fp zero
REL_EDEC_STOP = 1.0e-3         # Optimizer.cpp:856-862 (allowEDecRelTol)
STATS_CAP = INNER_ITER_CAP + 16  # iterStats rows kept per step

APPLY_DTYPES = {"": None, "f32": torch.float32, "f64": torch.float64,
                "bf16": torch.bfloat16}


class BTDFactor(NamedTuple):
    """Block-tridiagonal Cholesky factor of the RCM-banded subdomain
    matrices: per-block INVERTED diagonal factors and the sub-diagonal
    coupling blocks (scan-major)."""
    linv: torch.Tensor   # (nb, P, bs, bs) L_kk^{-1}
    sub: torch.Tensor    # (nb-1, P, bs, bs) L_{k+1,k}


class CRFactor(NamedTuple):
    """Block cyclic-reduction factor of the same block-tridiagonal systems
    (dot_tpu's CRFactor, core.py:132-144): each level eliminates all odd
    blocks at once; per odd block j (D_j = L L^T, Li = L^{-1})
      levels[l] = (Li_j, G_lo = Li S_{j-1}, G_hi = Li S_j^T),
    and the <= 4-block root keeps the scan factor."""
    levels: tuple     # per level: (Li, G_lo, G_hi) each (n_odd, P, bs, bs)
    root: BTDFactor   # factor of the final reduced system (nb_root <= 4)


class CoarseFactor(NamedTuple):
    """Factor of the equilibrated coarse matrix (dot_tpu's kc_chol (Lc, dc)
    plus Lc^{-1}, which the apply multiplies with instead of two
    triangular solves)."""
    lc: torch.Tensor     # (6P, 6P) Cholesky factor of Kn + shift I
    linv: torch.Tensor   # (6P, 6P) Lc^{-1}
    dc: torch.Tensor     # (6P,) Jacobi scale


def factor_leaves(fac):
    """The tensors of an H0 factor (dense, BTDFactor or CRFactor)."""
    if isinstance(fac, CRFactor):
        return [t for lv in fac.levels for t in lv] + list(fac.root)
    if isinstance(fac, BTDFactor):
        return list(fac)
    return [fac]


def _any_nan(fac):
    """0-d bool: a NaN in any leaf (the tiers' test, as dot_tpu's bad())."""
    return torch.stack([torch.isnan(t).any() for t in factor_leaves(fac)]
                       ).any()


def _mm(a, b, bf16):
    """a @ b; with `bf16`, inputs rounded to bf16 and the products summed
    and kept in f32 (dot_general with preferred_element_type=f32: the
    products of bf16 values are exact in f32), as four casts and an f32
    GEMM. The callers: cyclic reduction's level products (`_cr_build`) and
    the dense fast path's trailing updates, with `bf16` on their fast tier
    and off on the exact ones. The block scan's bf16 SYRK is K31
    (`_btd_scan_equilibrated`), not this."""
    if bf16:
        b16 = torch.bfloat16
        return a.to(b16).to(torch.float32) @ b.to(b16).to(torch.float32)
    return a @ b


@dataclasses.dataclass
class SimState:
    """Dynamic simulation state (dot_tpu.steppers.core.SimState)."""
    x: torch.Tensor           # (nV, 3) positions
    x_n: torch.Tensor         # (nV, 3) previous step positions
    v: torch.Tensor           # (nV, 3) velocities
    x_tilta: torch.Tensor     # (nV, 3) inertia predictor
    dx_elastic: torch.Tensor  # (nV, 3)
    fixed: torch.Tensor       # (nV,) bool
    vel_sign: torch.Tensor    # () script turning sign
    released: torch.Tensor    # () bool rubberBandPull release happened
    elem_h: torch.Tensor      # (144, nEp) frozen element Hessians
    chol: object              # (P, n3, n3) tensor, BTDFactor or CRFactor
    equil: torch.Tensor       # (P, n3) equilibration sqrt-diagonals
    lb_s: torch.Tensor        # (m, nV, 3) L-BFGS s history (oldest..newest)
    lb_t: torch.Tensor        # (m, nV, 3) L-BFGS t history
    lb_rho: torch.Tensor      # (m,) t.s
    lb_valid: torch.Tensor    # (m,) 0/1
    kc_chol: object = None    # CoarseFactor, None when the coarse space is off


@dataclasses.dataclass
class StepStats:
    """Host-side result of one time step."""
    energy: float       # final incremental potential
    sqn_g: float        # final ||g||^2
    inner_iters: int
    ls_halvings: int
    stop: str           # "tol", "rel_dec", "ls_failed" or "iter_cap"
    rows: list          # per-iteration (alpha, E, ||g||^2), row 0 = start
    syncs: int          # device -> host reads this step took
    # dot_tpu's StepStats.stopped: the loop ended by its own stop rule (the
    # quasi-Newton and Newton steppers: a failed line search or the relative
    # decrease; the ADMM steppers: the iteration cap)
    stopped: bool = False


class SystemBase:
    """What the 3D System and the 2D System2D (dim2.py) share: the host
    read, the tolerance, the inertia terms, the warm starts 0-4, the
    Backward-Euler update, the float64 energy diagnostic and the factor
    dtype. A subclass sets dtype, factor_dtype, device, dt, dt_sq, n_vert,
    n_syncs, mesh, mat, mass, vol_w (the per-element rest measure), u_e,
    lam_e, gravity, grav_dt_sq, _sqnorm_H_rest and _sqnorm_l, and offers
    elastic_energy.

    The H0 layout every system states, in the 3D System's terms (what
    the benchmark and the profiler read): `n_parts` subdomains, each a
    padded block of `n3` dofs (0 and 0 without a plan), `banded` blocks
    of `band_nb` blocks of `band_bs` (read only where banded), the
    two-level coarse space (`use_coarse`) and the storage dtype of the
    applied factor (`apply_dtype`, None: the field dtype). A subclass sets
    n_parts and n3; the rest default to one dense block a part, no coarse
    space, the field dtype."""

    n_parts: int
    n3: int
    band_nb: int
    band_bs: int
    banded = False
    use_coarse = False
    apply_dtype = None

    @property
    def _solve_dtype(self):
        return (torch.float32 if self.factor_dtype == torch.bfloat16
                else self.factor_dtype)

    def _to_factor_dtype(self, Hn):
        """A bfloat16 factor dtype means: round the matrix to bf16 and
        factorize in f32 (LBFGS-HI's stand-in for the reference's
        incomplete Cholesky; dot_tpu core.py:776-783)."""
        if self.factor_dtype == torch.bfloat16:
            return Hn.to(torch.bfloat16).to(torch.float32)
        return Hn.to(self.factor_dtype)

    def host(self, *vals):
        """One device -> host read of 0-d tensors (counted in n_syncs; a
        `host_read` span whose wait_ns is the time blocked in the read)."""
        self.n_syncs += 1
        with tracing.span("host_read") as rec:
            t = torch.stack([v.reshape(()).to(torch.float64) for v in vals])
            t0 = time.perf_counter_ns()
            out = t.tolist()
            if rec is not None:
                rec["wait_ns"] = time.perf_counter_ns() - t0
        return out

    def scalar(self, v):
        return torch.tensor(v, dtype=self.dtype, device=self.device)

    def target_g_res(self, rel_tol):
        """targetGRes = eps^2 ||H_rest||^2 ||l||^2 (nFree/nV) dt^4
        (reference: computeCharNormSq; energyParamSum == 1)."""
        n_free = self.n_vert - int(np.count_nonzero(self.mesh.fixed_mask))
        return (rel_tol * rel_tol * self._sqnorm_H_rest * self._sqnorm_l
                * (n_free / self.n_vert) * self.dt_sq * self.dt_sq)

    def energy(self, x, x_tilta, F):
        """Incremental potential: dt^2 sum w Psi + 1/2 ||x - xt||_M^2
        (reference: Optimizer::computeEnergyVal, Optimizer.cpp:1183-1218)."""
        d = x - x_tilta
        e_in = 0.5 * torch.sum(self.mass * torch.sum(d * d, dim=-1))
        return self.elastic_energy(F) + e_in

    def inertia_quad(self, x0, p, x_tilta):
        """(c0, c1, c2) with  1/2||x0 + a p - xt||_M^2 = c0 + a c1 + a^2 c2."""
        d0 = x0 - x_tilta
        c0 = 0.5 * torch.sum(self.mass * torch.sum(d0 * d0, dim=-1))
        c1 = torch.sum(self.mass * torch.sum(d0 * p, dim=-1))
        c2 = 0.5 * torch.sum(self.mass * torch.sum(p * p, dim=-1))
        return c0, c1, c2

    def system_energy(self, x, x_n, sigma):
        """Diagnostic total energy in float64: elastic + kinetic +
        potential (reference: computeSystemEnergy, Optimizer.cpp:1310-1328)."""
        f64 = torch.float64
        psi_w = self.mat.psi(tuple(sigma), self.u_e, self.lam_e) * self.vol_w
        e = torch.sum(psi_w.to(f64))
        d = (x - x_n).to(f64)
        e = e + torch.sum(self.mass.to(f64)
                          * (0.5 * torch.sum(d * d, dim=-1) / self.dt_sq
                             - (x.to(f64) @ self.gravity.to(f64))))
        return e

    def warm_start(self, option, x, v, dx_elastic, fixed, x_tilta=None):
        """Warm starts 0-4 (Optimizer::initX, Optimizer.cpp:441-544)."""
        if option == 0:
            return x
        if option == 1:
            d = self.dt * v
        elif option == 2:
            d = self.dt * v + self.grav_dt_sq
        elif option == 3:
            d = self.dt * v + self.grav_dt_sq + dx_elastic
        elif option == 4:
            d = self.dt * v + self.grav_dt_sq + 0.5 * dx_elastic
        else:
            raise NotImplementedError(f"warmStart {option}")
        return x + torch.where(fixed[:, None], 0.0, d)

    def compute_x_tilta(self, x_n, v, fixed):
        """x~ = x^n + dt v + dt^2 g (free), x^n (fixed)
        (reference: computeXTilta, Optimizer.cpp:584-610)."""
        return torch.where(fixed[:, None], x_n,
                           x_n + self.dt * v + self.grav_dt_sq)

    def be_update(self, state, x_new):
        """Backward-Euler end-of-step update (Optimizer.cpp:354-361), in
        place on `state`."""
        dx_el = x_new - state.x_tilta
        v = (x_new - state.x_n) / self.dt
        state.x_tilta = self.compute_x_tilta(x_new, v, state.fixed)
        state.x, state.x_n = x_new, x_new.clone()
        state.v, state.dx_elastic = v, dx_el
        return state


class System(SystemBase):
    def __init__(self, mesh, cfg, plan, dtype=torch.float32, device=None,
                 use_kernels=True, apply_dtype=None, factor_dtype=None,
                 use_coarse=None):
        """`device`: None for the card (raises without one: pass "cpu" to
        run on the CPU). `plan`: a SubdomainPlan (partition.build_plan or
        build_node_plan), or None for the steppers that need no subdomain
        (LBFGS-PD): the elements are then padded to a multiple of 256 in
        natural order and no subdomain buffer is built. `factor_dtype`:
        None (the field dtype) or torch.bfloat16 (LBFGS-HI: round to bf16,
        factorize in f32). `apply_dtype`: storage dtype of the quasi-Newton
        H0 factor leaves (None: bf16 for f32 and bf16 factors, the solve
        dtype for f64 runs; dot_tpu core.py:187-195). `use_coarse=False`
        keeps the two-level coarse space off whatever cfg says (GSDD never
        applies it), so its plan is not built."""
        self.mesh = mesh
        self.cfg = cfg
        self.plan = plan
        self.dtype = dtype
        self.factor_dtype = factor_dtype or dtype
        low = (torch.float32, torch.bfloat16)
        if apply_dtype is None and self.factor_dtype in low:
            apply_dtype = torch.bfloat16
        self.apply_dtype = apply_dtype
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.k = ops if use_kernels else ops.plain
        self.mat = soa.SOA_MATERIALS[cfg.energy]
        self.dt = float(cfg.dt)
        self.dt_sq = self.dt * self.dt
        self.n_vert = mesh.n_vert
        self.n_parts = plan.n_parts if plan is not None else 0
        self.n3 = plan.n3 if plan is not None else 0
        self.n_syncs = 0
        self._solve_progs = {}     # K7's solve programs (_block_solve)
        p = plan

        self.band_bs = int(getattr(p, "band_bs", 0) or 0)
        self.band_nb = int(getattr(p, "band_nb", 0) or 0)
        self.banded = self.band_nb >= 3
        self._chunk = None
        self._low = None
        self._pd_plan = None
        if self.banded:
            # dot_tpu's gate of its bf16 low-memory rebuild: two f32
            # copies of the band would not fit comfortably (core.py:277-282)
            band_f32 = ((2 * self.band_nb - 1) * self.band_bs * self.band_bs
                        * 4 * self.n_parts)
            if (band_f32 > 2 << 30 and self.n_parts > 1
                    and self.factor_dtype in low):
                self._chunk = True
        # two-level coarse space: auto at P >= 16 (core.py:300-302); a node
        # plan has no element partition (part None) and never takes it
        cw = int(getattr(cfg, "coarse", -1))
        self.use_coarse = (use_coarse is not False and p is not None
                           and p.part is not None
                           and (cw == 1 or (cw == -1 and p.n_parts >= 16)))

        def t(a, dt=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=self.device)

        # ---- padded, reordered element arrays -------------------------
        if p is not None:
            src, valid = p.elem_src, p.elem_valid
        else:
            n_pad = -(-mesh.n_elem // 256) * 256
            src = np.zeros(n_pad, np.int32)
            src[:mesh.n_elem] = np.arange(mesh.n_elem, dtype=np.int32)
            valid = np.zeros(n_pad, bool)
            valid[:mesh.n_elem] = True
        conn = mesh.conn[src].astype(np.int32)
        conn_gather = np.where(valid[:, None], conn, 0)
        conn_scatter = np.where(valid[:, None], conn, mesh.n_vert)
        rti = mesh.rest_tri_inv[src] * valid[:, None, None]
        self.n_elem_p = conn.shape[0]
        # (4, nEp) int32 corner ids: the kernels' layout
        self.conn = t(conn_gather.T, torch.int32)
        self.conn_s = t(conn_scatter.T, torch.int32)
        self.vol_w = t((mesh.tri_weight * mesh.vol)[src] * valid, dtype)
        self.u_e = t(mesh.u[src], dtype)
        self.lam_e = t(mesh.lam[src], dtype)
        self.g9 = t(rti.reshape(-1, 9).T, dtype)   # restTriInv (9, nEp)
        self._conn_scatter_np = conn_scatter   # host copy (PD band plan)
        # (element, corner) incidences sorted by vertex (K13; id nV is the
        # padding dump), as dot_tpu's scat_perm / scat_segids
        scat_perm, scat_segids, scat_off = pd.incidence_csr(conn_scatter,
                                                            mesh.n_vert)
        self.scat_perm = t(scat_perm)
        self.scat_segids = t(scat_segids)
        self.scat_off = t(scat_off)

        # ---- global fields --------------------------------------------
        self.mass = t(mesh.mass, dtype)
        grav = np.zeros(3)
        if cfg.with_gravity:
            grav[1] = GRAVITY_Y
        self.gravity = t(grav, dtype)
        self.grav_dt_sq = t(grav * self.dt_sq, dtype)

        # characteristic tolerance pieces (Optimizer.cpp:612-651)
        self._sqnorm_H_rest = self._compute_sqnorm_h_rest()
        self._sqnorm_l = self.mesh.sqnorm_face_area_sums
        self.coarse_plan = None
        if p is None:
            return

        # ---- subdomain plan buffers ------------------------------------
        self.l2g = t(p.local_to_global, torch.int64)
        self.local_valid = t(p.local_valid)
        self.mass_img = t(mesh.mass[p.local_to_global] * p.local_valid, dtype)
        self.mass_flat = self.mass_img.reshape(-1)
        self.dup = t(np.maximum(p.dup, 1), dtype)
        # block-level assembly plan: contiguous 9-wide rows of the
        # block-major element-Hessian buffer in dest-sorted tuple order
        src_block = (p.asm_elem.astype(np.int64) * 16 + p.asm_a * 4 + p.asm_b)
        self.asm_src_block = t(src_block[p.asm_tuple_perm], torch.int64)
        self.asm_block_stage1 = t(p.asm_block_stage1, torch.int64)
        self.asm_ub_dest = t(p.asm_ub_dest, torch.int64)
        self.n_unique_blocks = int(p.asm_ub_dest.shape[0]) // 9
        self.gath_perm = t(p.gath_perm, torch.int64)
        self.gath_segids = t(p.gath_segids, torch.int64)
        # CSR runs of the sorted vertex ids (K8; id nV is the dump)
        self.gath_off = t(band.csr_offsets(p.gath_segids, self.n_vert + 1))
        if self.banded:
            ub_row = np.asarray(p.band_ub_row, np.int64)
            ub_col = np.asarray(p.band_ub_col, np.int64)
            if not np.array_equal(np.flatnonzero(ub_row == ub_col),
                                  np.sort(np.asarray(p.band_diag_ub))):
                raise ValueError("plan: band_diag_ub must list exactly the "
                                 "blocks with ub_row == ub_col")
            P, bs, nb = self.n_parts, self.band_bs, self.band_nb
            self.band_plan = band.BandPlan(
                src_block=self.asm_src_block, stage1=self.asm_block_stage1,
                seg_off=t(band.csr_offsets(p.asm_block_stage1,
                                           self.n_unique_blocks)),
                ub_row=t(ub_row), ub_col=t(ub_col),
                diag_ub=t(p.band_diag_ub, torch.int64),
                dest=t(p.band_dest, torch.int64),
                pad_diag=t(p.band_pad_diag, torch.int64),
                total=P * nb * bs * bs + P * (nb - 1) * bs * bs)
        # own-element-only tables (build_plan(..., own_plan=True): ADMM-DD's
        # local Hessians, dot_tpu core.py:381-407): scalar-level on dense
        # plans, a second BandPlan on banded ones
        self.own_band_plan = None
        self.n_own_unique = 0
        n_own = int(getattr(p, "n_own", 0))
        if getattr(p, "own_udest", None) is not None:
            i3 = np.arange(3)
            comp = ((p.asm_a[:n_own, None, None] * 4
                     + p.asm_b[:n_own, None, None]) * 9
                    + i3[None, :, None] * 3 + i3[None, None, :])
            gidx = comp.astype(np.int64) * self.n_elem_p \
                + p.asm_elem[:n_own, None, None].astype(np.int64)
            self.own_gather_idx = t(gidx.reshape(-1)[p.own_perm], torch.int64)
            self.own_stage1 = t(p.own_stage1, torch.int64)
            self.own_udest = t(p.own_udest, torch.int64)
            self.n_own_unique = int(p.own_udest.shape[0])
        if getattr(p, "own_band_dest", None) is not None:
            P, bs, nb = self.n_parts, self.band_bs, self.band_nb
            n_oub = int(p.own_ub_row.shape[0])
            self.own_band_plan = band.BandPlan(
                src_block=t(src_block[:n_own][p.own_block_perm], torch.int64),
                stage1=t(p.own_block_stage1, torch.int64),
                seg_off=t(band.csr_offsets(p.own_block_stage1, n_oub)),
                ub_row=t(p.own_ub_row, torch.int64),
                ub_col=t(p.own_ub_col, torch.int64),
                diag_ub=t(p.own_diag_ub, torch.int64),
                dest=t(p.own_band_dest, torch.int64),
                pad_diag=self.band_plan.pad_diag,
                total=self.band_plan.total)
        if self.use_coarse:
            self.coarse_plan = coarse.build_plan(mesh, p, dtype, self.device)


    # ------------------------------------------------------------------
    def _compute_sqnorm_h_rest(self):
        """||dP/dF(I)||_F^2 with the first element's Lame params, no SPD
        projection (at F = I the rotated-basis M is dP/dF)."""
        one = torch.ones(1, dtype=torch.float64)
        u0 = torch.tensor([self.mesh.u[0]], dtype=torch.float64)
        l0 = torch.tensor([self.mesh.lam[0]], dtype=torch.float64)
        s1 = (one, one, one)
        a = self.mat.d2psi(s1, u0, l0)
        dpsi = self.mat.dpsi(s1, u0, l0)
        bl = self.mat.b_left(s1, u0, l0)
        # ||M||_F^2 = ||A||_F^2 + sum_k 2 (L+R)^2 + 2 (L-R)^2
        tot = (a[0] ** 2 + 2 * a[1] ** 2 + 2 * a[2] ** 2 + a[3] ** 2
               + 2 * a[4] ** 2 + a[5] ** 2)
        for k, (ci, cj) in enumerate(((0, 1), (1, 2), (2, 0))):
            r = (dpsi[ci] + dpsi[cj]) / (2.0 * (s1[ci] + s1[cj]))
            tot = tot + 2 * (bl[k] + r) ** 2 + 2 * (bl[k] - r) ** 2
        return float(tot[0])

    # ------------------------------------------------------------------
    # energy / gradient / hessian (kernels K1-K4)
    # ------------------------------------------------------------------
    def defgrad(self, x):
        """(9, nEp) deformation gradients at positions (or directions) x."""
        F, _ = self.k.direction_pass(x, self.conn, self.g9)
        return F

    def elastic_energy(self, F0, Fp=None, alpha=None):
        """dt^2 sum w Psi(sigma(F0 + alpha Fp)) (the line-search trial)."""
        e, _ = self.k.ls_trial_energy(F0, Fp, alpha, self.u_e, self.lam_e,
                                      self.vol_w, self.mat)
        return self.dt_sq * e

    def sigma(self, F):
        """(3, nEp) signed singular values of F."""
        _, s = self.k.ls_trial_energy(F, None, None, self.u_e, self.lam_e,
                                      self.vol_w, self.mat, want_sigma=True)
        return s

    @tracing.span("gradient")
    def gradient(self, x, x_tilta, fixed):
        """(nV, 3), zero at fixed vertices (Optimizer.cpp:1220-1256)."""
        acc = self.k.elem_gradient(x, self.conn, self.conn_s, self.g9,
                                   self.u_e, self.lam_e, self.vol_w, self.mat)
        g = acc[:self.n_vert] * self.dt_sq
        g = g + self.mass[:, None] * (x - x_tilta)
        return torch.where(fixed[:, None], 0.0, g)

    @tracing.span("element_hessians")
    def element_hessians(self, x):
        """(144, nEp) SPD-projected element Hessians at x, dt^2-scaled,
        block-major component order (soa.block_major_order)."""
        return self.k.elem_hessian(x, self.conn, self.g9, self.u_e,
                                   self.lam_e, self.vol_w, self.mat,
                                   self.dt_sq)

    def quadratic_form(self, elem_h, p):
        """(p^T H_tr p including the mass diagonal, F(p)) from one corner
        gather of p (alpha-init, Optimizer.cpp:1075-1093)."""
        Fp, q_el = self.k.direction_pass(p, self.conn, self.g9, elem_h)
        q_m = torch.sum(self.mass[:, None] * p * p)
        return q_el + q_m, Fp

    # ------------------------------------------------------------------
    # subdomain assembly
    # ------------------------------------------------------------------
    def _assembly_compact(self, elem_h):
        """Gather 9-wide block rows in dest order and reduce duplicate
        (sbd, row, col) blocks with one sorted segment-sum (dense plans;
        the banded path does this inside K5)."""
        eh_rows = elem_h.t().reshape(-1, 9)          # (nEp*16, 9)
        rows = eh_rows[self.asm_src_block]           # (nAsm, 9)
        out = torch.zeros((self.n_unique_blocks, 9), dtype=self.dtype,
                          device=self.device)
        return out.index_add_(0, self.asm_block_stage1, rows)

    def _free(self, fixed):
        return torch.logical_and(self.local_valid,
                                 torch.logical_not(fixed[self.l2g]))

    @tracing.span("assemble")
    def assemble_subdomains(self, elem_h, fixed):
        """Subdomain Hessians with interface completion, lumped mass on
        free dofs, identity rows for fixed/padding (reference:
        DOTTimeStepper::fillInDecomposedHessians). Dense (P, n3, n3), or
        block-tridiagonal (diag, sub) when the plan is RCM-banded."""
        if self.banded:
            return self._assemble_btd(elem_h, fixed)
        P, n3 = self.n_parts, self.n3
        compact = self._assembly_compact(elem_h)
        Hd = torch.zeros(P * n3 * n3, dtype=self.dtype, device=self.device)
        Hd[self.asm_ub_dest] = compact.reshape(-1)
        Hd = Hd.reshape(P, n3, n3)
        f3 = torch.repeat_interleave(self._free(fixed).to(self.dtype), 3,
                                     dim=-1)                     # (P, n3)
        Hd = Hd * f3[:, :, None] * f3[:, None, :]
        diag = torch.repeat_interleave(self.mass_img, 3, dim=-1) * f3 \
            + (1.0 - f3)
        Hd.diagonal(dim1=1, dim2=2).add_(diag)
        return Hd

    def assemble_subdomains_local_only(self, elem_h, fixed, mass_local):
        """Dense (P, n3, n3) subdomain Hessians from OWN elements only (no
        interface completion) with the subdomain lumped mass `mass_local`
        (P, N): the elasticity + mass part of ADMM-DD's augmented local
        Hessian (reference: computeHessianProxy_subdomain,
        ADMMDDTimeStepper.cpp:1540+; dot_tpu core.py:790-809). Plain torch,
        as the dense assemble_subdomains."""
        P, n3 = self.n_parts, self.n3
        vals = elem_h.reshape(-1)[self.own_gather_idx]
        compact = torch.zeros(self.n_own_unique, dtype=self.dtype,
                              device=self.device)
        compact.index_add_(0, self.own_stage1, vals)
        Hd = torch.zeros(P * n3 * n3, dtype=self.dtype, device=self.device)
        Hd[self.own_udest] = compact
        Hd = Hd.reshape(P, n3, n3)
        f3 = torch.repeat_interleave(self._free(fixed).to(self.dtype), 3,
                                     dim=-1)
        Hd = Hd * f3[:, :, None] * f3[:, None, :]
        diag = torch.repeat_interleave(mass_local, 3, dim=-1) * f3 \
            + (1.0 - f3)
        Hd.diagonal(dim1=1, dim2=2).add_(diag)
        return Hd

    def assemble_own_btd_flat(self, elem_h, fixed, mass_local, w_vals,
                              free3f, wp):
        """The banded augmented local Hessians of ADMM-DD as the flat
        [diag | sub] band (K19): the own-element blocks with the subdomain
        lumped mass on free diagonals and unit fixed / padding rows
        (dot_tpu core.py:811-839), plus the masked compact W `w_vals` and
        the masked mass-diff diagonal at the band slots of `wp` (an
        admm.WPlan; dot_tpu admm_dd.py:352-357; upper-neighbour entries of
        W are dropped like the assembly's)."""
        freef = self._free(fixed).to(self.dtype).reshape(-1)
        return self.k.own_band_assemble(
            elem_h, freef, mass_local.reshape(-1).contiguous(),
            self.own_band_plan, w_vals, free3f, wp)

    def _assemble_btd(self, elem_h, fixed):
        """Block-tridiagonal assembly (K5) into the flat [diag | sub]
        buffer, returned as scan-major views (diag (nb, P, bs, bs), sub
        (nb-1, P, bs, bs)); upper-neighbour entries are dropped (their
        transpose lives in `sub`), padding rows get a unit diagonal."""
        P, bs, nb = self.n_parts, self.band_bs, self.band_nb
        freef = self._free(fixed).to(self.dtype).reshape(-1)
        flat = self.k.band_assemble(elem_h, freef, self.mass_flat,
                                    self.band_plan)
        diag_sz = P * nb * bs * bs
        return (flat[:diag_sz].view(nb, P, bs, bs),
                flat[diag_sz:].view(nb - 1, P, bs, bs))

    # ------------------------------------------------------------------
    # factorization
    # ------------------------------------------------------------------
    @tracing.span("h0_factor")
    def factorize(self, Hd, fast=False):
        """Jacobi-equilibrated Cholesky. Returns (L, d); L is a BTDFactor
        or CRFactor for banded input.

        `fast` marks the quasi-Newton preconditioner (dot_tpu's
        factorize_fast, core.py:1137-1203): cyclic reduction on deep bands,
        bf16 trailing updates and bf16 factor storage in f32, and the
        robustness tiers (a factor with a NaN is rebuilt exactly, then with
        a 1e-4 shift of the unit diagonal). Without `fast` a failed factor
        comes back as NaN, as jnp's Cholesky does."""
        if isinstance(Hd, tuple):
            return self._factorize_btd(*Hd, fast=fast)
        if fast and self.factor_dtype in (torch.float32, torch.bfloat16):
            blk = 768 if self.n3 % 768 == 0 else 384
            if self.n3 % blk == 0 and self.n3 > blk:
                return self._factorize_dense_fast(Hd, blk)
        d = torch.sqrt(Hd.diagonal(dim1=1, dim2=2))
        dinv = 1.0 / d
        Hn = Hd * dinv[:, :, None] * dinv[:, None, :]
        L, info = torch.linalg.cholesky_ex(self._to_factor_dtype(Hn))
        bad = info != 0
        if fast:
            if self.host(torch.logical_or(bad.any(), torch.isnan(L).any()))[0]:
                eye = torch.eye(self.n3, dtype=self.dtype, device=self.device)
                L, info = torch.linalg.cholesky_ex(
                    self._to_factor_dtype(Hn + 1.0e-4 * eye))
                bad = info != 0
        return torch.where(bad[:, None, None], torch.nan, L), d

    def _dense_chol_nan(self, M):
        """Cholesky of (M + M^T) / 2 (jnp.linalg.cholesky), NaN where it
        fails."""
        L, info = torch.linalg.cholesky_ex((M + M.mT) / 2)
        return torch.where((info != 0)[:, None, None], torch.nan, L)

    def _factorize_dense_fast(self, Hd, blk):
        """f32 dense preconditioner (dot_tpu core.py:1147-1203): blocked
        right-looking Cholesky over blk-wide panels whose trailing updates
        are bf16-input GEMMs with f32 results; diagonal tiles through K6,
        the panel below as A L_kk^{-T} = A Li_kk^T. Tiers: a NaN factor is
        redone exactly, then with a 1e-4 shift."""
        n3 = self.n3
        d = torch.sqrt(Hd.diagonal(dim1=1, dim2=2))
        dinv = 1.0 / d
        A = (Hd * dinv[:, :, None] * dinv[:, None, :]).to(torch.float32)
        L = torch.zeros_like(A)
        for k in range(n3 // blk):
            o = k * blk
            Lkk, Likk, _ = self.k.chol_inv(A[:, :blk, :blk].contiguous(), True)
            L[:, o:o + blk, o:o + blk] = Lkk
            if o + blk < n3:
                pnl = A[:, blk:, :blk] @ Likk.mT
                L[:, o + blk:, o:o + blk] = pnl
                A = A[:, blk:, blk:] - _mm(pnl, pnl.mT, True)
        L = L.to(self._solve_dtype)
        if self.host(torch.isnan(L).any())[0]:
            Hn0 = Hd * dinv[:, :, None] * dinv[:, None, :]
            L = self._dense_chol_nan(self._to_factor_dtype(Hn0))
            if self.host(torch.isnan(L).any())[0]:
                eye = torch.eye(n3, dtype=Hn0.dtype, device=self.device)
                L = self._dense_chol_nan(
                    self._to_factor_dtype(Hn0 + 1.0e-4 * eye))
        return L, d

    def _factorize_btd(self, diag, sub, fast, allow_cr=True):
        """Jacobi-equilibrated factorization of the block-tridiagonal
        systems (dot_tpu core.py:853-982): block cyclic reduction for the
        preconditioner on deep bands (fast, nb >= 8, f32 band < 1.5 GiB;
        `allow_cr` turns it off), the block scan otherwise. Tiers with
        `fast`: a factor with a NaN is rebuilt without the bf16 GEMMs (f32
        only: in f64 that is the first build again), then with a 1e-4
        shift; one host read when the first build is good."""
        nb, P, bs = diag.shape[0], diag.shape[1], diag.shape[2]
        d = torch.sqrt(diag.diagonal(dim1=-2, dim2=-1))   # (nb, P, bs)
        dinv = 1.0 / d
        f32 = self.factor_dtype in (torch.float32, torch.bfloat16)
        use_bf16 = fast and f32
        fdt = self._solve_dtype
        # low-memory scan: the scan's inputs stored bf16 when the factors
        # are anyway (dot_tpu core.py:870-878)
        lowmem = fast and self.apply_dtype == torch.bfloat16 and f32
        out_dt = self.apply_dtype if (fast and self.apply_dtype is not None) \
            else fdt
        band_f32_bytes = (2 * nb - 1) * P * bs * bs * 4
        use_cr = (allow_cr and fast and nb >= 8
                  and band_f32_bytes < (3 << 30) // 2)

        def build(shift, bf16):
            dg = (diag * dinv[:, :, :, None]
                  * dinv[:, :, None, :]).to(fdt)
            if shift:
                dg = dg + shift * torch.eye(bs, dtype=fdt, device=self.device)
            sb = (sub * dinv[1:, :, :, None] * dinv[:-1, :, None, :]).to(fdt)
            if use_cr:
                return self._cr_build(dg, sb, out_dt, bf16)
            if not fast and self.factor_dtype == torch.bfloat16:
                # the exact path rounds its inputs as the dense one does
                dg, sb = self._to_factor_dtype(dg), self._to_factor_dtype(sb)
            if lowmem:
                dg, sb = dg.to(torch.bfloat16), sb.to(torch.bfloat16)
            return self._btd_scan_equilibrated(dg, sb, 0.0, bf16, out_dt)

        fac = build(0.0, use_bf16)
        if fast and self.host(_any_nan(fac))[0]:
            if use_bf16:
                fac = build(0.0, False)
            if not use_bf16 or self.host(_any_nan(fac))[0]:
                fac = build(1.0e-4, False)
        return fac, d.transpose(0, 1).reshape(P, nb * bs)

    def _btd_scan_equilibrated(self, dg, sb, shift, bf16_syrk, out_dt=None):
        """Sequential block Cholesky over scan-major equilibrated blocks
        (possibly stored bf16, upcast per block to the solve dtype, `shift`
        I added to each upcast diagonal block):
          L_k L_k^T = D_k - S_{k-1} S_{k-1}^T,  S_k = A_{k+1,k} L_k^{-T},
        with L_k and Li_k = L_k^{-1} from K6 (lower triangle read) and
        S_k = A_{k+1,k} Li_k^T as an f32 matmul instead of a triangular
        solve. The SYRK and the subtraction: under `bf16_syrk` (the fast
        tier, f32 only) one launch of K31 on S_k rounded to bf16 (the leaf
        itself where leaves are bf16), bf16 products summed in f32 on the
        tensor cores, the lower tiles of D_{k+1} written (a `schur_update`
        span); without it (the exact tiers, f64) D_{k+1} - S_k S_k^T in the
        solve dtype. Leaves are stored in `out_dt` (default: apply_dtype,
        else the solve dtype)."""
        fdt = self._solve_dtype
        out_dt = out_dt or self.apply_dtype or fdt
        nb, bs = dg.shape[0], dg.shape[-1]
        if bf16_syrk and fdt != torch.float32:
            raise ValueError("the bf16 SYRK scan runs in f32")
        sh = (shift * torch.eye(bs, dtype=fdt, device=self.device)
              if shift else None)

        def diag_block(k):
            D = dg[k].to(fdt)
            return D + sh if sh is not None else D

        lis, lss = [], []
        Dk = diag_block(0)
        for k in range(nb):
            _, Li, _ = self.k.chol_inv(Dk.contiguous(), False)
            lis.append(Li.to(out_dt))
            if k == nb - 1:
                break
            Ls = sb[k].to(fdt) @ Li.mT
            if not bf16_syrk:
                lss.append(Ls.to(out_dt))
                Dk = diag_block(k + 1) - Ls @ Ls.mT
                continue
            Lsb = Ls.to(torch.bfloat16)
            lss.append(Lsb if out_dt == torch.bfloat16 else Ls.to(out_dt))
            with tracing.span("schur_update"):
                Dk = self.k.schur_update(dg[k + 1], Lsb)
            if sh is not None:
                Dk = Dk + sh
        sub = (torch.stack(lss) if lss else
               torch.zeros((0,) + tuple(dg.shape[1:]), dtype=out_dt,
                           device=self.device))
        return BTDFactor(torch.stack(lis), sub)

    def _cr_build(self, dg, sb, out_dt, bf16_gemm):
        """CRFactor from equilibrated scan-major (nb, P, bs, bs) inputs
        (dot_tpu core.py:999-1059): eliminate the odd blocks level by level
        until the reduced system has <= 4 blocks, then scan-factor the root.
        The diagonal blocks (levels and root) are factored symmetrized
        (jnp.linalg.cholesky) by K6; the level GEMMs A, B, C are bf16-input
        with `bf16_gemm`."""
        P, bs, fdt = dg.shape[1], dg.shape[2], dg.dtype
        levels = []
        while dg.shape[0] > 4:
            m = dg.shape[0]
            n_odd = m // 2
            n_even = m - n_odd
            Slo = sb[0::2][:n_odd]                       # A[j, j-1]
            Shi = sb[1::2]                               # A[j+1, j]
            if Shi.shape[0] < n_odd:                     # last odd = nb-1
                Shi = torch.cat([Shi, torch.zeros((1, P, bs, bs), dtype=fdt,
                                                  device=self.device)])
            _, Li, _ = self.k.chol_inv(
                dg[1::2].reshape(-1, bs, bs).contiguous(), True)
            Li = Li.view(n_odd, P, bs, bs)
            G_lo = Li @ Slo
            G_hi = Li @ Shi.mT
            nd = dg[0::2].clone()
            nd[:n_odd] -= _mm(G_lo.mT, G_lo, bf16_gemm).to(fdt)
            nd[1:] -= _mm(G_hi.mT, G_hi, bf16_gemm).to(fdt)[:n_even - 1]
            sb = -_mm(G_hi.mT, G_lo, bf16_gemm).to(fdt)[:n_even - 1]
            dg = nd
            levels.append(tuple(t.to(out_dt).contiguous()
                                for t in (Li, G_lo, G_hi)))

        lis, lss = [], []
        Dk = dg[0]
        for k in range(dg.shape[0]):
            _, Lik, _ = self.k.chol_inv(Dk.contiguous(), True)
            lis.append(Lik.to(out_dt))
            if k + 1 < dg.shape[0]:
                Ls = sb[k] @ Lik.mT
                lss.append(Ls.to(out_dt))
                Dk = dg[k + 1] - Ls @ Ls.mT
        root = BTDFactor(
            torch.stack(lis),
            torch.stack(lss) if lss else torch.zeros(
                (0, P, bs, bs), dtype=out_dt, device=self.device))
        return CRFactor(levels=tuple(levels), root=root)

    # ------------------------------------------------------------------
    # solves and the H0 apply
    # ------------------------------------------------------------------
    def solve_local(self, L, r):
        """Solve the factored subdomain systems against equilibrated
        right-hand sides r (P, n3) -> (P, n3)."""
        if isinstance(L, CRFactor):
            return self._block_solve("cr", factor_leaves(L), r)
        if isinstance(L, BTDFactor):
            # forward/backward block substitution with the pre-inverted
            # diagonal factors (dot_tpu core.py:1219-1261)
            return self._block_solve("btd", list(L), r)
        rr = r.to(self._solve_dtype)[..., None]
        y = torch.linalg.solve_triangular(L, rr, upper=False)
        z = torch.linalg.solve_triangular(L.mT, y, upper=True)
        return z[..., 0]

    @tracing.span("block_solve")
    def _block_solve(self, kind, leaves, r):
        """One solve against factor leaves (band.solve_program's kinds) as
        K7's solve entry: one launch. The program is built once per factor
        (leaves at the same addresses with the same shapes get the same
        program, so it is cached by them and holds no tensor of its own)."""
        key = (kind,) + tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                              for t in leaves)
        prog = self._solve_progs.get(key)
        if prog is None:
            if len(self._solve_progs) >= 64:
                self._solve_progs.clear()
            prog = self._solve_progs[key] = band.solve_program(kind, leaves)
        return self.k.block_solve(prog, leaves,
                                  r.to(self._solve_dtype).contiguous())

    @tracing.span("h0_apply")
    def h0_apply(self, L, d, rhs, kc=None, fixed=None):
        """Per-subdomain backsolve + duplicate averaging (reference:
        DOTTimeStepper::solve_oneStep, DOTTimeStepper.cpp:406-450): K8's
        gather, the solve, K8's averaging; plus the additive coarse
        correction Z Kc^{-1} Z^T rhs when a coarse factor `kc` is given
        (dot_tpu core.py:1263-1280)."""
        rhs = rhs.contiguous()
        r = self.k.h0_gather(rhs, self.l2g, self.local_valid, d)
        z = self.solve_local(L, r).to(self.dtype).contiguous()
        fine = self.k.h0_average(z, d, self.gath_perm, self.gath_segids,
                                 self.gath_off, self.dup)
        if kc is None:
            return fine
        return self._coarse_apply(kc, rhs, fixed, fine)

    @tracing.span("rebuild_h0")
    def rebuild_h0(self, x, fixed):
        """Element Hessians at x, the coarse factor (or None), and the fine
        factor: the chunked rebuild when `_chunk` is set, else assemble +
        factorize (dot_tpu core.py:1451-1463). Returns (elem_h, L, d, kc)."""
        elem_h = self.element_hessians(x)
        kc = self._coarse_factor(elem_h, fixed) if self.use_coarse else None
        if self._chunk is not None:
            L, d = self._rebuild_banded_chunked(elem_h, fixed)
        else:
            L, d = self.factorize(self.assemble_subdomains(elem_h, fixed),
                                  fast=True)
        return elem_h, L, d, kc

    # ------------------------------------------------------------------
    # the two-level coarse space (dot_tpu core.py:289-352, 1296-1449)
    # ------------------------------------------------------------------
    def _coarse_matrix(self, elem_h, fixed):
        """(Kn, dc): Kc = Z^T (dt^2 K + M) Z (K10), symmetrized and
        Jacobi-equilibrated with a 1e-12 max floor, Kn = Kc / dc dc^T in
        the solve dtype (6P, 6P)."""
        P = self.n_parts
        freev = torch.logical_not(fixed).to(self.dtype)
        kc = self.k.coarse_assemble(elem_h, self.conn, freev, self.mass,
                                    self.coarse_plan)
        K = kc.view(P, P, 6, 6).permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
        K = 0.5 * (K + K.T)
        diag = torch.diagonal(K)
        dc = torch.sqrt(torch.maximum(diag, 1e-12 * torch.max(diag)))
        return (K / dc[:, None] / dc[None, :]).to(self._solve_dtype), dc

    @tracing.span("coarse_factor")
    def _coarse_factor(self, elem_h, fixed):
        """The coarse matrix (`_coarse_matrix`) factored with a 1e-4 shift
        by K6 (a failed factor is redone with a 0.05 shift: dot_tpu's NaN
        tier, one host read). Returns a CoarseFactor."""
        Kn, dc = self._coarse_matrix(elem_h, fixed)
        eye = torch.eye(Kn.shape[0], dtype=Kn.dtype, device=self.device)
        Lc, Li, bad = self.k.chol_inv((Kn + 1e-4 * eye)[None].contiguous(),
                                      True)
        if self.host(bad.any())[0]:
            Lc, Li, _ = self.k.chol_inv((Kn + 0.05 * eye)[None].contiguous(),
                                        True)
        return CoarseFactor(Lc[0].contiguous(), Li[0].contiguous(), dc)

    def _coarse_apply(self, kc, rhs, fixed, fine=None):
        """fine + Z Kc^{-1} Z^T rhs: K11's restriction to the 6P coarse
        dofs (owner sums, / dc), Lc^{-T} Lc^{-1} on Lc^{-1} as one launch
        of K7's solve entry, K11's prolongation (/ dc, zero at fixed
        vertices) added to `fine`."""
        freev = torch.logical_not(fixed).to(self.dtype)
        rc = self.k.coarse_restrict(rhs, freev, kc.dc, self.coarse_plan)
        y = self._block_solve("pair", [kc.linv], rc[None])[0].to(self.dtype)
        return self.k.coarse_prolong(y.contiguous(), kc.dc, freev,
                                     self.coarse_plan, fine)

    # ------------------------------------------------------------------
    # the chunked low-memory rebuild (dot_tpu core.py:1465-1559)
    # ------------------------------------------------------------------
    def _band_compact(self, elem_h, fixed):
        """The finished (nUB, 9) compact unique-block values (K5's compact
        entry point)."""
        freef = self._free(fixed).to(self.dtype).reshape(-1)
        return self.k.band_compact(elem_h, freef, self.mass_flat,
                                   self.band_plan)

    def _equil_scatter(self, compact):
        """(the bf16 (or solve-dtype) band holding the equilibrated lower
        blocks, d (P, n3)): K12 on the lower-only tables, built at first
        use."""
        if self._low is None:
            self._low = band.low_plan(self.plan, self.band_plan, self.device)
        bdt = (torch.bfloat16 if self.apply_dtype == torch.bfloat16
               else self._solve_dtype)
        return self.k.band_equil_scatter(compact, self._low, bdt)

    def _rebuild_banded_chunked(self, elem_h, fixed):
        """The compact -> d from its diagonal blocks -> equilibrated by
        dinv[row] dinv[col] -> rounded to bf16 -> one lower-only scatter
        into the band, then one block scan over all P subdomains. Tiers:
        the bf16-SYRK scan, then an exact scan on the same band, then a
        1e-4 shift (one host read each). Returns (BTDFactor, d)."""
        P, bs, nb = self.n_parts, self.band_bs, self.band_nb
        with tracing.span("assemble"):
            flat, d = self._equil_scatter(self._band_compact(elem_h, fixed))
        diag_sz = P * nb * bs * bs
        dg = flat[:diag_sz].view(nb, P, bs, bs)
        sb = flat[diag_sz:].view(nb - 1, P, bs, bs)
        with tracing.span("h0_factor"):
            fac = self._btd_scan_equilibrated(dg, sb, 0.0, True)
            if self.host(_any_nan(fac))[0]:
                fac = self._btd_scan_equilibrated(dg, sb, 0.0, False)
                if self.host(_any_nan(fac))[0]:
                    fac = self._btd_scan_equilibrated(dg, sb, 1.0e-4, False)
        return fac, d

    # ------------------------------------------------------------------
    # warm start (Optimizer::initX, Optimizer.cpp:441-582)
    # ------------------------------------------------------------------
    def warm_start(self, option, x, v, dx_elastic, fixed, x_tilta=None):
        if option != 5:
            return super().warm_start(option, x, v, dx_elastic, fixed)
        # Jacobi-preconditioned first step (Optimizer.cpp:545-582):
        # d_i = -g_i / H_ii at the last-timestep configuration
        g = self.gradient(x, x_tilta, fixed)
        d = -g / self.hessian_diag(self.element_hessians(x))
        return x + torch.where(fixed[:, None], 0.0, d)

    @tracing.span("hessian_diag")
    def hessian_diag(self, elem_h):
        """(nV, 3) diagonal of mass + dt^2-weighted elastic Hessian (the
        computePrecondMtr diagonal read by warmStart 5): K13 over each
        vertex's (element, corner) incidences."""
        return self.k.hessian_diag(elem_h, self.scat_perm, self.scat_segids,
                                   self.scat_off, self.mass)

    # ------------------------------------------------------------------
    # LBFGS-PD fixed initializer: M + dt^2 D^T W D, scalar per coordinate
    # (reference: LBFGSTimeStepper::precompute, LBFGSTimeStepper.cpp:113-194)
    # ------------------------------------------------------------------
    @property
    def pd_band_plan(self):
        """Lazy whole-mesh scalar RCM-banded plan of the PD matrix as a
        pd.PDPlan on the device (None for meshes too small to band: fewer
        than 3 blocks). Built on the host once."""
        if self._pd_plan is None:
            bp = partition.build_pd_band_plan(self._conn_scatter_np,
                                              self.n_vert)
            self._pd_plan = (pd.pd_plan(bp, self.device)
                             if bp is not None else False)
        return self._pd_plan or None

    def _pd_weights(self):
        """LBFGS-PD weights vol (2 mu + lambda) dt^2
        (LBFGSTimeStepper.cpp:144)."""
        return self.vol_w * (2.0 * self.u_e + self.lam_e) \
            * self.scalar(self.dt_sq)

    @tracing.span("pd_factor")
    def build_pd_factor(self, fixed, w=None):
        """(L, d) of M + dt^2 D^T W D with unit rows at fixed vertices: K14
        into the RCM band, factored exactly as one P = 1 block-tridiagonal
        system (a BTDFactor; a failed factor is NaN); on meshes whose band
        has fewer than 3 blocks, the dense (nV, nV) Cholesky factor. `w`:
        (nEp,) element weights (default: LBFGS-PD's)."""
        nv = self.n_vert
        free = torch.logical_not(fixed).to(self.dtype)
        if w is None:
            w = self._pd_weights()
        bp = self.pd_band_plan
        if bp is not None:
            flat = self.k.pd_assemble(self.g9, self.conn, w, free, self.mass,
                                      bp)
            diag_sz = bp.nb * bp.bs * bp.bs
            # scan-major with P = 1 (the same linear buffer as P-major)
            diag = flat[:diag_sz].view(bp.nb, 1, bp.bs, bp.bs)
            sub = flat[diag_sz:].view(bp.nb - 1, 1, bp.bs, bp.bs)
            return self._factorize_btd(diag, sub, fast=False)
        # dense branch (small meshes; plain torch, as the dense H0 plans)
        vals = pd.pd_pair_vals_ref(self.g9, self.conn, w, free)
        cs = self.conn_s.long()
        B = torch.zeros((nv + 1) * (nv + 1), dtype=self.dtype,
                        device=self.device)
        for a in range(4):
            for b in range(4):
                B.index_add_(0, cs[a] * (nv + 1) + cs[b], vals[a * 4 + b])
        B = B.view(nv + 1, nv + 1)[:nv, :nv].clone()
        B.diagonal().add_(self.mass * free + (1.0 - free))
        d = torch.sqrt(B.diagonal())
        dinv = 1.0 / d
        L = self._dense_chol_nan(
            self._to_factor_dtype(B * dinv[:, None] * dinv[None, :])[None])[0]
        return L, d

    @tracing.span("pd_solve")
    def pd_solve(self, L, d, rhs):
        """Dim-separated solves against the fixed PD factor (reference:
        Optimizer::dimSeparatedSolve, Optimizer.cpp:883-1020). On the band:
        one launch of K7's solve entry ("pd": the permute and / d, the
        block-tridiagonal solve with the three coordinates as right-hand
        sides, / d and the un-permute; bit for bit K15's gather, 4 nb - 2
        products and scatter), in the solve dtype (the field dtype on every
        stepper that calls it)."""
        if isinstance(L, BTDFactor):
            bp = self.pd_band_plan
            sdt = self._solve_dtype
            z = self._block_solve("pd", [L.linv, L.sub, bp.inv, bp.perm,
                                         d[0].to(sdt)], rhs)
            return z.to(self.dtype)
        r = (rhs / d[:, None]).to(self._solve_dtype)
        y = torch.linalg.solve_triangular(L, r, upper=False)
        z = torch.linalg.solve_triangular(L.mT, y, upper=True)
        return z.to(self.dtype) / d[:, None]

    # ------------------------------------------------------------------
    # one subdomain's solve (the GSDD sweep; dot_tpu core.py:1282-1294,
    # gsdd.py:34-55)
    # ------------------------------------------------------------------
    @tracing.span("subdomain_solve")
    def subdomain_solve(self, L, d, q, i):
        """Solve subdomain i's factor against the global vector q (nV, 3)
        and scatter the local solution into a zero (nV, 3) direction: K16's
        gather, the solve on the subdomain's slice of the factor (axis 1 of
        every leaf of a BTDFactor or CRFactor, read in place; axis 0 of a
        dense factor), K16's scatter."""
        r = self.k.local_gather_one(q.contiguous(), self.l2g,
                                    self.local_valid, d, i)
        if isinstance(L, CRFactor):
            Li = CRFactor(
                levels=tuple(tuple(t[:, i:i + 1] for t in lv)
                             for lv in L.levels),
                root=BTDFactor(*(t[:, i:i + 1] for t in L.root)))
        elif isinstance(L, BTDFactor):
            Li = BTDFactor(*(t[:, i:i + 1] for t in L))
        else:
            Li = L[i:i + 1]
        z = self.solve_local(Li, r[None])[0].to(self.dtype).contiguous()
        return self.k.local_scatter_one(z, d, self.l2g, self.local_valid, i,
                                        self.n_vert)

    # ------------------------------------------------------------------
    def init_state(self, script_data):
        """Initial SimState (reference: Optimizer ctor + precompute)."""
        dtype, dev = self.dtype, self.device
        x = torch.as_tensor(script_data.x0, dtype=dtype, device=dev)
        fixed = torch.as_tensor(script_data.fixed0, device=dev)
        v = torch.zeros((self.n_vert, 3), dtype=dtype, device=dev)
        elem_h, L, d, kc = self.rebuild_h0(x, fixed)
        m = LBFGS_HISTORY
        return SimState(
            x=x, x_n=x.clone(), v=v,
            x_tilta=self.compute_x_tilta(x, v, fixed),
            dx_elastic=torch.zeros_like(x), fixed=fixed,
            vel_sign=self.scalar(1.0),
            released=torch.zeros((), dtype=torch.bool, device=dev),
            elem_h=elem_h, chol=L, equil=d,
            lb_s=torch.zeros((m, self.n_vert, 3), dtype=dtype, device=dev),
            lb_t=torch.zeros((m, self.n_vert, 3), dtype=dtype, device=dev),
            lb_rho=torch.ones(m, dtype=dtype, device=dev),
            lb_valid=torch.zeros(m, dtype=dtype, device=dev), kc_chol=kc)
