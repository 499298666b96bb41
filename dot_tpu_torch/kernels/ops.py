"""Wrappers of the thirty-two hand-written kernels of the steppers' paths.

Each wrapper checks device, dtype, shape and contiguity, then
- takes its plain PyTorch version (kernels/soa.py for K1-K4,
  kernels/band.py for K5-K8, K12 and K31, kernels/lbfgs.py for K9,
  kernels/coarse.py for K10-K11, kernels/pd.py for K13-K16,
  kernels/admm.py for K17-K20 and the per-slab / from-F entry points of
  K1 / K2, kernels/soa2d.py for the 2D kernels K21-K24, defgrad2d and the
  check entries of their device functions, kernels/dd2d.py for the 2D
  decomposed path's K25-K28 and K32, kernels/admm2d.py for K29-K30 and
  the 2D ADMM-DD entries of K21 / K22 / K26) for CPU tensors;
- launches its kernel for CUDA tensors (K1-K3: csrc/elem.cu, K5:
  csrc/band_asm.cu, K6: csrc/chol_inv.cu, K7 (one launch a whole solve,
  K15's pd_solve included): csrc/block_matvec.cu, K8 and K16: csrc/h0.cu,
  K10-K11: csrc/coarse.cu, K12: csrc/band_equil.cu, K13: csrc/hdiag.cu,
  K14: csrc/pd.cu, K17, K18 and K20 (its line-search entry w_quad too):
  csrc/admm.cu, K19: band_asm.cu, K31: csrc/schur.cu,
  K21-K24: csrc/elem2d.cu (K24's assembly: dd2d.cu's one pass),
  K25-K28: csrc/dd2d.cu, K32: csrc/trsolve.cu, K29-K30: csrc/admm2d.cu
  (K21 / K22 / K26's 2D ADMM-DD entries in elem2d.cu and dd2d.cu), K9:
  csrc/lbfgs.cu, all through ctypes (K6, K7's solves, K9, w_quad and K32
  launch cooperatively); K4:
  triton_qf.py),
  checks the launch's cudaGetLastError and adds one to its count in
  `launches`;
- raises for any other device.
There is no fallback: a kernel that does not build or launch raises.

`plain` offers the plain versions under the same names and signatures;
System(use_kernels=False) takes them on any device (a comparison run on
the card, never the main path).
"""

from __future__ import annotations

import ctypes
import types

import torch

from . import admm, admm2d, band, coarse, dd2d, lbfgs, pd, soa, soa2d

plain = types.SimpleNamespace(
    ls_trial_energy=soa.ls_trial_energy_ref,
    elem_gradient=soa.elem_gradient_ref,
    elem_hessian=soa.elem_hessian_ref,
    direction_pass=soa.direction_pass_ref,
    band_assemble=band.band_assemble_ref,
    chol_inv=band.chol_inv_ref,
    block_solve=band.block_solve_ref,
    h0_gather=band.h0_gather_ref,
    h0_average=band.h0_average_ref,
    lbfgs_first=lbfgs.lbfgs_first_ref,
    lbfgs_second=lbfgs.lbfgs_second_ref,
    coarse_assemble=coarse.coarse_assemble_ref,
    coarse_restrict=coarse.coarse_restrict_ref,
    coarse_prolong=coarse.coarse_prolong_ref,
    band_compact=band.band_compact_ref,
    band_equil_scatter=band.band_equil_scatter_ref,
    hessian_diag=pd.hessian_diag_ref,
    pd_assemble=pd.pd_assemble_ref,
    local_gather_one=pd.local_gather_one_ref,
    local_scatter_one=pd.local_scatter_one_ref,
    admm_local_step=admm.admm_local_step_ref,
    make_pd3=admm.make_pd3_ref,
    dtw_scatter=admm.dtw_scatter_ref,
    own_band_assemble=admm.own_band_assemble_ref,
    w_matvec=admm.w_matvec_ref,
    w_quad=admm.w_quad_ref,
    ls_trial_energy_parts=admm.ls_trial_energy_parts_ref,
    elem_gradient_from_F=admm.elem_gradient_from_F_ref,
    defgrad2d=soa2d.defgrad2d_ref,
    ls_trial_energy2d=soa2d.ls_trial_energy2d_ref,
    elem_gradient2d=soa2d.elem_gradient2d_ref,
    elem_hessian2d=soa2d.elem_hessian2d_ref,
    dense_assemble2d=soa2d.dense_assemble2d_ref,
    dense_scale2d=soa2d.dense_scale2d_ref,
    svd2_flip=soa2d.svd2_flip_ref,
    eigh2=soa2d.eigh2_ref,
    make_pd2=soa2d.make_pd2_ref,
    material2d=soa2d.material2d_ref,
    quadratic_form2d=dd2d.quadratic_form2d_ref,
    subdomain_assemble2d=dd2d.subdomain_assemble2d_ref,
    subdomain_scale2d=dd2d.subdomain_scale2d_ref,
    h0_gather2d=dd2d.h0_gather2d_ref,
    h0_average2d=dd2d.h0_average2d_ref,
    local_gather_one2d=dd2d.local_gather_one2d_ref,
    local_scatter_one2d=dd2d.local_scatter_one2d_ref,
    pd_assemble2d=dd2d.pd_assemble2d_ref,
    hessian_diag2d=dd2d.hessian_diag2d_ref,
    admm_local_step2d=admm2d.admm_local_step2d_ref,
    dtw_scatter2d=admm2d.dtw_scatter2d_ref,
    ls_trial_energy2d_parts=admm2d.ls_trial_energy2d_parts_ref,
    elem_gradient2d_from_F=admm2d.elem_gradient2d_from_F_ref,
    w_assemble2d=admm2d.w_assemble2d_ref,
    local_h_assemble2d=admm2d.local_h_assemble2d_ref,
    schur_update=band.schur_update_ref,
    tri_solve=dd2d.tri_solve_ref)
# w_diag: w_matvec's diagonal-only launch, which has no plain version of
# its own
KERNELS = tuple(vars(plain)) + ("w_diag",)
launches = dict.fromkeys(KERNELS, 0)

_lib = None
_DTYPES = {torch.float32: 0, torch.float64: 1}
_A_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def reset_launches():
    for k in KERNELS:
        launches[k] = 0


def _load():
    """The built libraries as one namespace of C functions (every source
    is compiled, in parallel, at the first call)."""
    global _lib
    if _lib is None:
        from .csrc import build
        libs = {k: ctypes.CDLL(v) for k, v in build.build().items()}
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sig = {
            ("elem", "dot_ls_trial_energy"): [I, I] + [P] * 6 + [I] + [P] * 4,
            ("elem", "dot_trial_partials"): [I],
            ("elem", "dot_elem_gradient"): [I, I] + [P] * 7 + [I, P, P],
            ("elem", "dot_elem_hessian"): ([I, I] + [P] * 6
                                           + [ctypes.c_double, I, P, P]),
            ("band_asm", "dot_band_assemble"): ([I, P, LL] + [P] * 7
                                                + [LL, P, LL, LL, P, P]),
            ("chol_inv", "dot_chol_inv"): [I, I, P, I, LL, I, P, P, P, P],
            ("schur", "dot_schur_update"): [I, P, LL, P, I, LL, I, P, P],
            ("trsolve", "dot_tri_solve"): [I, P, P, P, I, I, I,
                                           ctypes.c_uint, P, P],
            ("lbfgs", "dot_lbfgs_first"): [I, I, LL] + [P] * 8 + [LL, P],
            ("lbfgs", "dot_lbfgs_second"): [I, I, LL] + [P] * 9 + [LL, P],
            ("block_matvec", "dot_block_solve"): [I, I, P, I, I, I, LL, P, P,
                                                  P, I, P],
            ("h0", "dot_local_gather_one"): [I] + [P] * 4 + [LL, LL, P, P],
            ("h0", "dot_local_scatter_one"): [I] + [P] * 4
            + [LL, LL, LL, P, P],
            ("hdiag", "dot_hessian_diag"): [I, P, LL, P, P, P, LL, P, P],
            ("pd", "dot_pd_assemble"): ([I] + [P] * 5 + [LL] + [P] * 3
                                        + [LL, P, LL, P, LL, P, P]),
            ("h0", "dot_h0_gather"): [I] + [P] * 4 + [LL, P, P],
            ("h0", "dot_h0_average"): [I] + [P] * 5 + [LL, P, P],
            ("band_asm", "dot_band_compact"): ([I, P, LL] + [P] * 6
                                               + [LL, P, P]),
            ("band_equil", "dot_band_equil_scatter"): ([I, I, P, P, LL]
                                                       + [P] * 4
                                                       + [LL, P, LL, LL]
                                                       + [P] * 3),
            ("coarse", "dot_coarse_assemble"): ([I, P, LL] + [P] * 6
                                                + [LL, P, P, LL, P, P, P]),
            ("coarse", "dot_coarse_restrict"): [I] + [P] * 6 + [LL, P, P],
            ("coarse", "dot_coarse_prolong"): [I] + [P] * 6 + [LL, P, P],
            ("admm", "dot_admm_local_step"): [I, I] + [P] * 6 + [I] + [P] * 4,
            ("admm", "dot_make_pd3"): [I, P, I, P, P],
            ("admm", "dot_dtw_scatter"): ([I, P, P, P, LL, P, P, LL]
                                          + [P] * 7),
            ("admm", "dot_w_matvec"): [I] + [P] * 6 + [LL, I, P, P],
            ("admm", "dot_w_quad"): [I] + [P] * 7 + [LL, I, I, P, P, P],
            ("band_asm", "dot_band_add_w"): ([I] + [P] * 5
                                             + [LL, P, P, LL, LL, P, P]),
            ("elem", "dot_ls_trial_energy_parts"): ([I, I] + [P] * 6
                                                    + [I, I, P, P, P]),
            ("elem", "dot_elem_gradient_from_F"): ([I, I] + [P] * 6
                                                   + [I, P, P]),
            ("elem2d", "dot_defgrad2d"): [I, P, P, P, I, P, P],
            ("elem2d", "dot_ls_trial_energy2d"): ([I, I] + [P] * 6 + [I]
                                                  + [P] * 4),
            ("elem2d", "dot_trial2d_partials"): [I],
            ("elem2d", "dot_elem_gradient2d"): ([I, I] + [P] * 9
                                                + [ctypes.c_double, I, P, P,
                                                   LL, P, P, P]),
            ("elem2d", "dot_elem_hessian2d"): ([I, I] + [P] * 6
                                               + [ctypes.c_double, I, P, P]),
            ("elem2d", "dot_dense_scale2d"): [I, P, P, P, LL, LL, P],
            ("elem2d", "dot_svd2_flip"): [I, P, I, P, P, P, P],
            ("elem2d", "dot_eigh2"): [I, P, I, P, P, P, P],
            ("elem2d", "dot_material2d"): [I, I, P, P, P, I, P, P],
            ("dd2d", "dot_qf2d_partials"): [I, LL],
            ("dd2d", "dot_quadratic_form2d"): [I] + [P] * 5 + [I, LL]
            + [P] * 4,
            ("dd2d", "dot_subdomain_assemble2d"): [I] + [P] * 7
            + [LL, LL, LL, I, I, P, P, P],
            ("dd2d", "dot_subdomain_scale2d"): [I] + [P] * 4 + [LL, LL, P],
            ("dd2d", "dot_pd_assemble2d"): [I, P, P, I] + [P] * 7
            + [LL, I, P, P, P],
            ("dd2d", "dot_h0_gather2d"): [I] + [P] * 4 + [LL, LL, P, P],
            ("dd2d", "dot_h0_average2d"): [I] + [P] * 5 + [LL, P, P],
            ("dd2d", "dot_local_scatter_one2d"): [I] + [P] * 4
            + [LL, LL, LL, P, P],
            ("dd2d", "dot_hessian_diag2d"): [I, P, LL, P, P, P, LL, P, P],
            ("admm2d", "dot_admm_local_step2d"): ([I, I] + [P] * 6 + [I]
                                                  + [P] * 4),
            ("admm2d", "dot_dtw_scatter2d"): ([I, P, P, P, LL, P, P, LL]
                                              + [P] * 7),
            ("elem2d", "dot_ls_trial_energy2d_parts"): ([I, I] + [P] * 6
                                                        + [I, I, P, P, P]),
            ("elem2d", "dot_elem_gradient2d_from_F"): ([I, I] + [P] * 5
                                                       + [I, P, P, LL, P, P,
                                                          P]),
            ("dd2d", "dot_w_assemble2d"): ([I] + [P] * 6 + [LL, LL, LL]
                                           + [P] * 7 + [LL, I, P, P, P]),
            ("dd2d", "dot_local_h_assemble2d"): ([I] + [P] * 9
                                                 + [LL, LL, LL, I, P, P,
                                                    P]),
        }
        ns = types.SimpleNamespace()
        for (lib, fn), args in sig.items():
            f = getattr(libs[lib], fn)
            f.argtypes = args
            f.restype = I
            setattr(ns, fn[4:], f)
        _lib = ns
    return _lib


def _check(name, ref, tensors, shapes):
    """Same device and float dtype as `ref`, contiguous, expected shapes
    (None entries of `shapes` are not checked)."""
    if ref.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {ref.dtype} (float32 or float64)")
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name}: {key} on {t.device}, not {ref.device}")
        want = torch.int32 if key.startswith("conn") else ref.dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, not {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        shape = shapes.get(key)
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"not {tuple(shape)}")


def _route(name, t):
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel for device {t.device}")


def _ok(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    launches[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    # the current stream's handle; the raw getter of torch's CUDA builds
    # skips building a Stream object (microseconds of host time a launch)
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ls_trial_energy(F0, Fp, alpha, u, lam, w, mat, want_sigma=False):
    """K1: sum_e w Psi(sigma(F0 + alpha Fp)) (Fp may be None: F = F0).
    F0, Fp: (9, N); alpha: 0-d; u, lam, w: (N,). Returns (0-d sum,
    sigma (3, N) or None)."""
    n = F0.shape[-1]
    if Fp is not None and alpha is None:
        raise ValueError("ls_trial_energy: a direction Fp needs its alpha")
    _check("ls_trial_energy", F0,
           dict(F0=F0, Fp=Fp, alpha=alpha, u=u, lam=lam, w=w),
           dict(F0=(9, n), Fp=(9, n), alpha=(), u=(n,), lam=(n,), w=(n,)))
    if not _route("ls_trial_energy", F0):
        return soa.ls_trial_energy_ref(F0, Fp, alpha, u, lam, w, mat,
                                       want_sigma)
    lib = _load()
    part = torch.empty(lib.trial_partials(n), dtype=F0.dtype,
                       device=F0.device)
    out = torch.empty((), dtype=F0.dtype, device=F0.device)
    sigma = (torch.empty((3, n), dtype=F0.dtype, device=F0.device)
             if want_sigma else None)
    err = lib.ls_trial_energy(
        _DTYPES[F0.dtype], mat.code, _ptr(F0), _ptr(Fp), _ptr(alpha),
        _ptr(u), _ptr(lam), _ptr(w), n, _ptr(part), _ptr(out), _ptr(sigma),
        _stream(F0))
    _ok("ls_trial_energy", err)
    return out, sigma


def elem_gradient(x, conn, conn_s, g9, u, lam, w, mat):
    """K2: per-element D (w P) at x scattered into an (nV+1, 3)
    accumulator (last row: padding elements). x: (nV, 3); conn, conn_s:
    (4, N) int32 gather / scatter vertex ids; g9: (9, N)."""
    n = conn.shape[-1]
    _check("elem_gradient", x,
           dict(x=x, conn=conn, conn_s=conn_s, g9=g9, u=u, lam=lam, w=w),
           dict(x=(x.shape[0], 3), conn=(4, n), conn_s=(4, n), g9=(9, n),
                u=(n,), lam=(n,), w=(n,)))
    if not _route("elem_gradient", x):
        return soa.elem_gradient_ref(x, conn, conn_s, g9, u, lam, w, mat)
    lib = _load()
    acc = torch.zeros((x.shape[0] + 1, 3), dtype=x.dtype, device=x.device)
    err = lib.elem_gradient(
        _DTYPES[x.dtype], mat.code, _ptr(x), _ptr(conn), _ptr(conn_s),
        _ptr(g9), _ptr(u), _ptr(lam), _ptr(w), n, _ptr(acc), _stream(x))
    _ok("elem_gradient", err)
    return acc


def elem_hessian(x, conn, g9, u, lam, w, mat, dt_sq):
    """K3: (144, N) block-major SPD-projected element Hessians at x, times
    dt_sq."""
    n = conn.shape[-1]
    _check("elem_hessian", x, dict(x=x, conn=conn, g9=g9, u=u, lam=lam, w=w),
           dict(x=(x.shape[0], 3), conn=(4, n), g9=(9, n), u=(n,), lam=(n,),
                w=(n,)))
    if not _route("elem_hessian", x):
        return soa.elem_hessian_ref(x, conn, g9, u, lam, w, mat, dt_sq)
    lib = _load()
    out = torch.empty((144, n), dtype=x.dtype, device=x.device)
    err = lib.elem_hessian(
        _DTYPES[x.dtype], mat.code, _ptr(x), _ptr(conn), _ptr(g9), _ptr(u),
        _ptr(lam), _ptr(w), float(dt_sq), n, _ptr(out), _stream(x))
    _ok("elem_hessian", err)
    return out


def direction_pass(p, conn, g9, elem_h=None):
    """K4: F(p) (9, N) from one corner gather of p, and, given the (144, N)
    block-major element Hessians, sum_e p_e^T H_e p_e (else None)."""
    n = conn.shape[-1]
    _check("direction_pass", p, dict(p=p, conn=conn, g9=g9, elem_h=elem_h),
           dict(p=(p.shape[0], 3), conn=(4, n), g9=(9, n),
                elem_h=(144, n)))
    if not _route("direction_pass", p):
        return soa.direction_pass_ref(p, conn, g9, elem_h)
    from . import triton_qf
    F, q = triton_qf.launch(p, conn, g9, elem_h)   # Triton raises on failure
    launches["direction_pass"] += 1
    return F, q


# ----------------------------------------------------------------------
# K5-K8: the H0 rebuild and apply
# ----------------------------------------------------------------------
def _fits(ts, shape):
    if len(ts) != len(shape):
        return False
    for s, x in zip(shape, ts):
        if s is not None and s != x:
            return False
    return True


def _need(name, key, t, device, dtype, shape=None):
    """t on `device`, of `dtype` (a dtype or a tuple of them), contiguous,
    of `shape` (None entries unchecked). The passing case is one
    expression: the wrappers of kernels that take microseconds spend most
    of a call in these checks."""
    if (t.device == device and (t.dtype in dtype if isinstance(dtype, tuple)
                                else t.dtype == dtype)
            and t.is_contiguous()
            and (shape is None or _fits(t.shape, shape))):
        return
    if t.device != device:
        raise ValueError(f"{name}: {key} on {t.device}, not {device}")
    ok = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in ok:
        raise TypeError(f"{name}: {key} is {t.dtype}, not {ok}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {key} is not contiguous")
    if shape is not None and (t.dim() != len(shape) or any(
            s is not None and s != ts for s, ts in zip(shape, t.shape))):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"not {tuple(shape)}")


def _float(name, t):
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} (float32 or float64)")
    return t.dtype


def band_assemble(elem_h, freef, mass_flat, plan):
    """K5: the flat [diag | sub] band (plan.total,) of the subdomain H0s
    from the (144, nEp) block-major element Hessians; freef, mass_flat:
    (P*N,) free mask and lumped mass per local vertex; plan: band.BandPlan."""
    name, dev = "band_assemble", elem_h.device
    dt = _float(name, elem_h)
    n_ub = plan.ub_row.shape[0]
    _need(name, "elem_h", elem_h, dev, dt, (144, None))
    _need(name, "freef", freef, dev, dt, (None,))
    _need(name, "mass_flat", mass_flat, dev, dt, freef.shape)
    i64 = torch.int64
    _need(name, "src_block", plan.src_block, dev, i64, (None,))
    _need(name, "stage1", plan.stage1, dev, i64, plan.src_block.shape)
    _need(name, "seg_off", plan.seg_off, dev, i64, (n_ub + 1,))
    _need(name, "ub_row", plan.ub_row, dev, i64, (n_ub,))
    _need(name, "ub_col", plan.ub_col, dev, i64, (n_ub,))
    _need(name, "diag_ub", plan.diag_ub, dev, i64, (None,))
    _need(name, "dest", plan.dest, dev, i64, (n_ub * 9,))
    _need(name, "pad_diag", plan.pad_diag, dev, i64, (None,))
    if not _route(name, elem_h):
        return band.band_assemble_ref(elem_h, freef, mass_flat, plan)
    lib = _load()
    flat = torch.zeros(plan.total, dtype=dt, device=dev)
    err = lib.band_assemble(
        _DTYPES[dt], _ptr(elem_h), elem_h.shape[1], _ptr(plan.src_block),
        _ptr(plan.seg_off), _ptr(plan.ub_row), _ptr(plan.ub_col),
        _ptr(freef), _ptr(mass_flat), _ptr(plan.dest), n_ub,
        _ptr(plan.pad_diag), plan.pad_diag.shape[0], plan.total, _ptr(flat),
        _stream(elem_h))
    _ok(name, err)
    return flat


_ERRORS = {-2: "the device has no cooperative launch",
           -3: "no block of the kernel fits on an SM",
           -4: "device ordinal beyond the kernel's cache",
           -5: "history length outside 1..8",
           -6: "tile width not built for the dtype",
           -7: "libcuda offers no cuTensorMapEncodeTiled",
           -8: "cuTensorMapEncodeTiled refused the tensor map"}


def _ok_coop(name, err):
    """_ok for the kernels with codes of their own (the cooperatively
    launched K6, K7's solves, K9, w_quad and K32; K31): the negative codes
    name
    what the card lacks."""
    if err in _ERRORS:
        raise RuntimeError(f"{name}: kernel not launched ({_ERRORS[err]})")
    _ok(name, err)


def chol_inv(A, symmetrize):
    """K6: (L, L^{-1}, bad) of a batch (B, n, n) of SPD blocks of any
    width, in one launch; bad is a (B,) bool flag and a flagged block is
    NaN in L and L^{-1}. `symmetrize` factors (A + A^T) / 2, else the lower
    triangle is read."""
    name = "chol_inv"
    dt = _float(name, A)
    _need(name, "A", A, A.device, dt, (None, A.shape[-1], A.shape[-1]))
    if not _route(name, A):
        return band.chol_inv_ref(A, symmetrize)
    lib = _load()
    B, n = A.shape[0], A.shape[-1]
    L = torch.empty_like(A)
    Li = torch.empty_like(A)
    info = torch.empty(B, dtype=torch.int32, device=A.device)
    err = lib.chol_inv(_DTYPES[dt], band.k6_tile(dt, B), _ptr(A), n, B,
                       int(bool(symmetrize)), _ptr(L), _ptr(Li), _ptr(info),
                       _stream(A))
    _ok_coop(name, err)
    return L, Li, info != 0


def schur_update(D, A, out=None):
    """K31: float(D) - float(A) float(A)^T over a batch (B, n, n) in f32,
    in one launch: the block scan's Schur-complement update with A = the
    bf16 Ls (bf16 products summed in f32 on the tensor cores). D in bf16 or
    f32, its blocks any fixed distance apart (a view of a scan-major band),
    read in place; `out` (B, n, n) f32 receives the tiles that hold the
    lower triangle (diagonal tiles in full) and keeps what it held in the
    strictly-upper ones. A width that is no multiple of 8 is padded into a
    copy of A (TMA reads 16-byte aligned rows)."""
    name = "schur_update"
    B, n = A.shape[0], A.shape[-1]
    _need(name, "A", A, A.device, torch.bfloat16, (B, n, n))
    if D.device != A.device or D.dtype not in (torch.bfloat16,
                                               torch.float32):
        raise TypeError(f"{name}: D is {D.dtype} on {D.device}")
    stride = _block_stride(name, D, B, n)
    if out is not None:
        _need(name, "out", out, A.device, torch.float32, (B, n, n))
        if _overlap(out, D) or _overlap(out, A):
            raise ValueError(f"{name}: out overlaps D or A")
    if not _route(name, A):
        return band.schur_update_ref(D, A, out)
    lib = _load()
    if out is None:
        out = torch.empty((B, n, n), dtype=torch.float32, device=A.device)
    lda = -(-n // 8) * 8
    if lda != n or A.data_ptr() % 16:
        Ap = A.new_empty((B, n, lda))
        Ap[..., :n] = A
        A = Ap
    err = lib.schur_update(_A_DTYPES[D.dtype], _ptr(D), stride, _ptr(A),
                           lda, B, n, _ptr(out), _stream(A))
    _ok_coop(name, err)
    return out


def _overlap(a, b):
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def _block_stride(name, A, B, n):
    """Entries between the (n, n) row-major blocks of A (B, n, n), which
    may be a strided view of a larger stack (one subdomain's blocks of a
    scan-major factor leaf); nothing is copied, anything else raises."""
    if A.dim() != 3 or tuple(A.shape) != (B, n, n):
        raise ValueError(f"{name}: A has shape {tuple(A.shape)}, not "
                         f"{(B, n, n)}")
    if n > 1 and (A.stride(2) != 1 or A.stride(1) != n):
        raise ValueError(f"{name}: the blocks of A are not row-major "
                         f"(strides {A.stride()})")
    stride = A.stride(0) if B > 1 else n * n
    if stride < n * n:
        raise ValueError(f"{name}: the blocks of A overlap (batch stride "
                         f"{stride})")
    return stride


def block_solve(prog, leaves, r):
    """K7's solve entry: z = the solve of `prog` (a band.SolveProgram: a
    block-tridiagonal scan, a cyclic-reduction solve or the coarse pair
    against r (P, nb n); "pd": LBFGS-PD's 3-column solve with its permute /
    scale passes against r (nV, 3)) in f32 or f64, on the leaves the
    program was built for (factor leaves in bf16, f32 or f64; "pd" adds
    the plan's inv and perm and the scale d in r's dtype), in one
    cooperative launch. Raises where the launch is refused: no fallback."""
    return _block_solve(prog, leaves, r, 0)


def _block_solve(prog, leaves, r, grid):
    """block_solve with the launch's grid: 0 the co-resident blocks (at
    most one per item of the largest stage), else `grid` blocks (tests: a
    grid above the co-resident limit must be refused)."""
    name = "block_solve"
    dt = _float(name, r)
    _need(name, "r", r, r.device, dt, prog.shape)
    fac = leaves[:2] if prog.kind == "pd" else leaves
    a_dt = fac[0].dtype
    if (a_dt not in _A_DTYPES or prog.ptrs != tuple(t.data_ptr()
                                                    for t in leaves)
            or any(t.dtype != a_dt or t.device != r.device for t in fac)):
        raise ValueError(f"{name}: leaves other than the program's, or of "
                         f"mixed dtype or device")
    if prog.kind == "pd":
        _need(name, "d", leaves[4], r.device, dt, (prog.nb * prog.n,))
    if not _route(name, r):
        return band.block_solve_ref(prog, leaves, r)
    lib = _load()
    size = r.numel() if prog.kind == "pd" else prog.P * prog.nb * prog.n
    buf = torch.empty(size + prog.ws, dtype=dt, device=r.device)
    z = buf[:size].view(prog.shape)
    err = lib.block_solve(_A_DTYPES[a_dt], _DTYPES[dt], _ptr(prog.table),
                          prog.stages.shape[0], prog.n, prog.k,
                          prog.max_items, _ptr(r), _ptr(z),
                          _ptr(buf[size:]), grid, _stream(r))
    _ok_coop(name, err)
    return z


def h0_gather(rhs, l2g, valid, d):
    """K8 (gather): r = rhs[l2g] * valid / d, (P, 3N). rhs: (nV, 3); l2g:
    (P, N) int64; valid: (P, N) bool; d: (P, 3N)."""
    name = "h0_gather"
    dt = _float(name, rhs)
    P, N = l2g.shape
    _need(name, "rhs", rhs, rhs.device, dt, (None, 3))
    _need(name, "l2g", l2g, rhs.device, torch.int64, (P, N))
    _need(name, "valid", valid, rhs.device, torch.bool, (P, N))
    _need(name, "d", d, rhs.device, dt, (P, 3 * N))
    if not _route(name, rhs):
        return band.h0_gather_ref(rhs, l2g, valid, d)
    lib = _load()
    r = torch.empty((P, 3 * N), dtype=dt, device=rhs.device)
    err = lib.h0_gather(_DTYPES[dt], _ptr(rhs), _ptr(l2g), _ptr(valid),
                        _ptr(d), P * N, _ptr(r), _stream(rhs))
    _ok(name, err)
    return r


def h0_average(z, d, perm, segids, seg_off, dup):
    """K8 (average): p = z / d gathered by `perm`, summed over the runs of
    the sorted vertex ids `segids` (CSR offsets `seg_off`, (nV+2,); id nV
    is the dump) and divided by the duplicate counts dup (nV,). z, d:
    (P, 3N). Returns (nV, 3)."""
    name = "h0_average"
    dt = _float(name, z)
    n_vert = dup.shape[0]
    _need(name, "z", z, z.device, dt, (None, None))
    _need(name, "d", d, z.device, dt, tuple(z.shape))
    _need(name, "perm", perm, z.device, torch.int64, (z.numel() // 3,))
    _need(name, "segids", segids, z.device, torch.int64, perm.shape)
    _need(name, "seg_off", seg_off, z.device, torch.int64, (n_vert + 2,))
    _need(name, "dup", dup, z.device, dt, (n_vert,))
    if not _route(name, z):
        return band.h0_average_ref(z, d, perm, segids, seg_off, dup)
    lib = _load()
    out = torch.empty((n_vert, 3), dtype=dt, device=z.device)
    err = lib.h0_average(_DTYPES[dt], _ptr(z), _ptr(d), _ptr(perm),
                         _ptr(seg_off), _ptr(dup), n_vert, _ptr(out),
                         _stream(z))
    _ok(name, err)
    return out


# ----------------------------------------------------------------------
# K9: the L-BFGS two-loop's vector passes, two cooperative launches
# ----------------------------------------------------------------------
def _history(name, S, T, v, rho, valid, k=None, G=None):
    """The checks of K9's entries as one expression (they run every
    L-BFGS iteration, on the host's critical path); on a failure _need
    words the fault."""
    dt = _float(name, v)
    m, n = S.shape
    di = v.get_device()
    ok = (S.dtype is dt and T.dtype is dt and rho.dtype is dt
          and valid.dtype is dt and T.shape == S.shape and v.shape == (n,)
          and rho.shape == (m,) and valid.shape == (m,)
          and S.is_contiguous() and T.is_contiguous() and v.is_contiguous()
          and rho.is_contiguous() and valid.is_contiguous()
          and S.get_device() == di and T.get_device() == di
          and rho.get_device() == di and valid.get_device() == di)
    if k is not None:
        ok = ok and (k.dtype is dt and G.dtype is dt and k.shape == (m,)
                     and G.shape == (m, m) and k.is_contiguous()
                     and G.is_contiguous() and k.get_device() == di
                     and G.get_device() == di)
    if not ok:
        for key, t, shape in (("S", S, (m, n)), ("T", T, (m, n)),
                              ("v", v, (n,)), ("rho", rho, (m,)),
                              ("valid", valid, (m,)), ("k", k, (m,)),
                              ("G", G, (m, m))):
            if t is not None:
                _need(name, key, t, v.device, dt, shape)


_lbfgs_scratch = {}


def _scratch(dev, dt):
    """The cached scratch of K9's two entries on (device, dtype): the
    per-block partials (at most 4 blocks a SM, m + m^2 <= 72 each) and c."""
    key = (dev, dt)
    if key not in _lbfgs_scratch:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _lbfgs_scratch[key] = torch.empty(4 * sms * 72 + 8, dtype=dt,
                                          device=dev)
    return _lbfgs_scratch[key]


def lbfgs_first(S, T, g, rho, valid):
    """K9's first entry: (q (n,), k (m,), G (m, m)) from S, T (m, n), the
    gradient g (n,), rho and valid (m,): loop 1 and q = -g - k^T T; see
    kernels/lbfgs.py."""
    name = "lbfgs_first"
    _history(name, S, T, g, rho, valid)
    if not _route(name, g):
        return lbfgs.lbfgs_first_ref(S, T, g, rho, valid)
    m, n = S.shape
    q = torch.empty_like(g)
    kG = torch.empty(m + m * m, dtype=g.dtype, device=g.device)
    k, G = kG[:m], kG[m:].view(m, m)
    scr = _scratch(g.device, g.dtype)
    kp = kG.data_ptr()
    err = _load().lbfgs_first(
        _DTYPES[g.dtype], m, n, S.data_ptr(), T.data_ptr(), g.data_ptr(),
        rho.data_ptr(), valid.data_ptr(), q.data_ptr(), kp,
        kp + m * kG.element_size(), scr.data_ptr(), scr.numel(), _stream(g))
    _ok_coop(name, err)
    return q, k, G


def lbfgs_second(T, S, r, k, G, rho, valid):
    """K9's second entry: r + c^T S (n,) from T, S (m, n), the H0-applied
    r (n,), loop 1's k (m,) and G (m, m), rho and valid (m,), with c from
    loop 2."""
    name = "lbfgs_second"
    _history(name, T, S, r, rho, valid, k, G)
    m, n = T.shape
    if not _route(name, r):
        return lbfgs.lbfgs_second_ref(T, S, r, k, G, rho, valid)
    out = torch.empty_like(r)
    scr = _scratch(r.device, r.dtype)
    err = _load().lbfgs_second(
        _DTYPES[r.dtype], m, n, T.data_ptr(), S.data_ptr(), r.data_ptr(),
        k.data_ptr(), G.data_ptr(), rho.data_ptr(), valid.data_ptr(),
        out.data_ptr(), scr.data_ptr(), scr.numel(), _stream(r))
    _ok_coop(name, err)
    return out


# ----------------------------------------------------------------------
# K10-K11: the coarse space; K5 (compact) and K12: the chunked rebuild
# ----------------------------------------------------------------------
def _coarse_fields(name, dt, dev, cp, freev):
    nv = cp.own.shape[0]
    _need(name, "freev", freev, dev, dt, (nv,))
    _need(name, "xc", cp.xc, dev, dt, (nv, 3))
    _need(name, "own", cp.own, dev, torch.int64, (nv,))


def coarse_assemble(elem_h, conn, freev, mass, cp):
    """K10: the (P*P, 36) blocks of Kc = Z^T (dt^2 K + M) Z from the
    (144, nEp) element Hessians; conn (4, nEp) int32 gather ids; freev,
    mass (nV,); cp: coarse.CoarsePlan."""
    name, dev = "coarse_assemble", elem_h.device
    dt = _float(name, elem_h)
    n_ep = elem_h.shape[1]
    _need(name, "elem_h", elem_h, dev, dt, (144, n_ep))
    _need(name, "conn", conn, dev, torch.int32, (4, n_ep))
    _coarse_fields(name, dt, dev, cp, freev)
    _need(name, "mass", mass, dev, dt, freev.shape)
    i64 = torch.int64
    _need(name, "items", cp.items, dev, i64, (None,))
    _need(name, "chunk_off", cp.chunk_off, dev, i64, (None,))
    _need(name, "pair_off", cp.pair_off, dev, i64, (None,))
    _need(name, "pair_dest", cp.pair_dest, dev, i64,
          (cp.pair_off.shape[0] - 1,))
    if not _route(name, elem_h):
        return coarse.coarse_assemble_ref(elem_h, conn, freev, mass, cp)
    lib = _load()
    n_chunk = cp.chunk_off.shape[0] - 1
    n_pair = cp.pair_dest.shape[0]
    P = cp.n_parts
    part = torch.empty((n_chunk, 36), dtype=dt, device=dev)
    kc = torch.zeros((P * P, 36), dtype=dt, device=dev)
    err = lib.coarse_assemble(
        _DTYPES[dt], _ptr(elem_h), n_ep, _ptr(conn), _ptr(cp.xc),
        _ptr(freev), _ptr(mass), _ptr(cp.items), _ptr(cp.chunk_off),
        n_chunk, _ptr(cp.pair_off), _ptr(cp.pair_dest), n_pair, _ptr(part),
        _ptr(kc), _stream(elem_h))
    _ok(name, err)
    return kc


def coarse_restrict(rhs, freev, dc, cp):
    """K11 (restrict): (6P,) [sum free r, sum xc x free r] per owner part,
    divided by dc (6P,). rhs: (nV, 3)."""
    name, dev = "coarse_restrict", rhs.device
    dt = _float(name, rhs)
    P = cp.n_parts
    _need(name, "rhs", rhs, dev, dt, (cp.own.shape[0], 3))
    _coarse_fields(name, dt, dev, cp, freev)
    _need(name, "dc", dc, dev, dt, (6 * P,))
    _need(name, "vperm", cp.vperm, dev, torch.int64, cp.own.shape)
    _need(name, "voff", cp.voff, dev, torch.int64, (P + 1,))
    if not _route(name, rhs):
        return coarse.coarse_restrict_ref(rhs, freev, dc, cp)
    lib = _load()
    rc = torch.empty(6 * P, dtype=dt, device=dev)
    err = lib.coarse_restrict(_DTYPES[dt], _ptr(rhs), _ptr(freev),
                              _ptr(cp.xc), _ptr(cp.vperm), _ptr(cp.voff),
                              _ptr(dc), P, _ptr(rc), _stream(rhs))
    _ok(name, err)
    return rc


def coarse_prolong(y, dc, freev, cp, base=None):
    """K11 (prolong): (nV, 3) (yt + yr x xc) free, (yt, yr) = (y / dc) of
    each vertex's owner part, plus `base` (nV, 3) if given. y, dc: (6P,)."""
    name, dev = "coarse_prolong", y.device
    dt = _float(name, y)
    P, nv = cp.n_parts, cp.own.shape[0]
    _need(name, "y", y, dev, dt, (6 * P,))
    _need(name, "dc", dc, dev, dt, (6 * P,))
    _coarse_fields(name, dt, dev, cp, freev)
    if base is not None:
        _need(name, "base", base, dev, dt, (nv, 3))
    if not _route(name, y):
        return coarse.coarse_prolong_ref(y, dc, freev, cp, base)
    lib = _load()
    out = torch.empty((nv, 3), dtype=dt, device=dev)
    err = lib.coarse_prolong(_DTYPES[dt], _ptr(y), _ptr(dc), _ptr(freev),
                             _ptr(cp.xc), _ptr(cp.own), _ptr(base), nv,
                             _ptr(out), _stream(y))
    _ok(name, err)
    return out


def band_compact(elem_h, freef, mass_flat, plan):
    """K5 (compact): the finished (nUB, 9) unique-block values that
    band_assemble scatters; same arguments."""
    name, dev = "band_compact", elem_h.device
    dt = _float(name, elem_h)
    n_ub = plan.ub_row.shape[0]
    _need(name, "elem_h", elem_h, dev, dt, (144, None))
    _need(name, "freef", freef, dev, dt, (None,))
    _need(name, "mass_flat", mass_flat, dev, dt, freef.shape)
    i64 = torch.int64
    _need(name, "src_block", plan.src_block, dev, i64, (None,))
    _need(name, "seg_off", plan.seg_off, dev, i64, (n_ub + 1,))
    _need(name, "ub_row", plan.ub_row, dev, i64, (n_ub,))
    _need(name, "ub_col", plan.ub_col, dev, i64, (n_ub,))
    if not _route(name, elem_h):
        return band.band_compact_ref(elem_h, freef, mass_flat, plan)
    lib = _load()
    out = torch.empty((n_ub, 9), dtype=dt, device=dev)
    err = lib.band_compact(
        _DTYPES[dt], _ptr(elem_h), elem_h.shape[1], _ptr(plan.src_block),
        _ptr(plan.seg_off), _ptr(plan.ub_row), _ptr(plan.ub_col),
        _ptr(freef), _ptr(mass_flat), n_ub, _ptr(out), _stream(elem_h))
    _ok(name, err)
    return out


def band_equil_scatter(compact, lp, bdt):
    """K12: (the flat [diag | sub] band (lp.total,) in `bdt` (bf16, f32 or
    f64) holding the equilibrated lower blocks of the (nUB, 9) compact,
    d (P, 3N)); lp: band.LowPlan."""
    name, dev = "band_equil_scatter", compact.device
    dt = _float(name, compact)
    n_ub = lp.ub_row.shape[0]
    _need(name, "compact", compact, dev, dt, (n_ub, 9))
    i64 = torch.int64
    for key in ("diag_slot", "sel", "pad_diag"):
        _need(name, key, getattr(lp, key), dev, i64, (None,))
    _need(name, "ub_row", lp.ub_row, dev, i64, (n_ub,))
    _need(name, "ub_col", lp.ub_col, dev, i64, (n_ub,))
    _need(name, "dest", lp.dest, dev, i64, (lp.sel.shape[0] * 9,))
    if bdt not in _A_DTYPES:
        raise TypeError(f"{name}: band dtype {bdt}")
    if not _route(name, compact):
        return band.band_equil_scatter_ref(compact, lp, bdt)
    lib = _load()
    n_slot = lp.diag_slot.shape[0]
    flat = torch.zeros(lp.total, dtype=bdt, device=dev)
    d = torch.empty(n_slot * 3, dtype=dt, device=dev)
    err = lib.band_equil_scatter(
        _DTYPES[dt], _A_DTYPES[bdt], _ptr(compact), _ptr(lp.diag_slot),
        n_slot, _ptr(lp.ub_row), _ptr(lp.ub_col), _ptr(lp.sel),
        _ptr(lp.dest), lp.sel.shape[0], _ptr(lp.pad_diag),
        lp.pad_diag.shape[0], lp.total, _ptr(flat), _ptr(d),
        _stream(compact))
    _ok(name, err)
    return flat, d.view(lp.n_parts, -1)


# ----------------------------------------------------------------------
# K13-K16: warmStart 5, the LBFGS-PD factor and solve, the GSDD sweep
# ----------------------------------------------------------------------
def hessian_diag(elem_h, perm, segids, seg_off, mass):
    """K13: (nV, 3) diagonal of M + dt^2 H: the (corner, coordinate)
    diagonal entries of the (144, nEp) element Hessians summed over each
    vertex's incidences (perm: e*4+c sorted by vertex, segids their sorted
    vertex ids, seg_off (nV+2,) the CSR offsets; id nV is the dump), plus
    mass (nV,)."""
    name, dev = "hessian_diag", elem_h.device
    dt = _float(name, elem_h)
    n_ep, nv = elem_h.shape[1], mass.shape[0]
    _need(name, "elem_h", elem_h, dev, dt, (144, n_ep))
    _need(name, "perm", perm, dev, torch.int64, (4 * n_ep,))
    _need(name, "segids", segids, dev, torch.int64, (4 * n_ep,))
    _need(name, "seg_off", seg_off, dev, torch.int64, (nv + 2,))
    _need(name, "mass", mass, dev, dt, (nv,))
    if not _route(name, elem_h):
        return pd.hessian_diag_ref(elem_h, perm, segids, seg_off, mass)
    lib = _load()
    out = torch.empty((nv, 3), dtype=dt, device=dev)
    err = lib.hessian_diag(_DTYPES[dt], _ptr(elem_h), n_ep, _ptr(perm),
                           _ptr(seg_off), _ptr(mass), nv, _ptr(out),
                           _stream(elem_h))
    _ok(name, err)
    return out


def pd_assemble(g9, conn, w, freev, mass, plan):
    """K14: the flat [diag | sub] band (plan.total,) of M + dt^2 D^T W D.
    g9 (9, nEp) restTriInv; conn (4, nEp) int32 gather ids; w (nEp,)
    element weights; freev, mass (nV,); plan: pd.PDPlan."""
    name, dev = "pd_assemble", g9.device
    dt = _float(name, g9)
    n_ep, nv = g9.shape[1], mass.shape[0]
    _need(name, "g9", g9, dev, dt, (9, n_ep))
    _need(name, "conn", conn, dev, torch.int32, (4, n_ep))
    _need(name, "w", w, dev, dt, (n_ep,))
    _need(name, "freev", freev, dev, dt, (nv,))
    _need(name, "mass", mass, dev, dt, (nv,))
    i64 = torch.int64
    n_dest = plan.udest.shape[0]
    _need(name, "dest", plan.dest, dev, i64, (16 * n_ep,))
    _need(name, "items", plan.items, dev, i64, (None,))
    _need(name, "seg_off", plan.seg_off, dev, i64, (n_dest + 1,))
    _need(name, "udest", plan.udest, dev, i64, (n_dest,))
    _need(name, "diag_dest", plan.diag_dest, dev, i64, (nv,))
    _need(name, "pad_dest", plan.pad_dest, dev, i64, (None,))
    if not _route(name, g9):
        return pd.pd_assemble_ref(g9, conn, w, freev, mass, plan)
    lib = _load()
    flat = torch.zeros(plan.total, dtype=dt, device=dev)
    err = lib.pd_assemble(
        _DTYPES[dt], _ptr(g9), _ptr(conn), _ptr(w), _ptr(freev), _ptr(mass),
        n_ep, _ptr(plan.items), _ptr(plan.seg_off), _ptr(plan.udest), n_dest,
        _ptr(plan.diag_dest), nv, _ptr(plan.pad_dest),
        plan.pad_dest.shape[0], _ptr(flat), _stream(g9))
    _ok(name, err)
    return flat


def _local_tables(name, ref, l2g, valid, d, part):
    P, N = l2g.shape
    _need(name, "l2g", l2g, ref.device, torch.int64, (P, N))
    _need(name, "valid", valid, ref.device, torch.bool, (P, N))
    _need(name, "d", d, ref.device, ref.dtype, (P, 3 * N))
    if not 0 <= part < P:
        raise ValueError(f"{name}: subdomain {part} of {P}")
    return N


def local_gather_one(rhs, l2g, valid, d, part):
    """K16 (gather): subdomain `part`'s r = rhs[l2g] * valid / d, (3N,).
    rhs (nV, 3); l2g (P, N) int64; valid (P, N) bool; d (P, 3N)."""
    name = "local_gather_one"
    dt = _float(name, rhs)
    _need(name, "rhs", rhs, rhs.device, dt, (None, 3))
    N = _local_tables(name, rhs, l2g, valid, d, part)
    if not _route(name, rhs):
        return pd.local_gather_one_ref(rhs, l2g, valid, d, part)
    lib = _load()
    r = torch.empty(3 * N, dtype=dt, device=rhs.device)
    err = lib.local_gather_one(_DTYPES[dt], _ptr(rhs), _ptr(l2g),
                               _ptr(valid), _ptr(d), part, N, _ptr(r),
                               _stream(rhs))
    _ok(name, err)
    return r


def local_scatter_one(z, d, l2g, valid, part, n_vert):
    """K16 (scatter): the zero-extended (nV, 3) direction holding
    subdomain `part`'s z / d (z (3N,)) at its valid local vertices; padded
    slots write nothing."""
    name = "local_scatter_one"
    dt = _float(name, z)
    N = _local_tables(name, z, l2g, valid, d, part)
    _need(name, "z", z, z.device, dt, (3 * N,))
    if not _route(name, z):
        return pd.local_scatter_one_ref(z, d, l2g, valid, part, n_vert)
    lib = _load()
    out = torch.empty((n_vert, 3), dtype=dt, device=z.device)
    err = lib.local_scatter_one(_DTYPES[dt], _ptr(z), _ptr(d), _ptr(l2g),
                                _ptr(valid), part, N, n_vert, _ptr(out),
                                _stream(z))
    _ok(name, err)
    return out


# ----------------------------------------------------------------------
# K17-K20 and the added entry points of K1 / K2: the two ADMM steppers
# ----------------------------------------------------------------------
def admm_local_step(Dx, u9, w, vol_dtsq, mu, lam, mat, want_counts=False):
    """K17: (z, du), each (9, N): ADMM-PD's per-element local step on
    Dx + u9 (see kernels/admm.py). Dx, u9: (9, N); w, vol_dtsq, mu, lam:
    (N,). With `want_counts` also a (2, N) int32 tensor: each element's
    Newton iterations and energy evaluations."""
    name = "admm_local_step"
    n = Dx.shape[-1]
    _check(name, Dx, dict(Dx=Dx, u9=u9, w=w, vol_dtsq=vol_dtsq, mu=mu,
                          lam=lam),
           dict(Dx=(9, n), u9=(9, n), w=(n,), vol_dtsq=(n,), mu=(n,),
                lam=(n,)))
    if not _route(name, Dx):
        return admm.admm_local_step_ref(Dx, u9, w, vol_dtsq, mu, lam, mat,
                                        want_counts)
    lib = _load()
    z = torch.empty_like(Dx)
    du = torch.empty_like(Dx)
    counts = (torch.empty((2, n), dtype=torch.int32, device=Dx.device)
              if want_counts else None)
    err = lib.admm_local_step(_DTYPES[Dx.dtype], mat.code, _ptr(Dx),
                              _ptr(u9), _ptr(w), _ptr(vol_dtsq), _ptr(mu),
                              _ptr(lam), n, _ptr(z), _ptr(du), _ptr(counts),
                              _stream(Dx))
    _ok(name, err)
    return (z, du, counts) if want_counts else (z, du)


def make_pd3(a6):
    """K17's SPD projection on its own (the check of that device
    function): (6, N) packed symmetric 3x3 matrices, eigenvalues clamped
    at 0."""
    name = "make_pd3"
    n = a6.shape[-1]
    _check(name, a6, dict(a6=a6), dict(a6=(6, n)))
    if not _route(name, a6):
        return admm.make_pd3_ref(a6)
    lib = _load()
    out = torch.empty_like(a6)
    err = lib.make_pd3(_DTYPES[a6.dtype], _ptr(a6), n, _ptr(out),
                       _stream(a6))
    _ok(name, err)
    return out


def dtw_scatter(M9, g9, w, perm, segids, seg_off, x, mass=None, base=None,
                offset=None, free=None):
    """K18: (nV, 3) per-vertex sums of D^T (w M) over the sorted
    (element, corner) incidences, finished as s + mass x (given `mass`) or
    (base + s - offset) free + x (1 - free) (given base, offset and free).
    M9, g9: (9, N); w: (N,); perm, segids: (4N,) int64; seg_off: (nV + 2,);
    x, base, offset: (nV, 3); mass, free: (nV,)."""
    name, dev = "dtw_scatter", M9.device
    dt = _float(name, M9)
    n, nv = M9.shape[-1], x.shape[0]
    if (mass is None) == (base is None) or (
            base is not None and (offset is None or free is None)):
        raise ValueError(f"{name}: give mass, or base, offset and free")
    _need(name, "M9", M9, dev, dt, (9, n))
    _need(name, "g9", g9, dev, dt, (9, n))
    _need(name, "w", w, dev, dt, (n,))
    _need(name, "perm", perm, dev, torch.int64, (4 * n,))
    _need(name, "segids", segids, dev, torch.int64, (4 * n,))
    _need(name, "seg_off", seg_off, dev, torch.int64, (nv + 2,))
    _need(name, "x", x, dev, dt, (nv, 3))
    for key, t, shape in (("mass", mass, (nv,)), ("base", base, (nv, 3)),
                          ("offset", offset, (nv, 3)), ("free", free, (nv,))):
        if t is not None:
            _need(name, key, t, dev, dt, shape)
    if not _route(name, M9):
        return admm.dtw_scatter_ref(M9, g9, w, perm, segids, seg_off, x,
                                    mass, base, offset, free)
    lib = _load()
    out = torch.empty((nv, 3), dtype=dt, device=dev)
    err = lib.dtw_scatter(_DTYPES[dt], _ptr(M9), _ptr(g9), _ptr(w), n,
                          _ptr(perm), _ptr(seg_off), nv, _ptr(x), _ptr(mass),
                          _ptr(base), _ptr(offset), _ptr(free), _ptr(out),
                          _stream(M9))
    _ok(name, err)
    return out


_W_PLANS = {}     # (id, device, dtype) -> (WPlan, n_rows, n_w): checked once


def _w_plan(name, wp, dev, dt):
    """(n_rows, n_w) of an admm.WPlan, its static tables (row, col,
    row_off, md3) checked once per plan, device and dtype: the K20 entries
    take microseconds on the card, and these checks were most of a call."""
    key = (id(wp), dev, dt)
    hit = _W_PLANS.get(key)
    if hit is not None and hit[0] is wp:
        return hit[1], hit[2]
    n_rows, n_w = wp.row_off.shape[0] - 1, wp.row.shape[0]
    _need(name, "row", wp.row, dev, torch.int64, (n_w,))
    _need(name, "col", wp.col, dev, torch.int64, (n_w,))
    _need(name, "row_off", wp.row_off, dev, torch.int64, (n_rows + 1,))
    _need(name, "md3", wp.md3, dev, dt, (n_rows,))
    if len(_W_PLANS) >= 64:
        _W_PLANS.clear()
    _W_PLANS[key] = (wp, n_rows, n_w)    # holds wp: its id stays its own
    return n_rows, n_w


def _w_tables(name, ref, free3f, wp, w_vals):
    """(n_rows, n_w): the plan's tables (once) and the per-call w_vals and
    free3f on ref's device and dtype."""
    n_rows, n_w = _w_plan(name, wp, ref.device, ref.dtype)
    _need(name, "w_vals", w_vals, ref.device, ref.dtype, (n_w,))
    _need(name, "free3f", free3f, ref.device, ref.dtype, (n_rows,))
    return n_rows, n_w


def own_band_assemble(elem_h, freef, mass_flat, plan, w_vals, free3f, wp):
    """K19: the flat [diag | sub] band (plan.total,) of ADMM-DD's augmented
    local Hessians: the own-element blocks of the (144, nEp) element
    Hessians with the subdomain lumped mass (plan: the own band.BandPlan;
    freef, mass_flat: (P N,)), + the masked compact W (w_vals (nUW,),
    free3f (P n3,), wp: admm.WPlan with band slots) and + the masked
    mass-diff diagonal."""
    name, dev = "own_band_assemble", elem_h.device
    dt = _float(name, elem_h)
    n_ub = plan.ub_row.shape[0]
    _need(name, "elem_h", elem_h, dev, dt, (144, None))
    _need(name, "freef", freef, dev, dt, (None,))
    _need(name, "mass_flat", mass_flat, dev, dt, freef.shape)
    i64 = torch.int64
    _need(name, "src_block", plan.src_block, dev, i64, (None,))
    _need(name, "seg_off", plan.seg_off, dev, i64, (n_ub + 1,))
    _need(name, "ub_row", plan.ub_row, dev, i64, (n_ub,))
    _need(name, "ub_col", plan.ub_col, dev, i64, (n_ub,))
    _need(name, "dest", plan.dest, dev, i64, (n_ub * 9,))
    _need(name, "pad_diag", plan.pad_diag, dev, i64, (None,))
    n_rows, n_w = _w_tables(name, elem_h, free3f, wp, w_vals)
    if wp.band_dest is None:
        raise ValueError(f"{name}: the W plan has no band slots")
    _need(name, "band_dest", wp.band_dest, dev, i64, (n_w,))
    _need(name, "md_band_diag", wp.md_band_diag, dev, i64, (n_rows,))
    if not _route(name, elem_h):
        return admm.own_band_assemble_ref(elem_h, freef, mass_flat, plan,
                                          w_vals, free3f, wp)
    lib = _load()
    flat = torch.zeros(plan.total, dtype=dt, device=dev)
    err = lib.band_assemble(
        _DTYPES[dt], _ptr(elem_h), elem_h.shape[1], _ptr(plan.src_block),
        _ptr(plan.seg_off), _ptr(plan.ub_row), _ptr(plan.ub_col),
        _ptr(freef), _ptr(mass_flat), _ptr(plan.dest), n_ub,
        _ptr(plan.pad_diag), plan.pad_diag.shape[0], plan.total, _ptr(flat),
        _stream(elem_h))
    if err == 0:
        err = lib.band_add_w(
            _DTYPES[dt], _ptr(w_vals), _ptr(free3f), _ptr(wp.row),
            _ptr(wp.col), _ptr(wp.band_dest), n_w, _ptr(wp.md3),
            _ptr(wp.md_band_diag), n_rows, plan.total, _ptr(flat),
            _stream(elem_h))
    _ok(name, err)
    return flat


def w_matvec(w_vals, free3f, a, wp, diag_only=False):
    """K20: (P n3,) y = W a of ADMM-DD's compact interface-weight operator,
    masked to free rows and columns, plus the masked mass-diff diagonal;
    with `diag_only` (a None) the operator's diagonal (counted as
    `w_diag`). w_vals: (nUW,); free3f, a: (P n3,); wp: admm.WPlan."""
    name = "w_diag" if diag_only else "w_matvec"
    n_rows, _ = _w_tables(name, free3f, free3f, wp, w_vals)
    if diag_only != (a is None):
        raise ValueError(f"{name}: `a` is given exactly without diag_only")
    if a is not None:
        _need(name, "a", a, free3f.device, free3f.dtype, (n_rows,))
    _float(name, free3f)
    if not _route(name, free3f):
        return admm.w_matvec_ref(w_vals, free3f, a, wp, diag_only)
    lib = _load()
    out = torch.empty_like(free3f)
    err = lib.w_matvec(_DTYPES[free3f.dtype], _ptr(w_vals), _ptr(free3f),
                       _ptr(a), _ptr(wp.col), _ptr(wp.row_off), _ptr(wp.md3),
                       n_rows, int(bool(diag_only)), _ptr(out),
                       _stream(free3f))
    _ok(name, err)
    return out


W_QUAD_ROWS = 64     # rows of one w_quad item (four lanes a row)


def w_quad(w_vals, free3f, aug0, pa, wp, n_parts):
    """K20's line-search entry: (3, P) a0c = aug0.W aug0 / 2, a1c = (pa.W
    aug0 + aug0.W pa) / 2, a2c = pa.W pa / 2 per part of the masked compact
    W (w_matvec's operator), in one cooperative launch that reads each W
    entry once for both columns and sums each part in a fixed order (the
    same bits from run to run). w_vals (nUW,); free3f, aug0, pa (P n3,)."""
    name = "w_quad"
    dt = _float(name, free3f)
    n_rows, _ = _w_tables(name, free3f, free3f, wp, w_vals)
    _need(name, "aug0", aug0, free3f.device, dt, (n_rows,))
    _need(name, "pa", pa, free3f.device, dt, (n_rows,))
    if n_parts < 1 or n_rows % n_parts:
        raise ValueError(f"{name}: {n_rows} rows in {n_parts} parts")
    if not _route(name, free3f):
        return admm.w_quad_ref(w_vals, free3f, aug0, pa, wp, n_parts)
    lib = _load()
    n3 = n_rows // n_parts
    chunks = -(-n3 // W_QUAD_ROWS)
    # the (3, P) result, then the (P chunks, 4) item sums
    buf = torch.empty(3 * n_parts + 4 * n_parts * chunks, dtype=dt,
                      device=free3f.device)
    out = buf.data_ptr()
    err = lib.w_quad(_DTYPES[dt], w_vals.data_ptr(), free3f.data_ptr(),
                     aug0.data_ptr(), pa.data_ptr(), wp.col.data_ptr(),
                     wp.row_off.data_ptr(), wp.md3.data_ptr(), n3, n_parts,
                     chunks, out + 3 * n_parts * buf.element_size(), out,
                     _stream(free3f))
    _ok_coop(name, err)
    return buf[:3 * n_parts].view(3, n_parts)


def ls_trial_energy_parts(F0, Fp, alpha, u, lam, w, mat, n_parts):
    """K1 per slab: (P,) sums of w Psi(sigma(F0 + alpha_p Fp)) over the P
    equal element slabs of the (9, N) buffers, alpha (P,) one step per slab
    (Fp and alpha may be None: F = F0)."""
    name = "ls_trial_energy_parts"
    n = F0.shape[-1]
    if (Fp is None) != (alpha is None):
        raise ValueError(f"{name}: a direction Fp and its alphas go together")
    if n_parts < 1 or n % n_parts:
        raise ValueError(f"{name}: {n} elements in {n_parts} slabs")
    _check(name, F0, dict(F0=F0, Fp=Fp, alpha=alpha, u=u, lam=lam, w=w),
           dict(F0=(9, n), Fp=(9, n), alpha=(n_parts,), u=(n,), lam=(n,),
                w=(n,)))
    if not _route(name, F0):
        return admm.ls_trial_energy_parts_ref(F0, Fp, alpha, u, lam, w, mat,
                                              n_parts)
    lib = _load()
    part = torch.empty(n_parts * lib.trial_partials(n // n_parts),
                       dtype=F0.dtype, device=F0.device)
    out = torch.empty(n_parts, dtype=F0.dtype, device=F0.device)
    err = lib.ls_trial_energy_parts(
        _DTYPES[F0.dtype], mat.code, _ptr(F0), _ptr(Fp), _ptr(alpha),
        _ptr(u), _ptr(lam), _ptr(w), n, n_parts, _ptr(part), _ptr(out),
        _stream(F0))
    _ok(name, err)
    return out


def elem_gradient_from_F(F, conn_s, g9, u, lam, w, mat, n_rows):
    """K2 from carried deformation gradients: per-element D (w P) at F
    (9, N) scattered into an (n_rows + 1, 3) accumulator (last row: padding
    elements, skipped). conn_s: (4, N) int32 scatter row ids."""
    name = "elem_gradient_from_F"
    n = F.shape[-1]
    _check(name, F, dict(F=F, conn_s=conn_s, g9=g9, u=u, lam=lam, w=w),
           dict(F=(9, n), conn_s=(4, n), g9=(9, n), u=(n,), lam=(n,),
                w=(n,)))
    if not _route(name, F):
        return admm.elem_gradient_from_F_ref(F, conn_s, g9, u, lam, w, mat,
                                             n_rows)
    lib = _load()
    acc = torch.zeros((n_rows + 1, 3), dtype=F.dtype, device=F.device)
    err = lib.elem_gradient_from_F(
        _DTYPES[F.dtype], mat.code, _ptr(F), _ptr(conn_s), _ptr(g9), _ptr(u),
        _ptr(lam), _ptr(w), n, _ptr(acc), _stream(F))
    _ok(name, err)
    return acc


# ----------------------------------------------------------------------
# K21-K24: the 2D (triangle-mesh) projected-Newton path, and the check
# entries of its device functions
# ----------------------------------------------------------------------
def _elem2d(name, x, conn, g4, u, lam, w):
    """The element statics of the 2D kernels next to the positions x."""
    dt = _float(name, x)
    n = conn.shape[-1]
    if n == 0:
        raise ValueError(f"{name}: no elements")
    _need(name, "x", x, x.device, dt, (None, 3))
    _need(name, "conn", conn, x.device, torch.int32, (3, n))
    _need(name, "g4", g4, x.device, dt, (4, n))
    for key, t in (("u", u), ("lam", lam), ("w", w)):
        if t is not None:
            _need(name, key, t, x.device, dt, (n,))
    return dt, n


def defgrad2d(x, conn, g4):
    """(4, N) deformation gradients of the in-plane coordinates of x
    (nV, 3): positions or a search direction. conn (3, N) int32; g4 (4, N)
    restTriInv."""
    name = "defgrad2d"
    dt, n = _elem2d(name, x, conn, g4, None, None, None)
    if not _route(name, x):
        return soa2d.defgrad2d_ref(x, conn, g4)
    lib = _load()
    F = torch.empty((4, n), dtype=dt, device=x.device)
    err = lib.defgrad2d(_DTYPES[dt], _ptr(x), _ptr(conn), _ptr(g4), n,
                        _ptr(F), _stream(x))
    _ok(name, err)
    return F


def ls_trial_energy2d(F0, Fp, alpha, u, lam, w, mat, want_sigma=False):
    """K21: sum_e w Psi(sigma(F0 + alpha Fp)) over triangles (Fp may be
    None: F = F0). F0, Fp: (4, N); alpha: 0-d; u, lam, w: (N,). Returns
    (0-d sum, sigma (2, N) or None)."""
    name = "ls_trial_energy2d"
    n = F0.shape[-1]
    if n == 0:
        raise ValueError(f"{name}: no elements")
    if Fp is not None and alpha is None:
        raise ValueError(f"{name}: a direction Fp needs its alpha")
    _check(name, F0, dict(F0=F0, Fp=Fp, alpha=alpha, u=u, lam=lam, w=w),
           dict(F0=(4, n), Fp=(4, n), alpha=(), u=(n,), lam=(n,), w=(n,)))
    if not _route(name, F0):
        return soa2d.ls_trial_energy2d_ref(F0, Fp, alpha, u, lam, w, mat,
                                           want_sigma)
    lib = _load()
    part = torch.empty(lib.trial2d_partials(n), dtype=F0.dtype,
                       device=F0.device)
    out = torch.empty((), dtype=F0.dtype, device=F0.device)
    sigma = (torch.empty((2, n), dtype=F0.dtype, device=F0.device)
             if want_sigma else None)
    err = lib.ls_trial_energy2d(
        _DTYPES[F0.dtype], mat.code, _ptr(F0), _ptr(Fp), _ptr(alpha),
        _ptr(u), _ptr(lam), _ptr(w), n, _ptr(part), _ptr(out), _ptr(sigma),
        _stream(F0))
    _ok(name, err)
    return out, sigma


def elem_gradient2d(x, x_tilta, free, mass, conn, g4, u, lam, w, mat, dt_sq,
                    plan):
    """K22: the (nV, 3) gradient of the 2D incremental potential at x:
    dt_sq times the per-vertex sums of the corner forces D (w P), plus
    mass (x - x_tilta); z = 0; zero where free (nV,) is 0. plan: a
    soa2d.Scatter2DPlan (its vertex-sorted incidences set the sum order)."""
    name = "elem_gradient2d"
    dt, n = _elem2d(name, x, conn, g4, u, lam, w)
    nv = x.shape[0]
    _need(name, "x_tilta", x_tilta, x.device, dt, (nv, 3))
    _need(name, "free", free, x.device, dt, (nv,))
    _need(name, "mass", mass, x.device, dt, (nv,))
    _need(name, "gdest", plan.gdest, x.device, torch.int64, (6 * n,))
    _need(name, "inc_perm", plan.inc_perm, x.device, torch.int64, (3 * n,))
    _need(name, "inc_off", plan.inc_off, x.device, torch.int64, (nv + 1,))
    if not _route(name, x):
        return soa2d.elem_gradient2d_ref(x, x_tilta, free, mass, conn, g4, u,
                                         lam, w, mat, dt_sq, plan)
    lib = _load()
    ge = torch.empty((6, n), dtype=dt, device=x.device)
    out = torch.empty((nv, 3), dtype=dt, device=x.device)
    err = lib.elem_gradient2d(
        _DTYPES[dt], mat.code, _ptr(x), _ptr(x_tilta), _ptr(free), _ptr(mass),
        _ptr(conn), _ptr(g4), _ptr(u), _ptr(lam), _ptr(w), float(dt_sq), n,
        _ptr(plan.inc_perm), _ptr(plan.inc_off), nv, _ptr(ge), _ptr(out),
        _stream(x))
    _ok(name, err)
    return out


def elem_hessian2d(x, conn, g4, u, lam, w, mat, dt_sq):
    """K23: (36, N) SPD-projected 6x6 element Hessians at x, row-major over
    the (corner, xy) dofs, times dt_sq."""
    name = "elem_hessian2d"
    dt, n = _elem2d(name, x, conn, g4, u, lam, w)
    if not _route(name, x):
        return soa2d.elem_hessian2d_ref(x, conn, g4, u, lam, w, mat, dt_sq)
    lib = _load()
    out = torch.empty((36, n), dtype=dt, device=x.device)
    err = lib.elem_hessian2d(
        _DTYPES[dt], mat.code, _ptr(x), _ptr(conn), _ptr(g4), _ptr(u),
        _ptr(lam), _ptr(w), float(dt_sq), n, _ptr(out), _stream(x))
    _ok(name, err)
    return out


def dense_assemble2d(H36, free, mass, tab):
    """K24: (H (2 nV, 2 nV), d (2 nV,)) from the (36, N) element Hessians:
    the whole-mesh matrix summed by slot in a fixed order, + mass on the
    diagonal, rows and columns of fixed dofs zeroed with a unit diagonal;
    d = sqrt(diag H). free, mass: (nV,); tab: dd2d.dense_tables. On the
    card K26's one write pass over the whole mesh as one part (mass after
    the mask, s f f + (m f + (1 - f)): the same bits for a 0 / 1 mask)."""
    name, dev = "dense_assemble2d", H36.device
    dt = _float(name, H36)
    nv, n2 = tab.n_loc, tab.n
    _need(name, "H36", H36, dev, dt, (36, None))
    _need(name, "free", free, dev, dt, (nv,))
    _need(name, "mass", mass, dev, dt, (nv,))
    _slot_tables(name, dev, tab)
    if tab.n_parts != 1 or tab.dof != 2:
        raise ValueError(f"{name}: tables of {tab.n_parts} parts, "
                         f"{tab.dof} dofs")
    if not _route(name, H36):
        return soa2d.dense_assemble2d_ref(H36, free, mass, tab)
    lib = _load()
    H = torch.empty((n2, n2), dtype=dt, device=dev)
    d = torch.empty(n2, dtype=dt, device=dev)
    err = lib.subdomain_assemble2d(
        _DTYPES[dt], _ptr(H36), *_rows(tab), _ptr(free), _ptr(mass), nv, n2,
        1, 2, tab.max_row, _ptr(H), _ptr(d), _stream(H36))
    _ok(name, err)
    return H, d


def dense_scale2d(H, d, tab):
    """K24's second entry: H / d_i / d_j (the Jacobi equilibration before
    the Cholesky). On the card the assembled slots of H (tab.udest) are
    scaled in place and H is returned (every other entry is 0); the plain
    version returns a new tensor."""
    name, dev = "dense_scale2d", H.device
    dt = _float(name, H)
    n2, n_slot = tab.n, tab.udest.shape[0]
    _need(name, "H", H, dev, dt, (n2, n2))
    _need(name, "d", d, dev, dt, (n2,))
    _need(name, "udest", tab.udest, dev, torch.int64, (n_slot,))
    if not _route(name, H):
        return soa2d.dense_scale2d_ref(H, d, tab)
    lib = _load()
    err = lib.dense_scale2d(_DTYPES[dt], _ptr(H), _ptr(d), _ptr(tab.udest),
                            n_slot, n2, _stream(H))
    _ok(name, err)
    return H


def svd2_flip(F):
    """The check of the device function svd2_flip: (U (4, N), sigma (2, N),
    V (4, N)) of F (4, N)."""
    name = "svd2_flip"
    n = F.shape[-1]
    _check(name, F, dict(F=F), dict(F=(4, n)))
    if not _route(name, F):
        return soa2d.svd2_flip_ref(F)
    lib = _load()
    U, V = torch.empty_like(F), torch.empty_like(F)
    s = torch.empty((2, n), dtype=F.dtype, device=F.device)
    err = lib.svd2_flip(_DTYPES[F.dtype], _ptr(F), n, _ptr(U), _ptr(s),
                        _ptr(V), _stream(F))
    _ok(name, err)
    return U, s, V


def eigh2(h3):
    """The check of the device function eigh2: (lam (2, N), Q (4, N)) of
    packed sym2 matrices h3 (3, N)."""
    name = "eigh2"
    n = h3.shape[-1]
    _check(name, h3, dict(h3=h3), dict(h3=(3, n)))
    if not _route(name, h3):
        return soa2d.eigh2_ref(h3)
    lib = _load()
    lam = torch.empty((2, n), dtype=h3.dtype, device=h3.device)
    Q = torch.empty((4, n), dtype=h3.dtype, device=h3.device)
    err = lib.eigh2(_DTYPES[h3.dtype], _ptr(h3), n, _ptr(lam), _ptr(Q), None,
                    _stream(h3))
    _ok(name, err)
    return lam, Q


def make_pd2(h3):
    """The check of the device function make_pd2: (3, N) packed sym2
    matrices with their eigenvalues clamped at 0."""
    name = "make_pd2"
    n = h3.shape[-1]
    _check(name, h3, dict(h3=h3), dict(h3=(3, n)))
    if not _route(name, h3):
        return soa2d.make_pd2_ref(h3)
    lib = _load()
    out = torch.empty_like(h3)
    err = lib.eigh2(_DTYPES[h3.dtype], _ptr(h3), n, None, None, _ptr(out),
                    _stream(h3))
    _ok(name, err)
    return out


def material2d(F, u, lam, mat):
    """The check of the 2D materials' device functions: (11, N) Psi, dPsi
    (2), d2Psi (3), BLeftCoef and the first Piola stress (4) at the flip-SVD
    of F (4, N)."""
    name = "material2d"
    n = F.shape[-1]
    _check(name, F, dict(F=F, u=u, lam=lam), dict(F=(4, n), u=(n,),
                                                   lam=(n,)))
    if not _route(name, F):
        return soa2d.material2d_ref(F, u, lam, mat)
    lib = _load()
    out = torch.empty((11, n), dtype=F.dtype, device=F.device)
    err = lib.material2d(_DTYPES[F.dtype], mat.code, _ptr(F), _ptr(u),
                         _ptr(lam), n, _ptr(out), _stream(F))
    _ok(name, err)
    return out


# ----------------------------------------------------------------------
# K25-K28: the 2D decomposed path (DOT, GSDD, LBFGS-PD / H / HI / JH)
# ----------------------------------------------------------------------
def quadratic_form2d(p, conn, g4, elem_h, mass):
    """K25: (p^T H p + sum m |p|^2 (0-d), F(p) (4, N)) from one corner
    gather of the direction p (nV, 3); elem_h (36, N) row-major (K23's),
    mass (nV,). The sum is taken in a fixed order (no atomics)."""
    name = "quadratic_form2d"
    dt, n = _elem2d(name, p, conn, g4, None, None, None)
    nv, dev = p.shape[0], p.device
    _need(name, "elem_h", elem_h, dev, dt, (36, n))
    _need(name, "mass", mass, dev, dt, (nv,))
    if not _route(name, p):
        return dd2d.quadratic_form2d_ref(p, conn, g4, elem_h, mass)
    lib = _load()
    Fp = torch.empty((4, n), dtype=dt, device=dev)
    part = torch.empty(lib.qf2d_partials(n, nv), dtype=dt, device=dev)
    out = torch.empty((), dtype=dt, device=dev)
    err = lib.quadratic_form2d(_DTYPES[dt], _ptr(p), _ptr(conn), _ptr(g4),
                               _ptr(elem_h), _ptr(mass), n, nv, _ptr(Fp),
                               _ptr(part), _ptr(out), _stream(p))
    _ok(name, err)
    return out, Fp


# SlotTables already checked, by id: (tables, device); the few most recent
# (a run's path holds five), so that stale tables are not kept alive
_TABLES_OK = {}


def _slot_tables(name, dev, tab):
    """The SlotTables' tensors on `dev`, contiguous: the kernel's row
    tables int32, the plain version's (src, dest) int64. Checked once per
    tables object and device: a SlotTables is an immutable tuple of the
    tensors dd2d.slot_tables built, so a repeat would find the same, and
    K26's calls take microseconds on the card (the checks were most of a
    call's host time)."""
    hit = _TABLES_OK.get(id(tab))
    if hit is not None and hit[0] is tab and hit[1] == dev:
        return
    i32, i64 = torch.int32, torch.int64
    n_slot = tab.col.shape[0]
    _need(name, "items", tab.items, dev, i32, (None,))
    _need(name, "seg_off", tab.seg_off, dev, i32, (n_slot + 1,))
    _need(name, "row_off", tab.row_off, dev, i32,
          (tab.n_parts * tab.n + 1,))
    _need(name, "col", tab.col, dev, i32, (n_slot,))
    _need(name, "src", tab.src, dev, i64, tab.items.shape)
    _need(name, "dest", tab.dest, dev, i64, tab.items.shape)
    if tab.extra is not None:
        _need(name, "extra", tab.extra, dev, torch.uint8, (n_slot,))
    if len(_TABLES_OK) >= 8:
        _TABLES_OK.clear()
    _TABLES_OK[id(tab)] = (tab, dev)


def _rows(tab):
    """The kernel's row tables of `tab` as pointers: items, seg_off,
    row_off, col."""
    return (_ptr(tab.items), _ptr(tab.seg_off), _ptr(tab.row_off),
            _ptr(tab.col))


def subdomain_assemble2d(elem_h, free, mass_img, tab):
    """K26: (Hd (P, n2p, n2p), d (P, n2p)): the subdomain Hessians with
    interface completion summed by slot in plan order, the free mask on
    rows and columns, mass_img f + (1 - f) on the diagonal; d =
    sqrt(diag). elem_h (36, N) row-major; free, mass_img (P, N); tab: a
    dd2d.SlotTables of the plan (dd2d.subdomain_tables)."""
    name, dev = "subdomain_assemble2d", elem_h.device
    dt = _float(name, elem_h)
    P, N, n = tab.n_parts, tab.n_loc, tab.n
    _need(name, "elem_h", elem_h, dev, dt, (36, None))
    _need(name, "free", free, dev, dt, (P, N))
    _need(name, "mass_img", mass_img, dev, dt, (P, N))
    _slot_tables(name, dev, tab)
    if tab.dof != 2:
        raise ValueError(f"{name}: tables of {tab.dof} dofs per vertex")
    if not _route(name, elem_h):
        return dd2d.subdomain_assemble2d_ref(elem_h, free, mass_img, tab)
    lib = _load()
    H = elem_h.new_empty((P, n, n))
    d = elem_h.new_empty((P, n))
    err = lib.subdomain_assemble2d(
        _DTYPES[dt], _ptr(elem_h), *_rows(tab), _ptr(free), _ptr(mass_img),
        N, n, P, 2, tab.max_row, _ptr(H), _ptr(d), _stream(elem_h))
    _ok(name, err)
    return H, d


def subdomain_scale2d(H, d, tab):
    """K26's second entry: the Jacobi-equilibrated, symmetrized
    (H / d_r / d_c + H / d_c / d_r) / 2 of the assembled slots (the matrix
    jnp.linalg.cholesky factors in dot_tpu). H (P, n, n), d (P, n), tab the
    SlotTables H was assembled with (K26's or K28's). On the card H is
    scaled in place and returned (every other entry is 0); the plain
    version returns a new tensor."""
    name, dev = "subdomain_scale2d", H.device
    dt = _float(name, H)
    P, n = tab.n_parts, tab.n
    _need(name, "H", H, dev, dt, (P, n, n))
    _need(name, "d", d, dev, dt, (P, n))
    _slot_tables(name, dev, tab)
    if not _route(name, H):
        return dd2d.subdomain_scale2d_ref(H, d, tab)
    lib = _load()
    err = lib.subdomain_scale2d(_DTYPES[dt], _ptr(H), _ptr(d),
                                _ptr(tab.row_off), _ptr(tab.col), P * n, n,
                                _stream(H))
    _ok(name, err)
    return H


def pd_assemble2d(g4, w, free, mass, tab):
    """K28: (S (nV, nV), d (nV,)) of M + dt^2 D^T W D at dim 2: the nine
    corner pairs' w_e (D_a . D_b) summed by slot in element order, the
    free mask on rows and columns, mass f + (1 - f) on the diagonal; d =
    sqrt(diag). g4 (4, N) restTriInv; w (N,) element weights; free, mass
    (nV,); tab: dd2d.pd_tables."""
    name, dev = "pd_assemble2d", g4.device
    dt = _float(name, g4)
    n, nv = g4.shape[-1], tab.n
    _need(name, "g4", g4, dev, dt, (4, n))
    _need(name, "w", w, dev, dt, (n,))
    _need(name, "free", free, dev, dt, (nv,))
    _need(name, "mass", mass, dev, dt, (nv,))
    _slot_tables(name, dev, tab)
    if tab.dof != 1 or tab.n_parts != 1:
        raise ValueError(f"{name}: tables of {tab.n_parts} parts, "
                         f"{tab.dof} dofs per vertex")
    if not _route(name, g4):
        return dd2d.pd_assemble2d_ref(g4, w, free, mass, tab)
    lib = _load()
    vals = g4.new_empty((9, n))
    S = g4.new_empty((nv, nv))
    d = g4.new_empty(nv)
    err = lib.pd_assemble2d(
        _DTYPES[dt], _ptr(g4), _ptr(w), n, _ptr(vals), *_rows(tab),
        _ptr(free), _ptr(mass), nv, tab.max_row, _ptr(S), _ptr(d),
        _stream(g4))
    _ok(name, err)
    return S, d


def hessian_diag2d(elem_h, mass, plan):
    """K28's second entry: the (nV, 3) diagonal of M + dt^2 H at dim 2 (the
    (c, c) diagonal entries of the (36, N) row-major element Hessians
    summed per vertex in incidence order, + mass; z column 1). plan: a
    soa2d.Scatter2DPlan (its vertex-sorted incidences)."""
    name, dev = "hessian_diag2d", elem_h.device
    dt = _float(name, elem_h)
    n, nv = elem_h.shape[-1], mass.shape[0]
    _need(name, "elem_h", elem_h, dev, dt, (36, n))
    _need(name, "mass", mass, dev, dt, (nv,))
    _need(name, "gdest", plan.gdest, dev, torch.int64, (6 * n,))
    _need(name, "inc_perm", plan.inc_perm, dev, torch.int64, (3 * n,))
    _need(name, "inc_off", plan.inc_off, dev, torch.int64, (nv + 1,))
    if not _route(name, elem_h):
        return dd2d.hessian_diag2d_ref(elem_h, mass, plan)
    lib = _load()
    out = torch.empty((nv, 3), dtype=dt, device=dev)
    err = lib.hessian_diag2d(_DTYPES[dt], _ptr(elem_h), n,
                             _ptr(plan.inc_perm), _ptr(plan.inc_off),
                             _ptr(mass), nv, _ptr(out), _stream(elem_h))
    _ok(name, err)
    return out


def _local_tables2d(name, ref, l2g, valid, d):
    P, N = l2g.shape
    _need(name, "l2g", l2g, ref.device, torch.int64, (P, N))
    _need(name, "valid", valid, ref.device, torch.bool, (P, N))
    _need(name, "d", d, ref.device, ref.dtype, (P, 2 * N))
    return P, N


def h0_gather2d(rhs, l2g, valid, d):
    """K27 (gather): r = rhs[l2g][:, :2] * valid / d, (P, 2N). rhs (nV, 3);
    l2g (P, N) int64; valid (P, N) bool; d (P, 2N)."""
    name = "h0_gather2d"
    dt = _float(name, rhs)
    _need(name, "rhs", rhs, rhs.device, dt, (None, 3))
    P, N = _local_tables2d(name, rhs, l2g, valid, d)
    if not _route(name, rhs):
        return dd2d.h0_gather2d_ref(rhs, l2g, valid, d)
    lib = _load()
    r = torch.empty((P, 2 * N), dtype=dt, device=rhs.device)
    err = lib.h0_gather2d(_DTYPES[dt], _ptr(rhs), _ptr(l2g), _ptr(valid),
                          _ptr(d), 0, P * N, _ptr(r), _stream(rhs))
    _ok(name, err)
    return r


def h0_average2d(z, d, perm, segids, seg_off, dup):
    """K27 (average): (nV, 3) z / d gathered by `perm`, summed over the
    runs of the sorted vertex ids `segids` (CSR offsets `seg_off`, (nV+2,);
    id nV is the padding's dump) in order, divided by dup (nV,); z = 0.
    z, d: (P, 2N)."""
    name = "h0_average2d"
    dt = _float(name, z)
    nv = dup.shape[0]
    _need(name, "z", z, z.device, dt, (None, None))
    _need(name, "d", d, z.device, dt, tuple(z.shape))
    _need(name, "perm", perm, z.device, torch.int64, (z.numel() // 2,))
    _need(name, "segids", segids, z.device, torch.int64, perm.shape)
    _need(name, "seg_off", seg_off, z.device, torch.int64, (nv + 2,))
    _need(name, "dup", dup, z.device, dt, (nv,))
    if not _route(name, z):
        return dd2d.h0_average2d_ref(z, d, perm, segids, seg_off, dup)
    lib = _load()
    out = torch.empty((nv, 3), dtype=dt, device=z.device)
    err = lib.h0_average2d(_DTYPES[dt], _ptr(z), _ptr(d), _ptr(perm),
                           _ptr(seg_off), _ptr(dup), nv, _ptr(out),
                           _stream(z))
    _ok(name, err)
    return out


def local_gather_one2d(rhs, l2g, valid, d, part):
    """K27 (one subdomain's gather): (2N,) rhs[l2g[part]][:, :2] *
    valid[part] / d[part]."""
    name = "local_gather_one2d"
    dt = _float(name, rhs)
    _need(name, "rhs", rhs, rhs.device, dt, (None, 3))
    P, N = _local_tables2d(name, rhs, l2g, valid, d)
    if not 0 <= part < P:
        raise ValueError(f"{name}: subdomain {part} of {P}")
    if not _route(name, rhs):
        return dd2d.local_gather_one2d_ref(rhs, l2g, valid, d, part)
    lib = _load()
    r = torch.empty(2 * N, dtype=dt, device=rhs.device)
    err = lib.h0_gather2d(_DTYPES[dt], _ptr(rhs), _ptr(l2g), _ptr(valid),
                          _ptr(d), part, N, _ptr(r), _stream(rhs))
    _ok(name, err)
    return r


def local_scatter_one2d(z, d, l2g, valid, part, n_vert):
    """K27 (one subdomain's scatter): the zero (nV, 3) direction holding
    subdomain `part`'s z / d (z (2N,)) at its valid local vertices; padded
    slots write nothing."""
    name = "local_scatter_one2d"
    dt = _float(name, z)
    P, N = _local_tables2d(name, z, l2g, valid, d)
    _need(name, "z", z, z.device, dt, (2 * N,))
    if not 0 <= part < P:
        raise ValueError(f"{name}: subdomain {part} of {P}")
    if not _route(name, z):
        return dd2d.local_scatter_one2d_ref(z, d, l2g, valid, part, n_vert)
    lib = _load()
    out = torch.empty((n_vert, 3), dtype=dt, device=z.device)
    err = lib.local_scatter_one2d(_DTYPES[dt], _ptr(z), _ptr(d), _ptr(l2g),
                                  _ptr(valid), part, N, n_vert, _ptr(out),
                                  _stream(z))
    _ok(name, err)
    return out


# ----------------------------------------------------------------------
# K29, K30 and the added entry points of K21 / K22 / K26: the two 2D ADMM
# steppers
# ----------------------------------------------------------------------
# K32's tagged words (the solved vectors, 32 bits of a value beside the
# call's epoch in each 64-bit word), per device: [int64 tensor, the last
# call's epoch]. The words are zeroed once; each call publishes under a
# new epoch, so no call resets, memsets or reads them. Calls on one device
# share them: they run in the order of one stream (a CUDA graph holding a
# call would replay its epoch: none may be replayed).
_tri_words = {}


def _tri_epoch(dev, n_words):
    st = _tri_words.get(dev)
    if st is None or st[0].numel() < n_words or st[1] == 0xffffffff:
        st = _tri_words[dev] = [torch.zeros(n_words, dtype=torch.int64,
                                            device=dev), 0]
    st[1] += 1
    return st[0], st[1]


def tri_solve(L, r):
    """K32: z = L^{-T} L^{-1} r, (P, n), for P lower Cholesky factors L
    (P, n, n) and right-hand sides r (P, n), in one launch (forward, then
    backward substitution over 64 x 64 tiles). L is read as it is stored:
    row major, or column major (L.mT contiguous: the batched library
    Cholesky's layout, and its slices L[i:i + 1]); other strides raise."""
    name = "tri_solve"
    dt = _float(name, L)
    if L.dim() != 3 or L.shape[1] != L.shape[2]:
        raise ValueError(f"{name}: L has shape {tuple(L.shape)}, not "
                         "(P, n, n)")
    P, n = L.shape[0], L.shape[2]
    _need(name, "r", r, L.device, dt, (P, n))
    upper = not L.is_contiguous()
    S = L.mT if upper else L
    if not S.is_contiguous():
        raise ValueError(f"{name}: L is neither row nor column major")
    if not _route(name, L):
        return dd2d.tri_solve_ref(L, r)
    lib = _load()
    z = torch.empty_like(r)
    words, epoch = _tri_epoch(L.device, 2 * P * n * (r.element_size() // 4))
    err = lib.tri_solve(_DTYPES[dt], _ptr(S), _ptr(r), _ptr(z), P, n,
                        int(upper), epoch, _ptr(words), _stream(L))
    _ok_coop(name, err)
    return z


def admm_local_step2d(Dx, u4, w, vol_dtsq, mu, lam, mat, want_counts=False):
    """K29: (z, du), each (4, N): ADMM-PD's per-triangle local step on
    Dx + u4 at dim 2 (see kernels/admm2d.py). Dx, u4: (4, N); w, vol_dtsq,
    mu, lam: (N,). With `want_counts` also a (2, N) int32 tensor: each
    triangle's Newton iterations and energy evaluations."""
    name = "admm_local_step2d"
    n = Dx.shape[-1]
    _check(name, Dx, dict(Dx=Dx, u4=u4, w=w, vol_dtsq=vol_dtsq, mu=mu,
                          lam=lam),
           dict(Dx=(4, n), u4=(4, n), w=(n,), vol_dtsq=(n,), mu=(n,),
                lam=(n,)))
    if not _route(name, Dx):
        return admm2d.admm_local_step2d_ref(Dx, u4, w, vol_dtsq, mu, lam,
                                            mat, want_counts)
    lib = _load()
    z = torch.empty_like(Dx)
    du = torch.empty_like(Dx)
    counts = (torch.empty((2, n), dtype=torch.int32, device=Dx.device)
              if want_counts else None)
    err = lib.admm_local_step2d(_DTYPES[Dx.dtype], mat.code, _ptr(Dx),
                                _ptr(u4), _ptr(w), _ptr(vol_dtsq), _ptr(mu),
                                _ptr(lam), n, _ptr(z), _ptr(du), _ptr(counts),
                                _stream(Dx))
    _ok(name, err)
    return (z, du, counts) if want_counts else (z, du)


def dtw_scatter2d(M4, g4, w, plan, x, mass=None, base=None, offset=None,
                  free=None):
    """K30: (nV, 3) per-vertex sums of D^T (w M) over the vertex-sorted
    (triangle, corner) incidences of plan (a soa2d.Scatter2DPlan), z
    column 0, finished as s + mass x (given `mass`) or (base + s - offset)
    free + x (1 - free) (given base, offset and free). M4, g4: (4, N); w:
    (N,); x, base, offset: (nV, 3); mass, free: (nV,)."""
    name, dev = "dtw_scatter2d", M4.device
    dt = _float(name, M4)
    n, nv = M4.shape[-1], x.shape[0]
    if (mass is None) == (base is None) or (
            base is not None and (offset is None or free is None)):
        raise ValueError(f"{name}: give mass, or base, offset and free")
    _need(name, "M4", M4, dev, dt, (4, n))
    _need(name, "g4", g4, dev, dt, (4, n))
    _need(name, "w", w, dev, dt, (n,))
    _need(name, "gdest", plan.gdest, dev, torch.int64, (6 * n,))
    _need(name, "inc_perm", plan.inc_perm, dev, torch.int64, (3 * n,))
    _need(name, "inc_off", plan.inc_off, dev, torch.int64, (nv + 1,))
    _need(name, "x", x, dev, dt, (nv, 3))
    for key, t, shape in (("mass", mass, (nv,)), ("base", base, (nv, 3)),
                          ("offset", offset, (nv, 3)), ("free", free, (nv,))):
        if t is not None:
            _need(name, key, t, dev, dt, shape)
    if not _route(name, M4):
        return admm2d.dtw_scatter2d_ref(M4, g4, w, plan, x, mass, base,
                                        offset, free)
    lib = _load()
    out = torch.empty((nv, 3), dtype=dt, device=dev)
    err = lib.dtw_scatter2d(_DTYPES[dt], _ptr(M4), _ptr(g4), _ptr(w), n,
                            _ptr(plan.inc_perm), _ptr(plan.inc_off), nv,
                            _ptr(x), _ptr(mass), _ptr(base), _ptr(offset),
                            _ptr(free), _ptr(out), _stream(M4))
    _ok(name, err)
    return out


def ls_trial_energy2d_parts(F0, Fp, alpha, u, lam, w, mat, n_parts):
    """K21 per slab: (P,) sums of w Psi(sigma(F0 + alpha_p Fp)) over the P
    equal triangle slabs of the (4, N) buffers, alpha (P,) one step per slab
    (Fp and alpha may be None: F = F0). Each slab's sum is taken in a fixed
    order (no atomics)."""
    name = "ls_trial_energy2d_parts"
    n = F0.shape[-1]
    if (Fp is None) != (alpha is None):
        raise ValueError(f"{name}: a direction Fp and its alphas go together")
    if n_parts < 1 or n == 0 or n % n_parts:
        raise ValueError(f"{name}: {n} triangles in {n_parts} slabs")
    _check(name, F0, dict(F0=F0, Fp=Fp, alpha=alpha, u=u, lam=lam, w=w),
           dict(F0=(4, n), Fp=(4, n), alpha=(n_parts,), u=(n,), lam=(n,),
                w=(n,)))
    if not _route(name, F0):
        return admm2d.ls_trial_energy2d_parts_ref(F0, Fp, alpha, u, lam, w,
                                                  mat, n_parts)
    lib = _load()
    part = torch.empty(n_parts * lib.trial2d_partials(n // n_parts),
                       dtype=F0.dtype, device=F0.device)
    out = torch.empty(n_parts, dtype=F0.dtype, device=F0.device)
    err = lib.ls_trial_energy2d_parts(
        _DTYPES[F0.dtype], mat.code, _ptr(F0), _ptr(Fp), _ptr(alpha),
        _ptr(u), _ptr(lam), _ptr(w), n, n_parts, _ptr(part), _ptr(out),
        _stream(F0))
    _ok(name, err)
    return out


def elem_gradient2d_from_F(F, conn_s, g4, u, lam, w, mat, rows):
    """K22 from carried deformation gradients: the per-corner forces
    D (w P) at F (4, N) summed into rows.n_rows local rows, (n_rows, 2),
    each row over its incidences (rows: admm2d.RowIncidences of conn_s) in
    order; conn_s (3, N) int32 row ids, padding triangles at row n_rows."""
    name = "elem_gradient2d_from_F"
    n = F.shape[-1]
    if n == 0:
        raise ValueError(f"{name}: no triangles")
    _check(name, F, dict(F=F, conn_s=conn_s, g4=g4, u=u, lam=lam, w=w),
           dict(F=(4, n), conn_s=(3, n), g4=(4, n), u=(n,), lam=(n,),
                w=(n,)))
    _need(name, "inc_perm", rows.inc_perm, F.device, torch.int64, (3 * n,))
    _need(name, "inc_off", rows.inc_off, F.device, torch.int64,
          (rows.n_rows + 1,))
    if not _route(name, F):
        return admm2d.elem_gradient2d_from_F_ref(F, conn_s, g4, u, lam, w,
                                                 mat, rows)
    lib = _load()
    ge = torch.empty((6, n), dtype=F.dtype, device=F.device)
    out = torch.empty((rows.n_rows, 2), dtype=F.dtype, device=F.device)
    err = lib.elem_gradient2d_from_F(
        _DTYPES[F.dtype], mat.code, _ptr(F), _ptr(g4), _ptr(u), _ptr(lam),
        _ptr(w), n, _ptr(rows.inc_perm), _ptr(rows.inc_off),
        rows.n_rows, _ptr(ge), _ptr(out), _stream(F))
    _ok(name, err)
    return out


def w_assemble2d(elem_h, free, sfree, md_sh, w_tab, c_tab):
    """K26's W / consensus entry: (Wm (P, n2p, n2p), C (ns2, ns2), dc
    (ns2,)) of 2D ADMM-DD from the (36, nE) row-major element Hessians:
    W's slots summed in plan order with rows and columns of non-free dofs
    zeroed (free (P, N)); C's slots likewise, + md_sh on the diagonal,
    masked by sfree (ns + 1,), a unit diagonal where it is 0, and dc =
    sqrt(diag C). w_tab, c_tab: dd2d.SlotTables (2 dofs a vertex; C's one
    part of ns + 1 vertices)."""
    name, dev = "w_assemble2d", elem_h.device
    dt = _float(name, elem_h)
    P, N, n = w_tab.n_parts, w_tab.n_loc, w_tab.n
    ns1, nc = c_tab.n_loc, c_tab.n
    _need(name, "elem_h", elem_h, dev, dt, (36, None))
    _need(name, "free", free, dev, dt, (P, N))
    _need(name, "sfree", sfree, dev, dt, (ns1,))
    _need(name, "md_sh", md_sh, dev, dt, (ns1,))
    _slot_tables(name, dev, w_tab)
    _slot_tables(name, dev, c_tab)
    if w_tab.dof != 2 or c_tab.dof != 2 or c_tab.n_parts != 1:
        raise ValueError(f"{name}: W and C tables of 2 dofs, C of one part")
    if not _route(name, elem_h):
        return admm2d.w_assemble2d_ref(elem_h, free, sfree, md_sh, w_tab,
                                       c_tab)
    lib = _load()
    Wm = elem_h.new_empty((P, n, n))
    C = elem_h.new_empty((nc, nc))
    dc = elem_h.new_empty(nc)
    err = lib.w_assemble2d(
        _DTYPES[dt], _ptr(elem_h), *_rows(w_tab), _ptr(free), N, n, P,
        _ptr(Wm), *_rows(c_tab), _ptr(sfree), _ptr(md_sh), nc,
        max(w_tab.max_row, c_tab.max_row), _ptr(C), _ptr(dc),
        _stream(elem_h))
    _ok(name, err)
    return Wm, C, dc


def local_h_assemble2d(elem_h, Wm, free, mass, tab):
    """K26's local-Hessian entry: (H (P, n2p, n2p), d (P, n2p)) of 2D
    ADMM-DD's augmented local Hessians: the own triangles' (36, P epad)
    row-major Hessians summed by slot in plan order, rows and columns of
    non-free dofs zeroed (free (P, N)), + Wm, + mass f + (1 - f) on the
    diagonal (mass (P, N)); d = sqrt(diag). tab: the own dd2d.SlotTables,
    whose slots also cover every slot of Wm, marked in tab.extra (K26's
    scaling entry on `tab` then reaches every nonzero; the kernel reads Wm
    at those slots only: it is 0 elsewhere)."""
    name, dev = "local_h_assemble2d", elem_h.device
    dt = _float(name, elem_h)
    P, N, n = tab.n_parts, tab.n_loc, tab.n
    _need(name, "elem_h", elem_h, dev, dt, (36, None))
    _need(name, "Wm", Wm, dev, dt, (P, n, n))
    _need(name, "free", free, dev, dt, (P, N))
    _need(name, "mass", mass, dev, dt, (P, N))
    _slot_tables(name, dev, tab)
    if tab.dof != 2:
        raise ValueError(f"{name}: tables of {tab.dof} dofs per vertex")
    if tab.extra is None:
        raise ValueError(f"{name}: own tables without W's slots")
    if not _route(name, elem_h):
        return admm2d.local_h_assemble2d_ref(elem_h, Wm, free, mass, tab)
    lib = _load()
    H = elem_h.new_empty((P, n, n))
    d = elem_h.new_empty((P, n))
    err = lib.local_h_assemble2d(
        _DTYPES[dt], _ptr(elem_h), *_rows(tab), _ptr(tab.extra), _ptr(free),
        _ptr(mass), _ptr(Wm), N, n, P, tab.max_row, _ptr(H), _ptr(d),
        _stream(elem_h))
    _ok(name, err)
    return H, d
