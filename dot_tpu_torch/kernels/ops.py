"""Wrappers of the sixteen hand-written kernels of the steppers' paths.

Each wrapper checks device, dtype, shape and contiguity, then
- takes its plain PyTorch version (kernels/soa.py for K1-K4,
  kernels/band.py for K5-K8 and K12, kernels/lbfgs.py for K9,
  kernels/coarse.py for K10-K11, kernels/pd.py for K13-K16) for CPU
  tensors;
- launches its kernel for CUDA tensors (K1-K3: csrc/elem.cu, K5:
  csrc/band_asm.cu, K6: csrc/chol_inv.cu, K7 and K15's products:
  csrc/block_matvec.cu, K8 and K16: csrc/h0.cu, K10-K11: csrc/coarse.cu,
  K12: csrc/band_equil.cu, K13: csrc/hdiag.cu, K14 and K15's permute
  passes: csrc/pd.cu, all through ctypes; K4: triton_qf.py, K9:
  triton_lbfgs.py), checks the launch's cudaGetLastError and adds one to
  its count in `launches`;
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

from . import band, coarse, lbfgs, pd, soa

KERNELS = ("ls_trial_energy", "elem_gradient", "elem_hessian",
           "direction_pass", "band_assemble", "chol_inv", "block_matvec",
           "h0_gather", "h0_average", "lbfgs_loop1", "lbfgs_loop2",
           "lbfgs_combine", "coarse_assemble", "coarse_restrict",
           "coarse_prolong", "band_compact", "band_equil_scatter",
           "hessian_diag", "pd_assemble", "block_matvec_k", "pd_gather",
           "pd_scatter", "local_gather_one", "local_scatter_one")
launches = dict.fromkeys(KERNELS, 0)

plain = types.SimpleNamespace(
    ls_trial_energy=soa.ls_trial_energy_ref,
    elem_gradient=soa.elem_gradient_ref,
    elem_hessian=soa.elem_hessian_ref,
    direction_pass=soa.direction_pass_ref,
    band_assemble=band.band_assemble_ref,
    chol_inv=band.chol_inv_ref,
    block_matvec=band.block_matvec_ref,
    h0_gather=band.h0_gather_ref,
    h0_average=band.h0_average_ref,
    lbfgs_loop1=lbfgs.lbfgs_loop1_ref,
    lbfgs_loop2=lbfgs.lbfgs_loop2_ref,
    lbfgs_combine=lbfgs.lbfgs_combine_ref,
    coarse_assemble=coarse.coarse_assemble_ref,
    coarse_restrict=coarse.coarse_restrict_ref,
    coarse_prolong=coarse.coarse_prolong_ref,
    band_compact=band.band_compact_ref,
    band_equil_scatter=band.band_equil_scatter_ref,
    hessian_diag=pd.hessian_diag_ref,
    pd_assemble=pd.pd_assemble_ref,
    block_matvec_k=pd.block_matvec_k_ref,
    pd_gather=pd.pd_gather_ref,
    pd_scatter=pd.pd_scatter_ref,
    local_gather_one=pd.local_gather_one_ref,
    local_scatter_one=pd.local_scatter_one_ref)

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
            ("chol_inv", "dot_chol_inv"): [I, P, I, LL, I, P, P, P, P],
            ("chol_inv", "dot_chol_inv_max_n"): [I],
            ("block_matvec", "dot_block_matvec"): [I, I] + [P] * 4
            + [LL, I, I, LL, P],
            ("block_matvec", "dot_block_matvec_k"): [I, I] + [P] * 4
            + [LL, I, I, I, P],
            ("h0", "dot_local_gather_one"): [I] + [P] * 4 + [LL, LL, P, P],
            ("h0", "dot_local_scatter_one"): [I] + [P] * 4
            + [LL, LL, LL, P, P],
            ("hdiag", "dot_hessian_diag"): [I, P, LL, P, P, P, LL, P, P],
            ("pd", "dot_pd_assemble"): ([I] + [P] * 5 + [LL] + [P] * 3
                                        + [LL, P, LL, P, LL, P, P]),
            ("pd", "dot_pd_gather"): [I, P, P, P, LL, P, P],
            ("pd", "dot_pd_scatter"): [I, P, P, P, LL, P, P],
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
        }
        ns = types.SimpleNamespace()
        for (lib, fn), args in sig.items():
            f = getattr(libs[lib], fn)
            f.argtypes = args
            f.restype = LL if fn == "dot_chol_inv_max_n" else I
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
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise RuntimeError(f"{name}: no kernel for device {t.device}")


def _ok(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    launches[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


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
def _need(name, key, t, device, dtype, shape=None):
    """t on `device`, of `dtype` (a dtype or a tuple of them), contiguous,
    of `shape` (None entries unchecked)."""
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


_chol_max_n = {}


def chol_inv(A, symmetrize):
    """K6: (L, L^{-1}, bad) of a batch (B, n, n) of SPD blocks; bad is a
    (B,) bool flag and a flagged block is NaN in L and L^{-1}.
    `symmetrize` factors (A + A^T) / 2, else the lower triangle is read."""
    name = "chol_inv"
    dt = _float(name, A)
    _need(name, "A", A, A.device, dt, (None, A.shape[-1], A.shape[-1]))
    if not _route(name, A):
        return band.chol_inv_ref(A, symmetrize)
    lib = _load()
    B, n = A.shape[0], A.shape[-1]
    if dt not in _chol_max_n:
        _chol_max_n[dt] = lib.chol_inv_max_n(_DTYPES[dt])
    if n > _chol_max_n[dt]:
        raise ValueError(
            f"{name}: blocks of {n} exceed the kernel's panel limit "
            f"({_chol_max_n[dt]} for {dt}): a band this wide (a P = 1 plan "
            "or the PD matrix of a mesh with a wide graph bandwidth) needs "
            "a factorization that spans several thread blocks")
    L = torch.empty_like(A)
    Li = torch.empty_like(A)
    info = torch.empty(B, dtype=torch.int32, device=A.device)
    err = lib.chol_inv(_DTYPES[dt], _ptr(A), n, B, int(bool(symmetrize)),
                       _ptr(L), _ptr(Li), _ptr(info), _stream(A))
    _ok(name, err)
    return L, Li, info != 0


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


def block_matvec(A, v, c=None, trans=False, out=None):
    """K7: op(A) v, or c - op(A) v, over a batch: A (B, n, n) in bf16, f32
    or f64, taken to v's dtype; v, c, out (B, n) in f32 or f64. `out`
    (may be c, must not overlap v) receives the result. A's blocks may lie
    any fixed distance apart (a view [:, i] of an (m, P, n, n) stack): they
    are read in place, never copied."""
    name = "block_matvec"
    dt = _float(name, v)
    B, n = v.shape[0], v.shape[-1]
    _need(name, "v", v, v.device, dt, (B, n))
    if A.device != v.device or A.dtype not in _A_DTYPES:
        raise TypeError(f"{name}: A is {A.dtype} on {A.device}")
    stride = _block_stride(name, A, B, n)
    if c is not None:
        _need(name, "c", c, v.device, dt, (B, n))
    if out is not None:
        _need(name, "out", out, v.device, dt, (B, n))
        if _overlap(out, v):
            raise ValueError(f"{name}: out overlaps v")
    if not _route(name, v):
        return band.block_matvec_ref(A, v, c, trans, out)
    lib = _load()
    if out is None:
        out = torch.empty_like(v)
    err = lib.block_matvec(_A_DTYPES[A.dtype], _DTYPES[dt], _ptr(A), _ptr(v),
                           _ptr(c), _ptr(out), B, n, int(bool(trans)),
                           stride, _stream(v))
    _ok(name, err)
    return out


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
# K9: the L-BFGS two-loop's vector passes (Triton)
# ----------------------------------------------------------------------
def _history(name, S, T, v, rho, valid):
    dt = _float(name, v)
    m, n = S.shape
    dev = v.device
    _need(name, "S", S, dev, dt, (m, n))
    if T is not None:
        _need(name, "T", T, dev, dt, (m, n))
    _need(name, "v", v, dev, dt, (n,))
    _need(name, "rho", rho, dev, dt, (m,))
    _need(name, "valid", valid, dev, dt, (m,))


def lbfgs_loop1(S, T, g, rho, valid):
    """K9 (loop 1): (k (m,), G (m, m)) from S, T (m, n), the gradient g
    (n,), rho and valid (m,); see kernels/lbfgs.py."""
    name = "lbfgs_loop1"
    _history(name, S, T, g, rho, valid)
    if not _route(name, g):
        return lbfgs.lbfgs_loop1_ref(S, T, g, rho, valid)
    from . import triton_lbfgs
    out = triton_lbfgs.launch_loop1(S, T, g, rho, valid)
    launches[name] += 1
    return out


def lbfgs_loop2(T, r, k, G, rho, valid):
    """K9 (loop 2): c (m,) from T (m, n), the H0-applied r (n,), loop 1's k
    (m,) and G (m, m), rho and valid (m,)."""
    name = "lbfgs_loop2"
    _history(name, T, None, r, rho, valid)
    m = T.shape[0]
    _need(name, "k", k, r.device, r.dtype, (m,))
    _need(name, "G", G, r.device, r.dtype, (m, m))
    if not _route(name, r):
        return lbfgs.lbfgs_loop2_ref(T, r, k, G, rho, valid)
    from . import triton_lbfgs
    out = triton_lbfgs.launch_loop2(T, r, k, G, rho, valid)
    launches[name] += 1
    return out


def lbfgs_combine(x, c, V, neg_x=False, neg_c=False):
    """K9 (combine): (+-x) + (+-(c^T V)) for x (n,), c (m,), V (m, n)."""
    name = "lbfgs_combine"
    dt = _float(name, x)
    m, n = V.shape
    _need(name, "x", x, x.device, dt, (n,))
    _need(name, "c", c, x.device, dt, (m,))
    _need(name, "V", V, x.device, dt, (m, n))
    if not _route(name, x):
        return lbfgs.lbfgs_combine_ref(x, c, V, neg_x, neg_c)
    from . import triton_lbfgs
    out = triton_lbfgs.launch_combine(x, c, V, neg_x, neg_c)
    launches[name] += 1
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


def block_matvec_k(A, v, c=None, trans=False, out=None):
    """K15: op(A) v, or c - op(A) v, with k = 3 right-hand sides in one
    pass over A: A (B, n, n) contiguous in bf16, f32 or f64, taken to v's
    dtype; v, c, out (B, n, 3). `out` (may be c) must not overlap v."""
    name = "block_matvec_k"
    dt = _float(name, v)
    if v.dim() != 3:
        raise ValueError(f"{name}: v has shape {tuple(v.shape)}, not "
                         "(B, n, k)")
    B, n, k = v.shape
    _need(name, "v", v, v.device, dt, (B, n, k))
    _need(name, "A", A, v.device, tuple(_A_DTYPES), (B, n, n))
    if c is not None:
        _need(name, "c", c, v.device, dt, (B, n, k))
    if out is not None:
        _need(name, "out", out, v.device, dt, (B, n, k))
        if _overlap(out, v):
            raise ValueError(f"{name}: out overlaps v")
    if not _route(name, v):
        return pd.block_matvec_k_ref(A, v, c, trans, out)
    if k != 3:
        raise ValueError(f"{name}: the kernel takes 3 right-hand sides, "
                         f"not {k}")
    lib = _load()
    if out is None:
        out = torch.empty_like(v)
    err = lib.block_matvec_k(_A_DTYPES[A.dtype], _DTYPES[dt], _ptr(A),
                             _ptr(v), _ptr(c), _ptr(out), B, n, k,
                             int(bool(trans)), _stream(v))
    _ok(name, err)
    return out


def pd_gather(rhs, inv, d):
    """K15 (gather): (nv_p, 3) rows of rhs (nV, 3) permuted (inv (nv_p,):
    the vertex of each row, -1 at padding rows, which are zero) and divided
    by d (nv_p,)."""
    name, dev = "pd_gather", rhs.device
    dt = _float(name, rhs)
    nv_p = inv.shape[0]
    _need(name, "rhs", rhs, dev, dt, (None, 3))
    _need(name, "inv", inv, dev, torch.int64, (nv_p,))
    _need(name, "d", d, dev, dt, (nv_p,))
    if not _route(name, rhs):
        return pd.pd_gather_ref(rhs, inv, d)
    lib = _load()
    out = torch.empty((nv_p, 3), dtype=dt, device=dev)
    err = lib.pd_gather(_DTYPES[dt], _ptr(rhs), _ptr(inv), _ptr(d), nv_p,
                        _ptr(out), _stream(rhs))
    _ok(name, err)
    return out


def pd_scatter(z, perm, d):
    """K15 (scatter): (nV, 3) (z / d)[perm]; z (nv_p, 3), d (nv_p,), perm
    (nV,) the permuted row of each vertex."""
    name, dev = "pd_scatter", z.device
    dt = _float(name, z)
    nv_p, nv = z.shape[0], perm.shape[0]
    _need(name, "z", z, dev, dt, (nv_p, 3))
    _need(name, "perm", perm, dev, torch.int64, (nv,))
    _need(name, "d", d, dev, dt, (nv_p,))
    if not _route(name, z):
        return pd.pd_scatter_ref(z, perm, d)
    lib = _load()
    out = torch.empty((nv, 3), dtype=dt, device=dev)
    err = lib.pd_scatter(_DTYPES[dt], _ptr(z), _ptr(perm), _ptr(d), nv,
                         _ptr(out), _stream(z))
    _ok(name, err)
    return out


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
