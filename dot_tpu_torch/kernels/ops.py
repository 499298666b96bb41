"""Wrappers of the eight hand-written kernels of the DOT main path.

Each wrapper checks device, dtype, shape and contiguity, then
- takes its plain PyTorch version (kernels/soa.py for K1-K4,
  kernels/band.py for K5-K8) for CPU tensors;
- launches its kernel for CUDA tensors (K1-K3: csrc/elem.cu, K5:
  csrc/band_asm.cu, K6: csrc/chol_inv.cu, K7: csrc/block_matvec.cu, K8:
  csrc/h0.cu, all through ctypes; K4: triton_qf.py), checks the launch's
  cudaGetLastError and adds one to its count in `launches`;
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

from . import band, soa

KERNELS = ("ls_trial_energy", "elem_gradient", "elem_hessian",
           "direction_pass", "band_assemble", "chol_inv", "block_matvec",
           "h0_gather", "h0_average")
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
    h0_average=band.h0_average_ref)

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
            + [LL, I, I, P],
            ("h0", "dot_h0_gather"): [I] + [P] * 4 + [LL, P, P],
            ("h0", "dot_h0_average"): [I] + [P] * 5 + [LL, P, P],
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
        raise ValueError(f"{name}: blocks of {n} exceed the kernel's panel "
                         f"limit ({_chol_max_n[dt]} for {dt})")
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


def block_matvec(A, v, c=None, trans=False, out=None):
    """K7: op(A) v, or c - op(A) v, over a batch: A (B, n, n) in bf16, f32
    or f64, taken to v's dtype; v, c, out (B, n) in f32 or f64. `out`
    (may be c, must not overlap v) receives the result."""
    name = "block_matvec"
    dt = _float(name, v)
    B, n = v.shape[0], v.shape[-1]
    _need(name, "v", v, v.device, dt, (B, n))
    _need(name, "A", A, v.device, tuple(_A_DTYPES), (B, n, n))
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
                           _stream(v))
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
