"""Wrappers of the four hand-written kernels of the DOT main path.

Each wrapper checks device, dtype, shape and contiguity, then
- takes its plain PyTorch version (kernels/soa.py) for CPU tensors;
- launches its kernel for CUDA tensors (K1-K3: csrc/elem.cu through
  ctypes; K4: triton_qf.py), checks the launch's cudaGetLastError and adds
  one to its count in `launches`;
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

from . import soa

KERNELS = ("ls_trial_energy", "elem_gradient", "elem_hessian",
           "direction_pass")
launches = dict.fromkeys(KERNELS, 0)

plain = types.SimpleNamespace(
    ls_trial_energy=soa.ls_trial_energy_ref,
    elem_gradient=soa.elem_gradient_ref,
    elem_hessian=soa.elem_hessian_ref,
    direction_pass=soa.direction_pass_ref)

_lib = None
_DTYPES = {torch.float32: 0, torch.float64: 1}


def reset_launches():
    for k in KERNELS:
        launches[k] = 0


def _load():
    global _lib
    if _lib is None:
        from .csrc import build
        lib = ctypes.CDLL(build.build())
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.dot_ls_trial_energy.argtypes = [I, I] + [P] * 6 + [I] + [P] * 4
        lib.dot_ls_trial_energy.restype = I
        lib.dot_trial_partials.argtypes = [I]
        lib.dot_trial_partials.restype = I
        lib.dot_elem_gradient.argtypes = [I, I] + [P] * 7 + [I, P, P]
        lib.dot_elem_gradient.restype = I
        lib.dot_elem_hessian.argtypes = ([I, I] + [P] * 6
                                         + [ctypes.c_double, I, P, P])
        lib.dot_elem_hessian.restype = I
        _lib = lib
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
    part = torch.empty(lib.dot_trial_partials(n), dtype=F0.dtype,
                       device=F0.device)
    out = torch.empty((), dtype=F0.dtype, device=F0.device)
    sigma = (torch.empty((3, n), dtype=F0.dtype, device=F0.device)
             if want_sigma else None)
    err = lib.dot_ls_trial_energy(
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
    err = lib.dot_elem_gradient(
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
    err = lib.dot_elem_hessian(
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
