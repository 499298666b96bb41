# Copied from dot_tpu/native.py: the port cannot import dot_tpu, whose package import pulls in jax.
# One change: the library is built into dot_tpu_torch/build/ (never into native/),
# through a temporary file and a rename so that concurrent first uses never load half a file.
"""ctypes loader for the native host-runtime kernels (native/planops.cpp).

Compiles the shared library on first use (g++ -O3, cached next to the
source) and exposes numpy-typed wrappers. Every entry point has a pure
numpy fallback so the framework still works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = [os.path.join(_HERE, "native", "planops.cpp"),
         os.path.join(_HERE, "native", "mlkway.cpp")]
_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
_SO = os.path.join(_BUILD, "libplanops.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        src_mtime = max(os.path.getmtime(s) for s in _SRCS)
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < src_mtime):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 *_SRCS, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.sort_unique_inverse_i64.restype = ctypes.c_int64
        lib.sort_unique_inverse_i64.argtypes = [i64p, ctypes.c_int64,
                                                i32p, i32p, i64p]
        lib.build_block_plan.restype = ctypes.c_int64
        lib.build_block_plan.argtypes = [i32p, i32p, i32p, ctypes.c_int64,
                                         ctypes.c_int64, i32p, i32p, i64p]
        lib.partition_mesh_dual.restype = ctypes.c_int64
        lib.partition_mesh_dual.argtypes = [i32p, ctypes.c_int64,
                                            ctypes.c_int32, ctypes.c_double,
                                            i32p]
        lib.partition_mesh_dual_w.restype = ctypes.c_int64
        lib.partition_mesh_dual_w.argtypes = [i32p, ctypes.c_int64,
                                              ctypes.c_int32,
                                              ctypes.c_double, i32p, i32p]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _numpy_sui(keys):
    perm = np.argsort(keys, kind="stable").astype(np.int32)
    uni, inv = np.unique(keys[perm], return_inverse=True)
    return perm, inv.astype(np.int32), uni


def sort_unique_inverse(keys: np.ndarray):
    """Returns (perm int32, inverse int32 (sorted order), unique int64) —
    the sorted-segment-sum plan for a multiset of destinations."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = keys.shape[0]
    lib = _load()
    if lib is None or n == 0:
        return _numpy_sui(keys)
    perm = np.empty(n, dtype=np.int32)
    inv = np.empty(n, dtype=np.int32)
    uni = np.empty(n, dtype=np.int64)
    nu = lib.sort_unique_inverse_i64(_ptr(keys, ctypes.c_int64), n,
                                     _ptr(perm, ctypes.c_int32),
                                     _ptr(inv, ctypes.c_int32),
                                     _ptr(uni, ctypes.c_int64))
    if nu < 0:  # size/range limits exceeded
        return _numpy_sui(keys)
    return perm, inv, uni[:nu].copy()


def partition_mesh_dual(tets: np.ndarray, n_parts: int,
                        imbalance: float = 1.03, elem_wgt=None):
    """Multilevel k-way partition of the tet dual graph (native/mlkway.cpp;
    reference role: METIS<3>::partMesh, METIS.hpp:109-160). `elem_wgt`
    (optional int (nE,), non-negative) balances per-element weight instead
    of element count — the vwgt role of the reference's USE_METIS 3/4
    schemes (ADMMDDTimeStepper.cpp:98-152). Returns
    (part_ids int32 (nE,), edge_cut) or None if the native library is
    unavailable (callers fall back to RCB)."""
    tets = np.ascontiguousarray(tets, dtype=np.int32)
    n_elem = tets.shape[0]
    lib = _load()
    if lib is None or n_elem == 0 or n_parts <= 0:
        return None
    out = np.empty(n_elem, dtype=np.int32)
    if elem_wgt is None:
        cut = lib.partition_mesh_dual(_ptr(tets, ctypes.c_int32), n_elem,
                                      n_parts, imbalance,
                                      _ptr(out, ctypes.c_int32))
    else:
        elem_wgt = np.ascontiguousarray(elem_wgt, dtype=np.int32)
        assert elem_wgt.shape == (n_elem,)
        cut = lib.partition_mesh_dual_w(_ptr(tets, ctypes.c_int32), n_elem,
                                        n_parts, imbalance,
                                        _ptr(elem_wgt, ctypes.c_int32),
                                        _ptr(out, ctypes.c_int32))
    if cut < 0:
        return None
    return out, int(cut)


def block_plan(sbd: np.ndarray, row: np.ndarray, col: np.ndarray, n3: int):
    """Fused 3x3-block scatter plan: scalar dests
    sbd*n3^2 + (row*3+i)*n3 + (col*3+j), sorted+uniqued in C++.
    Returns (perm int32 (9n,), inverse int32, unique int64)."""
    sbd = np.ascontiguousarray(sbd, dtype=np.int32)
    row = np.ascontiguousarray(row, dtype=np.int32)
    col = np.ascontiguousarray(col, dtype=np.int32)
    n_t = sbd.shape[0]
    lib = _load()
    if lib is not None and n_t > 0:
        n = n_t * 9
        perm = np.empty(n, dtype=np.int32)
        inv = np.empty(n, dtype=np.int32)
        uni = np.empty(n, dtype=np.int64)
        nu = lib.build_block_plan(_ptr(sbd, ctypes.c_int32),
                                  _ptr(row, ctypes.c_int32),
                                  _ptr(col, ctypes.c_int32),
                                  n_t, n3,
                                  _ptr(perm, ctypes.c_int32),
                                  _ptr(inv, ctypes.c_int32),
                                  _ptr(uni, ctypes.c_int64))
        if nu >= 0:
            return perm, inv, uni[:nu].copy()
    # numpy fallback
    i3 = np.arange(3, dtype=np.int64)
    dest = (sbd.astype(np.int64)[:, None, None] * (n3 * n3)
            + (row.astype(np.int64)[:, None, None] * 3 + i3[None, :, None]) * n3
            + (col.astype(np.int64)[:, None, None] * 3 + i3[None, None, :]))
    return _numpy_sui(dest.reshape(-1))
