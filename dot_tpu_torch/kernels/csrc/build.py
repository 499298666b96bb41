"""Build the CUDA sources of csrc/ with nvcc, one shared library with a plain
C interface per source, at first use, into dot_tpu_torch/build/
(git-ignored).

Every missing library is compiled at the same time (one nvcc process per
source). A library's name carries a hash of its sources and flags, so an
edited source is rebuilt and a stale library is never loaded. Each build
runs through a temporary file and a rename; nvcc's -Xptxas -v report
(registers, spills, shared memory per kernel) is kept beside the library
as <name>_build.log.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library -> (sources, the first one compiled; extra flags). -fmad=false:
# products and sums round one by one, as the plain PyTorch versions'
# elementwise ops do (K1-K3, K5, K8, K13, K14, K16-K20 then agree bit for bit
# in most outputs; the 2D kernels K21-K24 and K29 up to the device library's
# atan2, sin and cos; K25-K28 and K30 on the 2D decomposed and ADMM paths);
# K6, K7, K9, K15 and K31 are sums of products whose order differs from
# the plain versions' anyway, so they keep the contraction. K6 and K9 are
# launched cooperatively (cooperative_groups' grid barrier, which needs no
# -rdc since CUDA 11).
LIBRARIES = {
    "elem": (("elem.cu", "elem.cuh"), ("-fmad=false",)),
    "band_asm": (("band_asm.cu",), ("-fmad=false",)),
    "chol_inv": (("chol_inv.cu",), ()),
    "schur": (("schur.cu",), ()),
    "lbfgs": (("lbfgs.cu",), ()),
    "block_matvec": (("block_matvec.cu",), ()),
    "h0": (("h0.cu",), ("-fmad=false",)),
    "coarse": (("coarse.cu",), ("-fmad=false",)),
    "band_equil": (("band_equil.cu",), ("-fmad=false",)),
    "hdiag": (("hdiag.cu",), ("-fmad=false",)),
    "pd": (("pd.cu",), ("-fmad=false",)),
    "admm": (("admm.cu", "elem.cuh"), ("-fmad=false",)),
    "elem2d": (("elem2d.cu", "elem2d.cuh"), ("-fmad=false",)),
    "dd2d": (("dd2d.cu",), ("-fmad=false",)),
    "admm2d": (("admm2d.cu", "elem2d.cuh"), ("-fmad=false",)),
}

last_build_seconds = None   # wall time of the last build() that compiled


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(name):
    return FLAGS + LIBRARIES[name][1]


def library_path(name):
    sources, _ = LIBRARIES[name]
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for src in sources:
        with open(os.path.join(_HERE, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdot{name}_{h.hexdigest()[:16]}.so")


def log_path(name):
    return os.path.join(BUILD_DIR, f"{name}_build.log")


def build():
    """{library name: path} of every library, compiling the missing ones in
    parallel. Raises RuntimeError with nvcc's output if a build fails."""
    global last_build_seconds
    paths = {name: library_path(name) for name in LIBRARIES}
    todo = [n for n, p in paths.items() if not os.path.exists(p)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        cmd = [nvcc, *_flags(name), "-o", tmp,
               os.path.join(_HERE, LIBRARIES[name][0][0])]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        out, err = proc.communicate()
        with open(log_path(name), "w") as f:
            f.write(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{err[-4000:]}")
        else:
            os.replace(tmp, paths[name])
    last_build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return paths
