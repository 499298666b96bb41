"""Build csrc/elem.cu with nvcc into a shared library with a plain C
interface, at first use, into dot_tpu_torch/build/ (git-ignored).

The library's name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. The build runs
through a temporary file and a rename; nvcc's -Xptxas -v report (registers,
spills, shared memory per kernel) is kept beside the library as
elem_build.log.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
SOURCES = ("elem.cu", "elem.cuh")
# -fmad=false: products and sums round one by one, as the plain PyTorch
# version's elementwise ops do (see elem.cuh)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

last_build_seconds = None


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path():
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdotelem_{h.hexdigest()[:16]}.so")


def build():
    """Path of the built library, compiling it if it is not there yet.
    Raises RuntimeError with nvcc's output if the build fails."""
    global last_build_seconds
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *FLAGS, "-o", tmp, os.path.join(_HERE, "elem.cu")]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    last_build_seconds = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, "elem_build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr[-4000:]}")
    os.replace(tmp, so)
    return so
