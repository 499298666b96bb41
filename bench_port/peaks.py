"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core
GPU datasheet: dense rates, no sparsity, at the 700 W power limit), and
the least time of a piece of work on it: the larger of its operations
over the fastest unit its stated numerics permit and its bytes over the
memory bandwidth (each input read once, each output written once)."""

from __future__ import annotations

H100_SXM = {
    "bf16": 989.4e12,      # tensor cores, bf16 / fp16 inputs
    "tf32": 494.7e12,      # tensor cores, TF32
    "f32": 66.9e12,        # CUDA cores (float32 with TF32 off)
    "f64": 66.9e12,        # tensor cores, FP64
    "hbm_bytes_per_s": 3.35e12,
}
DTYPE_BYTES = {"bf16": 2, "f32": 4, "f64": 8, "i64": 8}


def least_time(flops, nbytes, numerics):
    """(seconds, "ops" or "bytes": the bound that sets it)."""
    t_ops = flops / H100_SXM[numerics]
    t_bytes = nbytes / H100_SXM["hbm_bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
