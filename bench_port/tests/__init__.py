"""Part of the benchmark of dot_tpu_torch (see bench_port/run.py)."""
