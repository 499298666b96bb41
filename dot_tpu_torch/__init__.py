"""dot_tpu_torch: dot_tpu's time steppers in PyTorch, with hand-written
CUDA / Triton kernels for NVIDIA Hopper (sm_90a): the nine steppers at dim 3
and the 2D pipeline's core (projected Newton on triangle meshes, dim2.py).

A port of dot_tpu (the JAX reference, which stays beside it). It imports
torch and never jax or dot_tpu; the pure-numpy host modules are copies.
Entry point: python -m dot_tpu_torch 100 <scene.txt> [tag] [--frames N]
[--dtype f32|f64] [--device cuda|cpu].
"""
