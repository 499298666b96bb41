"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def default_device():
    """The port runs on the card unless the caller asks for the CPU."""
    return "cuda"


def resolve_device(device=None):
    """torch.device for `device` (None: the card); raises when it names
    CUDA and no CUDA device is present, instead of falling back."""
    dev = torch.device(device or default_device())
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: dot_tpu_torch runs on an NVIDIA GPU by "
            "default; pass device='cpu' (--device cpu) to run on the CPU")
    return dev
