"""Carry a dot_tpu plan and state across to the port, as plain numpy.

The tests build one numpy SubdomainPlan (with either package's
partition.build_plan) and one initial state, and hand both to dot_tpu and
to the port, so that the two start from identical data.
"""

from __future__ import annotations

import numpy as np
import torch

from .steppers.core import (APPLY_DTYPES, BTDFactor, CoarseFactor, CRFactor,
                            SimState, System)


def system_from_plan(mesh, cfg, plan, dtype=torch.float64, device="cpu",
                     use_kernels=True, factor_dtype=None, use_coarse=None):
    """The port's System on a numpy SubdomainPlan (dot_tpu's or the
    port's: the fields are the same; an element plan, a node plan, or None
    for LBFGS-PD), with cfg's applyDtype. `factor_dtype`:
    torch.bfloat16 for LBFGS-HI."""
    return System(mesh, cfg, plan, dtype=dtype, device=device,
                  use_kernels=use_kernels,
                  apply_dtype=APPLY_DTYPES[getattr(cfg, "apply_dtype", "")],
                  factor_dtype=factor_dtype, use_coarse=use_coarse)


def factor_from_numpy(chol, device="cpu"):
    """dot_tpu's H0 factor (dense array, BTDFactor or CRFactor, leaves as
    numpy) as the port's, each leaf in its own storage dtype (an ml_dtypes
    bfloat16 leaf goes through its 16-bit pattern)."""
    def t(a):
        a = np.array(a)               # a writable C-contiguous copy
        if a.dtype.name == "bfloat16":
            bits = torch.from_numpy(a.view(np.uint16).view(np.int16))
            return bits.view(torch.bfloat16).to(device)
        return torch.as_tensor(a, device=device)

    if isinstance(chol, np.ndarray):
        return t(chol)
    if hasattr(chol, "levels") and hasattr(chol, "root"):
        return CRFactor(
            levels=tuple(tuple(t(x) for x in lv) for lv in chol.levels),
            root=BTDFactor(t(chol.root.linv), t(chol.root.sub)))
    if hasattr(chol, "linv") and hasattr(chol, "sub"):
        return BTDFactor(t(chol.linv), t(chol.sub))
    raise TypeError(f"unknown H0 factor kind {type(chol).__name__}")


def coarse_from_numpy(kc, device="cpu", dtype=None):
    """dot_tpu's coarse factor (Lc, dc) (or None) as the port's
    CoarseFactor, with Lc^{-1} from one triangular solve."""
    if kc is None:
        return None
    lc = torch.as_tensor(np.asarray(kc[0]), device=device, dtype=dtype)
    dc = torch.as_tensor(np.asarray(kc[1]), device=device, dtype=dtype)
    eye = torch.eye(lc.shape[0], dtype=lc.dtype, device=device)
    li = torch.linalg.solve_triangular(lc, eye, upper=False)
    return CoarseFactor(lc, li.contiguous(), dc)


def state_from_numpy(d, system=None):
    """The port's SimState from a dot_tpu SimState whose leaves went
    through np.asarray. Tensors go to `system`'s device; the fields to its
    dtype (else the CPU, dtype kept), the H0 factor's leaves keep their
    storage dtype (bf16 leaves of an f32 run stay bf16; the f32 factor of
    an LBFGS-HI run stays f32). LBFGS-PD's state carries over as it is: its
    P = 1 BTDFactor or dense (nV, nV) factor, its d and the (1, 1)
    elem_h."""
    dev = system.device if system is not None else "cpu"
    fdt = system.dtype if system is not None else None

    def t(a, dtype=fdt):
        return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

    chol = factor_from_numpy(d.chol, dev)
    if isinstance(chol, torch.Tensor) and system is not None:
        chol = chol.to(system._solve_dtype)
    return SimState(
        x=t(d.x), x_n=t(d.x_n), v=t(d.v), x_tilta=t(d.x_tilta),
        dx_elastic=t(d.dx_elastic), fixed=t(d.fixed, torch.bool),
        vel_sign=t(d.vel_sign), released=t(d.released, torch.bool),
        elem_h=t(d.elem_h), chol=chol, equil=t(d.equil),
        lb_s=t(d.lb_s), lb_t=t(d.lb_t), lb_rho=t(d.lb_rho),
        lb_valid=t(d.lb_valid),
        kc_chol=coarse_from_numpy(getattr(d, "kc_chol", None), dev, fdt))
