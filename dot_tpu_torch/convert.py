"""Carry a dot_tpu plan and state across to the port, as plain numpy.

The tests build one numpy SubdomainPlan (with either package's
partition.build_plan) and one initial state, and hand both to dot_tpu and
to the port, so that the two start from identical data.
"""

from __future__ import annotations

import numpy as np
import torch

from .steppers.core import BTDFactor, SimState, System


def system_from_plan(mesh, cfg, plan, dtype=torch.float64, device="cpu",
                     use_kernels=True):
    """The port's System on a numpy SubdomainPlan (dot_tpu's or the
    port's: the fields are the same)."""
    return System(mesh, cfg, plan, dtype=dtype, device=device,
                  use_kernels=use_kernels)


def state_from_numpy(d, system=None):
    """The port's SimState from a dot_tpu SimState whose leaves went
    through np.asarray. Tensors go to `system`'s device and dtype (else
    the CPU, dtype kept). A dense or block-tridiagonal H0 factor is carried
    over; dot_tpu's cyclic-reduction factor has no counterpart in the port,
    so then the factor is rebuilt by `system` at d.x."""
    dev = system.device if system is not None else "cpu"
    fdt = system.dtype if system is not None else None

    def t(a, dtype=fdt):
        return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

    chol = d.chol
    if isinstance(chol, np.ndarray):
        chol = t(chol)
    elif hasattr(chol, "linv") and hasattr(chol, "sub"):
        chol = BTDFactor(t(chol.linv), t(chol.sub))
    else:
        chol = None
    st = SimState(
        x=t(d.x), x_n=t(d.x_n), v=t(d.v), x_tilta=t(d.x_tilta),
        dx_elastic=t(d.dx_elastic), fixed=t(d.fixed, torch.bool),
        vel_sign=t(d.vel_sign), released=t(d.released, torch.bool),
        elem_h=t(d.elem_h), chol=chol, equil=t(d.equil),
        lb_s=t(d.lb_s), lb_t=t(d.lb_t), lb_rho=t(d.lb_rho),
        lb_valid=t(d.lb_valid))
    if chol is None:
        if system is None:
            raise ValueError("this H0 factor kind needs a system to rebuild")
        st.elem_h, st.chol, st.equil = system.rebuild_h0(st.x, st.fixed)
    return st
