"""The plain reference states what the program computes (f64, on the
CPU, at bar_mesh(8, 3, 3)): the tolerance, the gradient, the system
energy, the twist's and the stretch's handles; and its TF32 rounding."""

from __future__ import annotations

import os

import pytest
import torch

from bench_port import driver
from bench_port.references.tet_fcr import Scene, round_tf32


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 3 * 2.0 ** -11, -3.0e-5], dtype=torch.float32)
    got = round_tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2.0 ** -10
    assert got[2] == 1.0                      # a tie goes to the even value
    assert got[3] == 1.0 + 2.0 ** -9
    assert abs(got[4] / x[4] - 1) <= 2.0 ** -11


@pytest.mark.parametrize("script", ["twist", "stretch"])
def test_reference_matches_the_program(tiny_cell, tmp_path, script):
    cell = tiny_cell(script=script)
    scene = driver.scene_kind(cell.config)
    out = str(tmp_path / "out")
    os.makedirs(out)
    path, mesh = scene.write(cell.config, cell.traffic, str(tmp_path), out)
    sim = scene.simulator(path, cell.config, cell.traffic, "cpu", out)
    sysm = sim.system
    sysm.dtype = torch.float64
    ref = Scene(cell.config, mesh, "cpu", "f64")
    assert abs(ref.target / sysm.target_g_res(1e-5) - 1) < 1e-12
    st = sim.state
    assert torch.equal(ref.x0.to(torch.float32), st.x)
    assert torch.equal(ref.free, ~st.fixed)

    g = torch.Generator().manual_seed(0)
    x_n = ref.x0 + 1e-3 * torch.randn(ref.x0.shape, generator=g,
                                      dtype=torch.float64)
    v_n = 1e-2 * torch.randn(ref.x0.shape, generator=g, dtype=torch.float64)
    x = x_n + 1e-3 * torch.randn(ref.x0.shape, generator=g,
                                 dtype=torch.float64)
    xt = ref.x_tilde(x_n, v_n)
    prog = as_float64(sysm)
    gp = prog.gradient(x, xt, st.fixed)
    gr = ref.gradient(x, xt)
    assert torch.linalg.norm(gp - gr) <= 1e-5 * torch.linalg.norm(gr)
    e_prog = prog.system_energy(x, x_n, prog.sigma(prog.defgrad(x)))
    assert abs(float(e_prog) / float(ref.system_energy(x, x_n)[0]) - 1) < 1e-6
    # the script's handles: one frame of the program's script
    step = sim.stepper._anim
    xs, *_ = step(x_n.to(torch.float32), st.fixed, st.vel_sign, st.released)
    h = ref.handles_t
    assert torch.allclose(xs.double()[h], ref.move_handles(x_n), atol=1e-6)


def as_float64(sysm):
    """The program's System with its f32 tables in float64, for a
    comparison at the reference's precision."""
    for k, v in list(vars(sysm).items()):
        if torch.is_tensor(v) and v.dtype == torch.float32:
            setattr(sysm, k, v.double())
    return sysm
