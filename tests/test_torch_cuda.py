"""The port's kernels on the card (marker `cuda`): each kernel against its
plain PyTorch version on CUDA tensors, and one DOT step on the card against
the same step on the CPU. Skipped where there is no CUDA device; on the
GPU machine run

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from dot_tpu_torch import partition, scripts
from dot_tpu_torch.config import Config
from dot_tpu_torch.kernels import ops, soa
from dot_tpu_torch.mesh_gen import bar_mesh
from dot_tpu_torch.steppers import DOTStepper, System

pytestmark = pytest.mark.cuda

# f64 agrees to roundoff (1e-10, H 1e-9); f32 to 1e-5 on elementwise
# results and sums, norm-wise 1e-4 on the atomically summed gradient and H
TOL = {torch.float64: (1e-10, 1e-9), torch.float32: (1e-5, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dtype, dev, n_cells=(6, 3, 3)):
    mesh = bar_mesh(*n_cells)
    mesh.set_lame(1e5, 0.4)
    rng = np.random.default_rng(0)
    n = mesh.n_elem

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    x = mesh.V + 0.05 * rng.normal(size=mesh.V.shape)
    return dict(conn=t(mesh.conn.T, torch.int32),
                g9=t(mesh.rest_tri_inv.reshape(-1, 9).T), u=t(mesh.u),
                lam=t(mesh.lam), w=t(mesh.vol), x=t(x),
                p=t(rng.normal(size=mesh.V.shape)),
                F0=t(rng.normal(size=(9, n))), Fp=t(rng.normal(size=(9, n))),
                alpha=torch.tensor(0.5, dtype=dtype, device=dev))


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name", sorted(soa.SOA_MATERIALS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_plain_versions(cuda, dtype, name):
    d = _inputs(dtype, cuda)
    tol, tol_n = TOL[dtype]
    mat = soa.SOA_MATERIALS[name]
    ops.reset_launches()
    ek, sk = ops.ls_trial_energy(d["F0"], d["Fp"], d["alpha"], d["u"],
                                 d["lam"], d["w"], mat, want_sigma=True)
    er, sr = soa.ls_trial_energy_ref(d["F0"], d["Fp"], d["alpha"], d["u"],
                                     d["lam"], d["w"], mat, want_sigma=True)
    assert _rel(ek, er) <= tol and _rel(sk, sr) <= tol
    args = (d["x"], d["conn"], d["conn"], d["g9"], d["u"], d["lam"], d["w"],
            mat)
    assert _rel(ops.elem_gradient(*args), soa.elem_gradient_ref(*args)) \
        <= tol_n
    hargs = (d["x"], d["conn"], d["g9"], d["u"], d["lam"], d["w"], mat,
             0.025 ** 2)
    hk, hr = ops.elem_hessian(*hargs), soa.elem_hessian_ref(*hargs)
    assert _rel(hk, hr) <= tol_n
    fk, qk = ops.direction_pass(d["p"], d["conn"], d["g9"], hr)
    fr, qr = soa.direction_pass_ref(d["p"], d["conn"], d["g9"], hr)
    assert _rel(fk, fr) <= tol and _rel(qk, qr) <= tol
    torch.cuda.synchronize()
    assert all(v == 1 for v in ops.launches.values()), ops.launches


def test_dot_step_on_card_matches_cpu(cuda):
    mesh = bar_mesh(8, 3, 3)
    cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script="twist", handle_ratio=0.05)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = scripts.init_script(mesh, "twist")
    mesh.fixed_mask = sd.fixed0.copy()
    plan = partition.build_plan(mesh, 4, pad_elem_to=16, pad_n3_to=48)
    out = []
    for dev in ("cpu", cuda):
        st = DOTStepper(System(mesh, cfg, plan, dtype=torch.float64,
                               device=dev), sd)
        s = st.init_state()
        for _ in range(2):
            s, (_, e) = st.step(s)
        out.append((s.x.cpu().numpy(), e))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-9, atol=1e-12)
    assert out[1][1] == pytest.approx(out[0][1], rel=1e-9)
