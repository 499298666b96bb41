"""The port's ADMM-PD stepper against dot_tpu on the CPU (float64, the port
on the plain versions of K17 and K18).

Per function, on the same numpy inputs made from a seed:
- the per-element local step (K17's plain version against
  ADMMPDStepper._local_step) on random, inverted and near-degenerate
  deformation gradients and duals, FCR and SNH: z and du at rtol 1e-9;
- the matrix-free (M + D^T W D) x and the rhs scatter (K18's plain version
  against _apply_A / _scatter) at 1e-12;
- the Overby weights and the prefactored global matrix's solve.
As a whole: three time steps of bar 8x3x3 stretch from dot_tpu's state give
dot_tpu's positions at rtol 1e-7 with equal iteration counts, and the same
sysE as the port's DOT run at 1e-3 (tests/test_admm.py); a script whose
Dirichlet set changes on the second frame covers the re-factorization; the
Simulator runs a `timeStepper ADMM 50` scene on the CPU and ignores
h0Refresh for it.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dot_tpu import partition as jpartition
from dot_tpu import scripts as jscripts
from dot_tpu import steppers as jsteppers
from dot_tpu.config import Config
from dot_tpu.mesh_gen import bar_mesh
from dot_tpu_torch import convert
from dot_tpu_torch import io as meshio
from dot_tpu_torch import steppers as tsteppers
from dot_tpu_torch.kernels import admm as kadmm
from dot_tpu_torch.kernels import ops, soa
from dot_tpu_torch.sim import run_script

SMALL = dict(pad_elem_to=16, pad_n3_to=48)


def _scene(script="stretch", cells=(8, 3, 3), energy="FCR"):
    mesh = bar_mesh(*cells)
    cfg = Config(energy=energy, dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script=script, handle_ratio=0.05)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = jscripts.init_script(mesh, script)
    mesh.fixed_mask = sd.fixed0.copy()
    return mesh, cfg, sd


@pytest.fixture(scope="module")
def pair():
    """One scene, both packages' ADMM-PD steppers on it (FCR)."""
    mesh, cfg, sd = _scene()
    jst = jsteppers.ADMMPDStepper(
        jsteppers.System(mesh, cfg, None, dtype=jnp.float64), sd)
    tst = tsteppers.ADMMPDStepper(convert.system_from_plan(mesh, cfg, None),
                                  sd)
    return mesh, cfg, sd, jst, tst


def _local_inputs(n, seed):
    """(Dx, u), each (9, n): random deformation gradients around the
    identity, a quarter of them inverted (one column negated), a quarter
    near-degenerate (two equal singular values, or one close to zero), and
    duals of mixed size."""
    rng = np.random.default_rng(seed)
    F = np.eye(3)[None] + 0.3 * rng.normal(size=(n, 3, 3))
    q = n // 4
    F[:q, :, 0] *= -1.0                                   # inverted
    rot = np.linalg.qr(rng.normal(size=(q, 3, 3)))[0]
    sig = np.stack([np.full(q, 1.2), np.full(q, 1.2),
                    np.where(np.arange(q) % 2 == 0, 1e-7, 0.7)], axis=1)
    F[q:2 * q] = rot * sig[:, None, :] @ np.swapaxes(
        np.linalg.qr(rng.normal(size=(q, 3, 3)))[0], 1, 2)
    u = 0.1 * rng.normal(size=(n, 3, 3))
    u[::3] = 0.0
    return F.reshape(n, 9).T.copy(), u.reshape(n, 9).T.copy()


@pytest.mark.parametrize("energy", ["FCR", "SNH"])
def test_local_step_matches_dot_tpu(energy, pair):
    if energy == "FCR":
        _, _, _, jst, tst = pair
    else:
        mesh, cfg, sd = _scene(energy=energy)
        jst = jsteppers.ADMMPDStepper(
            jsteppers.System(mesh, cfg, None, dtype=jnp.float64), sd)
        tst = tsteppers.ADMMPDStepper(
            convert.system_from_plan(mesh, cfg, None), sd)
    n = tst.system.n_elem_p
    assert n == jst.system.n_elem_p
    np.testing.assert_allclose(tst.w_e.numpy(), np.asarray(jst.w_e),
                               rtol=1e-14)
    Dx, u = _local_inputs(n, 5)
    jz, jdu = jst._local_step(tuple(jnp.asarray(Dx)), tuple(jnp.asarray(u)))
    tz, tdu = tst._local_step(torch.as_tensor(Dx), torch.as_tensor(u))
    # padded elements have zero weights: 0 / 0 in both packages
    real = np.asarray(jst.w_e) > 0
    assert real.sum() == tst.system.mesh.n_elem > n // 2
    np.testing.assert_allclose(tz.numpy()[:, real], np.stack(jz)[:, real],
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(tdu.numpy()[:, real], np.stack(jdu)[:, real],
                               rtol=1e-9, atol=1e-11)
    # the step did something: z is not Dx + u, and it lowered each
    # element's local objective
    assert float(np.abs(tz.numpy()[:, real] - (Dx + u)[:, real]).max()) > 1e-3


def test_local_step_reaches_the_fixed_point_of_its_objective(pair):
    """At the returned sigma the projected-Newton gradient is small where
    the loop stopped on its relative-decrease test: the plain version is a
    minimiser, not only a copy of dot_tpu's arithmetic."""
    _, _, _, _, tst = pair
    sys = tst.system
    n = sys.n_elem_p
    Dx, u = _local_inputs(n, 9)
    Dx, u = torch.as_tensor(Dx), torch.as_tensor(u)
    z, du = tst._local_step(Dx, u)
    real = tst.w_e > 0
    np.testing.assert_allclose((Dx - z).numpy(), du.numpy(), rtol=0,
                               atol=1e-12)
    _, s_hat, _ = soa.svd3_flip_soa(tuple(Dx + u))
    _, s, _ = soa.svd3_flip_soa(tuple(z))

    def energy(sv):
        d = sum((s_hat[i] - sv[i]) ** 2 for i in range(3))
        return sys.mat.psi(sv, sys.u_e, sys.lam_e) * tst.vol_dtsq \
            + 0.5 * tst.w_e * d
    assert bool((energy(s)[real] <= energy(s_hat)[real] + 1e-12).all())


def test_make_pd3_plain_is_the_soa_projection():
    rng = np.random.default_rng(2)
    a6 = torch.as_tensor(rng.normal(size=(6, 64)))
    out = ops.make_pd3(a6)
    for k in range(64):
        a, b, c, d, e, f = a6[:, k].tolist()
        w, Q = np.linalg.eigh(np.array([[a, b, c], [b, d, e], [c, e, f]]))
        M = (Q * np.maximum(w, 0.0)) @ Q.T
        np.testing.assert_allclose(
            out[:, k].numpy(), M[np.triu_indices(3)], rtol=1e-9, atol=1e-12)


def test_apply_A_and_rhs_scatter_match_dot_tpu(pair):
    mesh, _, sd, jst, tst = pair
    sys = tst.system
    rng = np.random.default_rng(11)
    x = sd.x0 + 0.05 * rng.normal(size=sd.x0.shape)
    ja = jst._apply_A(jnp.asarray(x))
    ta = tst._apply_A(torch.as_tensor(x))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-12,
                               atol=1e-12)
    # the rhs of the global step: (M xHat + D^T W (z - u) - offset) free
    # + x (1 - free)
    n = sys.n_elem_p
    z = rng.normal(size=(9, n))
    u9 = 0.1 * rng.normal(size=(9, n))
    m_xhat = rng.normal(size=(mesh.n_vert, 3))
    offset = rng.normal(size=(mesh.n_vert, 3))
    free = np.logical_not(sd.fixed0).astype(np.float64)
    Dr = jst._D_rows()
    zmu = [[jst.w_e * (z[3 * i + j] - u9[3 * i + j]) for j in range(3)]
           for i in range(3)]
    ge = [[sum(Dr[c][j] * zmu[i][j] for j in range(3)) for i in range(3)]
          for c in range(4)]
    jrhs = (m_xhat + np.asarray(jst._scatter(ge)) - offset) * free[:, None] \
        + x * (1.0 - free[:, None])
    trhs = tst._scatter(torch.as_tensor(z - u9), torch.as_tensor(x),
                        base=torch.as_tensor(m_xhat),
                        offset=torch.as_tensor(offset),
                        free=torch.as_tensor(free))
    np.testing.assert_allclose(trhs.numpy(), jrhs, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="mass, or base"):
        tst._scatter(torch.as_tensor(z), torch.as_tensor(x))


def test_global_factor_solves_like_dot_tpu(pair):
    mesh, _, sd, jst, tst = pair
    fixed = sd.fixed0
    jL, jd = jst.build_factor(jnp.asarray(fixed))
    tL, td = tst.build_factor(torch.as_tensor(fixed))
    rhs = np.random.default_rng(4).normal(size=(mesh.n_vert, 3))
    jx = jst.system.pd_solve(jL, jd, jnp.asarray(rhs))
    tx = tst.system.pd_solve(tL, td, torch.as_tensor(rhs))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9,
                               atol=1e-12)


def _dot_result():
    mesh, cfg, sd = _scene()
    plan = jpartition.build_plan(mesh, 4, **SMALL)
    st = tsteppers.DOTStepper(convert.system_from_plan(mesh, cfg, plan), sd)
    s = st.init_state()
    for _ in range(3):
        s, (_, sys_e) = st.step(s)
    return s.x.numpy().copy(), sys_e


def test_stepper_matches_dot_tpu_from_one_state(pair):
    _, _, _, jst, tst = pair
    js = jst.init_state()
    # copy before stepping: dot_tpu donates its state buffers
    ts = convert.admm_state_from_numpy(jax.tree.map(np.array, js),
                                       tst.system)
    assert tst.warm_start_opt == 2
    tol = tst.system.target_g_res(1e-5)
    for _ in range(3):
        js, (jstats, je) = jst.step(js, rel_tol=1e-5)
        ts, (tstats, te) = tst.step(ts, rel_tol=1e-5)
        assert tstats.inner_iters == int(jstats.inner_iters) > 0
        assert tstats.stop == "tol" and tstats.sqn_g <= tol
        assert tstats.ls_halvings == 0
        # one read per iteration + the start + the system energy
        assert tstats.syncs == tstats.inner_iters + 2
        jrows = np.asarray(jstats.rows)[:tstats.inner_iters + 1]
        np.testing.assert_allclose(np.asarray(tstats.rows), jrows, rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(te, float(je), rtol=1e-9)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), rtol=1e-6,
                               atol=1e-8)
    # the port's own init_state builds the same factor
    own = tst.init_state()
    np.testing.assert_allclose(own.equil.numpy(), ts.equil.numpy(),
                               rtol=1e-12)
    # cross-solver: the same minimization as DOT's
    x_dot, e_dot = _dot_result()
    np.testing.assert_allclose(te, e_dot, rtol=1e-3)
    assert float(np.abs(ts.x.numpy() - x_dot).max()) < 2e-3


def test_iteration_cap_is_reported(pair):
    mesh, cfg, sd, _, _ = pair
    tst = tsteppers.ADMMPDStepper(convert.system_from_plan(mesh, cfg, None),
                                  sd, max_iter=3)
    s, (stats, sys_e) = tst.step(tst.init_state())
    assert stats.inner_iters == 3 and stats.stop == "iter_cap"
    assert np.isfinite(sys_e) and len(stats.rows) == 4


def test_boundary_change_refactorizes():
    """rubberBandPull with its release moved to the second frame: the
    Dirichlet set shrinks there, and both packages rebuild the global
    factor and go on agreeing."""
    mesh, cfg, sd = _scene(script="rubberBandPull", cells=(8, 4, 3))
    assert sd.has_bc_change and sd.release_group.any()
    x_tv = sd.x0[sd.turning_vert, 0]
    sd = dataclasses.replace(sd, turning_lo=float(x_tv - 0.05))
    # the pulled waist snaps back after the release: cap the iterations
    jst = jsteppers.ADMMPDStepper(
        jsteppers.System(mesh, cfg, None, dtype=jnp.float64), sd, max_iter=40)
    tst = tsteppers.ADMMPDStepper(convert.system_from_plan(mesh, cfg, None),
                                  sd, max_iter=40)
    js = jst.init_state()
    ts = convert.admm_state_from_numpy(jax.tree.map(np.array, js),
                                       tst.system)
    n_fixed = []
    equil0 = ts.equil.clone()
    for _ in range(3):
        js, (jstats, je) = jst.step(js, rel_tol=1e-5)
        ts, (tstats, te) = tst.step(ts, rel_tol=1e-5)
        assert tstats.inner_iters == int(jstats.inner_iters)
        n_fixed.append(int(ts.fixed.sum()))
        np.testing.assert_allclose(te, float(je), rtol=1e-8)
    assert n_fixed[-1] < n_fixed[0] and bool(ts.released)
    assert not torch.equal(ts.equil, equil0)
    np.testing.assert_allclose(ts.equil.numpy(), np.asarray(js.equil),
                               rtol=1e-12)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-7,
                               atol=1e-10)


SCENE = """energy FCR
timeStepper {stepper}
time 5 0.025
density 1000
stiffness 100000 0.4
script twist
handleRatio 0.05
shape input {mesh}
{extra}"""


@pytest.mark.parametrize("extra", ["", "h0Refresh 2"])
def test_simulator_runs_admm_scene_on_the_cpu(tmp_path, extra):
    mesh = bar_mesh(8, 3, 3)
    mp = tmp_path / "bar.msh"
    meshio.save_tet_mesh(str(mp), mesh.V, mesh.conn, mesh.SF)
    sp = tmp_path / "scene.txt"
    sp.write_text(SCENE.format(stepper="ADMM 50", mesh=mp, extra=extra))
    sim, _ = run_script(str(sp), frames=2, output_root=str(tmp_path / "out"),
                        dtype="f64", device="cpu", mute=True)
    assert type(sim.stepper).__name__ == "ADMMPDStepper"
    assert sim.stepper.max_iter == 50 and sim.system.plan is None
    assert os.path.basename(sim.out).startswith("bar_twist_FCR_ADMM")
    files = set(os.listdir(sim.out))
    need = {"config.txt", "iterStats.txt", "log.txt", "info.txt",
            "finalResult_mesh.msh", "status2", "2.obj"}
    assert need <= files, need - files
    for r in sim.frames:
        assert np.isfinite(r["sys_e"]) and r["stop"] in ("tol", "iter_cap")
        assert r["iters"] <= 50
    assert torch.isfinite(sim.state.x).all()


def test_plain_versions_are_the_cpu_route_only():
    """On the CPU the wrappers take the plain versions; a tensor on another
    device type never does."""
    a6 = torch.zeros((6, 4), dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ops.make_pd3(a6)
    assert kadmm.bulk_modulus(3.0, 1.0) == 3.0
