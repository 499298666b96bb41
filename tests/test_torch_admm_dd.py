"""The port's ADMM-DD stepper against dot_tpu on the CPU (float64, the port
on the plain versions of K19, K20 and the per-slab / from-F entry points of
K1 / K2).

Per function, on the same numpy inputs made from a seed (bar 18x3x3, 3
parts, band_bs_unit 48 so that the local factor is banded, as
tests/test_admm.py:158-160):
- assemble_subdomains_local_only, and assemble_own_btd_flat + W + the
  mass-diff diagonal, at 1e-12;
- update_weights (the compact W, the equilibrated consensus factor, its
  scale) at 1e-10;
- w_matvec / w_diag / w_add_dense against the densified W at 1e-12;
- the per-slab trial energy and the gradient from carried deformation
  gradients against dot_tpu's local energies / gradient at 1e-12.
As a whole: three time steps of bar 8x3x3 stretch (4 parts, dense local
factor) and of bar 18x3x3 (3 parts, banded) from dot_tpu's state give
dot_tpu's positions at rtol 1e-7 with equal iteration counts (initDual's CG
stops on the same step in both packages, so 1e-7 holds), sysE as the port's
DOT run at 1e-3; the banded local factor gives the dense one's trajectory;
the Simulator runs a `timeStepper ADMMDD 4` scene on the CPU.
"""

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
from dot_tpu.kernels import soa as jsoa
from dot_tpu.mesh_gen import bar_mesh
from dot_tpu_torch import convert
from dot_tpu_torch import io as meshio
from dot_tpu_torch import partition as tpartition
from dot_tpu_torch import steppers as tsteppers
from dot_tpu_torch.kernels import ops
from dot_tpu_torch.sim import run_script
from dot_tpu_torch.steppers.core import BTDFactor

SMALL = dict(pad_elem_to=16, pad_n3_to=48)


def _scene(cells, handle_ratio):
    mesh = bar_mesh(*cells)
    cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script="stretch", handle_ratio=handle_ratio)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = jscripts.init_script(mesh, "stretch")
    mesh.fixed_mask = sd.fixed0.copy()
    return mesh, cfg, sd


def _pair(cells, handle_ratio, n_parts, **plan_kw):
    mesh, cfg, sd = _scene(cells, handle_ratio)
    plan = jpartition.build_plan(mesh, n_parts, own_plan=True, **SMALL,
                                 **plan_kw)
    ap = jpartition.build_admm_dd_plan(mesh, plan)
    jst = jsteppers.ADMMDDStepper(
        jsteppers.System(mesh, cfg, plan, dtype=jnp.float64), sd, ap)
    tst = tsteppers.ADMMDDStepper(convert.system_from_plan(mesh, cfg, plan),
                                  sd, ap)
    return mesh, cfg, sd, plan, jst, tst


@pytest.fixture(scope="module")
def banded():
    """bar 18x3x3, 3 parts, banded local factor: both packages' steppers."""
    out = _pair((18, 3, 3), 0.1, 3, band_bs_unit=48, band_min_nb=3)
    plan, tst = out[3], out[5]
    assert plan.band_nb >= 3 and plan.own_band_dest is not None
    assert tst.banded_local and tst.system.own_band_plan is not None
    return out


@pytest.fixture(scope="module")
def dense():
    """bar 8x3x3, 4 parts, dense local factor."""
    out = _pair((8, 3, 3), 0.05, 4)
    assert not out[5].banded_local
    return out


def _moved(sd, seed=0, amp=0.02):
    return sd.x0 + amp * np.random.default_rng(seed).normal(size=sd.x0.shape)


def test_port_builds_the_same_admm_dd_plan(banded):
    mesh, _, _, plan, _, _ = banded
    tplan = tpartition.build_plan(mesh, 3, own_plan=True, band_bs_unit=48,
                                  band_min_nb=3, **SMALL)
    tap = tpartition.build_admm_dd_plan(mesh, tplan)
    jap = jpartition.build_admm_dd_plan(mesh, plan)
    for f in ("w_udest", "w_band_dest", "md_band_diag", "conn_local",
              "mass_local", "mass_dif", "c_udest", "l2shared"):
        np.testing.assert_array_equal(getattr(tap, f), getattr(jap, f), f)
    # an upper-neighbour entry of W carries a slot past the band: dropped
    total = tplan.n_parts * (2 * tplan.band_nb - 1) * tplan.band_bs ** 2
    assert int(tap.w_band_dest.max()) >= total
    assert int(tap.md_band_diag.max()) < total


def test_local_only_assembly_matches_dot_tpu(banded, dense):
    for mesh, _, sd, plan, jst, tst in (banded, dense):
        x = _moved(sd)
        fixed = sd.fixed0
        jsys, tsys = jst.system, tst.system
        jeh, jwv, _, _ = jst.update_weights(jnp.asarray(x),
                                            jnp.asarray(fixed))
        teh = torch.as_tensor(np.array(jeh))
        twv = torch.as_tensor(np.array(jwv))
        tfix = torch.as_tensor(fixed)
        free3f = tst._free3(tfix).reshape(-1)
        jfree3f = jst._free3(jnp.asarray(fixed)).reshape(-1)
        if plan.own_udest is not None:
            jH = jsys.assemble_subdomains_local_only(
                jeh, jnp.asarray(fixed), jst.mass_local)
            tH = tsys.assemble_subdomains_local_only(teh, tfix,
                                                     tst.mass_local)
            np.testing.assert_allclose(tH.numpy(), np.asarray(jH),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(
                tst.w_add_dense(tH, twv, free3f).numpy(),
                np.asarray(jst.w_add_dense(jH, jwv, jfree3f)),
                rtol=1e-12, atol=1e-12)
        if tst.banded_local:
            jflat = jsys.assemble_own_btd_flat(jeh, jnp.asarray(fixed),
                                               jst.mass_local)
            jflat = jflat.at[jst.w_band_dest].add(
                jst._w_masked(jwv, jfree3f), mode="drop")
            jflat = jflat.at[jst.md_band_diag].add(jst._md3f(jfree3f))
            tflat = tsys.assemble_own_btd_flat(teh, tfix, tst.mass_local,
                                               twv, free3f, tst.wp)
            assert float(np.abs(np.asarray(jflat)).max()) > 1.0
            np.testing.assert_allclose(tflat.numpy(), np.asarray(jflat),
                                       rtol=1e-12, atol=1e-12)


def test_update_weights_matches_dot_tpu(banded):
    _, _, sd, _, jst, tst = banded
    x = _moved(sd, 1)
    jeh, jwv, jLc, jd = jst.update_weights(jnp.asarray(x),
                                           jnp.asarray(sd.fixed0))
    teh, twv, tLc, td = tst.update_weights(torch.as_tensor(x),
                                           torch.as_tensor(sd.fixed0))
    assert tLc.shape == (tst.ns3, tst.ns3) and bool(torch.isfinite(tLc).all())
    for t, j in ((teh, jeh), (twv, jwv), (tLc, jLc), (td, jd)):
        scale = float(np.abs(np.asarray(j)).max())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-10,
                                   atol=1e-12 * scale)


def test_compact_w_matches_dense(banded):
    """w_matvec / w_add_dense / w_diag reproduce the densified W (scatter +
    mass-diff diagonal + free mask)."""
    _, _, sd, _, _, tst = banded
    sys_ = tst.system
    P, n3 = sys_.n_parts, sys_.n3
    fixed = torch.as_tensor(sd.fixed0)
    _, wv, _, _ = tst.update_weights(torch.as_tensor(_moved(sd, 2)), fixed)
    free3f = tst._free3(fixed).reshape(-1)
    W = np.zeros(P * n3 * n3)
    np.add.at(W, tst.w_udest.numpy(), tst._w_masked(wv, free3f).numpy())
    W = W.reshape(P, n3, n3)
    idx = np.arange(n3)
    W[:, idx, idx] += tst._md3f(free3f).numpy().reshape(P, n3)
    assert np.abs(W).max() > 0 and np.count_nonzero(free3f.numpy() == 0) > 0
    rng = np.random.default_rng(3)
    v = rng.normal(size=(P, n3))
    np.testing.assert_allclose(
        tst.w_matvec(wv, free3f, torch.as_tensor(v)).numpy(),
        np.einsum("pij,pj->pi", W, v), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tst.w_diag(wv, free3f).numpy(),
                               W[:, idx, idx].reshape(-1), rtol=1e-12,
                               atol=1e-12)
    H0 = rng.normal(size=(P, n3, n3))
    np.testing.assert_allclose(
        tst.w_add_dense(torch.as_tensor(H0), wv, free3f).numpy(), H0 + W,
        rtol=1e-12, atol=1e-12)
    # the kernel's CSR offsets address exactly the sorted rows
    wp = tst.wp
    assert bool((wp.row[1:] >= wp.row[:-1]).all())
    cnt = torch.bincount(wp.row, minlength=P * n3)
    assert torch.equal(wp.row_off[1:] - wp.row_off[:-1], cnt)
    with pytest.raises(ValueError, match="diag_only"):
        ops.w_matvec(wv, free3f, None, wp)


def test_local_energy_and_gradient_match_dot_tpu(banded):
    """The per-slab trial energy (with one step per subdomain) and the
    gradient from carried deformation gradients, against dot_tpu's local
    energies and gradient at the same local state."""
    _, _, sd, _, jst, tst = banded
    jsys, tsys = jst.system, tst.system
    P, nmax = tsys.n_parts, tst.nmax
    rng = np.random.default_rng(6)
    x = _moved(sd, 4)
    fixed = sd.fixed0
    z = x + 0.01 * rng.normal(size=x.shape)
    u_loc = 0.01 * rng.normal(size=(P, nmax, 3))
    valid = np.asarray(jsys.local_valid)[..., None]
    l2g = np.asarray(jsys.l2g)
    xl = x[l2g] * valid + 0.01 * rng.normal(size=(P, nmax, 3)) * valid
    xhat = x[l2g] * valid
    p = 0.05 * rng.normal(size=(P, nmax, 3)) * valid
    alpha = np.array([1.0, 0.5, 0.125])

    _, jwv, _, _ = jst.update_weights(jnp.asarray(x), jnp.asarray(fixed))
    jfree3f = jst._free3(jnp.asarray(fixed)).reshape(-1)
    jxl = jst._to_flat(jnp.asarray(xl))
    jf9 = jst._local_fsvd(jxl)
    jU, js_, jV = jsoa.svd3_flip_soa(jf9)
    jg = jst._local_gradient(jxl, jst._to_flat(jnp.asarray(xhat)),
                             jnp.asarray(z), jnp.asarray(u_loc),
                             (jwv, jfree3f), jnp.asarray(fixed), jf9, jU,
                             js_, jV)
    je = jst._local_energies(jxl, jst._to_flat(jnp.asarray(xhat)),
                             jnp.asarray(z), jnp.asarray(u_loc),
                             (jwv, jfree3f), js_)

    tfix = torch.as_tensor(fixed)
    twp = (torch.as_tensor(np.array(jwv)), tst._free3(tfix).reshape(-1))
    txl = tst._to_flat(torch.as_tensor(xl))
    txh = tst._to_flat(torch.as_tensor(xhat))
    tf9 = tst._local_defgrad(txl)
    np.testing.assert_allclose(tf9.numpy(), np.stack(jf9), rtol=1e-12,
                               atol=1e-13)
    tg = tst._local_gradient(txl, txh, torch.as_tensor(z),
                             torch.as_tensor(u_loc), twp, tfix, tf9)
    te = tst._local_energies(txl, txh, torch.as_tensor(z),
                             torch.as_tensor(u_loc), twp, tf9)
    gs = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-12 * gs)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-12)

    # one step length per slab
    jfp9 = jst._local_fsvd(jst._to_flat(jnp.asarray(p)))
    n_slab = tsys.n_elem_p // P
    ae = jnp.repeat(jnp.asarray(alpha), n_slab)
    _, ss, _ = jsoa.svd3_flip_soa(tuple(f + ae * fp
                                        for f, fp in zip(jf9, jfp9)))
    psi_w = jsys.mat_soa.psi(ss, jsys.u_e, jsys.lam_e) * jsys.vol_w
    want = np.asarray(jnp.sum(psi_w.reshape(P, -1), axis=1))
    tfp9 = tst._local_defgrad(tst._to_flat(torch.as_tensor(p)))
    got = tst._slab_energies(tf9, tfp9, torch.as_tensor(alpha))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    odd = next(k for k in range(2, 64) if tsys.n_elem_p % k)
    with pytest.raises(ValueError, match="slabs"):
        ops.ls_trial_energy_parts(tf9, None, None, tsys.u_e, tsys.lam_e,
                                  tsys.vol_w, tsys.mat, odd)


@pytest.mark.parametrize("free", ["fixed0", "all_free"])
def test_w_quad_matches_dot_tpu(banded, free):
    """K20's line-search entry (w_quad_ref, and ops.w_quad on CPU tensors)
    against dot_tpu's a0c, a1c, a2c (admm_dd.py:524-529: two W products and
    four sums) at the same W, masks and vectors, f64 rtol 1e-12; the stepper
    no longer runs the pair of w_matvec calls."""
    from dot_tpu_torch.kernels import admm as kadmm
    _, _, sd, _, jst, tst = banded
    P, n3 = tst.system.n_parts, tst.system.n3
    rng = np.random.default_rng(9)
    fixed = sd.fixed0 if free == "fixed0" else np.zeros_like(sd.fixed0)
    _, jwv, _, _ = jst.update_weights(jnp.asarray(_moved(sd, 7)),
                                      jnp.asarray(fixed))
    jfree3f = jst._free3(jnp.asarray(fixed)).reshape(-1)
    aug0 = rng.normal(size=(P, n3))
    pa = 0.1 * rng.normal(size=(P, n3))
    Wa0 = jst.w_matvec(jwv, jfree3f, jnp.asarray(aug0))
    Wpa = jst.w_matvec(jwv, jfree3f, jnp.asarray(pa))
    want = np.stack([
        np.asarray(0.5 * jnp.sum(aug0 * Wa0, axis=1)),
        np.asarray(0.5 * (jnp.sum(pa * Wa0, axis=1)
                          + jnp.sum(aug0 * Wpa, axis=1))),
        np.asarray(0.5 * jnp.sum(pa * Wpa, axis=1))])
    wv = torch.as_tensor(np.array(jwv))
    free3f = tst._free3(torch.as_tensor(fixed)).reshape(-1)
    args = (wv, free3f, torch.as_tensor(aug0.reshape(-1)),
            torch.as_tensor(pa.reshape(-1)), tst.wp, P)
    got = kadmm.w_quad_ref(*args)
    assert got.shape == (3, P) and np.abs(want).min() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    assert torch.equal(ops.w_quad(*args), got)
    odd = next(k for k in range(2, 64) if (P * n3) % k)
    with pytest.raises(ValueError, match="parts"):
        ops.w_quad(*args[:5], odd)


def test_local_factor_is_the_exact_scan(banded):
    """The banded local factor is the exact block scan (a BTDFactor in the
    solve dtype), never cyclic reduction, and solve_local takes it."""
    _, _, sd, _, _, tst = banded
    sys_ = tst.system
    fixed = torch.as_tensor(sd.fixed0)
    x = torch.as_tensor(_moved(sd, 5))
    _, wv, _, _ = tst.update_weights(x, fixed)
    wpack = (wv, tst._free3(fixed).reshape(-1))
    valid = sys_.local_valid[..., None]
    xl_flat = tst._to_flat(x[sys_.l2g] * valid)
    L, d = tst._local_h_factor(xl_flat, wpack, fixed)
    assert isinstance(L, BTDFactor) and L.linv.dtype == torch.float64
    assert L.linv.shape == (sys_.band_nb, sys_.n_parts, sys_.band_bs,
                            sys_.band_bs)
    # against the dense factor of the same matrix
    eh = sys_.k.elem_hessian(xl_flat, tst.conn_local, sys_.g9, sys_.u_e,
                             sys_.lam_e, sys_.vol_w, sys_.mat, sys_.dt_sq)
    flat = sys_.assemble_own_btd_flat(eh, fixed, tst.mass_local, wpack[0],
                                      wpack[1], tst.wp)
    P, bs, nb = sys_.n_parts, sys_.band_bs, sys_.band_nb
    dg = flat[:P * nb * bs * bs].view(nb, P, bs, bs)
    sb = flat[P * nb * bs * bs:].view(nb - 1, P, bs, bs)
    H = torch.zeros((P, nb * bs, nb * bs), dtype=torch.float64)
    for k in range(nb):
        H[:, k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] = dg[k]
        if k + 1 < nb:
            H[:, (k + 1) * bs:(k + 2) * bs, k * bs:(k + 1) * bs] = sb[k]
    H = torch.tril(H) + torch.tril(H, -1).mT
    r = torch.as_tensor(np.random.default_rng(8).normal(size=(P, nb * bs)))
    got = sys_.solve_local(L, r / d) / d
    want = torch.linalg.solve(H, r[..., None])[..., 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8,
                               atol=1e-10)


def _dot_result(mesh, cfg, sd, n_parts, frames):
    plan = jpartition.build_plan(mesh, n_parts, **SMALL)
    st = tsteppers.DOTStepper(convert.system_from_plan(mesh, cfg, plan), sd)
    s = st.init_state()
    for _ in range(frames):
        s, (_, sys_e) = st.step(s)
    return s.x.numpy().copy(), sys_e


@pytest.mark.parametrize("which", ["dense", "banded"])
def test_stepper_matches_dot_tpu_from_one_state(which, request):
    mesh, cfg, sd, _, jst, tst = request.getfixturevalue(which)
    frames = 3 if which == "dense" else 2
    js = jst.init_state()
    # copy before stepping: dot_tpu donates its state buffers
    ts = convert.admm_dd_state_from_numpy(jax.tree.map(np.array, js),
                                          tst.system)
    tol = tst.system.target_g_res(1e-5)
    for _ in range(frames):
        js, (jstats, je) = jst.step(js, rel_tol=1e-5)
        ts, (tstats, te) = tst.step(ts, rel_tol=1e-5)
        assert tstats.inner_iters == int(jstats.inner_iters) > 0
        assert tstats.stop == "tol" and tstats.sqn_g <= tol
        assert tstats.syncs > tstats.inner_iters
        jrows = np.asarray(jstats.rows)[:tstats.inner_iters + 1]
        np.testing.assert_allclose(np.asarray(tstats.rows), jrows, rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(te, float(je), rtol=1e-9)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(ts.w_vals.numpy(), np.asarray(js.w_vals),
                               rtol=1e-6, atol=1e-8)
    x_dot, e_dot = _dot_result(mesh, cfg, sd, tst.system.n_parts, frames)
    np.testing.assert_allclose(te, e_dot, rtol=1e-3)
    assert float(np.abs(ts.x.numpy() - x_dot).max()) < 2e-3


def test_banded_local_factor_gives_the_dense_trajectory(banded):
    mesh, cfg, sd, _, _, tb = banded
    plan = jpartition.build_plan(mesh, 3, own_plan=True, banded=False,
                                 **SMALL)
    td = tsteppers.ADMMDDStepper(
        convert.system_from_plan(mesh, cfg, plan), sd,
        jpartition.build_admm_dd_plan(mesh, plan))
    assert not td.banded_local and tb.banded_local
    sb, sd_ = tb.init_state(), td.init_state()
    for _ in range(2):
        sb, (st_b, e_b) = tb.step(sb)
        sd_, (st_d, e_d) = td.step(sd_)
        assert st_b.inner_iters == st_d.inner_iters
    np.testing.assert_allclose(e_b, e_d, rtol=1e-9)
    np.testing.assert_allclose(sb.x.numpy(), sd_.x.numpy(), rtol=1e-7,
                               atol=1e-8)


SCENE = """energy FCR
timeStepper ADMMDD 4
warmStart 2
time 5 0.025
density 1000
stiffness 100000 0.4
script twist
handleRatio 0.05
inexactSolve 1
h0Refresh 2
shape input {mesh}
"""


def test_simulator_runs_admmdd_scene_on_the_cpu(tmp_path):
    mesh = bar_mesh(8, 3, 3)
    mp = tmp_path / "bar.msh"
    meshio.save_tet_mesh(str(mp), mesh.V, mesh.conn, mesh.SF)
    sp = tmp_path / "scene.txt"
    sp.write_text(SCENE.format(mesh=mp))
    sim, _ = run_script(str(sp), frames=2, output_root=str(tmp_path / "out"),
                        dtype="f64", device="cpu", mute=True)
    assert type(sim.stepper).__name__ == "ADMMDDStepper"
    assert sim.system.n_parts == 4 and sim.system.plan.n_own > 0
    assert os.path.basename(sim.out) == "bar_twist_FCR_ADMMDD4"
    files = set(os.listdir(sim.out))
    need = {"config.txt", "iterStats.txt", "log.txt", "info.txt",
            "finalResult_mesh.msh", "status2", "2.obj", "label.obj"}
    assert need <= files, need - files
    for r in sim.frames:
        assert np.isfinite(r["sys_e"]) and r["stop"] == "tol"
    assert torch.isfinite(sim.state.x).all()
