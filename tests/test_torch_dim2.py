"""The port's 2D core (dot_tpu_torch.dim2) against dot_tpu.dim2 on the CPU,
f64: Mesh2D, System2D's whole-mesh part function by function, the slice as
a whole (3 frames of the spikes stretch scene under Newton against the
recorded golden sysE and against dot_tpu's own Newton2DStepper), Sharkey,
and the 2D entry points (Sim2D, run_script_2d, the CLI's dispatch) with
their output contract and refusals.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dot_tpu import dim2 as jdim2
from dot_tpu import scripts as jscripts
from dot_tpu.config import Config as JConfig
from dot_tpu_torch import dim2, scripts
from dot_tpu_torch.__main__ import main as cli_main
from dot_tpu_torch.config import Config
from dot_tpu_torch.convert import sim2d_state_from_numpy
from dot_tpu_torch.kernels import ops
from dot_tpu_torch.sim import parse_status

# tests/test_dim2.py:241-245 (spikes / stretch / FCR / dt 0.025 / E 1e5 /
# nu 0.4 / rho 1000 / resolution 200 / relTol 1e-5, CPU f64)
GOLDEN_2D_SPIKES_SYS_E = [
    3.294256031942e+03,
    3.294256605060e+03,
    3.300416677680e+03,
]
KW = dict(energy="FCR", time_stepper="Newton", dt=0.025, rho=1000.0, ym=1e5,
          pr=0.4, script="stretch", handle_ratio=0.03, resolution=200)
MESH_FIELDS = ("V", "V_rest", "conn", "SF", "rest_tri_inv", "area", "mass",
               "u", "lam", "fixed_mask")


def _pair(shape, energy="FCR"):
    """(dot_tpu stepper, port stepper) on the same scene."""
    kw = dict(KW, shape=shape, energy=energy)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jmesh = jdim2.Mesh2D.from_config(jcfg)
    jsd = jscripts.init_script(jmesh, jcfg.script)
    jmesh.fixed_mask = jsd.fixed0.copy()
    jst = jdim2.Newton2DStepper(
        jdim2.System2D(jmesh, jcfg, dtype=jnp.float64), jsd)
    mesh = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(mesh, cfg.script)
    mesh.fixed_mask = sd.fixed0.copy()
    st = dim2.Newton2DStepper(dim2.System2D(mesh, cfg, device="cpu"), sd)
    return jst, st


@pytest.fixture(scope="module")
def spikes():
    return _pair("spikes")


@pytest.fixture(scope="module")
def sharkey():
    return _pair("Sharkey")


@pytest.fixture(scope="module")
def deformed(spikes):
    """A deformed state of the spikes scene: positions, predictor, mask."""
    jst, st = spikes
    rng = np.random.default_rng(20261016)
    nv = st.system.n_vert
    x = np.asarray(st.script_data.x0, np.float64).copy()
    x[:, :2] += 0.01 * rng.normal(size=(nv, 2))
    xt = x.copy()
    xt[:, :2] += 0.005 * rng.normal(size=(nv, 2))
    fixed = np.asarray(st.script_data.fixed0)
    return x, xt, fixed


@pytest.mark.parametrize("shape", ["spikes", "Sharkey"])
def test_mesh2d_fields_equal_dot_tpu(shape, request):
    jst, st = request.getfixturevalue(shape.lower())
    jm, m = jst.system.mesh, st.system.mesh
    assert (m.n_vert, m.n_elem) == (jm.n_vert, jm.n_elem)
    for f in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(m, f), getattr(jm, f), f)
    assert m.sqnorm_face_area_sums == jm.sqnorm_face_area_sums
    for a, b in zip(m.border_verts, jm.border_verts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(m.bbox, jm.bbox)
    assert dim2.is_2d_shape(shape) and not dim2.is_2d_shape("input")


def test_energy_and_sigma(spikes, deformed):
    (jst, st), (x, xt, fixed) = spikes, deformed
    js, ts = jst.system, st.system
    f, U, s, V = js.fsvd(jnp.asarray(x))
    tx, txt = torch.as_tensor(x), torch.as_tensor(xt)
    F = ts.defgrad(tx)
    np.testing.assert_allclose(F.numpy(), np.stack([np.asarray(a) for a in f]),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(ts.sigma(F).numpy(),
                               np.stack([np.asarray(a) for a in s]),
                               rtol=1e-12)
    e_j = float(js.energy(jnp.asarray(x), jnp.asarray(xt), s))
    assert float(ts.energy(tx, txt, F)) == pytest.approx(e_j, rel=1e-12)
    assert float(ts.elastic_energy(F)) == pytest.approx(
        float(js.elastic_energy_sigma(s)), rel=1e-12)
    c = ts.inertia_quad(tx, tx - txt, txt)
    cj = js.inertia_quad(jnp.asarray(x), jnp.asarray(x - xt), jnp.asarray(xt))
    np.testing.assert_allclose([float(v) for v in c], [float(v) for v in cj],
                               rtol=1e-12)


def test_gradient(spikes, deformed):
    (jst, st), (x, xt, fixed) = spikes, deformed
    js, ts = jst.system, st.system
    f, U, s, V = js.fsvd(jnp.asarray(x))
    gj = np.asarray(js.gradient(jnp.asarray(x), jnp.asarray(xt),
                                jnp.asarray(fixed), f, U, s, V))
    gt = ts.gradient(torch.as_tensor(x), torch.as_tensor(xt),
                     torch.as_tensor(fixed)).numpy()
    np.testing.assert_allclose(gt, gj, rtol=1e-10,
                               atol=1e-10 * np.abs(gj).max())
    assert (gt[:, 2] == 0).all() and (gt[fixed] == 0).all()
    assert np.abs(gt[~fixed]).max() > 0


def test_factorize_and_solve(spikes, deformed):
    (jst, st), (x, xt, fixed) = spikes, deformed
    js, ts = jst.system, st.system
    Lj, dj = js.factorize(jnp.asarray(x), jnp.asarray(fixed))
    Lt, dt_ = ts.factorize(torch.as_tensor(x), torch.as_tensor(fixed))
    Lj, dj = np.asarray(Lj), np.asarray(dj)
    np.testing.assert_allclose(dt_.numpy(), dj, rtol=1e-12)
    # the matrix the factor stands for, rescaled: d L L^T d
    Hj = dj[:, None] * (Lj @ Lj.T) * dj[None, :]
    Ht = dt_[:, None] * (Lt @ Lt.T) * dt_[None, :]
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=1e-10,
                               atol=1e-10 * np.abs(Hj).max())
    fx = np.repeat(fixed, 2)
    np.testing.assert_allclose(Ht.numpy()[fx][:, fx], np.eye(fx.sum()),
                               atol=1e-12)
    rng = np.random.default_rng(5)
    g = np.concatenate([rng.normal(size=(ts.n_vert, 2)),
                        np.zeros((ts.n_vert, 1))], axis=1)
    pj = np.asarray(js.solve(jnp.asarray(Lj), jnp.asarray(dj), jnp.asarray(g)))
    pt = ts.solve(Lt, dt_, torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-9, atol=1e-10 * np.abs(pj).max())
    assert (pt[:, 2] == 0).all()


def test_factorize_failure_is_nan(spikes):
    """A matrix that is not positive definite comes back NaN (jnp's
    Cholesky; the NaN-safe line search then stops the step)."""
    _, st = spikes
    ts = st.system
    x = torch.as_tensor(st.script_data.x0).clone()
    x[:, :2] = float("nan")
    L, _ = ts.factorize(x, torch.as_tensor(st.script_data.fixed0))
    assert torch.isnan(L).all()


def _library_factor(sysm, x, fixed):
    """System2D.factorize's factor as the library gave it before K34:
    cholesky_ex on the scaled matrix, NaN added where it failed."""
    H, d = sysm.k.dense_assemble2d(sysm.element_hessians(x),
                                   sysm._free(fixed), sysm.mass,
                                   sysm.dense_tab)
    Hn = sysm.k.dense_scale2d(H, d, sysm.dense_tab)
    L, info = torch.linalg.cholesky_ex(Hn)
    return L.add_(torch.where(info != 0, torch.nan, 0.0).to(L.dtype)), d


@pytest.mark.parametrize("case", ["deformed", "failing"])
def test_whole_mesh_factorize_goes_through_k34s_wrapper(spikes, deformed,
                                                        monkeypatch, case):
    """System2D(whole_mesh=True).factorize calls ops.whole_chol once and,
    on the CPU in f64, gives the library's factor bit for bit (all NaN
    where the factorization fails)."""
    (_, st), (x, _, fixed) = spikes, deformed
    ts = st.system
    sysm = dim2.System2D(ts.mesh, ts.cfg, device="cpu", whole_mesh=True)
    tx, tf = torch.as_tensor(x), torch.as_tensor(fixed)
    if case == "failing":
        tx = tx.clone()
        tx[:, :2] = float("nan")
    calls = []
    real = ops.whole_chol
    monkeypatch.setattr(ops, "whole_chol",
                        lambda A: calls.append(A.shape) or real(A))
    L, d = sysm.factorize(tx, tf)
    assert calls == [(sysm.n2, sysm.n2)]
    L0, d0 = _library_factor(sysm, tx, tf)
    torch.testing.assert_close(d, d0, rtol=0, atol=0, equal_nan=True)
    if case == "failing":
        assert torch.isnan(L).all() and torch.isnan(L0).all()
    else:
        assert torch.equal(L, L0)


@pytest.mark.parametrize("shape,dtype,error", [
    ((2, 6, 6), torch.float64, ValueError),
    ((6, 5), torch.float64, ValueError),
    ((6,), torch.float32, ValueError),
    ((6, 6), torch.float16, TypeError),
    ((6, 6), torch.int32, TypeError)])
def test_whole_chol_refuses_bad_shapes_and_dtypes(shape, dtype, error):
    with pytest.raises(error, match="whole_chol"):
        ops.whole_chol(torch.zeros(shape, dtype=dtype))


@pytest.mark.parametrize("n", [7, 128, 129, 640, 1000, 20342])
def test_whole_chol_order_deals_what_a_pair_reads_first(n):
    """K34's dealing order: every tile (I, J), J <= I, is written by one
    pair, and every tile a pair reads ((J, K), (I0, K), (I0 + 1, K) for
    K < J, and (J, J) below the diagonal) by a pair dealt before it."""
    from dot_tpu_torch.kernels import dd2d
    order = dd2d.whole_chol_order(n)
    nt = -(-n // dd2d.WHOLE_TILE)
    rank = {}
    for q, code in enumerate(order.tolist()):
        J, I0 = code >> 16, code & 0xffff
        assert J <= I0 < nt and (I0 - J) % 2 == 0
        for i in range(I0, min(I0 + 2, nt)):
            assert (i, J) not in rank
            rank[i, J] = q
    assert len(rank) == nt * (nt + 1) // 2
    for q, code in enumerate(order.tolist()):
        J, I0 = code >> 16, code & 0xffff
        reads = [(r, K) for K in range(J)
                 for r in (J, I0, I0 + 1) if r < nt]
        if I0 != J:
            reads.append((J, J))
        assert all(rank[t] < q for t in reads), (J, I0)


def test_target_g_res_and_tolerance_pieces(spikes):
    jst, st = spikes
    assert st.system._sqnorm_H_rest == pytest.approx(
        jst.system._sqnorm_H_rest, rel=1e-12)
    for rel in (1e-5, 1e-3):
        assert st.system.target_g_res(rel) == pytest.approx(
            jst.system.target_g_res(rel), rel=1e-12)


@pytest.mark.parametrize("energy", ["SNH", "SNHWL"])
def test_tolerance_pieces_other_materials(energy):
    jst, st = _pair("spikes", energy)
    assert st.system._sqnorm_H_rest == pytest.approx(
        jst.system._sqnorm_H_rest, rel=1e-12)


@pytest.mark.parametrize("option", [0, 1, 2, 3, 4])
def test_warm_start(spikes, deformed, option):
    (jst, st), (x, xt, fixed) = spikes, deformed
    rng = np.random.default_rng(option)
    v, dxe = rng.normal(size=(2,) + x.shape)
    wj = jst.system.warm_start(option, jnp.asarray(x), jnp.asarray(v),
                               jnp.asarray(dxe), jnp.asarray(fixed))
    wt = st.system.warm_start(option, torch.as_tensor(x), torch.as_tensor(v),
                              torch.as_tensor(dxe), torch.as_tensor(fixed))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-14)


def test_warm_start_5_is_refused(spikes, deformed):
    (jst, st), (x, xt, fixed) = spikes, deformed
    t = torch.as_tensor(x)
    with pytest.raises(NotImplementedError, match="2D"):
        st.system.warm_start(5, t, t, t, torch.as_tensor(fixed))
    with pytest.raises(NotImplementedError, match="2D"):
        jst.system.warm_start(5, jnp.asarray(x), jnp.asarray(x),
                              jnp.asarray(x), jnp.asarray(fixed))


def test_system_energy_and_x_tilta(spikes, deformed):
    (jst, st), (x, xt, fixed) = spikes, deformed
    js, ts = jst.system, st.system
    _, _, s, _ = js.fsvd(jnp.asarray(x))
    ej = float(js.system_energy(jnp.asarray(x), jnp.asarray(xt), s))
    tx = torch.as_tensor(x)
    et = ts.system_energy(tx, torch.as_tensor(xt), ts.sigma(ts.defgrad(tx)))
    assert et.dtype == torch.float64
    assert float(et) == pytest.approx(ej, rel=1e-12)
    # f64 accumulation whatever the field dtype
    s32 = dim2.System2D(ts.mesh, ts.cfg, dtype=torch.float32, device="cpu")
    x32 = tx.to(torch.float32)
    e32 = s32.system_energy(x32, torch.as_tensor(xt, dtype=torch.float32),
                            s32.sigma(s32.defgrad(x32)))
    assert e32.dtype == torch.float64
    assert float(e32) == pytest.approx(ej, rel=1e-4)
    rng = np.random.default_rng(9)
    v = rng.normal(size=x.shape)
    np.testing.assert_allclose(
        ts.compute_x_tilta(tx, torch.as_tensor(v),
                           torch.as_tensor(fixed)).numpy(),
        np.asarray(js.compute_x_tilta(jnp.asarray(x), jnp.asarray(v),
                                      jnp.asarray(fixed))), rtol=1e-14)


def test_state_round_trip(spikes):
    jst, st = spikes
    js0 = jst.init_state()
    ts0 = sim2d_state_from_numpy(js0, st.system)
    own = st.init_state()
    for f in ("x", "x_n", "v", "x_tilta", "dx_elastic", "fixed", "vel_sign",
              "released"):
        a, b = getattr(ts0, f), getattr(own, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(js0, f)))
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.fixture(scope="module")
def three_frames(spikes):
    """3 frames of both steppers from the same initial state."""
    jst, st = spikes
    js = jst.init_state()
    ts = sim2d_state_from_numpy(js, st.system)
    rows = []
    for _ in range(3):
        js, (jstats, je) = jst.step(js, 1e-5)
        ts, (tstats, te) = st.step(ts, 1e-5)
        rows.append(dict(
            xj=np.asarray(js.x).copy(), xt=ts.x.numpy().copy(),
            itj=int(jstats.inner_iters), itt=tstats.inner_iters,
            lsj=int(jstats.ls_halvings), lst=tstats.ls_halvings,
            ej=float(je), et=te, stats=tstats,
            vj=np.asarray(js.v).copy(), vt=ts.v.numpy().copy()))
    return rows


def test_newton2d_matches_golden(three_frames):
    vals = [r["et"] for r in three_frames]
    assert np.isfinite(vals).all()
    np.testing.assert_allclose(vals, GOLDEN_2D_SPIKES_SYS_E, rtol=2e-4)
    for r in three_frames:
        assert r["itt"] > 0 and r["stats"].stop in ("tol", "rel_dec")
        # one host read at the start, two an iteration (a trial, the new
        # gradient), one for sysE
        assert r["stats"].syncs == 2 + 2 * r["itt"] + r["lst"]


def test_newton2d_matches_dot_tpu(three_frames):
    for r in three_frames:
        assert (r["itt"], r["lst"]) == (r["itj"], r["lsj"])
        np.testing.assert_allclose(r["xt"], r["xj"], rtol=1e-7, atol=1e-12)
        np.testing.assert_allclose(r["vt"], r["vj"], rtol=1e-5, atol=1e-9)
        assert r["et"] == pytest.approx(r["ej"], rel=1e-9)
        assert (r["xt"][:, 2] == 0).all()


def test_sharkey_runs_and_z_stays_zero(sharkey):
    jst, st = sharkey
    s = st.init_state()
    for _ in range(2):
        s, (stats, sys_e) = st.step(s, 1e-5)
        assert stats.inner_iters > 0 and np.isfinite(sys_e)
    x = s.x.numpy()
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x[:, 2], 0.0, atol=1e-14)
    m = st.system.mesh
    assert x[m.border_verts[1], 0].mean() > m.V_rest[m.border_verts[1],
                                                     0].mean()


def test_plain_namespace_is_the_cpu_route(spikes, deformed):
    """On CPU tensors the wrappers take their plain versions and count no
    launch; System2D(use_kernels=False) gives the same numbers."""
    (jst, st), (x, xt, fixed) = spikes, deformed
    ts = st.system
    plain = dim2.System2D(ts.mesh, ts.cfg, device="cpu", use_kernels=False)
    ops.reset_launches()
    tx, txt, tf = (torch.as_tensor(a) for a in (x, xt, fixed))
    assert torch.equal(ts.gradient(tx, txt, tf), plain.gradient(tx, txt, tf))
    (La, da), (Lb, db) = ts.factorize(tx, tf), plain.factorize(tx, tf)
    assert torch.equal(La, Lb) and torch.equal(da, db)
    assert not any(ops.launches.values())
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ops.defgrad2d(tx.to("meta"), ts.conn.to("meta"), ts.g4.to("meta"))


SCENE_2D = """energy FCR
timeStepper {stepper}
warmStart {warm}
resolution 200
size 1
time 5 0.025
density 1000
stiffness 100000 0.4
script stretch
handleRatio 0.03
shape spikes
{extra}"""


def _scene(tmp_path, stepper="Newton", warm=2, extra=""):
    sp = tmp_path / "spikes.txt"
    sp.write_text(SCENE_2D.format(stepper=stepper, warm=warm, extra=extra))
    return str(sp)


def _check_contract(sim, frames):
    files = set(os.listdir(sim.out))
    need = {"config.txt", "iterStats.txt", "log.txt", "info.txt"} | {
        f"status{i}" for i in range(frames + 1)} | {
        f"{i}.obj" for i in range(frames + 1)}
    assert need <= files, need - files
    assert not any(f.endswith(".msh") for f in files)
    log = open(os.path.join(sim.out, "log.txt")).read()
    sys_e = [float(ln.split("=")[1]) for ln in log.splitlines()
             if ln.startswith("sysE = ")]
    np.testing.assert_allclose(sys_e, GOLDEN_2D_SPIKES_SYS_E[:frames],
                               rtol=2e-4)
    assert log.count("th tol: ") == frames
    x, v, dxe, frame = parse_status(os.path.join(sim.out, f"status{frames}"))
    assert frame == frames and x.shape == (sim.mesh.n_vert, 3)
    np.testing.assert_allclose(x, sim.state.x.numpy(), rtol=1e-6, atol=1e-9)
    obj = open(os.path.join(sim.out, f"{frames}.obj")).read().splitlines()
    assert sum(ln.startswith("v ") for ln in obj) == sim.mesh.n_vert
    assert sum(ln.startswith("f ") for ln in obj) == sim.mesh.n_elem
    info = open(os.path.join(sim.out, "info.txt")).read()
    assert f"vertAmt {sim.mesh.n_vert}" in info and "innerIterTotal" in info
    cfg = Config.load(os.path.join(sim.out, "config.txt"))
    assert cfg.shape == "spikes" and cfg.time_stepper == "Newton"


def test_run_script_2d_writes_output_contract(tmp_path):
    sim, spf = dim2.run_script_2d(_scene(tmp_path), frames=2,
                                  output_root=str(tmp_path / "out"),
                                  dtype="f64", device="cpu", mute=True)
    assert isinstance(sim, dim2.Sim2D) and sim.frame == 2 and spf > 0
    assert type(sim.stepper).__name__ == "Newton2DStepper"
    assert sim.system.dtype == torch.float64
    assert os.path.basename(sim.out) == "spikes_stretch_FCR_Newton"
    _check_contract(sim, 2)
    rows = open(os.path.join(sim.out, "iterStats.txt")).read().splitlines()
    assert len(rows) == sum(r["iters"] + 1 for r in sim.frames)


def test_cli_dispatches_on_2d_shape(tmp_path, capsys):
    cli_main(["100", _scene(tmp_path), "cli", "--frames", "1", "--dtype",
              "f64", "--device", "cpu", "--output-root",
              str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert "done: 1/200 2D frames" in out
    run_dir = tmp_path / "out" / "spikes_stretch_FCR_Newton_cli"
    assert (run_dir / "1.obj").exists() and (run_dir / "status1").exists()
    assert not (run_dir / "finalResult_mesh.msh").exists()


def test_2d_entry_points_need_a_card_unless_cpu_is_asked(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = _scene(tmp_path)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA"):
        dim2.Sim2D(Config.load(scene), out, mute=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        dim2.run_script_2d(scene, frames=1, output_root=out, mute=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["100", scene, "--frames", "1", "--output-root", out])
    sim = dim2.Sim2D(Config.load(scene), out, device="cpu", mute=True)
    assert sim.device.type == "cpu" and sim.system.dtype == torch.float64


@pytest.mark.parametrize("stepper,extra", [
    ("Newton", "restart status0"), ("DOT 4", "restart status0")])
def test_unported_2d_configurations_raise(tmp_path, stepper, extra):
    """Restart at dim 2 (every 2D stepper runs:
    tests/test_torch_dim2_steppers.py, test_torch_admm2d.py,
    test_torch_admmdd2d.py)."""
    cfg = Config.load(_scene(tmp_path, stepper, extra=extra))
    with pytest.raises(NotImplementedError, match="not ported .* yet"):
        dim2.Sim2D(cfg, str(tmp_path / "out"), device="cpu", mute=True)


def test_2d_warm_start_5_is_refused_by_the_run(tmp_path):
    sim = dim2.Sim2D(Config.load(_scene(tmp_path, warm=5)),
                     str(tmp_path / "out"), device="cpu", mute=True)
    with pytest.raises(NotImplementedError, match="warmStart 5"):
        sim.run(1)
