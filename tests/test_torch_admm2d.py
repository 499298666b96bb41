"""The port's 2D ADMM-PD (dim2.ADMMPD2D) against dot_tpu's on the CPU,
float64, the port on the plain versions of K29 and K30.

Per function, on the same numpy inputs made from a seed (the spikes stretch
scene at resolution 200):
- solve_sym2 against dot_tpu's _solve_sym2 (the same operations: equal);
- the per-triangle local step (K29's plain version against
  ADMMPD2D._local_step, FCR, SNH and SNHWL) on random, inverted and
  near-degenerate deformation gradients and duals: z and du at rtol
  1e-12; the loop counts it reports;
- the matrix-free (M + D^T W D) x and the rhs scatter (K30's plain version
  against _apply_A / _scatter and the rhs of admm.py:288-297) at 1e-12.
As a whole: three frames from dot_tpu's initial state give dot_tpu's
positions at rtol 1e-7 with equal iteration counts, and the recorded 2D
golden sysE (tests/test_dim2.py:381-405) at 2e-4 with z = 0. Through the
entry points: Sim2D builds ADMMPD2D with the scene's maxIter, run_script_2d
and the CLI write the output contract with dot_tpu's info.txt, and the
2D ADMM scenes raise without a card unless the CPU is asked for.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dot_tpu import dim2 as jdim2
from dot_tpu import scripts as jscripts
from dot_tpu.config import Config as JConfig
from dot_tpu.steppers.admm import _solve_sym2 as j_solve_sym2
from dot_tpu_torch import convert, dim2, scripts
from dot_tpu_torch.__main__ import main as cli_main
from dot_tpu_torch.config import Config
from dot_tpu_torch.kernels import admm2d, ops, soa2d

GOLDEN_2D_SPIKES_SYS_E = [
    3.294256031942e+03,
    3.294256605060e+03,
    3.300416677680e+03,
]
KW = dict(time_stepper="ADMM", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
          script="stretch", handle_ratio=0.03, shape="spikes",
          resolution=200)
EXACT = 1e-12
SCENE_2D = """energy FCR
timeStepper {stepper}
warmStart 2
resolution 200
size 1
time 5 0.025
density 1000
stiffness 100000 0.4
script stretch
handleRatio 0.03
shape spikes
"""


def _pair(energy="FCR"):
    """Both packages' 2D ADMM-PD steppers on the spikes scene."""
    jcfg, cfg = JConfig(energy=energy, **KW), Config(energy=energy, **KW)
    jm = jdim2.Mesh2D.from_config(jcfg)
    jsd = jscripts.init_script(jm, jcfg.script)
    jm.fixed_mask = jsd.fixed0.copy()
    m = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(m, cfg.script)
    m.fixed_mask = sd.fixed0.copy()
    jst = jdim2.ADMMPD2D(jdim2.System2D(jm, jcfg, dtype=jnp.float64), jsd,
                         max_iter=1000)
    tst = dim2.ADMMPD2D(dim2.System2D(m, cfg, device="cpu"), sd,
                        max_iter=1000)
    return jst, tst


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _local_inputs(n, seed):
    """(Dx, u), each (4, n): random deformation gradients around the
    identity, a quarter inverted (one column negated), a quarter with equal
    singular values or one close to zero, and duals of mixed size."""
    rng = np.random.default_rng(seed)
    F = np.eye(2)[None] + 0.3 * rng.normal(size=(n, 2, 2))
    q = n // 4
    F[:q, :, 0] *= -1.0                                   # inverted
    th = rng.uniform(0, 2 * np.pi, size=(q, 2))
    rot = [np.stack([np.stack([np.cos(t), -np.sin(t)], -1),
                     np.stack([np.sin(t), np.cos(t)], -1)], -2)
           for t in th.T]
    sig = np.stack([np.full(q, 1.2),
                    np.where(np.arange(q) % 2 == 0, 1e-7, 1.2)], axis=1)
    F[q:2 * q] = rot[0] * sig[:, None, :] @ np.swapaxes(rot[1], 1, 2)
    u = 0.1 * rng.normal(size=(n, 2, 2))
    u[::3] = 0.0
    return F.reshape(n, 4).T.copy(), u.reshape(n, 4).T.copy()


def test_solve_sym2_is_dot_tpus():
    rng = np.random.default_rng(3)
    a, c = 1.0 + rng.uniform(size=(2, 64))
    b = 0.5 * rng.uniform(-1, 1, size=64)
    g = rng.normal(size=(2, 64))
    want = j_solve_sym2(tuple(jnp.asarray(v) for v in (a, b, c)),
                        tuple(jnp.asarray(v) for v in g))
    got = admm2d.solve_sym2(tuple(torch.as_tensor(v) for v in (a, b, c)),
                            tuple(torch.as_tensor(v) for v in g))
    for w_, g_ in zip(want, got):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-15)
    h = np.stack([np.stack([a, b]), np.stack([b, c])])     # (2, 2, 64)
    x = np.stack([v.numpy() for v in got])
    np.testing.assert_allclose(np.einsum("ijn,jn->in", h, x), g, atol=1e-12)


@pytest.mark.parametrize("energy", ["FCR", "SNH", "SNHWL"])
def test_local_step_matches_dot_tpu(energy, pair):
    jst, tst = pair if energy == "FCR" else _pair(energy)
    n = tst.system.n_elem
    np.testing.assert_allclose(tst.w_e.numpy(), np.asarray(jst.w_e),
                               rtol=1e-15)
    Dx, u = _local_inputs(n, 5)
    jz, jdu = jax.jit(jst._local_step)(tuple(jnp.asarray(Dx)),
                                       tuple(jnp.asarray(u)))
    tz, tdu = tst._local_step(torch.as_tensor(Dx), torch.as_tensor(u))
    np.testing.assert_allclose(tz.numpy(), np.stack(jz), rtol=EXACT,
                               atol=EXACT)
    np.testing.assert_allclose(tdu.numpy(), np.stack(jdu), rtol=EXACT,
                               atol=EXACT)
    assert float(np.abs(tz.numpy() - (Dx + u)).max()) > 1e-3


def test_local_step_counts_and_objective(pair):
    """The (2, N) loop counts do not change z or du; every triangle took a
    Newton iteration and at least two energy evaluations; the returned
    sigma does not raise its local objective."""
    _, tst = pair
    sys = tst.system
    Dx, u = (torch.as_tensor(a) for a in _local_inputs(sys.n_elem, 9))
    args = (Dx, u, tst.w_e, tst.vol_dtsq, sys.u_e, sys.lam_e, sys.mat)
    z, du, counts = admm2d.admm_local_step2d_ref(*args, want_counts=True)
    z0, du0 = ops.admm_local_step2d(*args)
    assert torch.equal(z, z0) and torch.equal(du, du0)
    assert counts.dtype == torch.int32
    assert tuple(counts.shape) == (2, Dx.shape[1])
    assert int(counts[0].min()) >= 1
    assert bool((counts[1] >= counts[0] + 1).all())
    assert int(counts[0].max()) <= admm2d.LOCAL_MAX_ITER
    np.testing.assert_allclose((Dx - z).numpy(), du.numpy(), atol=1e-12)
    _, s_hat, _ = soa2d.svd2_flip_soa(tuple(Dx + u))
    _, s, _ = soa2d.svd2_flip_soa(tuple(z))

    def energy(sv):
        d = sum((s_hat[i] - sv[i]) ** 2 for i in range(2))
        return sys.mat.psi(sv, sys.u_e, sys.lam_e) * tst.vol_dtsq \
            + 0.5 * tst.w_e * d
    assert bool((energy(s) <= energy(s_hat) + 1e-12).all())


@pytest.mark.parametrize("epilogue", ["apply_A", "rhs"])
def test_dtw_scatter_matches_dot_tpu(epilogue, pair):
    jst, tst = pair
    sys = tst.system
    rng = np.random.default_rng(11)
    nv, n = sys.n_vert, sys.n_elem
    x = np.asarray(sys.mesh.V) + np.concatenate(
        [0.01 * rng.normal(size=(nv, 2)), np.zeros((nv, 1))], axis=1)
    xt = torch.as_tensor(x)
    if epilogue == "apply_A":
        want = np.asarray(jst._apply_A(jnp.asarray(x)))
        got = tst._apply_A(xt)
    else:
        M = rng.normal(size=(4, n))
        base = rng.normal(size=(nv, 3))
        off = rng.normal(size=(nv, 3))
        base[:, 2] = off[:, 2] = 0.0
        free = (rng.uniform(size=nv) > 0.1).astype(np.float64)
        Dr = jst._D_rows()
        w = jst.w_e
        Mj = jnp.asarray(M)
        ge = [[sum(Dr[c][j] * (w * Mj[2 * i + j]) for j in range(2))
               for i in range(2)] for c in range(3)]
        fr = jnp.asarray(free)[:, None]
        want = np.asarray((jnp.asarray(base) + jst._scatter(ge)
                           - jnp.asarray(off)) * fr
                          + jnp.asarray(x) * (1.0 - fr))
        got = tst._scatter(torch.as_tensor(M), xt,
                           base=torch.as_tensor(base),
                           offset=torch.as_tensor(off),
                           free=torch.as_tensor(free))
    np.testing.assert_allclose(got.numpy(), want, rtol=EXACT,
                               atol=EXACT * np.abs(want).max())
    assert (got[:, 2] == 0).all()


_frames = {}


def _three_frames(pair):
    if "rows" not in _frames:
        jst, tst = pair
        js = jst.init_state()
        ts = convert.admm_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, js), tst.system)
        rows = []
        for _ in range(3):
            js, (jstats, je) = jst.step(js, 1e-5)
            ts, (tstats, te) = tst.step(ts, 1e-5)
            rows.append(dict(xj=np.asarray(js.x).copy(),
                             xt=ts.x.numpy().copy(),
                             itj=int(jstats.inner_iters),
                             itt=tstats.inner_iters, ej=float(je), et=te,
                             stop=tstats.stop))
        _frames["rows"] = rows
    return _frames["rows"]


def test_frames_match_dot_tpu(pair):
    for r in _three_frames(pair):
        assert r["itt"] == r["itj"] > 0 and r["stop"] == "tol"
        np.testing.assert_allclose(r["xt"], r["xj"], rtol=1e-7,
                                   atol=1e-12 * np.abs(r["xj"]).max())
        assert r["et"] == pytest.approx(r["ej"], rel=1e-9)


def test_golden_and_plane(pair):
    """tests/test_dim2.py:381-405 on the port: the 2D golden sysE at rtol
    2e-4, z = 0."""
    rows = _three_frames(pair)
    np.testing.assert_allclose([r["et"] for r in rows],
                               GOLDEN_2D_SPIKES_SYS_E, rtol=2e-4)
    np.testing.assert_allclose(rows[-1]["xt"][:, 2], 0.0, atol=1e-14)


def _scene(tmp_path, stepper):
    sp = tmp_path / "spikes.txt"
    sp.write_text(SCENE_2D.format(stepper=stepper))
    return str(sp)


def test_sim2d_builds_admm_with_the_scenes_cap(tmp_path):
    """`timeStepper ADMM 7`: Sim2D builds ADMMPD2D with no plan, its cap
    the scene's maxIter, warmStart forced to 2; each frame stops by tol or
    at the cap."""
    sim = dim2.Sim2D(Config.load(_scene(tmp_path, "ADMM 7")),
                     str(tmp_path / "out"), device="cpu", mute=True)
    assert type(sim.stepper).__name__ == "ADMMPD2D"
    assert sim.system.plan is None and sim.stepper.max_iter == 7
    assert sim.stepper.warm_start_opt == 2
    sim.run(2)
    for r in sim.frames:
        assert r["stop"] in ("tol", "iter_cap") and 0 < r["iters"] <= 7
    assert float(sim.state.x[:, 2].abs().max()) == 0.0
    sim.finalize()


def test_run_script_and_cli(tmp_path, capsys):
    scene = _scene(tmp_path, "ADMM")
    sim, spf = dim2.run_script_2d(scene, frames=2, output_root=str(
        tmp_path / "out"), dtype="f64", device="cpu", mute=True)
    assert spf > 0 and os.path.basename(sim.out).startswith(
        "spikes_stretch_FCR_ADMM")
    files = set(os.listdir(sim.out))
    need = {"config.txt", "iterStats.txt", "log.txt", "info.txt", "status2",
            "2.obj"}
    assert need <= files and not any(f.endswith(".msh") for f in files)
    log = open(os.path.join(sim.out, "log.txt")).read()
    sys_e = [float(ln.split("=")[1]) for ln in log.splitlines()
             if ln.startswith("sysE = ")]
    np.testing.assert_allclose(sys_e, GOLDEN_2D_SPIKES_SYS_E[:2], rtol=2e-4)
    cli_main(["100", scene, "cli", "--frames", "1", "--dtype", "f64",
              "--device", "cpu", "--output-root", str(tmp_path / "cli")])
    out = capsys.readouterr().out
    assert "done: 1/200 2D frames" in out and "on cpu" in out
    run_dir, = (tmp_path / "cli").iterdir()
    assert (run_dir / "1.obj").exists() and (run_dir / "status1").exists()


def test_info_txt_matches_dot_tpu(tmp_path):
    scene = _scene(tmp_path, "ADMM")
    jsim = jdim2.Sim2D(JConfig.load(scene), str(tmp_path / "j"), mute=True,
                       render=False)
    jsim.run(1)
    jsim.finalize()
    sim = dim2.Sim2D(Config.load(scene), str(tmp_path / "t"), device="cpu",
                     mute=True)
    sim.run(1)
    sim.finalize()
    lines = [open(os.path.join(d, "info.txt")).read().splitlines()
             for d in (jsim.out, sim.out)]
    assert lines[1] == lines[0]


def test_wrappers_take_the_plain_versions_on_the_cpu_only(pair):
    _, tst = pair
    sys = tst.system
    n = sys.n_elem
    Dx = torch.zeros((4, n), dtype=torch.float64)
    args = (tst.w_e, tst.vol_dtsq, sys.u_e, sys.lam_e, sys.mat)
    with pytest.raises(ValueError, match="shape"):
        ops.admm_local_step2d(Dx[:, 1:].contiguous(), Dx, *args)
    with pytest.raises(ValueError, match="give mass"):
        ops.dtw_scatter2d(Dx, sys.g4, tst.w_e, sys.scatter_plan,
                          torch.zeros((sys.n_vert, 3), dtype=torch.float64))
    meta = Dx.to("meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ops.admm_local_step2d(meta, meta, *(a.to("meta") for a in args[:4]),
                              sys.mat)


@pytest.mark.parametrize("stepper", ["ADMM", "ADMMDD 4"])
def test_entry_points_need_a_card_unless_cpu_is_asked(tmp_path, monkeypatch,
                                                      stepper):
    """The 2D ADMM scenes through Sim2D, run_script_2d and the CLI raise
    without a card unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = _scene(tmp_path, stepper)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA"):
        dim2.Sim2D(Config.load(scene), out, mute=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        dim2.run_script_2d(scene, frames=1, output_root=out, mute=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["100", scene, "--frames", "1", "--output-root", out])
    sim = dim2.Sim2D(Config.load(scene), out, device="cpu", mute=True)
    assert sim.device.type == "cpu" and sim.system.dtype == torch.float64
