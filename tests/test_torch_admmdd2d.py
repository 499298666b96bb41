"""The port's 2D ADMM-DD (dim2.ADMMDD2D) against dot_tpu's on the CPU,
float64, the port on the plain versions of K21 per slab, K22 from F and
K26's two ADMM-DD entries (kernels/admm2d.py).

One spikes stretch scene (resolution 200) on one 4-part element plan for
the whole file (dot_tpu's jitted step compiles once per plan):
- every host table equal to dot_tpu's ADMMDD2D attribute of that name;
- the weights (the masked W, the consensus matrix C, its factor Lc and
  sqrt-diagonal dc) at a deformed state, at 1e-12 (the factors: LAPACK
  against XLA's Cholesky);
- the per-slab elastic energies, the local gradient and the augmented
  local Hessian (its factor and d) at the same state, 1e-12, and the
  symmetry K26's scaling relies on;
- three frames from dot_tpu's initial state: positions at rtol 1e-7 with
  equal iteration counts; the recorded 2D golden sysE
  (tests/test_dim2.py:437-463) at 2e-4, 0 < iterations < 1000, interface
  dofs present, z = 0;
- the entry points: Sim2D builds ADMMDD2D on the `ADMMDD 4` plan, and
  run_script_2d and the CLI write the output contract with dot_tpu's
  info.txt.
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
from dot_tpu.kernels import soa2d as jsoa2d
from dot_tpu_torch import convert, dim2, scripts
from dot_tpu_torch.__main__ import main as cli_main
from dot_tpu_torch.config import Config
from dot_tpu_torch.kernels import admm2d, dd2d

GOLDEN_2D_SPIKES_SYS_E = [
    3.294256031942e+03,
    3.294256605060e+03,
    3.300416677680e+03,
]
KW = dict(energy="FCR", time_stepper="ADMMDD", dt=0.025, rho=1000.0,
          ym=1e5, pr=0.4, script="stretch", handle_ratio=0.03,
          shape="spikes", resolution=200, partition_amt=4)
EXACT = 1e-12
SCENE_2D = """energy FCR
timeStepper ADMMDD 4
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


@pytest.fixture(scope="module")
def pair():
    """Both packages' 2D ADMM-DD steppers on one plan."""
    jcfg, cfg = JConfig(**KW), Config(**KW)
    jm = jdim2.Mesh2D.from_config(jcfg)
    jsd = jscripts.init_script(jm, jcfg.script)
    jm.fixed_mask = jsd.fixed0.copy()
    m = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(m, cfg.script)
    m.fixed_mask = sd.fixed0.copy()
    jp = jdim2.build_plan_2d(jm, 4)
    jst = jdim2.ADMMDD2D(jdim2.System2D(jm, jcfg, dtype=jnp.float64,
                                        plan=jp), jsd, jp)
    tst = dim2.ADMMDD2D(dim2.System2D(m, cfg, device="cpu",
                                      plan=convert.plan2d_from_numpy(jp)), sd)
    return jst, tst


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# dot_tpu attribute -> the port's value as numpy
TABLES = {
    "epad": lambda t: t.tables.epad,
    "conn_local": lambda t: t.tables.conn_local.T,
    "own_src": lambda t: t.tables.own_src,
    "own_dest": lambda t: t.tables.own_dest,
    "mass_local": lambda t: t.mass_local.numpy(),
    "mass_dif": lambda t: t.mass_dif.numpy(),
    "is_dual": lambda t: t.is_dual.numpy(),
    "owner_flat": lambda t: t.owner_flat.numpy(),
    "shared_ids": lambda t: t.shared_ids.numpy(),
    "n_shared": lambda t: t.n_shared,
    "ns2": lambda t: t.ns2,
    "l2shared": lambda t: t.l2shared.numpy(),
    "l2g": lambda t: t.system.l2g.numpy(),
    "local_valid": lambda t: t.system.local_valid.numpy(),
    "comp_gather": lambda t: t.tables.comp_gather,
    "w_dest": lambda t: t.tables.w_dest,
    "c_dest": lambda t: t.tables.c_dest,
    "lg4": lambda t: t.lg4.numpy(),
    "lw": lambda t: t.lw.numpy(),
    "lu": lambda t: t.lu.numpy(),
    "llam": lambda t: t.llam.numpy(),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_host_tables_are_dot_tpus(pair, name):
    jst, tst = pair
    want = getattr(jst, name)
    if isinstance(want, (tuple, list)):
        want = np.stack([np.asarray(v) for v in want])
    got = TABLES[name](tst)
    if np.ndim(want) == 0:
        assert int(got) == int(want)
    else:
        assert np.asarray(got).shape == np.asarray(want).shape
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_slot_tables_cover_w_and_the_local_hessian(pair):
    """The own table's slots hold every W slot and every diagonal slot (so
    K26's scaling on it reaches every nonzero of the augmented local
    Hessian); W's and C's tables index the row-major element Hessians."""
    _, tst = pair
    tb = tst.tables
    u = tst.own_tab.udest.numpy()
    assert np.isin(tb.w_dest, u).all()
    assert np.array_equal(tst.w_tab.dest.numpy(), tb.w_dest)
    n = tst.system.n_elem
    src = tb.comp_gather.astype(np.int64)
    want = dd2d.BLOCK_TO_ROW[src // n] * n + src % n
    assert np.array_equal(tst.w_tab.src.numpy(), want)
    assert tst.c_tab.n == tst.ns2 and tst.c_tab.n_parts == 1


@pytest.fixture(scope="module")
def deformed(pair):
    """A deformed state of the scene with the script's fixed set: x, fixed,
    and both packages' local positions, carried local F and duals."""
    jst, tst = pair
    sys = tst.system
    rng = np.random.default_rng(7)
    nv = sys.n_vert
    h = float(np.sqrt(sys.mesh.area.mean()))
    x = np.asarray(sys.mesh.V, np.float64).copy()
    x[:, :2] += 0.2 * h * rng.normal(size=(nv, 2))
    fixed = np.asarray(tst.script_data.fixed0)
    P, N = tst.P, tst.N
    valid = sys.local_valid.numpy()[..., None]
    l2g = sys.l2g.numpy()
    xl = x[l2g][:, :, :2] * valid
    xhat = (x + 0.01 * h * rng.normal(size=x.shape))
    xhat[:, 2] = 0.0
    xhatl = xhat[l2g][:, :, :2] * valid
    z = x.copy()
    z[:, :2] += 0.05 * h * rng.normal(size=(nv, 2))
    u_loc = 0.01 * h * rng.normal(size=(P, N, 2)) * valid
    p = 0.05 * h * rng.normal(size=(P, N, 2)) * valid
    return dict(x=x, fixed=fixed, xl=xl, xhatl=xhatl, z=z, u_loc=u_loc, p=p)


def _jflat(xl):
    return jnp.concatenate([jnp.asarray(xl.reshape(-1, 2)),
                            jnp.zeros((1, 2))], axis=0)


@pytest.fixture(scope="module")
def weights(pair, deformed):
    jst, tst = pair
    x, fixed = deformed["x"], deformed["fixed"]
    _, W, Lc, dc = jax.jit(jst._weights)(jnp.asarray(x), jnp.asarray(fixed))
    free2f = jst._free2(jnp.asarray(fixed)).reshape(-1)
    Wm = jst._w_masked(W, free2f)
    t = tst.weights(torch.as_tensor(x), torch.as_tensor(fixed))
    return dict(j=(np.asarray(Wm), np.asarray(Lc), np.asarray(dc),
                   np.asarray(free2f)), t=t)


@pytest.mark.parametrize("what", ["Wm", "C", "Lc", "dc"])
def test_weights_match_dot_tpu(pair, deformed, weights, what):
    jst, tst = pair
    jWm, jLc, jdc, _ = weights["j"]
    Wm, Lc, dc = (v.numpy() for v in weights["t"])
    if what == "Wm":
        assert _rel(Wm, jWm) <= EXACT and np.abs(jWm).max() > 0
    elif what == "dc":
        assert _rel(dc, jdc) <= EXACT
    elif what == "Lc":
        assert _rel(Lc, jLc) <= EXACT
    else:
        # dot_tpu keeps only Lc: its C is dc (Lc Lc^T) dc; the port's C
        # from its plain w_assemble2d
        sys = tst.system
        sfree = torch.cat([torch.logical_not(torch.as_tensor(
            deformed["fixed"])[tst.shared_ids]).double(),
            torch.zeros(1, dtype=torch.float64)])
        _, C, _ = admm2d.w_assemble2d_ref(
            sys.element_hessians(torch.as_tensor(deformed["x"])),
            tst._free(torch.as_tensor(deformed["fixed"])), sfree, tst.md_sh,
            tst.w_tab, tst.c_tab)
        jC = jdc[:, None] * (jLc @ jLc.T) * jdc[None, :]
        assert _rel(C.numpy(), jC) <= EXACT
        assert np.array_equal(C.numpy(), C.numpy().T)


def test_slab_energies_match_dot_tpu(pair, deformed):
    jst, tst = pair
    xl_j = _jflat(deformed["xl"])
    p_j = _jflat(deformed["p"])
    f4j, fp4j = jst._local_fsvd(xl_j), jst._local_fsvd(p_j)
    alpha = np.array([1.0, 0.5, 0.25, 0.125])
    ae = jnp.repeat(jnp.asarray(alpha), jst.epad)
    _, sj, _ = jsoa2d.svd2_flip_soa(tuple(a + ae * b
                                          for a, b in zip(f4j, fp4j)))
    _, s0j, _ = jsoa2d.svd2_flip_soa(f4j)
    f4 = tst._local_defgrad(tst._to_flat(torch.as_tensor(deformed["xl"])))
    fp4 = tst._local_defgrad(tst._to_flat(torch.as_tensor(deformed["p"])))
    np.testing.assert_allclose(f4.numpy(), np.stack(f4j), rtol=EXACT,
                               atol=EXACT)
    e = tst.slab_psi(f4, fp4, torch.as_tensor(alpha))
    e0 = tst.slab_psi(f4)
    assert _rel(e.numpy(), np.asarray(jst._local_psi_sum(sj))) <= EXACT
    assert _rel(e0.numpy(), np.asarray(jst._local_psi_sum(s0j))) <= EXACT


def test_local_gradient_matches_dot_tpu(pair, deformed, weights):
    jst, tst = pair
    jWm, _, _, jfree2f = weights["j"]
    xl_j, xh_j = _jflat(deformed["xl"]), _jflat(deformed["xhatl"])
    f4j = jst._local_fsvd(xl_j)
    U, s, V = jsoa2d.svd2_flip_soa(f4j)
    want = jax.jit(jst._local_gradient)(
        xl_j, xh_j, jnp.asarray(deformed["z"]),
        jnp.asarray(deformed["u_loc"]), jnp.asarray(jWm),
        jnp.asarray(jfree2f), f4j, U, s, V)
    Wm = weights["t"][0]
    fixed = torch.as_tensor(deformed["fixed"])
    free2f = torch.repeat_interleave(tst._free(fixed), 2, dim=-1)
    md2f = torch.repeat_interleave(tst.mass_dif, 2, dim=-1) * free2f
    xl = tst._to_flat(torch.as_tensor(deformed["xl"]))
    got = tst.local_gradient(
        xl, tst._to_flat(torch.as_tensor(deformed["xhatl"])),
        torch.as_tensor(deformed["z"]), torch.as_tensor(deformed["u_loc"]),
        Wm, free2f, md2f, tst._local_defgrad(xl))
    assert _rel(got.numpy(), np.asarray(want)) <= EXACT


def test_local_hessian_matches_dot_tpu(pair, deformed, weights):
    jst, tst = pair
    jWm, _, _, jfree2f = weights["j"]
    xl_j = _jflat(deformed["xl"])
    U, s, V = jsoa2d.svd2_flip_soa(jst._local_fsvd(xl_j))
    jL, jd = jax.jit(jst._local_h_factor)(jnp.asarray(jWm),
                                          jnp.asarray(jfree2f), U, s, V)
    jL, jd = np.asarray(jL), np.asarray(jd)
    Wm = weights["t"][0]
    free = tst._free(torch.as_tensor(deformed["fixed"]))
    xl = tst._to_flat(torch.as_tensor(deformed["xl"]))
    L, d = tst.local_h_factor(xl, Wm, free)
    assert _rel(d.numpy(), jd) <= EXACT
    assert _rel(L.numpy(), jL) <= EXACT
    # the assembled matrix before its scaling: symmetric bit for bit (a
    # slot and its mirror sum the same values in the same order), so K26's
    # scaling entry symmetrizes it from one side alone
    sys = tst.system
    eh = sys.k.elem_hessian2d(xl, tst.conn_local, tst.lg4, tst.lu, tst.llam,
                              tst.lw, sys.mat, sys.dt_sq)
    H, d2 = admm2d.local_h_assemble2d_ref(
        eh, Wm, free, tst.mass_local + tst.mass_dif * free, tst.own_tab)
    assert torch.equal(H, H.mT) and torch.equal(d2, d)
    jH = jd[:, :, None] * (jL @ np.swapaxes(jL, 1, 2)) * jd[:, None, :]
    assert _rel(H.numpy(), jH) <= EXACT


@pytest.mark.parametrize("what", ["Wm", "H"])
def test_rows_ref_matches_dot_tpu(pair, deformed, weights, what):
    """K26's W and local-Hessian entries, mirrored on the CPU over the row
    tables (dd2d.assemble_rows_ref; column chunks of one 16 B vector in
    pieces of three: every row spans several pieces), are dot_tpu's masked W and augmented local Hessian
    (d L L^T d from its factor) and the plain versions bit for bit."""
    jst, tst = pair
    jWm, _, _, jfree2f = weights["j"]
    sys = tst.system
    fixed = torch.as_tensor(deformed["fixed"])
    free = tst._free(fixed)
    if what == "Wm":
        eh = sys.element_hessians(torch.as_tensor(deformed["x"]))
        W, d = dd2d.assemble_rows_ref(eh, free, None, tst.w_tab, lanes=1,
                                      seg_vecs=3)
        assert d is None and torch.equal(W, weights["t"][0])
        assert _rel(W.numpy(), jWm) <= EXACT
        return
    xl_j = _jflat(deformed["xl"])
    U, s, V = jsoa2d.svd2_flip_soa(jst._local_fsvd(xl_j))
    jL, jd = (np.asarray(v) for v in jax.jit(jst._local_h_factor)(
        jnp.asarray(jWm), jnp.asarray(jfree2f), U, s, V))
    xl = tst._to_flat(torch.as_tensor(deformed["xl"]))
    eh = sys.k.elem_hessian2d(xl, tst.conn_local, tst.lg4, tst.lu, tst.llam,
                              tst.lw, sys.mat, sys.dt_sq)
    Wm = weights["t"][0]
    mass = tst.mass_local + tst.mass_dif * free
    H, d = dd2d.assemble_rows_ref(eh, free, mass, tst.own_tab, wadd=Wm,
                                  lanes=1, seg_vecs=3)
    Hr, dr = admm2d.local_h_assemble2d_ref(eh, Wm, free, mass, tst.own_tab)
    assert torch.equal(H, Hr) and torch.equal(d, dr)
    jH = jd[:, :, None] * (jL @ np.swapaxes(jL, 1, 2)) * jd[:, None, :]
    assert _rel(H.numpy(), jH) <= EXACT and _rel(d.numpy(), jd) <= EXACT


_frames = {}


def _three_frames(pair):
    if "rows" not in _frames:
        jst, tst = pair
        js = jst.init_state()
        ts = convert.sim2d_state_from_numpy(
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
    """tests/test_dim2.py:437-463 on the port."""
    _, tst = pair
    rows = _three_frames(pair)
    assert int(tst.is_dual.sum()) > 0
    assert all(0 < r["itt"] < 1000 for r in rows)
    np.testing.assert_allclose([r["et"] for r in rows],
                               GOLDEN_2D_SPIKES_SYS_E, rtol=2e-4)
    np.testing.assert_allclose(rows[-1]["xt"][:, 2], 0.0, atol=1e-14)


def _scene(tmp_path):
    sp = tmp_path / "spikes.txt"
    sp.write_text(SCENE_2D)
    return str(sp)


def test_sim2d_builds_admmdd_on_the_element_plan(tmp_path):
    sim = dim2.Sim2D(Config.load(_scene(tmp_path)), str(tmp_path / "out"),
                     device="cpu", mute=True)
    assert type(sim.stepper).__name__ == "ADMMDD2D"
    assert sim.system.n_parts == 4 and int(sim.system.dup.max()) > 1
    sim.run(1)
    r = sim.frames[0]
    assert r["stop"] == "tol" and 0 < r["iters"] < 1000
    assert float(sim.state.x[:, 2].abs().max()) == 0.0
    sim.finalize()


def test_run_script_and_cli(tmp_path, capsys):
    scene = _scene(tmp_path)
    sim, spf = dim2.run_script_2d(scene, frames=1, output_root=str(
        tmp_path / "out"), dtype="f64", device="cpu", mute=True)
    assert spf > 0 and os.path.basename(sim.out).startswith(
        "spikes_stretch_FCR_ADMMDD")
    files = set(os.listdir(sim.out))
    need = {"config.txt", "iterStats.txt", "log.txt", "info.txt", "status1",
            "1.obj"}
    assert need <= files and not any(f.endswith(".msh") for f in files)
    cli_main(["100", scene, "cli", "--frames", "1", "--dtype", "f64",
              "--device", "cpu", "--output-root", str(tmp_path / "cli")])
    out = capsys.readouterr().out
    assert "done: 1/200 2D frames" in out and "on cpu" in out


def test_info_txt_matches_dot_tpu(tmp_path):
    scene = _scene(tmp_path)
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
