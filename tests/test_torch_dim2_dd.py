"""The port's decomposed 2D System2D (dot_tpu_torch.dim2 with a Plan2D)
against dot_tpu.dim2.System2D on the CPU, f64, method by method, from one
deformed configuration of the spikes scene (resolution 200) on the 4-part
element plan: the element Hessians (after the fixed block-major ->
row-major permutation), the quadratic form and F(p) of the DOT alpha-init
(K25), the Hessian diagonal (K28's second entry), the subdomain assembly
and its symmetry (K26), factorize_fast (exact, through bf16 as LBFGS-HI,
and the global 1e-4 tier on an indefinite input), the H0 apply and every
subdomain's solve (K27), the LBFGS-PD factor and solve (K28). On the CPU
the wrappers take their plain versions (kernels/dd2d.py); K25-K28 on the
card are held to those in tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: rtol 1e-12 on elementwise results and sums (the same
operations, sums in another order), 1e-10 on factors and solves (LAPACK
against XLA's Cholesky); the bf16-rounded factor is f32 in both packages,
so it is held at f32's 1e-5 (its input matrix is held bit for bit).
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dot_tpu import dim2 as jdim2
from dot_tpu import scripts as jscripts
from dot_tpu.config import Config as JConfig
from dot_tpu.steppers.gsdd import GSDDStepper as JGSDD
from dot_tpu_torch import dim2, scripts
from dot_tpu_torch.config import Config
from dot_tpu_torch.convert import plan2d_from_numpy
from dot_tpu_torch.kernels import dd2d, ops

KW = dict(energy="FCR", time_stepper="DOT", dt=0.025, rho=1000.0, ym=1e5,
          pr=0.4, script="stretch", handle_ratio=0.03, shape="spikes",
          resolution=200)
EXACT, SOLVE = 1e-12, 1e-10


def _systems(kind="element", parts=4, bf16=False):
    jcfg, cfg = JConfig(**KW), Config(**KW)
    jm = jdim2.Mesh2D.from_config(jcfg)
    sd = jscripts.init_script(jm, jcfg.script)
    jm.fixed_mask = sd.fixed0.copy()
    m = dim2.Mesh2D.from_config(cfg)
    m.fixed_mask = scripts.init_script(m, cfg.script).fixed0.copy()
    build = jdim2.build_plan_2d if kind == "element" else \
        jdim2.build_node_plan_2d
    jp = build(jm, parts)
    js = jdim2.System2D(jm, jcfg, dtype=jnp.float64, plan=jp,
                        factor_dtype=jnp.bfloat16 if bf16 else None)
    ts = dim2.System2D(m, cfg, device="cpu", plan=plan2d_from_numpy(jp),
                       factor_dtype=torch.bfloat16 if bf16 else None)
    return js, ts, sd


@pytest.fixture(scope="module")
def pair():
    return _systems()


@pytest.fixture(scope="module")
def state(pair):
    """A deformed configuration, a direction, the fixed mask, and both
    packages' element Hessians there."""
    js, ts, sd = pair
    rng = np.random.default_rng(20261016)
    nv = ts.n_vert
    x = np.asarray(sd.x0, np.float64).copy()
    x[:, :2] += 0.01 * rng.normal(size=(nv, 2))
    p = np.zeros((nv, 3))
    p[:, :2] = 0.01 * rng.normal(size=(nv, 2))
    fixed = np.asarray(sd.fixed0)
    _, U, s, V = js.fsvd(jnp.asarray(x))
    jh = np.asarray(js.element_hessians(U, s, V))
    th = ts.element_hessians(torch.as_tensor(x))
    return types.SimpleNamespace(x=x, p=p, fixed=fixed, jh=jh, th=th,
                                 tfixed=torch.as_tensor(fixed))


def _close(a, b, rtol, what=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(),
                               err_msg=what)


def test_element_hessians_are_dot_tpus_permuted(state):
    """K23's row-major (36, nE) holds dot_tpu's block-major rows in the
    order of dd2d.BLOCK_TO_ROW."""
    th = state.th.numpy()
    _close(th[dd2d.BLOCK_TO_ROW], state.jh, EXACT)


def test_quadratic_form_and_direction_defgrad(pair, state):
    js, ts, _ = pair
    pj = jnp.asarray(state.p)
    pe = js.gather_corners(pj)
    php_j = float(js.quadratic_form(jnp.asarray(state.jh), pj, pe=pe))
    F_j = np.stack([np.asarray(f) for f in js.defgrad_from_corners(pe)])
    php, Fp = ts.quadratic_form(state.th, torch.as_tensor(state.p))
    assert float(php) == pytest.approx(php_j, rel=EXACT)
    _close(Fp.numpy(), F_j, EXACT)
    # F(p) equals the direction pass K21's callers use
    _close(Fp.numpy(), ts.defgrad(torch.as_tensor(state.p)).numpy(), EXACT)


def test_hessian_diag(pair, state):
    js, ts, _ = pair
    hj = np.asarray(js.hessian_diag(jnp.asarray(state.jh)))
    ht = ts.hessian_diag(state.th).numpy()
    _close(ht, hj, EXACT)
    assert (ht[:, 2] == 1.0).all()


@pytest.fixture(scope="module")
def assembled(pair, state):
    js, ts, _ = pair
    Hj = np.asarray(js.assemble_subdomains(jnp.asarray(state.jh),
                                           jnp.asarray(state.fixed)))
    Hd, d = ts.assemble_subdomains(state.th, state.tfixed)
    return Hj, Hd, d


def test_assemble_subdomains(pair, assembled):
    _, ts, _ = pair
    Hj, Hd, d = assembled
    assert Hd.shape == (ts.n_parts, ts.n3, ts.n3) == Hj.shape
    _close(Hd.numpy(), Hj, EXACT)
    # a slot and its mirror sum the same values in the same order
    assert torch.equal(Hd, Hd.mT)
    _close(d.numpy(), np.sqrt(np.einsum("pii->pi", Hj)), EXACT)
    # padding rows and fixed dofs: unit diagonal, zero off the diagonal
    f2 = np.repeat(~ts.local_valid.numpy(), 2, axis=1)
    pad = Hd.numpy()[f2]
    assert (np.abs(pad).sum(axis=1) == 1.0).all()


@pytest.mark.parametrize("lanes,seg", [(1, 3), (32, dd2d.SEG_VECS)])
def test_rows_ref_matches_dot_tpu(pair, state, assembled, lanes, seg):
    """K26's and K28's one-pass kernel, mirrored on the CPU over the row
    tables (dd2d.assemble_rows_ref; column chunks of one 16 B vector in
    pieces of three, and the kernel's 32 and 512: every row spans several
    chunks), is dot_tpu's assemble_subdomains and _build_pd_factor's
    matrix (d L L^T d from its factor) and the plain version bit for
    bit."""
    js, ts, _ = pair
    Hj, Hd, d = assembled
    free = torch.logical_and(ts.local_valid, torch.logical_not(
        state.tfixed[ts.l2g])).double()
    H, dm = dd2d.assemble_rows_ref(state.th, free, ts.mass_img, ts.asm_tab,
                                   lanes=lanes, seg_vecs=seg)
    assert torch.equal(H, Hd) and torch.equal(dm, d)
    _close(H.numpy(), Hj, EXACT)
    Lj, dj = (np.asarray(v) for v in js.build_pd_factor(
        jnp.asarray(state.fixed)))
    Sj = dj[:, None] * (Lj @ Lj.T) * dj[None, :]
    tab = dd2d.pd_tables(ts.mesh.conn, ts.n_vert, "cpu")
    w = ts.scalar(ts.dt_sq) * ts.vol_w * (2.0 * ts.u_e + ts.lam_e)
    fv = torch.logical_not(state.tfixed).double()
    S, ds = dd2d.assemble_rows_ref(dd2d.pd_pair_vals2d(ts.g4, w), fv[None],
                                   ts.mass[None], tab, lanes=lanes,
                                   seg_vecs=seg)
    Sr, dr = dd2d.pd_assemble2d_ref(ts.g4, w, fv, ts.mass, tab)
    assert torch.equal(S[0], Sr) and torch.equal(ds[0], dr)
    _close(S[0].numpy(), Sj, EXACT)
    _close(ds[0].numpy(), dj, EXACT)


def _factor_pair(js, ts, Hj, Hd, d):
    Lj, dj = js.factorize_fast(jnp.asarray(Hj))
    Lt, dt = ts.factorize_fast(Hd.clone(), d.clone())
    _close(dt.numpy(), np.asarray(dj), EXACT)
    return np.asarray(Lj), Lt


def test_factorize_fast_f64(pair, assembled):
    js, ts, _ = pair
    Hj, Hd, d = assembled
    Lj, Lt = _factor_pair(js, ts, Hj, Hd, d)
    assert Lt.dtype == torch.float64
    _close(Lt.numpy(), Lj, SOLVE)


def test_factorize_fast_through_bf16(state):
    """LBFGS-HI: the equilibrated matrix rounded to bf16 and factored in
    f32. The rounded matrix is bit-equal; the f32 factors agree to f32's
    rounding (LAPACK and XLA order their sums differently)."""
    js, ts, _ = _systems(bf16=True)
    Hj = np.asarray(js.assemble_subdomains(jnp.asarray(state.jh),
                                           jnp.asarray(state.fixed)))
    Hd, d = ts.assemble_subdomains(state.th, state.tfixed)
    Lj, Lt = _factor_pair(js, ts, Hj, Hd, d)
    assert Lt.dtype == torch.float32 and Lj.dtype == np.float32
    dinv = 1.0 / np.sqrt(np.einsum("pii->pi", Hj))
    Hn = Hj * dinv[:, :, None] * dinv[:, None, :]
    Hb = jnp.asarray(Hn).astype(jnp.bfloat16).astype(jnp.float32)
    Hb = np.asarray((Hb + jnp.swapaxes(Hb, 1, 2)) / 2)
    Ht = ts._to_factor_dtype(dd2d.subdomain_scale2d_ref(Hd, d, ts.asm_tab))
    np.testing.assert_array_equal(Ht.numpy(), Hb)
    _close(Lt.numpy(), Lj, 1e-5)


@pytest.mark.parametrize("shift", ["rescued", "still_indefinite"])
def test_factorize_fast_global_tier(pair, assembled, shift):
    """One indefinite subdomain makes dot_tpu refactor all P with 1e-4 on
    the diagonal (dim2.py:619-620); the port does the same after one host
    read. An eigenvalue of -5e-5 is rescued by the shift; a strongly
    indefinite block stays NaN while the others take the shifted factor."""
    js, ts, _ = pair
    Hj, Hd, d = assembled
    H = Hj.copy()
    if shift == "rescued":
        # lower subdomain 0's equilibrated spectrum to lambda_min = -5e-5
        Hn0 = H[0] / np.outer(np.sqrt(np.diag(H[0])), np.sqrt(np.diag(H[0])))
        c = np.linalg.eigvalsh(Hn0)[0] + 5e-5
        H[0] -= c * np.diag(np.diag(H[0]))
    else:
        H[0, 0, 2] = H[0, 2, 0] = 10.0 * np.sqrt(H[0, 0, 0] * H[0, 2, 2])
    Ht = torch.as_tensor(H)
    dt_ = torch.sqrt(Ht.diagonal(dim1=1, dim2=2))
    syncs = ts.n_syncs
    Lj, Lt = _factor_pair(js, ts, H, Ht, dt_)
    assert ts.n_syncs == syncs + 1
    nan_t = torch.isnan(Lt).any(dim=(1, 2)).tolist()
    nan_j = np.isnan(Lj).any(axis=(1, 2)).tolist()
    assert nan_t == nan_j == [shift != "rescued"] + [False] * (ts.n_parts - 1)
    ok = ~np.asarray(nan_t)
    _close(Lt.numpy()[ok], Lj[ok], SOLVE)
    # the healthy subdomains took the shifted factor too
    L1 = np.linalg.cholesky(Hn := (H[1] / np.outer(np.sqrt(np.diag(H[1])),
                                                   np.sqrt(np.diag(H[1]))))
                            + 1e-4 * np.eye(H.shape[1]))
    assert Hn.shape == L1.shape
    _close(Lt.numpy()[1], L1, SOLVE)


@pytest.fixture(scope="module")
def factored(pair, assembled):
    js, ts, _ = pair
    Hj, Hd, d = assembled
    Lj, dj = js.factorize_fast(jnp.asarray(Hj))
    Lt, dt = ts.factorize_fast(Hd.clone(), d.clone())
    return Lj, dj, Lt, dt


def test_h0_apply(pair, state, factored):
    js, ts, _ = pair
    Lj, dj, Lt, dt = factored
    rng = np.random.default_rng(3)
    q = np.concatenate([rng.normal(size=(ts.n_vert, 2)),
                        np.zeros((ts.n_vert, 1))], axis=1)
    rj = np.asarray(js.h0_apply(Lj, dj, jnp.asarray(q)))
    rt = ts.h0_apply(Lt, dt, torch.as_tensor(q)).numpy()
    _close(rt, rj, SOLVE)
    assert (rt[:, 2] == 0).all()


@pytest.mark.parametrize("i", range(4))
def test_subdomain_solve(pair, factored, i):
    """The GSDD sweep's solve of subdomain i (dot_tpu gsdd.py:34-55):
    nonzero on its own vertices only; a padded slot (l2g 0) leaves vertex 0
    alone when vertex 0 is not local."""
    js, ts, _ = pair
    Lj, dj, Lt, dt = factored
    rng = np.random.default_rng(10 + i)
    q = np.concatenate([rng.normal(size=(ts.n_vert, 2)),
                        np.zeros((ts.n_vert, 1))], axis=1)
    st = types.SimpleNamespace(chol=Lj, equil=dj)
    rj = np.asarray(JGSDD._subdomain_solve(None, js, st, jnp.asarray(q), i))
    rt = ts.subdomain_solve(Lt, dt, torch.as_tensor(q), i).numpy()
    _close(rt, rj, SOLVE)
    local = np.zeros(ts.n_vert, bool)
    local[ts.l2g[i][ts.local_valid[i]].numpy()] = True
    assert (rt[~local] == 0).all() and (rt[:, 2] == 0).all()
    assert np.abs(rt[local, :2]).min(axis=1).max() > 0
    if not local[0]:
        assert (rt[0] == 0).all()


def test_build_pd_factor_and_pd_solve():
    """LBFGS-PD at dim 2: M + dt^2 D^T W D, w_e = dt^2 area (2 mu +
    lambda), factored once; the 2-column solve with z = 0. Also with
    explicit weights (ADMM's hook)."""
    jcfg, cfg = JConfig(**KW), Config(**KW)
    jm = jdim2.Mesh2D.from_config(jcfg)
    sd = jscripts.init_script(jm, jcfg.script)
    jm.fixed_mask = sd.fixed0.copy()
    m = dim2.Mesh2D.from_config(cfg)
    m.fixed_mask = sd.fixed0.copy()
    js = jdim2.System2D(jm, jcfg, dtype=jnp.float64)
    ts = dim2.System2D(m, cfg, device="cpu")
    fixed = np.asarray(sd.fixed0)
    rng = np.random.default_rng(4)
    q = np.concatenate([rng.normal(size=(ts.n_vert, 2)),
                        np.zeros((ts.n_vert, 1))], axis=1)
    w = np.abs(rng.normal(size=ts.n_elem)) + 0.5
    for wj, wt in ((None, None), (jnp.asarray(w), torch.as_tensor(w))):
        Lj, dj = js.build_pd_factor(jnp.asarray(fixed), wj)
        Lt, dt = ts.build_pd_factor(torch.as_tensor(fixed), wt)
        _close(dt.numpy(), np.asarray(dj), EXACT)
        _close(Lt.numpy(), np.asarray(Lj), SOLVE)
        pj = np.asarray(js.pd_solve(Lj, dj, jnp.asarray(q)))
        pt = ts.pd_solve(Lt, dt, torch.as_tensor(q)).numpy()
        _close(pt, pj, SOLVE)
        assert (pt[:, 2] == 0).all()
        _close(pt[fixed, :2], q[fixed, :2], SOLVE, "unit rows at fixed")


def test_plain_route_and_refusals(pair, state):
    """On CPU tensors the K25-K28 wrappers take their plain versions and
    count no launch; another device has no kernel; wrong tables or shapes
    are refused."""
    _, ts, _ = pair
    ops.reset_launches()
    ts.quadratic_form(state.th, torch.as_tensor(state.p))
    ts.rebuild_h0(torch.as_tensor(state.x), state.tfixed)
    assert not any(ops.launches.values())
    meta = state.th.to("meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ops.hessian_diag2d(meta, ts.mass.to("meta"), type(ts.scatter_plan)(
            *(v.to("meta") if torch.is_tensor(v) else v
              for v in ts.scatter_plan)))
    with pytest.raises(ValueError, match="shape"):
        ops.subdomain_assemble2d(state.th, ts.mass_img[:1].clone(),
                                 ts.mass_img, ts.asm_tab)
    with pytest.raises(ValueError, match="subdomain 4 of 4"):
        ops.local_gather_one2d(torch.as_tensor(state.p), ts.l2g,
                               ts.local_valid, torch.ones(4, 2 * ts.l2g.shape[1],
                                                          dtype=torch.float64),
                               4)


def test_solve_local_route_and_refusals(pair, factored):
    """K32 on the CPU: System2D.solve_local (and subdomain_solve's P = 1
    slice L[i:i + 1]) takes the plain pair of library triangular solves,
    bit for bit, and counts no launch; the wrapper reads the factor row or
    column major and refuses other strides, shapes, dtypes and devices."""
    _, ts, _ = pair
    _, _, Lt, _ = factored
    rng = np.random.default_rng(7)
    r = torch.as_tensor(rng.normal(size=(Lt.shape[0], Lt.shape[-1])))
    ops.reset_launches()
    assert not Lt.is_contiguous() and Lt.mT.is_contiguous()
    assert torch.equal(ts.solve_local(Lt, r), dd2d.tri_solve_ref(Lt, r))
    assert torch.equal(ts.solve_local(Lt[1:2], r[1:2]),
                       dd2d.tri_solve_ref(Lt[1:2], r[1:2]))
    Lr = Lt.contiguous()
    assert torch.equal(ops.tri_solve(Lr, r), dd2d.tri_solve_ref(Lr, r))
    assert ops.launches["tri_solve"] == 0
    with pytest.raises(ValueError, match="neither row nor column major"):
        ops.tri_solve(Lr[:, ::2, ::2], r[:, ::2].contiguous())
    with pytest.raises(ValueError, match="shape"):
        ops.tri_solve(Lr, r[:, 1:].contiguous())
    with pytest.raises(ValueError, match="shape"):
        ops.tri_solve(Lr[:, :, 1:], r)
    with pytest.raises(TypeError):
        ops.tri_solve(Lr, r.float())
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ops.tri_solve(Lr.to("meta"), r.to("meta"))


@pytest.mark.parametrize("case", ["one_of_four_fails", "single_fails",
                                  "none_fails"])
def test_cholesky_nan_contract_on_the_plain_route(pair, case):
    """System2D._cholesky_nan through K33's wrapper on CPU tensors (its
    plain version, no launch counted): the factors are read from the lower
    triangle (the upper one here is garbage), exact zeros above the
    diagonal, column major as K32 reads them; a matrix with a pivot <= 0 is
    all NaN and the others are bit for bit the batch without it; the flag
    is a 0-d bool on the tensors' device. The wrapper refuses other dtypes,
    shapes, strides and devices."""
    _, ts, _ = pair
    rng = np.random.default_rng(33)
    P, n = 4, 37
    a = rng.normal(size=(P, n, n))
    A = a @ a.transpose(0, 2, 1) / n + np.eye(n)
    A += np.triu(np.full((n, n), 7.0), 1)
    H = torch.as_tensor(A)
    failed = {"one_of_four_fails": [1], "single_fails": [2],
              "none_fails": []}[case]
    Hf = H.clone()
    for i in failed:
        Hf[i, 5, 5] = -1.0
    if case == "single_fails":
        H, Hf, failed = H[2], Hf[2], [None]
    ops.reset_launches()
    L, bad = ts._cholesky_nan(Hf)
    L0, bad0 = ts._cholesky_nan(H)
    assert ops.launches["dense_chol"] == 0
    assert L.shape == H.shape and L.mT.is_contiguous()
    assert bad.dim() == 0 and bad.dtype == torch.bool
    assert bad.device == H.device
    assert bool(bad) == bool(failed) and not bool(bad0)
    sym = torch.tril(H) + torch.tril(H, -1).mT
    np.testing.assert_allclose(L0.numpy(), torch.linalg.cholesky(sym).numpy(),
                               rtol=SOLVE, atol=SOLVE)
    assert bool((torch.triu(L0, 1) == 0).all())
    mats = [(None, L, L0)] if H.dim() == 2 else [
        (i, L[i], L0[i]) for i in range(P)]
    for i, Li, L0i in mats:
        if i in failed:
            assert bool(torch.isnan(Li).all())
        else:
            assert torch.equal(Li, L0i)
    with pytest.raises(TypeError):
        ops.dense_chol(H.reshape(-1, n, n).to(torch.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        ops.dense_chol(H.reshape(-1, n, n)[..., 1:].contiguous())
    with pytest.raises(ValueError, match="not contiguous"):
        ops.dense_chol(H.reshape(-1, n, n).mT)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ops.dense_chol(H.reshape(-1, n, n).to("meta"))
