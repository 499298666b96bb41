"""The port's element math (dot_tpu_torch.kernels.soa, the plain PyTorch
version of the kernels) against dot_tpu.kernels.soa, in float64 on the CPU.

Inputs are made with numpy from a seed: random, inverted and degenerate
deformation gradients (rank-1/2, zero, identity and repeated singular
values). Tolerances: rtol 1e-10 on sigma, Psi, dPsi and P, 1e-9 on the
element Hessian; U and V only where sigma is well separated (elsewhere
they are not unique)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dot_tpu.kernels import soa as jsoa
from dot_tpu_torch.kernels import ops
from dot_tpu_torch.kernels import soa as tsoa

N = 96
MATS = ("FCR", "SNH", "SNHWL")
KINDS = ("random", "inverted", "degenerate")


def _F(kind, seed=0):
    """(9, N) float64 deformation gradients of one kind."""
    rng = np.random.default_rng({"random": 1, "inverted": 2,
                                 "degenerate": 3}[kind] + seed)
    if kind == "random":
        return rng.normal(size=(9, N))
    if kind == "inverted":
        F = np.eye(3).reshape(9, 1) + 0.3 * rng.normal(size=(9, N))
        F[[0, 3, 6]] *= -1.0                 # flip a column: det < 0
        return F
    F = np.empty((N, 3, 3))
    k = N // 6
    a, b = rng.normal(size=(k, 3)), rng.normal(size=(k, 3))
    F[:k] = a[:, :, None] * b[:, None, :]                       # rank 1
    Q = np.linalg.qr(rng.normal(size=(k, 3, 3)))[0]
    F[k:2 * k] = Q * np.asarray([2.0, 0.5, 0.0])                # rank 2
    F[2 * k:3 * k] = 0.0                                        # zero
    F[3 * k:4 * k] = np.eye(3)                                  # identity
    F[4 * k:5 * k] = Q * np.asarray([1.5, 1.5, 0.7])            # repeated
    F[5 * k:] = np.eye(3) + 1e-9 * rng.normal(size=(N - 5 * k, 3, 3))
    return F.reshape(N, 9).T.copy()


def _lame(seed=0):
    rng = np.random.default_rng(7 + seed)
    return (rng.uniform(1e3, 5e4, N), rng.uniform(1e3, 2e5, N),
            rng.uniform(0.1, 2.0, N))


def _D(seed=0):
    """Corner basis from a random restTriInv: (9, N) rti and [4][3] D."""
    rng = np.random.default_rng(11 + seed)
    rti = np.eye(3).reshape(9, 1) * 4.0 + rng.normal(size=(9, N))
    r = rti.reshape(3, 3, N)
    D = np.concatenate([-(r[0] + r[1] + r[2])[None], r], axis=0)   # (4,3,N)
    return rti, D


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _tup_j(a):
    return tuple(jnp.asarray(x) for x in a)


def _tup_t(a):
    return tuple(_t(x) for x in a)


@jax.jit
def _j_svd(f):
    return jsoa.svd3_flip_soa(f)


_J_ELEM = {}


def _j_elem(name):
    """One jitted program per material: SVD, Psi, dPsi, d2Psi, P and H."""
    if name not in _J_ELEM:
        mat = jsoa.SOA_MATERIALS[name]

        def fn(f, D, u, lam, w):
            U, s, V = jsoa.svd3_flip_soa(f)
            H = jsoa.element_hessian_soa(mat, U, s, V, D, u, lam, w)
            return (mat.psi(s, u, lam), mat.dpsi(s, u, lam),
                    mat.d2psi(s, u, lam), mat.b_left(s, u, lam),
                    mat.first_piola(f, U, s, V, u, lam), jnp.stack(H))
        _J_ELEM[name] = jax.jit(fn)
    return _J_ELEM[name]


def _t_elem(name, f, D, u, lam, w):
    mat = tsoa.SOA_MATERIALS[name]
    U, s, V = tsoa.svd3_flip_soa(f)
    H = tsoa.element_hessian_soa(mat, U, s, V, D, u, lam, w)
    return (mat.psi(s, u, lam), mat.dpsi(s, u, lam), mat.d2psi(s, u, lam),
            mat.b_left(s, u, lam), mat.first_piola(f, U, s, V, u, lam),
            torch.stack(H))


def _close(a, b, rtol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("kind", KINDS)
def test_flip_svd_matches_dot_tpu(kind):
    F = _F(kind)
    Uj, sj, Vj = _j_svd(_tup_j(F))
    Ut, st, Vt = tsoa.svd3_flip_soa(_tup_t(F))
    sj, st = np.stack(sj), np.stack([x.numpy() for x in st])
    _close(st, sj, 1e-10)
    # U, V are unique only where sigma is well separated
    gap = np.minimum(np.abs(sj[0] - sj[1]), np.abs(sj[1] - sj[2]))
    sep = gap > 1e-3 * np.maximum(np.abs(sj).max(axis=0), 1.0)
    assert sep.any() or kind == "degenerate"
    for a, b in ((Ut, Uj), (Vt, Vj)):
        a = np.stack([x.numpy() for x in a])[:, sep]
        b = np.stack(b)[:, sep]
        np.testing.assert_allclose(a, b, atol=1e-9)
    # the convention holds everywhere: det U = det V = +1, s0 >= s1 >= |s2|
    for M in (Ut, Vt):
        det = tsoa.det3(M).numpy()
        np.testing.assert_allclose(det, 1.0, atol=1e-9)
    assert np.all(st[0] >= st[1] - 1e-12)
    assert np.all(st[1] >= np.abs(st[2]) - 1e-12)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", MATS)
def test_material_and_hessian_match_dot_tpu(name, kind):
    F = _F(kind)
    u, lam, w = _lame()
    rti, D = _D()
    j = _j_elem(name)(_tup_j(F), [[jnp.asarray(D[c, i]) for i in range(3)]
                                  for c in range(4)],
                      jnp.asarray(u), jnp.asarray(lam), jnp.asarray(w))
    t = _t_elem(name, _tup_t(F), _t(D), _t(u), _t(lam), _t(w))
    # P and H need the rotation U V^T, which is not unique where F has
    # rank < 2 (sigma_1 = sigma_2 = 0): compare them where it is
    s = np.sort(np.linalg.svd(F.T.reshape(N, 3, 3), compute_uv=False))
    unique_r = s[:, 1] > 1e-6 * np.maximum(s[:, 2], 1.0)
    assert unique_r.sum() >= N * 2 // 3
    labels = ("psi", "dpsi", "d2psi", "b_left", "P")
    for lab, a, b in zip(labels, t[:5], j[:5]):
        a = np.stack([x.numpy() for x in a]) if isinstance(a, tuple) \
            else a.numpy()
        b = np.stack(b) if isinstance(b, tuple) else np.asarray(b)
        if lab == "P":
            a, b = a[:, unique_r], b[:, unique_r]
        _close(a, b, 1e-10)
    _close(t[5].numpy()[:, unique_r], np.asarray(j[5])[:, unique_r], 1e-9)


def test_jacobi_eigh_and_pd3_match_dot_tpu(rng):
    A = rng.normal(size=(6, N))
    A[0] += 3.0
    a6j = _tup_j(A)
    wj, Qj = jax.jit(jsoa.jacobi_eigh_soa)(a6j)
    wt, Qt = tsoa.jacobi_eigh_soa(_tup_t(A))
    _close(np.stack([x.numpy() for x in wt]), np.stack(wj), 1e-10)
    _close(np.stack([x.numpy() for x in Qt]), np.stack(Qj), 1e-10)
    pj = jax.jit(jsoa.make_pd3_soa)(a6j)
    pt = tsoa.make_pd3_soa(_tup_t(A))
    _close(np.stack([x.numpy() for x in pt]), np.stack(pj), 1e-10)


def _conn(nv, seed=0):
    rng = np.random.default_rng(5 + seed)
    return np.stack([rng.permutation(nv)[:N] for _ in range(4)]).astype(
        np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_fused_references_match_dot_tpu(kind):
    """The four fused plain references (the kernels' semantics) against
    dot_tpu's composition of the same steps."""
    nv = 2 * N
    rng = np.random.default_rng(3)
    conn = _conn(nv)
    rti, D = _D()
    u, lam, w = _lame()
    x = rng.normal(size=(nv, 3))
    F0, Fp = _F(kind), _F("random", seed=1)
    alpha = 0.375
    mat_t, mat_j = tsoa.FCR_SOA, jsoa.FCR_SOA
    dt_sq = 0.025 ** 2

    # K1: sum w Psi(F0 + a Fp), sigma
    e_t, s_t = tsoa.ls_trial_energy_ref(_t(F0), _t(Fp),
                                        torch.tensor(alpha, dtype=torch.float64),
                                        _t(u), _t(lam), _t(w), mat_t, True)
    _, s_j, _ = _j_svd(_tup_j(F0 + alpha * Fp))
    e_j = np.sum(np.asarray(mat_j.psi(s_j, jnp.asarray(u), jnp.asarray(lam)))
                 * w)
    _close(e_t.numpy(), e_j, 1e-10)
    _close(s_t.numpy(), np.stack(s_j), 1e-10)

    # F, corner basis and the three gather-based passes
    xT = tuple(jnp.asarray(x[:, d]) for d in range(3))
    Fj = jsoa.defgrad_soa(xT, tuple(jnp.asarray(c) for c in conn),
                          _tup_j(rti))
    Uj, sj, Vj = _j_svd(Fj)
    Dj = [[jnp.asarray(D[c, i]) for i in range(3)] for c in range(4)]
    ge = jsoa.element_gradient_soa(mat_j, Fj, Uj, sj, Vj, Dj,
                                   jnp.asarray(u), jnp.asarray(lam),
                                   jnp.asarray(w))
    g_j = np.zeros((nv + 1, 3))
    for c in range(4):
        np.add.at(g_j, conn[c], np.stack([np.asarray(ge[c][d])
                                          for d in range(3)], axis=-1))
    tc = torch.as_tensor(conn)
    g_t = tsoa.elem_gradient_ref(_t(x), tc, tc, _t(rti), _t(u), _t(lam),
                                 _t(w), mat_t)
    _close(g_t.numpy(), g_j, 1e-10)

    H = jsoa.element_hessian_soa(mat_j, Uj, sj, Vj, Dj, jnp.asarray(u),
                                 jnp.asarray(lam), jnp.asarray(w))
    h_j = np.stack([np.asarray(H[r]) for r in tsoa.block_major_order()]) \
        * dt_sq
    h_t = tsoa.elem_hessian_ref(_t(x), tc, _t(rti), _t(u), _t(lam), _t(w),
                                mat_t, dt_sq)
    _close(h_t.numpy(), h_j, 1e-9)

    p = rng.normal(size=(nv, 3))
    pT = tuple(jnp.asarray(p[:, d]) for d in range(3))
    Fp_j = jsoa.defgrad_soa(pT, tuple(jnp.asarray(c) for c in conn),
                            _tup_j(rti))
    pe = np.stack([p[conn[c], i] for c in range(4) for i in range(3)])
    hb = h_j.reshape(4, 4, 3, 3, N)
    q_j = np.einsum("abijn,ain,bjn->", hb, pe.reshape(4, 3, N),
                    pe.reshape(4, 3, N))
    F_t, q_t = tsoa.direction_pass_ref(_t(p), tc, _t(rti), _t(h_j))
    _close(F_t.numpy(), np.stack(Fp_j), 1e-10)
    _close(q_t.numpy(), q_j, 1e-10)


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    nv = 2 * N
    rng = np.random.default_rng(4)
    conn = torch.as_tensor(_conn(nv))
    rti, _ = _D()
    u, lam, w = (_t(a) for a in _lame())
    x = _t(rng.normal(size=(nv, 3)))
    g9 = _t(rti)
    F0, Fp = _t(_F("random")), _t(_F("inverted"))
    a = torch.tensor(0.5, dtype=torch.float64)
    mat = tsoa.FCR_SOA
    ops.reset_launches()
    pairs = [
        (ops.ls_trial_energy(F0, Fp, a, u, lam, w, mat, True),
         tsoa.ls_trial_energy_ref(F0, Fp, a, u, lam, w, mat, True)),
        ((ops.elem_gradient(x, conn, conn, g9, u, lam, w, mat),),
         (tsoa.elem_gradient_ref(x, conn, conn, g9, u, lam, w, mat),)),
        ((ops.elem_hessian(x, conn, g9, u, lam, w, mat, 0.1),),
         (tsoa.elem_hessian_ref(x, conn, g9, u, lam, w, mat, 0.1),)),
    ]
    h = pairs[2][1][0]
    pairs.append((ops.direction_pass(x, conn, g9, h),
                  tsoa.direction_pass_ref(x, conn, g9, h)))
    for got, want in pairs:
        for a_, b_ in zip(got, want):
            assert torch.equal(a_, b_)
    assert all(v == 0 for v in ops.launches.values())


def test_wrappers_reject_bad_inputs():
    rti, _ = _D()
    u, lam, w = (_t(a) for a in _lame())
    F0 = _t(_F("random"))
    a = torch.tensor(0.5, dtype=torch.float64)
    mat = tsoa.FCR_SOA
    with pytest.raises(TypeError):       # mixed dtypes
        ops.ls_trial_energy(F0.float(), None, a, u, lam, w, mat)
    with pytest.raises(ValueError):      # wrong shape
        ops.ls_trial_energy(F0[:8], None, a, u, lam, w, mat)
    with pytest.raises(ValueError):      # not contiguous
        ops.ls_trial_energy(F0.T.contiguous().T, None, a, u, lam, w, mat)
    conn = torch.as_tensor(_conn(2 * N)).long()
    x = torch.zeros((2 * N, 3), dtype=torch.float64)
    with pytest.raises(TypeError):       # corner ids must be int32
        ops.direction_pass(x, conn, _t(rti))
    with pytest.raises(RuntimeError):    # no kernel for this device
        ops.direction_pass(x.to("meta"), conn.int().to("meta"),
                           _t(rti).to("meta"))
