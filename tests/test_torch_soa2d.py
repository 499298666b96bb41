"""dot_tpu_torch.kernels.soa2d (the plain PyTorch versions of the 2D
kernels) against dot_tpu.kernels.soa2d on the same numpy inputs: the 2x2
flip-SVD, eigh2 / make_pd2, the three materials' sigma-space functions and
first Piola stress, defgrad2, the element gradient and the 6x6 element
Hessian with and without the SPD projection. f64 at 1e-12 (the element
gradient and Hessian 1e-10), one f32 case each at 1e-5.

U and V are not unique where F is a scaled rotation or s0 = s1, and eigh2's
Q is not at b = 0, a = c: sigma, U diag(sigma) V^T, the eigenvalues,
Q diag(lam) Q^T and everything built from them are compared, never U, V or
Q alone; P and H only where the polar factor is unique (Q = |(E, H)| well
away from 0).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dot_tpu.kernels import soa2d as jsoa
from dot_tpu_torch.kernels import soa2d as tsoa

MATS = sorted(tsoa.SOA2D_MATERIALS)
DTYPES = {"f64": (np.float64, torch.float64, 1e-12, 1e-10),
          "f32": (np.float32, torch.float32, 1e-5, 1e-5)}


def _j(a):
    """Rows of a numpy array as a tuple of jnp lanes."""
    return tuple(jnp.asarray(r) for r in a)


def _t(a):
    return tuple(torch.as_tensor(np.ascontiguousarray(r)) for r in a)


def _np(lanes):
    return np.stack([np.asarray(x) for x in lanes])


def _close(got, want, tol):
    """Max error relative to the reference's largest entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _matrices(rng, np_dt, n=96):
    """(4, n): random, inverted, near-rank-1, and the degenerate cases F = I
    (R = 0), a scaled rotation, a reflection (Q = 0) and F = 0."""
    F = rng.normal(size=(4, n)) * 1.2
    F[:, 0] = (1.0, 0.0, 0.0, 1.0)
    F[:, 1] = (0.0, -2.0, 2.0, 0.0)
    F[:, 2] = (1.0, 0.0, 0.0, -1.0)
    F[:, 3] = 0.0
    F[:, 4] = (1.0, 0.0, 0.0, -2.0)           # inverted
    third = n // 3
    inv = np.eye(2).reshape(4, 1) + 0.1 * rng.normal(size=(4, third))
    inv[[0, 2]] *= -1.0
    F[:, third:2 * third] = inv
    m = n - 2 * third
    uv = rng.normal(size=(2, m))[:, None] * rng.normal(size=(2, m))[None]
    F[:, 2 * third:] = uv.reshape(4, m) + 1e-9 * rng.normal(size=(4, m))
    return F.astype(np_dt)


def _polar_unique(F, floor=0.05):
    """Columns where the rotation U V^T is well defined."""
    E, H = 0.5 * (F[0] + F[3]), 0.5 * (F[2] - F[1])
    return np.sqrt(E * E + H * H) > floor * np.abs(F).max(axis=0).clip(1e-300)


def _params(n, np_dt):
    ym, pr = 1.0e5, 0.4
    u = np.full(n, ym / (2.0 * (1.0 + pr)), np_dt)
    lam = np.full(n, ym * pr / ((1.0 + pr) * (1.0 - 2.0 * pr)), np_dt)
    return u, lam


def _usv(U, s, V):
    return np.stack([U[2 * i] * s[0] * V[2 * j] + U[2 * i + 1] * s[1] * V[2 * j + 1]
                     for i in range(2) for j in range(2)])


@pytest.mark.parametrize("prec", sorted(DTYPES))
def test_svd2_flip(rng, prec):
    np_dt, _, tol, _ = DTYPES[prec]
    F = _matrices(rng, np_dt)
    Uj, sj, Vj = (_np(x) for x in jsoa.svd2_flip_soa(_j(F)))
    Ut, st, Vt = (_np(x) for x in tsoa.svd2_flip_soa(_t(F)))
    _close(st, sj, tol)
    _close(_usv(Ut, st, Vt), _usv(Uj, sj, Vj), tol)
    _close(_usv(Ut, st, Vt), F, 10 * tol)
    for M in (Ut, Vt):                       # proper rotations
        np.testing.assert_allclose(M[0] * M[3] - M[1] * M[2], 1.0,
                                   atol=10 * tol)
    assert (st[0] >= np.abs(st[1]) - 10 * tol).all()
    det = F[0].astype(np.float64) * F[3] - F[1].astype(np.float64) * F[2]
    assert (np.sign(st[1])[np.abs(det) > 1e-3] ==
            np.sign(det)[np.abs(det) > 1e-3]).all()
    assert st[1][4] < 0                       # the inverted case
    # the stacked reference the CUDA check entry is held against
    U2, s2, V2 = tsoa.svd2_flip_ref(torch.as_tensor(F))
    assert torch.equal(s2, torch.as_tensor(st))


@pytest.mark.parametrize("prec", sorted(DTYPES))
def test_eigh2_and_make_pd2(rng, prec):
    np_dt, _, tol, _ = DTYPES[prec]
    h = rng.normal(size=(3, 64))
    h[:, 0] = (2.0, 0.0, 2.0)                 # b = 0, a = c
    h[:, 1] = (1.0, 0.0, -3.0)
    h[:, 2] = (-1.0, 0.5, -2.0)               # negative definite
    h = h.astype(np_dt)
    (lj, Qj), (lt, Qt) = jsoa.eigh2_soa(*_j(h)), tsoa.eigh2_soa(*_t(h))
    lj, Qj, lt, Qt = _np(lj), _np(Qj), _np(lt), _np(Qt)
    _close(lt, lj, tol)

    def rec(l_, Q):
        return np.stack([l_[0] * Q[0] * Q[0] + l_[1] * Q[1] * Q[1],
                         l_[0] * Q[0] * Q[2] + l_[1] * Q[1] * Q[3],
                         l_[0] * Q[2] * Q[2] + l_[1] * Q[3] * Q[3]])
    _close(rec(lt, Qt), rec(lj, Qj), tol)
    _close(rec(lt, Qt), h, 10 * tol)
    assert (lt[0] >= lt[1]).all()
    pj, pt = _np(jsoa.make_pd2_soa(_j(h))), _np(tsoa.make_pd2_soa(_t(h)))
    _close(pt, pj, tol)
    np.testing.assert_allclose(pt[:, 2], 0.0, atol=10 * tol)
    assert torch.equal(tsoa.make_pd2_ref(torch.as_tensor(h)),
                       torch.as_tensor(pt))


@pytest.mark.parametrize("name", MATS)
@pytest.mark.parametrize("prec", sorted(DTYPES))
def test_material_sigma_functions(rng, prec, name):
    """psi, dpsi, d2psi, b_left on singular values, inverted and nearly
    flat ones among them."""
    np_dt, _, tol, _ = DTYPES[prec]
    s = np.concatenate([np.ones((2, 2)), rng.uniform(0.2, 2.5, size=(2, 40)),
                        np.array([[1.5], [-0.3]]), np.array([[2.0], [1e-4]])],
                       axis=1).astype(np_dt)
    u, lam = _params(s.shape[1], np_dt)
    mj, mt = jsoa.SOA2D_MATERIALS[name], tsoa.SOA2D_MATERIALS[name]
    tu, tl = torch.as_tensor(u), torch.as_tensor(lam)
    _close(mt.psi(_t(s), tu, tl), mj.psi(_j(s), u, lam), tol)
    _close(_np(mt.dpsi(_t(s), tu, tl)), _np(mj.dpsi(_j(s), u, lam)), tol)
    _close(_np(mt.d2psi(_t(s), tu, tl)), _np(mj.d2psi(_j(s), u, lam)), tol)
    _close(mt.b_left(_t(s), tu, tl), mj.b_left(_j(s), u, lam), tol)
    assert mt.name == mj.name == name


@pytest.mark.parametrize("name", MATS)
@pytest.mark.parametrize("prec", sorted(DTYPES))
def test_first_piola(rng, prec, name):
    np_dt, _, tol, _ = DTYPES[prec]
    F = _matrices(rng, np_dt)
    F = F[:, _polar_unique(F)]
    u, lam = _params(F.shape[1], np_dt)
    mj, mt = jsoa.SOA2D_MATERIALS[name], tsoa.SOA2D_MATERIALS[name]
    Pj = _np(mj.first_piola(_j(F), *jsoa.svd2_flip_soa(_j(F)), u, lam))
    Pt = _np(mt.first_piola(_t(F), *tsoa.svd2_flip_soa(_t(F)),
                            torch.as_tensor(u), torch.as_tensor(lam)))
    _close(Pt, Pj, 10 * tol)
    # the stacked 11-row reference of the CUDA check entry: P in rows 7-10
    rows = tsoa.material2d_ref(torch.as_tensor(F), torch.as_tensor(u),
                               torch.as_tensor(lam), mt)
    assert rows.shape == (11, F.shape[1])
    assert torch.equal(rows[7:], torch.as_tensor(Pt))


def _mesh_inputs(rng, np_dt):
    """A small triangle mesh (a jittered grid) with rest data, deformed
    positions (some triangles inverted) and material parameters."""
    from dot_tpu_torch.dim2 import Mesh2D
    from dot_tpu_torch import mesh_gen
    V, Fc, border = mesh_gen.grid_2d(size=1.0, elem_amt=60)
    mesh = Mesh2D(V, Fc, border=border)
    x = mesh.V.copy()
    x[:, :2] += 0.08 * rng.normal(size=(mesh.n_vert, 2))
    return mesh, x.astype(np_dt)


@pytest.mark.parametrize("prec", sorted(DTYPES))
def test_defgrad2(rng, prec):
    np_dt, t_dt, tol, _ = DTYPES[prec]
    mesh, x = _mesh_inputs(rng, np_dt)
    g = mesh.rest_tri_inv.reshape(-1, 4).T.astype(np_dt)
    conn = mesh.conn.T
    Fj = _np(jsoa.defgrad2_soa(_j(x.T[:2]), tuple(jnp.asarray(c) for c in conn),
                               _j(g)))
    Ft = tsoa.defgrad2d_ref(torch.as_tensor(x),
                            torch.as_tensor(conn, dtype=torch.int32),
                            torch.as_tensor(g))
    _close(Ft.numpy(), Fj, tol)
    # at rest F = I
    F0 = tsoa.defgrad2d_ref(torch.as_tensor(mesh.V.astype(np_dt)),
                            torch.as_tensor(conn, dtype=torch.int32),
                            torch.as_tensor(g))
    np.testing.assert_allclose(F0.numpy(), np.array([[1.0], [0], [0], [1]])
                               * np.ones((1, mesh.n_elem)), atol=100 * tol)


def _elem_args(mesh, x, np_dt):
    g = mesh.rest_tri_inv.reshape(-1, 4).T.astype(np_dt)
    D = np.concatenate([-mesh.rest_tri_inv.sum(axis=1, keepdims=True),
                        mesh.rest_tri_inv], axis=1).astype(np_dt)  # (nE,3,2)
    u, lam = mesh.u.astype(np_dt), mesh.lam.astype(np_dt)
    w = mesh.area.astype(np_dt)
    conn = tuple(jnp.asarray(c) for c in mesh.conn.T)
    Fj = jsoa.defgrad2_soa(_j(x.T[:2]), conn, _j(g))
    Dj = [[jnp.asarray(D[:, c, j]) for j in range(2)] for c in range(3)]
    return g, u, lam, w, Fj, Dj


@pytest.mark.parametrize("name", MATS)
@pytest.mark.parametrize("prec", sorted(DTYPES))
def test_element_gradient2(rng, prec, name):
    np_dt, t_dt, _, tol = DTYPES[prec]
    mesh, x = _mesh_inputs(rng, np_dt)
    g, u, lam, w, Fj, Dj = _elem_args(mesh, x, np_dt)
    mj, mt = jsoa.SOA2D_MATERIALS[name], tsoa.SOA2D_MATERIALS[name]
    gj = jsoa.element_gradient2_soa(mj, Fj, *jsoa.svd2_flip_soa(Fj), Dj, u,
                                    lam, w)
    gj = np.stack([np.asarray(gj[c][i]) for c in range(3) for i in range(2)])
    Ft = tuple(tsoa.defgrad2d_ref(torch.as_tensor(x), torch.as_tensor(
        mesh.conn.T, dtype=torch.int32), torch.as_tensor(g)))
    gt = tsoa.element_gradient2_soa(
        mt, Ft, *tsoa.svd2_flip_soa(Ft), tsoa.corner_basis2(torch.as_tensor(g)),
        torch.as_tensor(u), torch.as_tensor(lam), torch.as_tensor(w))
    gt = np.stack([gt[c][i].numpy() for c in range(3) for i in range(2)])
    ok = _polar_unique(_np(Fj))
    assert ok.sum() > 0.8 * mesh.n_elem
    _close(gt[:, ok], gj[:, ok], tol)


@pytest.mark.parametrize("project", [True, False], ids=["spd", "raw"])
@pytest.mark.parametrize("name", MATS)
@pytest.mark.parametrize("prec", sorted(DTYPES))
def test_element_hessian2(rng, prec, name, project):
    np_dt, t_dt, _, tol = DTYPES[prec]
    mesh, x = _mesh_inputs(rng, np_dt)
    g, u, lam, w, Fj, Dj = _elem_args(mesh, x, np_dt)
    mj, mt = jsoa.SOA2D_MATERIALS[name], tsoa.SOA2D_MATERIALS[name]
    Uj, sj, Vj = jsoa.svd2_flip_soa(Fj)
    Hj = _np(jsoa.element_hessian2_soa(mj, Uj, sj, Vj, Dj, u, lam, w,
                                       project_spd=project))
    Ht = tsoa.elem_hessian2d_ref(
        torch.as_tensor(x), torch.as_tensor(mesh.conn.T, dtype=torch.int32),
        torch.as_tensor(g), torch.as_tensor(u), torch.as_tensor(lam),
        torch.as_tensor(w), mt, 1.0, project_spd=project).numpy()
    # the twist term divides by s0 + s1 = 2 Q: compare where it is well
    # away from the 1e-6 clamp
    ok = _polar_unique(_np(Fj))
    _close(Ht[:, ok], Hj[:, ok], 10 * tol)
    H6 = Ht.reshape(6, 6, -1)
    np.testing.assert_array_equal(H6, H6.transpose(1, 0, 2))
    if project:
        ev = np.linalg.eigvalsh(H6.transpose(2, 0, 1).astype(np.float64))
        assert ev.min() >= -1e-6 * np.abs(ev).max()
