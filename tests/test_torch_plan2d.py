"""The port's 2D decomposition plans (dot_tpu_torch.plan2d) against
dot_tpu.dim2's on the CPU: the element plan (4 parts and 1), the node plan
(4 parts) and, on other shapes, 3- and 2-part plans give dot_tpu's arrays
element by element when both pad n2 to 64; and the tables the 2D kernels
read (kernels/dd2d.py) describe the same assembly as the plan.
"""

import numpy as np
import pytest
import torch

from dot_tpu import dim2 as jdim2
from dot_tpu.config import Config as JConfig
from dot_tpu_torch import dim2, plan2d
from dot_tpu_torch.config import Config
from dot_tpu_torch.kernels import dd2d

FIELDS = ("part", "local_to_global", "local_valid", "dup", "asm_src",
          "asm_dest", "gath_perm", "gath_segids")
# (shape, kind, parts)
CASES = [("spikes", "element", 4), ("spikes", "element", 1),
         ("spikes", "node", 4), ("Sharkey", "element", 3),
         ("grid", "node", 2)]


def _meshes(shape):
    kw = dict(energy="FCR", time_stepper="DOT", dt=0.025, rho=1000.0,
              ym=1e5, pr=0.4, script="stretch", handle_ratio=0.03,
              shape=shape, resolution=200)
    return (jdim2.Mesh2D.from_config(JConfig(**kw)),
            dim2.Mesh2D.from_config(Config(**kw)))


def _plans(shape, kind, parts, pad_to=64):
    jm, m = _meshes(shape)
    if kind == "element":
        return (jdim2.build_plan_2d(jm, parts),
                plan2d.build_plan_2d(m, parts, pad_to=pad_to), m)
    return (jdim2.build_node_plan_2d(jm, parts),
            plan2d.build_node_plan_2d(m, parts, pad_to=pad_to), m)


@pytest.mark.parametrize("shape,kind,parts", CASES)
def test_plan_arrays_equal_dot_tpu(shape, kind, parts):
    jp, p, _ = _plans(shape, kind, parts)
    assert (p.n_parts, p.n_local_max, p.n2) == (jp.n_parts, jp.n_local_max,
                                                jp.n2)
    for f in FIELDS:
        a, b = getattr(p, f), np.asarray(getattr(jp, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if kind == "node":
        assert p.dup.max() == 1
    elif parts > 1:
        assert p.dup.max() > 1
    else:
        assert (p.dup == 1).all() and p.local_valid.sum() == p.dup.size


@pytest.mark.parametrize("pad_to", [8, 128])
def test_pad_is_an_argument(pad_to):
    """The pad moves n2 and the destinations only: the same tuples in the
    same order, rows and columns unchanged."""
    jp, p, _ = _plans("spikes", "element", 4, pad_to=pad_to)
    assert p.n2 % pad_to == 0 and p.n2 >= 2 * int(p.local_valid.sum(1).max())
    np.testing.assert_array_equal(p.asm_src, jp.asm_src)

    def rc(q):
        d, n2 = q.asm_dest.astype(np.int64), q.n2
        return d // (n2 * n2), d % (n2 * n2) // n2, d % n2
    for a, b in zip(rc(p), rc(jp)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,kind,parts", CASES)
def test_slot_tables_hold_the_plan(shape, kind, parts):
    """K26's tables: each slot's run is the plan's entries for that slot in
    plan order, every diagonal slot is present, and the sources point at
    the same element Hessian entries in K23's row-major order."""
    _, p, m = _plans(shape, kind, parts)
    tab = dd2d.subdomain_tables(p, m.n_elem, "cpu")
    n, P = p.n2, p.n_parts
    assert (tab.n_parts, tab.n_loc, tab.n, tab.dof) == (P, p.n_local_max, n, 2)
    ud, off = tab.udest.numpy(), tab.seg_off.numpy()
    assert (np.diff(ud) > 0).all() and off[0] == 0 and off[-1] == p.asm_src.size
    diag = (np.arange(P)[:, None] * n * n
            + np.arange(n)[None, :] * (n + 1)).reshape(-1)
    assert np.isin(diag, ud).all()
    dest = p.asm_dest.astype(np.int64)
    order = np.argsort(dest, kind="stable")
    np.testing.assert_array_equal(np.repeat(ud, np.diff(off)), dest[order])
    np.testing.assert_array_equal(tab.items.numpy(), tab.src.numpy()[order])
    # block-major (a*3+b)*4 + i*2+j  ->  row-major (a*2+i)*6 + b*2+j
    assert sorted(dd2d.BLOCK_TO_ROW.tolist()) == list(range(36))
    src = p.asm_src.astype(np.int64)
    comp, e = src // m.n_elem, src % m.n_elem
    a, b, i, j = comp // 12, comp // 4 % 3, comp % 4 // 2, comp % 2
    np.testing.assert_array_equal(tab.src.numpy(),
                                  ((a * 2 + i) * 6 + b * 2 + j) * m.n_elem + e)


def test_pd_tables():
    """K28's tables: value (a*3+b)*N + e lands at conn[e,a]*nV + conn[e,b]
    (dot_tpu/dim2.py:707-709), each slot's run in element order."""
    _, m = _meshes("spikes")
    tab = dd2d.pd_tables(m.conn, m.n_vert, "cpu")
    n = m.n_elem
    src, dest = tab.src.numpy(), tab.dest.numpy()
    ab, e = src // n, src % n
    np.testing.assert_array_equal(
        dest, m.conn[e, ab // 3] * m.n_vert + m.conn[e, ab % 3])
    np.testing.assert_array_equal(e, np.repeat(np.arange(n), 9))
    assert (tab.n_parts, tab.n, tab.dof) == (1, m.n_vert, 1)
    items = tab.items.numpy()
    off = tab.seg_off.numpy()
    for k in range(0, tab.udest.shape[0], 97):
        run = items[off[k]:off[k + 1]] % n
        assert (np.diff(run) > 0).all()
    assert np.isin(np.arange(m.n_vert) * (m.n_vert + 1),
                   tab.udest.numpy()).all()
    assert tab.items.dtype == torch.int32
