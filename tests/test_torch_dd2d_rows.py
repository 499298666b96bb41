"""The row-ordered slot tables of K26 / K28's one-pass kernel
(kernels/dd2d.py SlotTables: row_off, col, int32 items / seg_off) and the
kernel's CPU mirror dd2d.assemble_rows_ref, on the CPU.

The tables of every caller of the kernel on the spikes scene (resolution
200): K24's whole-mesh tables (one part, 2 dofs: dd2d.dense_tables), K26's
subdomain tables (element plan, P 1, 2 and 4, 2 dofs a vertex), K28's PD
tables (one part, 1 dof) and 2D ADMM-DD's W, consensus C and own-element
tables (P 1, 2 and 4):
- row_off / col hold exactly the slots of udest, in row order, the int32
  runs are the int64 ones, and the own tables mark W's slots;
- the mirror, one warp a row piece writing its piece in column chunks of
  one, two and 32 aligned 16 B vectors, with rows cut into pieces of 3 and
  of the kernel's 512 vectors (a row of 128 spans many chunks and pieces;
  K28's rows of width 2 mod 4 start off 32 B alignment and take a
  head and a tail), and with the row's slots taken in windows of 5 as
  well as the kernel's 128, gives the plain versions' matrices bit for
  bit in f64 and f32: H, d, and |H - H^T| = 0 (K24's plain version adds
  the mass before the free mask, the kernel after it: the same bits);
- a fan whose centre vertex has 70 neighbours (rows of 142 slots, more
  than one window of dd2d.MAX_ROW), alone and in a strip of 301 vertices
  with its ids shuffled (the long rows' slots in every piece of a row),
  assembles through the mirror, which walks the windows as the kernel
  does, as the plain versions do, on K24's tables and on K26's (two
  parts).
The plain versions are held against dot_tpu in tests/test_torch_dim2_dd.py
and tests/test_torch_admmdd2d.py, the kernel against both on the card in
tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

from dot_tpu_torch import dim2, plan2d, scripts
from dot_tpu_torch.config import Config
from dot_tpu_torch.kernels import admm2d, dd2d, soa2d

KW = dict(energy="FCR", time_stepper="ADMMDD", dt=0.025, rho=1000.0,
          ym=1e5, pr=0.4, script="stretch", handle_ratio=0.03,
          shape="spikes", resolution=200)
# (table, parts)
TABLES = ([("dense", 1)] + [("subdomain", P) for P in (1, 2, 4)]
          + [("pd", 1)]
          + [(k, P) for k in ("w", "c", "own") for P in (1, 2, 4)])


@functools.lru_cache(maxsize=None)
def _scene(parts):
    """(ADMMDD2D stepper on the P-part element plan of the scene, a
    deformed x): its System2D holds K26's tables, the stepper W, C and
    own tables."""
    cfg = Config(partition_amt=parts, **KW)
    m = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(m, cfg.script)
    m.fixed_mask = sd.fixed0.copy()
    sysm = dim2.System2D(m, cfg, device="cpu",
                         plan=plan2d.build_plan_2d(m, parts))
    dd = dim2.ADMMDD2D(sysm, sd)
    rng = np.random.default_rng(20261017 + parts)
    h = float(np.sqrt(m.area.mean()))
    x = torch.as_tensor(sd.x0, dtype=torch.float64).clone()
    x[:, :2] += torch.as_tensor(0.2 * h * rng.normal(size=(m.n_vert, 2)))
    return dd, x


def _table(kind, parts):
    dd, _ = _scene(parts)
    if kind == "dense":
        return dd.system.dense_tab
    if kind == "subdomain":
        return dd.system.asm_tab
    if kind == "pd":
        return dd2d.pd_tables(dd.system.mesh.conn, dd.system.n_vert, "cpu")
    return {"w": dd.w_tab, "c": dd.c_tab, "own": dd.own_tab}[kind]


@pytest.mark.parametrize("kind,parts", TABLES)
def test_row_tables_hold_udest(kind, parts):
    tab = _table(kind, parts)
    P, n = tab.n_parts, tab.n
    assert tab.dof == (1 if kind == "pd" else 2)
    assert P == (1 if kind in ("dense", "pd", "c") else parts)
    for key in ("items", "seg_off", "row_off", "col"):
        assert getattr(tab, key).dtype == torch.int32, key
    ro, col = tab.row_off.numpy(), tab.col.numpy()
    ud = tab.udest.numpy()
    assert ro.shape == (P * n + 1,) and ro[0] == 0 and ro[-1] == ud.size
    assert (np.diff(ro) >= 1).all()            # every row has its diagonal
    assert tab.max_row == np.diff(ro).max() <= dd2d.MAX_ROW
    assert ((col >= 0) & (col < n)).all()
    row = np.repeat(np.arange(P * n, dtype=np.int64), np.diff(ro))
    np.testing.assert_array_equal(row * n + col, ud)
    # ADMM-DD's own tables mark W's slots (where its kernel reads W)
    if kind == "own":
        w = _scene(parts)[0].tables.w_dest
        np.testing.assert_array_equal(tab.extra.numpy(), np.isin(ud, w))
        assert tab.extra.dtype == torch.uint8
    else:
        assert tab.extra is None
    # the int32 runs are the int64 ones: items = src in stable slot order
    order = np.argsort(tab.dest.numpy(), kind="stable")
    np.testing.assert_array_equal(tab.items.numpy(), tab.src.numpy()[order])
    np.testing.assert_array_equal(
        np.repeat(ud, np.diff(tab.seg_off.numpy())),
        tab.dest.numpy()[order])


def _inputs(kind, parts, dtype):
    """(values, free, mass, wadd) of the kernel entry behind `kind`, and
    the plain version's (H, d) on the same inputs."""
    dd, x = _scene(parts)
    sysm = dd.system
    fixed = torch.as_tensor(dd.script_data.fixed0)
    free = dd._free(fixed).to(dtype)
    eh = sysm.element_hessians(x).to(dtype)
    tab = _table(kind, parts)
    if kind == "dense":
        fv = torch.logical_not(fixed).to(dtype)
        mass = sysm.mass.to(dtype)
        H, d = soa2d.dense_assemble2d_ref(eh, fv, mass, tab)
        return (eh, fv[None], mass[None], None), (H[None], d[None])
    if kind == "subdomain":
        args = (eh, free, sysm.mass_img.to(dtype), None)
        return args, dd2d._assemble_ref(eh, free, args[2], tab)
    if kind == "pd":
        w = sysm.scalar(sysm.dt_sq) * sysm.vol_w * (2.0 * sysm.u_e
                                                    + sysm.lam_e)
        fv = torch.logical_not(fixed).to(dtype)
        S, d = dd2d.pd_assemble2d_ref(sysm.g4.to(dtype), w.to(dtype), fv,
                                      sysm.mass.to(dtype), tab)
        vals = dd2d.pd_pair_vals2d(sysm.g4.to(dtype), w.to(dtype))
        return (vals, fv[None], sysm.mass.to(dtype)[None], None), \
            (S[None], d[None])
    sfree = torch.cat([torch.logical_not(fixed[dd.shared_ids]).to(dtype),
                       torch.zeros(1, dtype=dtype)])
    Wm, C, dc = admm2d.w_assemble2d_ref(eh, free, sfree, dd.md_sh.to(dtype),
                                        dd.w_tab, dd.c_tab)
    if kind == "w":
        return (eh, free, None, None), (Wm, None)
    if kind == "c":
        return (eh, sfree[None], dd.md_sh.to(dtype)[None], None), \
            (C[None], dc[None])
    xl = dd._to_flat(x[sysm.l2g][:, :, :2] * sysm.local_valid[..., None])
    ehl = sysm.k.elem_hessian2d(xl, dd.conn_local, dd.lg4, dd.lu, dd.llam,
                                dd.lw, sysm.mat, sysm.dt_sq).to(dtype)
    mass = (dd.mass_local + dd.mass_dif * free).to(dtype)
    return (ehl, free, mass, Wm), admm2d.local_h_assemble2d_ref(
        ehl, Wm, free, mass, tab)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind,parts", TABLES)
def test_rows_ref_is_the_plain_version_bit_for_bit(kind, parts, dtype):
    tab = _table(kind, parts)
    (vals, free, mass, wadd), (Hr, dr) = _inputs(kind, parts, dtype)
    # (one part has no interface: W is 0)
    assert (float(Hr.abs().max()) > 0) == (kind != "w" or parts > 1)
    if kind == "pd" and dtype == torch.float32:
        assert tab.n % 4 != 0           # rows off 32 B alignment
    # column chunks of 1 and 2 vectors and pieces of 3 (a row spans many),
    # the kernel's 32 and 512; windows of 5 slots and the kernel's 128
    for lanes, seg, win in ((1, 3, 5), (2, 3, dd2d.MAX_ROW),
                            (32, dd2d.SEG_VECS, 5),
                            (32, dd2d.SEG_VECS, dd2d.MAX_ROW)):
        H, d = dd2d.assemble_rows_ref(vals, free, mass, tab, wadd=wadd,
                                      lanes=lanes, seg_vecs=seg, window=win)
        assert torch.equal(H, Hr), lanes
        assert torch.equal(H, H.mT), lanes
        if dr is None:
            assert d is None
        else:
            assert torch.equal(d, dr), lanes
    if kind in ("subdomain", "own"):
        # padding rows: the unit diagonal alone
        pad = torch.repeat_interleave(~_scene(parts)[0].system.local_valid,
                                      2, dim=-1)
        assert bool((H[pad].abs().sum(-1) == 1).all())


def _fan(k=70, n_vert=None, seed=0):
    """A fan of k triangles around vertex 0 (ring vertices 1..k, closed):
    vertex 0 has k neighbours, its two rows 2 (k + 1) slots. With n_vert:
    a strip of triangles over the vertices past the ring, up to n_vert,
    and the vertex ids shuffled (seeded), so that the long rows' columns
    spread over the whole width."""
    i = np.arange(1, k + 1)
    conn = np.stack([np.zeros(k, np.int64), i, i % k + 1], axis=1)
    if n_vert is None:
        return conn
    j = np.arange(k + 1, n_vert - 2)
    conn = np.concatenate([conn, np.stack([j, j + 1, j + 2], axis=1)])
    return np.random.default_rng(seed).permutation(n_vert)[conn]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["dense", "subdomain"])
@pytest.mark.parametrize("n_vert", [None, 301])
def test_rows_longer_than_a_window(n_vert, kind, dtype):
    """Rows of 142 slots (> dd2d.MAX_ROW, the slots the kernel's warp holds
    at once): the mirror walks them in windows and gives the plain
    versions' matrices bit for bit: K24's whole-mesh tables, and K26's of
    two parts (the fan in each, numbered locally). The fan alone (rows of
    142 columns) and the fan in a strip of 301 vertices with its ids
    shuffled (rows of 602 columns, most of them off 32 B alignment: the
    long rows' slots spread over every piece of a row, so that a piece
    skips the windows left of it and carries its window from chunk to
    chunk); with the kernel's pieces, chunks and windows, and with pieces
    of 3 and 16 vectors, chunks of 1 and 2 and windows of 5."""
    conn = _fan(n_vert=n_vert)
    nv, n_el = conn.max() + 1, conn.shape[0]
    rng = np.random.default_rng(5)

    def t(a):
        return torch.as_tensor(a, dtype=dtype)
    if kind == "dense":
        tab = dd2d.dense_tables(conn, nv, "cpu")
        parts, n_val = 1, n_el
    else:
        # part p holds elements p n_el .. (p + 1) n_el - 1 of the values
        parts, n_val = 2, 2 * n_el
        dof = np.stack([2 * conn[:, c] + i for c in range(3)
                        for i in range(2)], axis=1)
        dest = np.repeat(dof, 6, axis=1) * (2 * nv) + np.tile(dof, (1, 6))
        src = np.arange(36)[None, :] * n_val + np.arange(n_el)[:, None]
        tab = dd2d.slot_tables(
            np.concatenate([src, src + n_el]).reshape(-1),
            np.concatenate([dest, dest + (2 * nv) ** 2]).reshape(-1),
            parts, nv, 2, "cpu")
    assert tab.max_row == 2 * (70 + 1) > dd2d.MAX_ROW
    vals = t(np.abs(rng.normal(size=(36, n_val))))   # d = sqrt(diag) real
    free = t((rng.uniform(size=(parts, nv)) > 0.2).astype(np.float64))
    free[:, conn[0, 0]] = 1.0              # the long rows stay free
    mass = t(rng.uniform(1.0, 2.0, size=(parts, nv)))
    Hr, dr = dd2d._assemble_ref(vals, free, mass, tab)
    for lanes, seg, win in ((32, dd2d.SEG_VECS, dd2d.MAX_ROW), (1, 3, 5),
                            (2, 16, dd2d.MAX_ROW)):
        H, d = dd2d.assemble_rows_ref(vals, free, mass, tab, lanes=lanes,
                                      seg_vecs=seg, window=win)
        assert torch.equal(H, Hr) and torch.equal(d, dr), (lanes, seg, win)
    if kind == "dense":
        Hk, dk = soa2d.dense_assemble2d_ref(vals, free[0], mass[0], tab)
        assert torch.equal(H[0], Hk) and torch.equal(d[0], dk)
