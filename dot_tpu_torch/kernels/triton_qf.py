"""K4 direction_pass in Triton: one corner gather of a direction p feeds
both its deformation gradients F(p) and the DOT alpha-init quadratic form.

Replaces System.quadratic_form (dot_tpu/steppers/core.py:1604-1621) with
the gather it shares with DOTStepper.alpha0_and_fp (steppers/dot.py:33-40,
core.py:522-541 defgrad_from_corners). Bound on the H100: memory. Per
element it reads 4 corner ids (16 B), 4 x 3 gathered p values (48 B f32,
L2-resident: p is 200 KB at bar17), restTriInv (36 B) and the 144 Hessian
rows (576 B f32), and writes F(p) (36 B): ~710 B per element, 61 MB at the
bar17 size (86,016 elements), 18 us at 3.35 TB/s. Design: each program
takes BLOCK elements; every one of the 144 block-major Hessian rows is read
once, as one coalesced vector load, and multiplied with the two gathered
corner values it pairs; the per-program sums go to a partials buffer that
a one-program second pass adds in a fixed order (no atomics), so the
alpha-init is the same from run to run.

`triton` is imported inside the launcher: the CPU test machines have none.
"""

from __future__ import annotations

import torch

BLOCK = 128
_kernels = None


def _build():
    # Triton resolves the names a kernel uses (tl, the helpers) in the
    # module's globals, so they are bound there, at first launch
    global triton, tl, _sel3, _sel4
    import triton
    import triton.language as tl

    @triton.jit
    def _sel3(k: tl.constexpr, v0, v1, v2):
        if k == 0:
            r = v0
        elif k == 1:
            r = v1
        else:
            r = v2
        return r

    @triton.jit
    def _sel4(k: tl.constexpr, v0, v1, v2, v3):
        if k == 0:
            r = v0
        elif k == 1:
            r = v1
        elif k == 2:
            r = v2
        else:
            r = v3
        return r

    @triton.jit
    def direction_kernel(p_ptr, conn_ptr, g_ptr, h_ptr, f_ptr, part_ptr, n,
                         HAS_H: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        c0 = tl.load(conn_ptr + offs, mask=m, other=0).to(tl.int64) * 3
        c1 = tl.load(conn_ptr + n + offs, mask=m, other=0).to(tl.int64) * 3
        c2 = tl.load(conn_ptr + 2 * n + offs, mask=m, other=0).to(tl.int64) * 3
        c3 = tl.load(conn_ptr + 3 * n + offs, mask=m, other=0).to(tl.int64) * 3
        x0 = tl.load(p_ptr + c0, mask=m, other=0.0)
        y0 = tl.load(p_ptr + c0 + 1, mask=m, other=0.0)
        z0 = tl.load(p_ptr + c0 + 2, mask=m, other=0.0)
        x1 = tl.load(p_ptr + c1, mask=m, other=0.0)
        y1 = tl.load(p_ptr + c1 + 1, mask=m, other=0.0)
        z1 = tl.load(p_ptr + c1 + 2, mask=m, other=0.0)
        x2 = tl.load(p_ptr + c2, mask=m, other=0.0)
        y2 = tl.load(p_ptr + c2 + 1, mask=m, other=0.0)
        z2 = tl.load(p_ptr + c2 + 2, mask=m, other=0.0)
        x3 = tl.load(p_ptr + c3, mask=m, other=0.0)
        y3 = tl.load(p_ptr + c3 + 1, mask=m, other=0.0)
        z3 = tl.load(p_ptr + c3 + 2, mask=m, other=0.0)
        # F = [p1 - p0, p2 - p0, p3 - p0] @ restTriInv
        for i in tl.static_range(3):
            e0 = _sel3(i, x1, y1, z1) - _sel3(i, x0, y0, z0)
            e1 = _sel3(i, x2, y2, z2) - _sel3(i, x0, y0, z0)
            e2 = _sel3(i, x3, y3, z3) - _sel3(i, x0, y0, z0)
            for j in tl.static_range(3):
                ga = tl.load(g_ptr + j * n + offs, mask=m, other=0.0)
                gb = tl.load(g_ptr + (3 + j) * n + offs, mask=m, other=0.0)
                gc = tl.load(g_ptr + (6 + j) * n + offs, mask=m, other=0.0)
                tl.store(f_ptr + (3 * i + j) * n + offs,
                         e0 * ga + e1 * gb + e2 * gc, mask=m)
        if HAS_H:
            acc = tl.zeros([BLOCK], dtype=x0.dtype)
            for a in tl.static_range(4):
                for b in tl.static_range(4):
                    for i in tl.static_range(3):
                        pa = _sel3(i, _sel4(a, x0, x1, x2, x3),
                                   _sel4(a, y0, y1, y2, y3),
                                   _sel4(a, z0, z1, z2, z3))
                        for j in tl.static_range(3):
                            pb = _sel3(j, _sel4(b, x0, x1, x2, x3),
                                       _sel4(b, y0, y1, y2, y3),
                                       _sel4(b, z0, z1, z2, z3))
                            comp = (a * 4 + b) * 9 + i * 3 + j
                            h = tl.load(h_ptr + comp * n + offs, mask=m,
                                        other=0.0)
                            acc += h * pa * pb
            tl.store(part_ptr + pid, tl.sum(acc, axis=0))

    @triton.jit
    def sum_partials_kernel(part_ptr, out_ptr, m, BLOCK: tl.constexpr):
        offs = tl.arange(0, BLOCK)
        acc = tl.zeros([BLOCK], dtype=part_ptr.dtype.element_ty)
        for start in range(0, m, BLOCK):
            acc += tl.load(part_ptr + start + offs, mask=start + offs < m,
                           other=0.0)
        tl.store(out_ptr, tl.sum(acc, axis=0))

    return direction_kernel, sum_partials_kernel


def launch(p, conn, g9, elem_h):
    """Launch K4 on CUDA tensors already checked by ops.direction_pass.
    Returns (F (9, N), q 0-d tensor or None)."""
    global _kernels
    if _kernels is None:
        _kernels = _build()
    direction_kernel, sum_partials_kernel = _kernels
    n = conn.shape[1]
    grid = (-(-n // BLOCK),)
    F = torch.empty((9, n), dtype=p.dtype, device=p.device)
    has_h = elem_h is not None
    part = torch.empty(grid[0] if has_h else 1, dtype=p.dtype, device=p.device)
    direction_kernel[grid](p, conn, g9, elem_h if has_h else g9, F, part, n,
                           HAS_H=has_h, BLOCK=BLOCK, num_warps=4)
    if not has_h:
        return F, None
    q = torch.empty((), dtype=p.dtype, device=p.device)
    sum_partials_kernel[(1,)](part, q, grid[0], BLOCK=1024, num_warps=4)
    return F, q
