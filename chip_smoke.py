#!/usr/bin/env python3
"""Smoke run of the dot_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases probe,build,kernels,golden,main,steppers,admm,scale,dim2,dim2dd,dim2admm]

Phases (each prints its lines; any failure exits non-zero before the
result line):
  probe    device name, `nvidia-smi` name and power limit, nvcc and triton
  build    the CUDA sources of csrc/ (K1-K3 elem.cu, K5 band_asm.cu, K6
           chol_inv.cu, K31 schur.cu, K7 (K15's solve too) block_matvec.cu,
           K8 and K16 h0.cu, K10-K11 coarse.cu, K12 band_equil.cu, K13
           hdiag.cu, K14 pd.cu, K17 / K18 / K20 admm.cu, K21-K24
           elem2d.cu, K25-K28 dd2d.cu, K32 trsolve.cu, K33 dense_chol.cu,
           K34 whole_chol.cu, K29 / K30 admm2d.cu; K19 and the
           per-slab / from-F entry points of K1 / K2 live in band_asm.cu
           and elem.cu, those of K21 / K22 in elem2d.cu, K26's W and
           local-Hessian entries in dd2d.cu; K9 lbfgs.cu) with nvcc for
           sm_90a, one nvcc per source, all at once; K4 with Triton
  kernels  each kernel against its plain PyTorch version on the card at the
           bar17 shapes, f64 and f32, with max errors against the
           tolerances, median times, the time of one PyTorch library call
           computing the same function where there is one (where the one
           call covers only the scatter of values computed outside it, the
           record holds library_ms null and the call's time as
           library_partial_ms), and the bound
           (the larger of bytes / 3.35 TB/s and operations / the unit's
           peak): K1-K4 on random, inverted and near-degenerate
           deformations of the bar17 mesh (86,016 tets, 16,473 vertices)
           from a seed; K5-K8 on the real bar17 plan (P 6, nb 13, bs 768)
           and its assembled blocks: the band, the 36 odd diagonal blocks
           of the first cyclic-reduction level (K6 symmetrized, and its
           6-block root batch lower-only; one indefinite block must come
           back flagged and NaN; one launch a call), K6 at its callers'
           other widths (a 2,000^2 block in both modes, the batch-1 block
           of Newton's exact scan on bar17's P = 1 plan, widths 37 and
           770: one launch a call; indefinite 770^2 blocks flagged and NaN
           in both modes at batch 1 and 3), K9's two entries at bar17's
           shape (m 5, n 49,419), K31 at the bar135 scan step (133 x 768)
           and a P = 1 scan's (1 x 768: "@p1"; against the f32 product,
           1e-6 norm-wise on the lower triangle, two calls bit for bit,
           one launch a call; timed with the casts + f32 GEMM + subtraction
           it replaced and torch.bmm(out_dtype=float32) where the card's
           torch has it), K7's solve entry on the factor and on one
           subdomain's strided slice of it (one cooperative launch a solve:
           the plain version's result within K7's tolerance, two calls bit
           for bit, one device kernel in a CUDA graph capture and in
           torch.profiler's trace, single and back-to-back times), the
           vertex gather and averaging; K13 on the same element Hessians,
           K16 on the same plan; K14 and K15 on the bar17 PD band (bs 512,
           nb 33): the assembled band and pd_solve as one launch of K7's
           solve entry ("pd": against the plain gather, 3-column products
           and scatter, one device kernel a call, single and back-to-back
           times); K17 (with the Newton iterations and
           energy evaluations each element took, which must equal the plain
           version's and which set its bound), its SPD projection alone,
           and K18 with both epilogues at the ADMM-PD shapes on random,
           inverted and near-degenerate Dx + u; K19, K20 (its diagonal
           flag, and its line-search entry w_quad against its plain version
           and the two w_matvec + sums it replaced, the same bits in two
           runs, one device kernel a call) and the per-slab / from-F entry
           points of K1 / K2 on the
           real bar17 own-element plan (P 6, the ADMM-DD plan's W); the 2D
           device functions (svd2_flip, eigh2, make_pd2, the three
           materials) through their check entries, defgrad2d and K21-K24 at
           the full-size 2D scene's shapes (K24's assembly, K26's one pass
           on whole-mesh tables: bit for bit the plain version's host sums,
           one device kernel a call, back-to-back times, rows of 282 slots
           on a fan, spread over several pieces of 2,202-column rows)
           (spikes at resolution 20,000:
           19,873 triangles, 10,171 vertices, a (20,342)^2 dense matrix) on
           random, inverted, near-degenerate and rest-state deformations;
           K25-K28 at the
           dim2dd path's shapes (the same scene on the 4-part element plan:
           P 4, n2p 5,248; K28 on the 10,171^2 PD matrix) on a deformed
           configuration, and factorize_fast's global 1e-4 tier on an
           indefinite subdomain (every subdomain refactored, one host
           read); K32 on that plan's factor (f32: its error against an f64
           solve of the factor within twice the library pair's; f64 1e-12
           against the pair; bit for bit run to run and in a P = 1 slice;
           one device kernel a call; back-to-back times); K33 on that
           plan's scaled subdomain matrices (f32: its error against an f64
           factor within 1.5x the library Cholesky's; f64 1e-12 against
           its plain version; bit for bit run to run; exact zeros above
           the diagonal; one device kernel a call; back-to-back times
           beside cholesky_ex alone); K34 on the spikes Newton matrix
           at the scene's start (n 20,342) and the scaled PD matrix (n
           10,171), f32: its error against an f64 factor at most the
           library Cholesky's, bit for bit run to run, exact zeros above
           the diagonal, one device kernel a call, times beside its plain
           version, cholesky_ex alone and the bound; K29 (with its
           loop counts, which set its bound) and K30
           with both epilogues on the full-size scene's triangles, and the
           per-slab / from-F entries of K21 / K22 and K26's W / consensus
           and local-Hessian entries on its 4-part ADMM-DD tables; K26's
           three entries and its scaling and K28 also by the device
           kernels one call runs (torch.profiler: one write pass, K28 its
           pair values + one, no zero fill; launches_per_call in the
           record) (`--phases kernels2d` runs the 2D checks alone)
  golden   bar 8x3x3, DOT with 4 parts, f64, 5 frames: sysE against the
           recorded golden trace (rtol 2e-4)
  main     bar17 twist, DOT 6, f32, relTol 1e-5 through sim.Simulator:
           1 warm-up + 10 timed frames; convergence, the H0 factor's kind
           (cyclic reduction, 2 levels, bf16 leaves), kernel launch counts
           (K1-K9), output files; 3 more frames with the H0 rebuild and
           apply timed (synchronised); then 3 frames with the plain
           versions of the kernels on the same card (sysE rtol 1e-3)
  steppers bar17 twist, f32, relTol 1e-5, through sim.Simulator, 3 frames
           each (Newton 2): DOT 6 (the yardstick), LBFGS (LBFGS-PD: exact
           f32 P = 1 BTDFactor of the PD band; K14; pd_solve one launch of
           K7's solve entry an iteration), GSDD 6 (K16 and K7
           on one subdomain's blocks: 2 launches of K16 per subdomain per
           sweep), DOT 6 with warmStart 5 (K13 once a frame), Newton (one
           exact P = 1 banded factorization per inner iteration), LBFGSH,
           LBFGSHI (factor from a matrix rounded through bf16), LBFGSJH 6
           (node plan, dense blocks); K7's solve entry on Newton's P = 1
           factor (f32, and its leaves cast to f64). Each run: finite sysE,
           stopped by tol or rel_dec, the factor's kind, its kernels launched, sysE against
           the plain-path run of the same frames (rtol 1e-3) and against
           DOT's (rtol 1e-3; LBFGSJH and GSDD 5e-3)
  admm     bar17 twist, f32, relTol 1e-5, through sim.Simulator, 2 frames
           each: `timeStepper ADMM` (K17, K18, K14, pd_solve one launch an
           iteration and the global K1 / K2 passes; one host read an
           iteration) and `timeStepper ADMMDD 6` (K19, K20, its diagonal
           flag and w_quad once an iteration, both new entry points,
           K3, K6, K7, K2; banded_local and an exact f32 BTDFactor
           (13, 6, 768, 768) as the local factor). Each run: finite sysE,
           every frame stopped by tol or at its cap (printed), iterations,
           syncs, s/frame, peak memory, its kernels launched, sysE against
           the plain-path run of the same frames (rtol 1e-3) and against
           DOT 6's (gated at rtol 1e-3 where the frames stopped by tol,
           printed where one hit its cap)
  scale    bar135 twist (131x31x31 cells, 755,346 tets, 135,168 vertices),
           `timeStepper DOT -1 1024` (tools/scalability.py's protocol),
           f32: mesh and plan built once (P 133, nb 8, bs 768; the coarse
           space and the chunked bf16 rebuild engage). Through
           sim.Simulator: 1 warm-up + 3 timed frames (P, coarse, chunked
           BTDFactor with bf16 leaves and kc_chol checked; every frame
           finite and stopped by tol or rel_dec; K9-K12, K5's compact
           entry point and K31 launched), 2 more frames with the rebuild
           (elem H / coarse factor / compact / K12 / scan) and the apply (fine /
           coarse) timed; K9-K12 and K5's compact entry point against their
           plain versions on the real plan, owner map, element Hessians and
           L-BFGS history (K9's two entries), and K6 and K7 at this
           path's own shapes (the (6P)^2 coarse block, the scan's
           lower-only (133, 768, 768) stage), K7's solve entry on the
           run's scan factor and on the coarse pair Lc^{-T} Lc^{-1}
           (library: two torch.mv), f64 and f32, timed with library and
           bound; the first 2 frames again with the plain versions (sysE
           rtol 1e-3)
  dim2     the 2D path through dim2.Sim2D on scene files written here:
           the spikes stretch golden (resolution 200, Newton, f64, kernels
           on: sysE against the recorded trace at rtol 2e-4, z = 0, the
           output files, no .msh), then the same scene at resolution 20,000
           in f32 (f64 instead, with a printed finding, if f32 does not
           reach relTol 1e-5): 1 warm-up + 3 timed frames, every frame
           finite and stopped by tol or rel_dec, z = 0, K21-K24 launched
           (K23 and K24 once an iteration), peak memory; 2 more frames with
           the assembly (K23 + K24), the library Cholesky, the triangular
           solves, the line search (K21) and the gradient (K22) timed; the
           same frames with the plain versions (sysE rtol 1e-3)
  dim2dd   the 2D decomposed path through dim2.Sim2D: the spikes golden
           under DOT 4 (f64, kernels on: sysE rtol 2e-4, z = 0), 2D Newton's
           frames at resolution 20,000 (f32) as the yardstick, then the
           same scene in f32 (f64 with a printed finding where f32 misses
           relTol) under DOT 4 (1 warm-up + 3 frames and 2 more with the
           rebuild (K23 / K26 / Cholesky), the apply (K27 / solves), K25,
           the line search (K21) and the gradient (K22) timed), GSDD 4,
           LBFGS, LBFGSH, LBFGSHI and LBFGSJH 4 (1 + 2 frames each): every
           frame finite, stopped by tol or rel_dec, z = 0; iterations
           (sweeps), halvings, syncs, s/frame, peak memory; K25 once a DOT
           iteration, K26 once a rebuild, K27 once an H0 apply (GSDD: 2 P
           a sweep), K28 once an LBFGS run; sysE against the plain path's
           same frames (rtol 1e-3) and Newton's (1e-3; GSDD, LBFGSJH 5e-3)
  dim2admm the 2D ADMM family through dim2.Sim2D: the spikes golden under
           ADMM and ADMMDD 4 (f64, kernels on: sysE rtol 2e-4, z = 0),
           then the full-size scene in f32 under ADMM (1 warm-up + 2
           frames) and ADMMDD 4 (1 + 1): every frame finite and stopped by
           tol or at its cap (printed), iterations, syncs, s/frame, peak
           memory, the launches of K29 / K30 (once an ADMM-PD iteration)
           and of the four ADMM-DD entries, sysE against the plain path's
           first frame (rtol 1e-3) and against 2D Newton's frames (1e-3
           where every frame stopped by tol, printed otherwise)
The last three lines are nvidia-smi's name and power limit, the kernels'
JSON record (per kernel: launches of all paths' runs and
launches_by_path {main, steppers, admm, scale, dim2, dim2dd, dim2admm};
times at the
bar17 shapes, the 2D kernels' at the full-size spikes scene's; under "bar135"
K6's, K7's and K9's at the bar135 shapes; K6's at its other widths under
"split2000", "lower2000", "newton", "w37", "w770") and {"ok": true,
"device": {...}}. Exits non-zero without a result
line when no CUDA device is present.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# Recorded golden sysE trace of the bar 8x3x3 DOT twist (f64), copied from
# tests/test_golden.py:23-29 (the tests import jax, so this script cannot
# import them).
GOLDEN_SYS_E = [
    7.529949140714e+01,
    7.420914838503e+01,
    7.326224468377e+01,
    7.243233402989e+01,
    7.174690962232e+01,
]

# Recorded golden sysE trace of the 2D spikes stretch scene (FCR, dt 0.025,
# E 1e5, nu 0.4, rho 1000, resolution 200, Newton, f64), copied from
# tests/test_dim2.py:241-245.
GOLDEN_2D_SPIKES_SYS_E = [
    3.294256031942e+03,
    3.294256605060e+03,
    3.300416677680e+03,
]
SPIKES_SCENE = """energy FCR
timeStepper {stepper}
warmStart 2
resolution {resolution}
size 1
time 5 0.025
density 1000
stiffness 100000 0.4
script stretch
handleRatio 0.03
shape spikes
"""
# the full-size 2D scene: 19,873 triangles, 10,171 vertices, a dense
# (20,342)^2 whole-mesh factor (1.655 GB in f32) every Newton iteration
SPIKES_FULL = 20000
DIM2_FRAMES = 3
DIM2_KERNELS = ("defgrad2d", "ls_trial_energy2d", "elem_gradient2d",
                "elem_hessian2d", "dense_assemble2d", "dense_scale2d")
# operations per triangle of K21-K23, counted from kernels/csrc/elem2d.cuh
# (two atan2 and two sincos in the SVD, one more of each in eigh2); an
# estimate: these kernels are bound by their bytes either way
ELEM2D_FLOPS = dict(ls_trial_energy2d=120, elem_gradient2d=180,
                    elem_hessian2d=600)
# the 2D decomposed path (dim2dd): the full-size spikes scene under each
# stepper of slice 1b: (scene's timeStepper line, timed frames after one
# warm-up, sysE rtol against 2D Newton's same frames: 1e-3, GSDD and the
# block-Jacobi LBFGS-JH 5e-3 as at dim 3). DOT 4 is the path's main run.
DD2D_PARTS = 4
DIM2DD_RUNS = {
    "DOT4": ("DOT 4", 3, 1e-3),
    "GSDD4": ("GSDD 4", 2, 5e-3),
    "LBFGS": ("LBFGS", 2, 1e-3),
    "LBFGSH": ("LBFGSH", 2, 1e-3),
    "LBFGSHI": ("LBFGSHI", 2, 1e-3),
    "LBFGSJH4": ("LBFGSJH 4", 2, 5e-3),
}
DD2D_KERNELS = ("quadratic_form2d", "subdomain_assemble2d",
                "subdomain_scale2d", "h0_gather2d", "h0_average2d",
                "local_gather_one2d", "local_scatter_one2d", "pd_assemble2d",
                "tri_solve", "dense_chol")
# the 2D ADMM family (dim2admm): the full-size spikes scene under each ADMM
# stepper: (scene's timeStepper line, timed frames after one warm-up)
DIM2ADMM_RUNS = {"ADMM": ("ADMM", 2), "ADMMDD4": ("ADMMDD 4", 1)}
ADMM2D_KERNELS = ("admm_local_step2d", "dtw_scatter2d",
                  "ls_trial_energy2d_parts", "elem_gradient2d_from_F",
                  "w_assemble2d", "local_h_assemble2d")
# K29 per triangle, counted from kernels/csrc/admm2d.cu and elem2d.cuh: the
# flip-SVD (two atan2, two sincos) once, then per Newton iteration dpsi,
# d2psi, the 2x2 eigendecomposition of make_pd2 (one atan2, one sincos) and
# the adjugate solve, and per energy evaluation psi and the distance term;
# multiplied by the counts the kernel reports
K29_FLOPS = dict(svd=120, newton=110, energy=15)

BAR17 = (56, 16, 16)
SCENE_TMPL = """energy FCR
timeStepper DOT 6
warmStart 2
resolution 1000
size 1
time 5 0.025
density 1000
stiffness 100000 0.4
script twist
shape input {mesh_path}
"""
# kernel vs plain tolerances: f64 on sigma, Psi, the sums, F(p) and the
# gradient 1e-10, on H 1e-9; f32 1e-5 on sigma, Psi, the sums and F(p), and
# norm-wise 1e-4 on the gradient (atomics reorder its sums) and on H
TOL = {"float64": dict(elem=1e-10, grad=1e-10, hess=1e-9),
       "float32": dict(elem=1e-5, grad=1e-4, hess=1e-4)}
SOURCES = {
    "ls_trial_energy": ("cuda", "dot_tpu_torch/kernels/csrc/elem.cu",
                        "dot_tpu/steppers/quasi_newton.py:32"),
    "elem_gradient": ("cuda", "dot_tpu_torch/kernels/csrc/elem.cu",
                      "dot_tpu/kernels/soa.py:450"),
    "elem_hessian": ("cuda", "dot_tpu_torch/kernels/csrc/elem.cu",
                     "dot_tpu/kernels/soa.py:458"),
    "direction_pass": ("triton", "dot_tpu_torch/kernels/triton_qf.py",
                       "dot_tpu/steppers/core.py:1604"),
    "band_assemble": ("cuda", "dot_tpu_torch/kernels/csrc/band_asm.cu",
                      "dot_tpu/steppers/core.py:750"),
    "chol_inv": ("cuda", "dot_tpu_torch/kernels/csrc/chol_inv.cu",
                 "dot_tpu/steppers/core.py:904"),
    "schur_update": ("cuda", "dot_tpu_torch/kernels/csrc/schur.cu",
                     "dot_tpu/steppers/core.py:1544"),
    "block_solve": ("cuda", "dot_tpu_torch/kernels/csrc/block_matvec.cu",
                    "dot_tpu/steppers/core.py:1061"),
    "h0_gather": ("cuda", "dot_tpu_torch/kernels/csrc/h0.cu",
                  "dot_tpu/steppers/core.py:1263"),
    "h0_average": ("cuda", "dot_tpu_torch/kernels/csrc/h0.cu",
                   "dot_tpu/steppers/core.py:1263"),
    "lbfgs_first": ("cuda", "dot_tpu_torch/kernels/csrc/lbfgs.cu",
                    "dot_tpu/steppers/quasi_newton.py:116"),
    "lbfgs_second": ("cuda", "dot_tpu_torch/kernels/csrc/lbfgs.cu",
                     "dot_tpu/steppers/quasi_newton.py:116"),
    "coarse_assemble": ("cuda", "dot_tpu_torch/kernels/csrc/coarse.cu",
                        "dot_tpu/steppers/core.py:1319"),
    "coarse_restrict": ("cuda", "dot_tpu_torch/kernels/csrc/coarse.cu",
                        "dot_tpu/steppers/core.py:1296"),
    "coarse_prolong": ("cuda", "dot_tpu_torch/kernels/csrc/coarse.cu",
                       "dot_tpu/steppers/core.py:1296"),
    "band_compact": ("cuda", "dot_tpu_torch/kernels/csrc/band_asm.cu",
                     "dot_tpu/steppers/core.py:733"),
    "band_equil_scatter": ("cuda", "dot_tpu_torch/kernels/csrc/band_equil.cu",
                           "dot_tpu/steppers/core.py:1465"),
    "hessian_diag": ("cuda", "dot_tpu_torch/kernels/csrc/hdiag.cu",
                     "dot_tpu/steppers/core.py:1587"),
    "pd_assemble": ("cuda", "dot_tpu_torch/kernels/csrc/pd.cu",
                    "dot_tpu/steppers/core.py:1656"),
    "local_gather_one": ("cuda", "dot_tpu_torch/kernels/csrc/h0.cu",
                         "dot_tpu/steppers/core.py:1282"),
    "local_scatter_one": ("cuda", "dot_tpu_torch/kernels/csrc/h0.cu",
                          "dot_tpu/steppers/core.py:1287"),
    "admm_local_step": ("cuda", "dot_tpu_torch/kernels/csrc/admm.cu",
                        "dot_tpu/steppers/admm.py:142"),
    "dtw_scatter": ("cuda", "dot_tpu_torch/kernels/csrc/admm.cu",
                    "dot_tpu/steppers/admm.py:216"),
    "own_band_assemble": ("cuda", "dot_tpu_torch/kernels/csrc/band_asm.cu",
                          "dot_tpu/steppers/core.py:811"),
    "w_matvec": ("cuda", "dot_tpu_torch/kernels/csrc/admm.cu",
                 "dot_tpu/steppers/admm_dd.py:221"),
    "w_diag": ("cuda", "dot_tpu_torch/kernels/csrc/admm.cu",
               "dot_tpu/steppers/admm_dd.py:244"),
    "w_quad": ("cuda", "dot_tpu_torch/kernels/csrc/admm.cu",
               "dot_tpu/steppers/admm_dd.py:524"),
    "ls_trial_energy_parts": ("cuda", "dot_tpu_torch/kernels/csrc/elem.cu",
                              "dot_tpu/steppers/admm_dd.py:532"),
    "elem_gradient_from_F": ("cuda", "dot_tpu_torch/kernels/csrc/elem.cu",
                             "dot_tpu/steppers/admm_dd.py:295"),
    "defgrad2d": ("cuda", "dot_tpu_torch/kernels/csrc/elem2d.cu",
                  "dot_tpu/kernels/soa2d.py:233"),
    "ls_trial_energy2d": ("cuda", "dot_tpu_torch/kernels/csrc/elem2d.cu",
                          "dot_tpu/dim2.py:911"),
    "elem_gradient2d": ("cuda", "dot_tpu_torch/kernels/csrc/elem2d.cu",
                        "dot_tpu/dim2.py:463"),
    "elem_hessian2d": ("cuda", "dot_tpu_torch/kernels/csrc/elem2d.cu",
                       "dot_tpu/kernels/soa2d.py:252"),
    "dense_assemble2d": ("cuda", "dot_tpu_torch/kernels/csrc/dd2d.cu",
                         "dot_tpu/dim2.py:486"),
    "dense_scale2d": ("cuda", "dot_tpu_torch/kernels/csrc/elem2d.cu",
                      "dot_tpu/dim2.py:494"),
    "quadratic_form2d": ("cuda", "dot_tpu_torch/kernels/csrc/dd2d.cu",
                         "dot_tpu/dim2.py:557"),
    "subdomain_assemble2d": ("cuda", "dot_tpu_torch/kernels/csrc/dd2d.cu",
                             "dot_tpu/dim2.py:588"),
    "subdomain_scale2d": ("cuda", "dot_tpu_torch/kernels/csrc/dd2d.cu",
                          "dot_tpu/dim2.py:604"),
    "h0_gather2d": ("cuda", "dot_tpu_torch/kernels/csrc/dd2d.cu",
                    "dot_tpu/dim2.py:645"),
    "h0_average2d": ("cuda", "dot_tpu_torch/kernels/csrc/dd2d.cu",
                     "dot_tpu/dim2.py:645"),
    "local_gather_one2d": ("cuda", "dot_tpu_torch/kernels/csrc/dd2d.cu",
                           "dot_tpu/dim2.py:631"),
    "local_scatter_one2d": ("cuda", "dot_tpu_torch/kernels/csrc/dd2d.cu",
                            "dot_tpu/dim2.py:637"),
    "pd_assemble2d": ("cuda", "dot_tpu_torch/kernels/csrc/dd2d.cu",
                      "dot_tpu/dim2.py:704"),
    "hessian_diag2d": ("cuda", "dot_tpu_torch/kernels/csrc/dd2d.cu",
                       "dot_tpu/dim2.py:567"),
    "tri_solve": ("cuda", "dot_tpu_torch/kernels/csrc/trsolve.cu",
                  "dot_tpu/dim2.py:623"),
    "dense_chol": ("cuda", "dot_tpu_torch/kernels/csrc/dense_chol.cu",
                   "dot_tpu/dim2.py:604"),
    "whole_chol": ("cuda", "dot_tpu_torch/kernels/csrc/whole_chol.cu",
                   "dot_tpu/dim2.py:496"),
    "admm_local_step2d": ("cuda", "dot_tpu_torch/kernels/csrc/admm2d.cu",
                          "dot_tpu/steppers/admm.py:142"),
    "dtw_scatter2d": ("cuda", "dot_tpu_torch/kernels/csrc/admm2d.cu",
                      "dot_tpu/dim2.py:823"),
    "ls_trial_energy2d_parts": ("cuda", "dot_tpu_torch/kernels/csrc/elem2d.cu",
                                "dot_tpu/dim2.py:1173"),
    "elem_gradient2d_from_F": ("cuda", "dot_tpu_torch/kernels/csrc/elem2d.cu",
                               "dot_tpu/dim2.py:1182"),
    "w_assemble2d": ("cuda", "dot_tpu_torch/kernels/csrc/dd2d.cu",
                     "dot_tpu/dim2.py:1123"),
    "local_h_assemble2d": ("cuda", "dot_tpu_torch/kernels/csrc/dd2d.cu",
                           "dot_tpu/dim2.py:1206"),
}
PATHS = ("main", "steppers", "admm", "scale", "dim2", "dim2dd", "dim2admm")
ALL_PHASES = ("probe", "build", "kernels", "golden", "main", "steppers",
              "admm", "scale", "dim2", "dim2dd", "dim2admm")
# kernels whose one library call covers only the scatter of values computed
# outside the timed call (per-element forces, gathered or scaled values):
# no PyTorch call computes their function, so the record holds
# library_ms null and that call's time as library_partial_ms
PARTIAL_LIBRARY = ("elem_gradient", "h0_average", "hessian_diag",
                   "pd_assemble", "dtw_scatter", "w_matvec", "w_diag", "w_quad",
                   "elem_gradient_from_F", "elem_gradient2d", "h0_average2d",
                   "hessian_diag2d", "coarse_restrict", "band_compact",
                   "dtw_scatter2d", "elem_gradient2d_from_F")
# the card's peaks (H100 SXM data sheet)
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
# operations per element of K1-K3, counted from kernels/csrc/elem.cuh
# (the 3x3 SVD's Jacobi sweeps dominate); an estimate: these kernels are
# bound by their bytes by a wide margin either way
ELEM_FLOPS = dict(ls_trial_energy=900, elem_gradient=1100,
                  elem_hessian=4000)
# K17 per element (f32 sweep counts): the flip-SVD once, then per Newton
# iteration the 3x3 Jacobi eigendecomposition of d2psi (4 sweeps x 3
# rotations), dpsi, d2psi and the adjugate solve, and per energy evaluation
# psi and the distance term; multiplied by the counts the kernel reports
K17_FLOPS = dict(svd=900, newton=900, energy=40)
BAR135 = (131, 31, 31)
SCALE_SCENE = SCENE_TMPL.replace("timeStepper DOT 6",
                                 "timeStepper DOT -1 1024")
# the entry points each path must launch (bar17: no coarse space, no
# chunked band; bar135 takes the chunked band instead of K5's band)
MAIN_KERNELS = ("ls_trial_energy", "elem_gradient", "elem_hessian",
                "direction_pass", "band_assemble", "chol_inv",
                "block_solve", "h0_gather", "h0_average", "lbfgs_first",
                "lbfgs_second")
SCALE_KERNELS = tuple(k for k in MAIN_KERNELS if k != "band_assemble") + (
    "coarse_assemble", "coarse_restrict", "coarse_prolong", "band_compact",
    "band_equil_scatter", "schur_update")
# the steppers phase: (scene's timeStepper line, warmStart, frames, sysE rtol
# against DOT, the kernels the run must launch beyond the shared per-element
# passes). sysE against DOT: 1e-3 as tests/test_lbfgs_variants.py, 5e-3 for
# the block-Jacobi LBFGS-JH (there too) and for GSDD, whose sweeps meet the
# same gradient tolerance with more low-frequency error left (dot_tpu's own
# tests/test_admm.py:63 holds it at 3e-3 after 2 frames; it grows by frame)
_QN = ("lbfgs_first", "lbfgs_second")
_H0 = ("elem_hessian", "chol_inv", "block_solve", "h0_gather", "h0_average")
STEPPER_RUNS = {
    "LBFGS": ("LBFGS", 2, 3, 1e-3, _QN + (
        "pd_assemble", "chol_inv", "block_solve")),
    "GSDD6": ("GSDD 6", 2, 3, 5e-3, (
        "elem_hessian", "band_assemble", "chol_inv", "block_solve",
        "local_gather_one", "local_scatter_one")),
    "DOT6ws5": ("DOT 6", 5, 3, 1e-3, _QN + _H0 + ("band_assemble",
                                                  "hessian_diag")),
    "Newton": ("Newton", 2, 2, 1e-3, _H0 + ("band_assemble",)),
    "LBFGSH": ("LBFGSH", 2, 3, 1e-3, _QN + _H0 + ("band_assemble",)),
    "LBFGSHI": ("LBFGSHI", 2, 3, 1e-3, _QN + _H0 + ("band_assemble",)),
    "LBFGSJH6": ("LBFGSJH 6", 2, 3, 5e-3, _QN + (
        "elem_hessian", "chol_inv", "h0_gather", "h0_average")),
}
# the admm phase: (scene's timeStepper line, the kernels the run must launch)
ADMM_FRAMES = 2
ADMM_RUNS = {
    "ADMM": ("ADMM", (
        "admm_local_step", "dtw_scatter", "pd_assemble", "chol_inv",
        "block_solve", "ls_trial_energy", "elem_gradient",
        "direction_pass")),
    "ADMMDD6": ("ADMMDD 6", (
        "own_band_assemble", "w_matvec", "w_diag", "w_quad",
        "ls_trial_energy_parts",
        "elem_gradient_from_F", "elem_hessian", "chol_inv", "block_solve",
        "elem_gradient", "ls_trial_energy", "direction_pass")),
}
ADMM_KERNELS = ("admm_local_step", "dtw_scatter", "own_band_assemble",
                "w_matvec", "w_diag", "w_quad", "ls_trial_energy_parts",
                "elem_gradient_from_F")
STEPPER_KERNELS = ("hessian_diag", "pd_assemble", "local_gather_one",
                   "local_scatter_one")
# K9-K16 vs plain: f64 1e-12, f32 1e-5 max-rel and 1e-4 norm-wise (sums
# in another order); K12's bf16 band: at most 1 bf16 ulp apart
TOL_SCALE = {"float64": dict(elem=1e-12, sum=1e-12),
             "float32": dict(elem=1e-5, sum=1e-4)}
# K5-K8 vs plain: f64 1e-12 on K5, K7, K8 and 1e-10 on K6's L and L^{-1}
# (norm-wise); f32 1e-4 norm-wise (the plain versions' index_add_ and
# cuBLAS/cuSOLVER sum in other orders)
TOL_H0 = {"float64": dict(exact=1e-12, chol=1e-10),
          "float32": dict(exact=1e-4, chol=1e-4)}


class Fail(Exception):
    pass


def say(*a):
    print(*a, flush=True)


def nvidia_smi():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() \
            else f"nvidia-smi rc {r.returncode}"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def phase_probe(torch):
    import platform
    from dot_tpu_torch.kernels.csrc import build
    say(f"probe: device {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, python {platform.python_version()}")
    say(f"probe: nvidia-smi: {nvidia_smi()}")
    r = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                       text=True, timeout=60)
    rel = [ln for ln in r.stdout.splitlines() if "release" in ln]
    say(f"probe: nvcc: {rel[0].strip() if rel else r.stdout.strip()}")
    import triton
    say(f"probe: triton {triton.__version__}; g++ "
        f"{'present' if shutil.which('g++') else 'absent'}")


def phase_build(torch):
    from dot_tpu_torch.kernels import ops, triton_qf
    from dot_tpu_torch.kernels.csrc import build
    t0 = time.perf_counter()
    ops._load()
    t1 = time.perf_counter()
    for lib in build.LIBRARIES:
        log = build.log_path(lib)
        if not os.path.exists(log):   # absent when already built
            continue
        name, spill = "?", ""
        with open(log) as f:
            for ln in f:
                m = re.search(r"Function properties for (_Z\w+)", ln)
                if m:
                    name = m.group(1)[:60]
                elif "spill stores" in ln:
                    spill = ln.strip()
                elif "Used" in ln and "registers" in ln:
                    regs = re.search(r"Used (\d+) registers", ln).group(1)
                    smem = re.search(r"(\d+) bytes smem", ln)
                    say(f"build: ptxas {lib} {name}: {regs} registers, "
                        f"{smem.group(1) if smem else 0} B static smem; "
                        f"{spill}")
    # K4: compile on a tiny input (the first launch of each variant
    # compiles it)
    dev = torch.device("cuda")
    for dt in (torch.float32, torch.float64):
        p = torch.zeros((4, 3), dtype=dt, device=dev)
        conn = torch.zeros((4, 2), dtype=torch.int32, device=dev)
        g9 = torch.zeros((9, 2), dtype=dt, device=dev)
        h = torch.zeros((144, 2), dtype=dt, device=dev)
        triton_qf.launch(p, conn, g9, None)
        triton_qf.launch(p, conn, g9, h)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    say(f"build: nvcc {len(build.LIBRARIES)} sources in parallel "
        f"{t1 - t0:.1f} s (sm_90a), triton K4 {t2 - t1:.1f} s")


def _bar17_inputs(torch, dtype, rng):
    """Element statics of the bar17 mesh and deformed states: a third of
    the vertices jittered (random and inverted elements), a third squashed
    flat (near-degenerate F), the rest at rest (repeated sigma = 1)."""
    from dot_tpu_torch.mesh_gen import bar_mesh
    mesh = bar_mesh(*BAR17, size=(4.0, 1.0, 1.0))
    mesh.set_lame(1e5, 0.4)
    dev = torch.device("cuda")
    n, nv = mesh.n_elem, mesh.n_vert

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    x = mesh.V.copy()
    sel = rng.permutation(nv)
    a, b = sel[:nv // 3], sel[nv // 3: 2 * nv // 3]
    x[a] += rng.normal(scale=0.05, size=(len(a), 3))
    x[b, 1] = x[b, 1] * 1e-3
    f0 = np.empty((9, n))
    third = n // 3
    f0[:, :third] = rng.normal(size=(9, third))                   # random
    inv = np.eye(3).reshape(9, 1) + 0.1 * rng.normal(size=(9, third))
    inv[[0, 3, 6]] *= -1.0                                         # det < 0
    f0[:, third:2 * third] = inv
    m = n - 2 * third                                              # rank ~1
    uv = rng.normal(size=(3, m))[:, None] * rng.normal(size=(3, m))[None]
    f0[:, 2 * third:] = uv.reshape(9, m) + 1e-7 * rng.normal(size=(9, m))
    return dict(
        conn=t(mesh.conn.T, torch.int32),
        g9=t(mesh.rest_tri_inv.reshape(-1, 9).T),
        u=t(mesh.u), lam=t(mesh.lam), w=t(mesh.vol),
        x=t(x), p=t(rng.normal(scale=0.01, size=(nv, 3))),
        F0=t(f0), Fp=t(rng.normal(size=(9, n))),
        alpha=torch.tensor(0.5, dtype=dtype, device=dev))


def _median_ms(torch, fn, reps=15):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _time_pair(torch, kernel, plain, plain_reps=15):
    """(kernel ms, plain ms): medians, better of two rounds in the order
    plain, kernel, kernel, plain."""
    p1 = _median_ms(torch, plain, plain_reps)
    k1 = _median_ms(torch, kernel)
    k2 = _median_ms(torch, kernel)
    p2 = _median_ms(torch, plain, plain_reps)
    return min(k1, k2), min(p1, p2)


def _rel_max(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-300)


def _bound(nbytes, flops, rate=F32_FLOP_S):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the unit's peak."""
    tb = nbytes / HBM_BYTES_S * 1e3
    tf = flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _report(torch, tag, kname, checks, fns, cost, bad, record,
            plain_reps=15):
    """Time kernel / plain / library (fns: (kernel, plain, library or
    None)), print the checks against their limits and the times, and keep
    the f32 record (max_abs_err, ms, plain_ms, library_ms, bound; a
    PARTIAL_LIBRARY kernel's call as library_partial_ms). `plain_reps`:
    timed calls of the plain version per round (fewer for one that takes
    seconds)."""
    ms, plain_ms = _time_pair(torch, fns[0], fns[1], plain_reps)
    lib_ms = _median_ms(torch, fns[2]) if fns[2] is not None else None
    partial = kname.split("@")[0] in PARTIAL_LIBRARY
    bound_ms, bound_by = _bound(*cost)
    parts = []
    for what, err, lim, _abs in checks:
        parts.append(f"{what} rel {err:.3e} (tol {lim:g})")
        if not err <= lim:
            bad.append(f"{kname} {tag} {what}: {err:.3e} > {lim:g}")
    lib = "none" if lib_ms is None else (
        f"none (partial: index_add_ {lib_ms:.4f} ms)" if partial
        else f"{lib_ms:.4f} ms")
    say(f"kernels: {tag} {kname}: " + ", ".join(parts)
        + f"; {ms:.4f} ms vs plain {plain_ms:.4f} ms, library {lib}, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {cost[0] / 1e6:.1f} MB, "
        f"{cost[1] / 1e9:.3f} GFLOP)")
    if tag == "float32":
        abs_err = max(a for _, _, _, a in checks if a is not None)
        record[kname] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None if partial else lib_ms)
        if partial:
            record[kname]["library_partial_ms"] = lib_ms


def _solve_check(torch, tag, kname, kind, leaves, r, tol, bad, record,
                 library=None):
    """K7's solve entry on one factor (band.solve_program's `kind` on
    `leaves`, right-hand sides r): the plain version (band.block_solve_ref)
    within `tol` norm-wise, two calls bit for bit, one device kernel a call
    (_work_check); timed single and back to back against the plain version
    and `library` (one PyTorch call computing the same function, or None).
    The f32 record gets the back-to-back times, the stages and the device
    kernels a call."""
    from dot_tpu_torch.kernels import band, ops
    prog = band.solve_program(kind, leaves)
    z = ops.block_solve(prog, leaves, r)
    z2 = ops.block_solve(prog, leaves, r)
    ref = band.block_solve_ref(prog, leaves, r)
    n_dev = _work_check(tag, kname, lambda: ops.block_solve(prog, leaves, r),
                        1, ("solve_kernel",), bad)
    st = prog.stages
    checks = [
        ("two calls (bit for bit)",
         0.0 if torch.equal(z, z2) else max(_rel_max(z, z2), 1e-300),
         0.0, float((z - z2).abs().max())),
        ("vs plain", _rel_norm(z, ref), tol, float((z - ref).abs().max()))]
    say(f"kernels: {tag} {kname}: {kind}, P {prog.P}, nb {prog.nb}, n "
        f"{prog.n}, k {prog.k}, leaves "
        f"{str(leaves[0].dtype).split('.')[-1]}: {len(st)} stages "
        f"({int(st[:, band.F_SYNC].sum())} grid barriers)")
    fns = (lambda: ops.block_solve(prog, leaves, r),
           lambda: band.block_solve_ref(prog, leaves, r), library)
    _report(torch, tag, kname, checks, fns, band.solve_cost(prog, leaves, r),
            bad, record)
    b2b = _back_to_back_ms(torch, fns[0])
    lib_b2b = None if library is None else _back_to_back_ms(torch, library)
    say(f"kernels: {tag} {kname}: back to back {b2b:.4f} ms a solve"
        + ("" if lib_b2b is None else f", library {lib_b2b:.4f} ms"))
    if tag == "float32":
        record[kname].update(
            back_to_back_ms=b2b, library_back_to_back_ms=lib_b2b,
            stages=len(st), launches_per_call=n_dev)
    del z, z2, ref


def phase_kernels(torch, record):
    from dot_tpu_torch.kernels import ops, soa
    mat = soa.FCR_SOA
    rng = np.random.default_rng(20261016)
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        d = _bar17_inputs(torch, dtype, rng)
        conn, g9, u, lam, w = d["conn"], d["g9"], d["u"], d["lam"], d["w"]
        dt_sq = 0.025 ** 2
        res = {}

        k = ops.ls_trial_energy(d["F0"], d["Fp"], d["alpha"], u, lam, w, mat,
                                want_sigma=True)
        r = soa.ls_trial_energy_ref(d["F0"], d["Fp"], d["alpha"], u, lam, w,
                                    mat, want_sigma=True)
        ps_k = mat.psi(tuple(k[1]), u, lam)
        ps_r = mat.psi(tuple(r[1]), u, lam)
        res["ls_trial_energy"] = [
            ("sum", _rel_max(k[0], r[0]), tol["elem"],
             float((k[0] - r[0]).abs())),
            ("sigma", _rel_max(k[1], r[1]), tol["elem"],
             float((k[1] - r[1]).abs().max())),
            ("psi", _rel_max(ps_k, ps_r), tol["elem"], None)]

        args = (d["x"], conn, conn, g9, u, lam, w, mat)
        gk, gr = ops.elem_gradient(*args), soa.elem_gradient_ref(*args)
        res["elem_gradient"] = [("grad", _rel_norm(gk, gr), tol["grad"],
                                 float((gk - gr).abs().max()))]

        hargs = (d["x"], conn, g9, u, lam, w, mat, dt_sq)
        hk, hr = ops.elem_hessian(*hargs), soa.elem_hessian_ref(*hargs)
        res["elem_hessian"] = [("H", _rel_norm(hk, hr), tol["hess"],
                                float((hk - hr).abs().max()))]

        fk, qk = ops.direction_pass(d["p"], conn, g9, hr)
        fr, qr = soa.direction_pass_ref(d["p"], conn, g9, hr)
        res["direction_pass"] = [
            ("F(p)", _rel_max(fk, fr), tol["elem"],
             float((fk - fr).abs().max())),
            ("pHp", _rel_max(qk, qr), tol["elem"], float((qk - qr).abs()))]
        torch.cuda.synchronize()

        # library yardstick of K2: the scatter of per-corner forces alone
        n, nv, sz = conn.shape[1], d["x"].shape[0], d["x"].element_size()
        forces = torch.randn((4 * n, 3), dtype=dtype, device="cuda")
        cidx = conn.reshape(-1).long()
        acc = torch.zeros((nv + 1, 3), dtype=dtype, device="cuda")
        times = {
            "ls_trial_energy": (
                lambda: ops.ls_trial_energy(d["F0"], d["Fp"], d["alpha"], u,
                                            lam, w, mat),
                lambda: soa.ls_trial_energy_ref(d["F0"], d["Fp"], d["alpha"],
                                                u, lam, w, mat), None),
            "elem_gradient": (lambda: ops.elem_gradient(*args),
                              lambda: soa.elem_gradient_ref(*args),
                              lambda: acc.index_add_(0, cidx, forces)),
            "elem_hessian": (lambda: ops.elem_hessian(*hargs),
                             lambda: soa.elem_hessian_ref(*hargs), None),
            "direction_pass": (
                lambda: ops.direction_pass(d["p"], conn, g9, hr),
                lambda: soa.direction_pass_ref(d["p"], conn, g9, hr), None),
        }
        # (bytes each input read once + outputs written once, operations)
        costs = {
            "ls_trial_energy": ((21 * n + 2) * sz,
                                ELEM_FLOPS["ls_trial_energy"] * n),
            "elem_gradient": ((3 * nv + 12 * n + 3 * (nv + 1)) * sz
                              + 32 * n, ELEM_FLOPS["elem_gradient"] * n),
            "elem_hessian": ((3 * nv + 12 * n + 144 * n) * sz + 16 * n,
                             ELEM_FLOPS["elem_hessian"] * n),
            "direction_pass": ((3 * nv + 9 * n + 144 * n + 9 * n + 1) * sz
                               + 16 * n, (144 * 3 + 2 * 27 + 9) * n),
        }
        bad = []
        for kname, checks in res.items():
            _report(torch, name, kname, checks, times[kname], costs[kname],
                    bad, record)
        if bad:
            raise Fail("kernel disagrees with its plain version: "
                       + "; ".join(bad))


def phase_golden(torch):
    from dot_tpu_torch import partition, scripts
    from dot_tpu_torch.config import Config
    from dot_tpu_torch.mesh_gen import bar_mesh
    from dot_tpu_torch.steppers import DOTStepper, System
    mesh = bar_mesh(8, 3, 3)
    cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script="twist", handle_ratio=0.05)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = scripts.init_script(mesh, "twist")
    mesh.fixed_mask = sd.fixed0.copy()
    plan = partition.build_plan(mesh, 4, pad_elem_to=16, pad_n3_to=48)
    stepper = DOTStepper(System(mesh, cfg, plan, dtype=torch.float64,
                                device="cuda"), sd)
    st = stepper.init_state()
    vals = []
    for _ in GOLDEN_SYS_E:
        st, (_stats, sys_e) = stepper.step(st)
        vals.append(sys_e)
    rel = np.abs(np.asarray(vals) / np.asarray(GOLDEN_SYS_E) - 1.0)
    say(f"golden: bar 8x3x3 DOT4 f64 sysE {['%.10e' % v for v in vals]}, "
        f"max rel {rel.max():.3e} (tol 2e-4)")
    if not rel.max() <= 2e-4:
        raise Fail(f"golden sysE off by {rel.max():.3e}")


def _bar_scene(tmp, cells=BAR17, tmpl=SCENE_TMPL, name="bar17"):
    """Write a bar mesh and its twist scene under tmp; return the scene
    path."""
    from dot_tpu_torch import io as meshio
    from dot_tpu_torch.mesh_gen import bar_mesh
    mesh = bar_mesh(*cells, size=(4.0, 1.0, 1.0))
    mesh_path = os.path.join(tmp, f"{name}.msh")
    meshio.save_tet_mesh(mesh_path, mesh.V, mesh.conn, mesh.SF)
    scene = os.path.join(tmp, f"{name}_twist.txt")
    with open(scene, "w") as f:
        f.write(tmpl.format(mesh_path=mesh_path))
    return scene



def _simulator(torch, scene, out_root, suffix="", **kw):
    """The Simulator run_script would build for `scene` (f32 on the card)."""
    from dot_tpu_torch.config import Config
    from dot_tpu_torch.sim import Simulator
    cfg = Config.load(scene)
    name = cfg.output_folder_name() + (f"_{suffix}" if suffix else "")
    return Simulator(cfg, os.path.join(out_root, name), dtype=torch.float32,
                     device="cuda", mute=True,
                     search_dirs=(os.path.dirname(scene),), **kw)


def phase_h0_kernels(torch, record):
    """K5-K8, K13 and K16 against their plain versions on the bar17 plan
    and blocks."""
    from dot_tpu_torch.kernels import band, ops, pd
    from dot_tpu_torch.steppers import System
    from dot_tpu_torch.steppers.core import factor_leaves
    tmp = tempfile.mkdtemp(prefix="dot_smoke_k_")
    try:
        sim = _simulator(torch, _bar_scene(tmp), os.path.join(tmp, "out"))
        mesh, cfg, plan = sim.mesh, sim.cfg, sim.system.plan
        x0 = sim.state.x.detach().cpu().numpy().astype(np.float64)
        fixed = sim.state.fixed
        sim.finalize()
        del sim
        rng = np.random.default_rng(20261017)
        x_np = x0 + 0.01 * rng.normal(size=x0.shape)
        bad = []
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split(".")[-1]
            tol, ts = TOL_H0[name], TOL_SCALE[name]
            sysm = System(mesh, cfg, plan, dtype=dtype, device="cuda")
            x = torch.as_tensor(x_np, dtype=dtype, device="cuda")
            eh = sysm.element_hessians(x)
            freef = sysm._free(fixed).to(dtype).reshape(-1)
            res, times = {}, {}

            # K5
            bp = sysm.band_plan
            fk = ops.band_assemble(eh, freef, sysm.mass_flat, bp)
            fr = band.band_assemble_ref(eh, freef, sysm.mass_flat, bp)
            res["band_assemble"] = [("band", _rel_norm(fk, fr), tol["exact"],
                                     float((fk - fr).abs().max()))]
            times["band_assemble"] = (
                lambda: ops.band_assemble(eh, freef, sysm.mass_flat, bp),
                lambda: band.band_assemble_ref(eh, freef, sysm.mass_flat, bp),
                None)
            sz = eh.element_size()
            n_ub, n_asm = bp.ub_row.shape[0], bp.src_block.shape[0]
            costs = {"band_assemble": (
                eh.numel() * sz + 16 * n_asm + 8 * (n_ub + 1) + 16 * n_ub
                + 2 * freef.numel() * sz + 72 * n_ub
                + 8 * bp.pad_diag.numel() + bp.total * sz, 9 * n_asm)}
            P, nb, bs = sysm.n_parts, sysm.band_nb, sysm.band_bs
            diag = fk[:P * nb * bs * bs].view(nb, P, bs, bs)
            sub = fk[P * nb * bs * bs:].view(nb - 1, P, bs, bs)
            del fr

            # K6: the first CR level's odd blocks (symmetrized) and the
            # root-size batch (lower only), equilibrated as the rebuild does
            dsq = torch.sqrt(diag.diagonal(dim1=-2, dim2=-1))
            dg = diag / dsq[..., :, None] / dsq[..., None, :]
            A_odd = dg[1::2].reshape(-1, bs, bs).contiguous()
            A_root = dg[0].contiguous()
            ops.reset_launches()
            Lk, Xk, bk = ops.chol_inv(A_odd, True)
            if ops.launches["chol_inv"] != 1:
                bad.append(f"chol_inv {name}: {ops.launches['chol_inv']} "
                           "launches for one call")
            Lr, Xr, br = band.chol_inv_ref(A_odd, True)
            Lk2, Xk2, _ = ops.chol_inv(A_root, False)
            Lr2, Xr2, _ = band.chol_inv_ref(A_root, False)
            res["chol_inv"] = [
                ("L", _rel_norm(Lk, Lr), tol["chol"],
                 float((Lk - Lr).abs().max())),
                ("Linv", _rel_norm(Xk, Xr), tol["chol"],
                 float((Xk - Xr).abs().max())),
                ("L root", _rel_norm(Lk2, Lr2), tol["chol"], None),
                ("Linv root", _rel_norm(Xk2, Xr2), tol["chol"], None)]
            if bool(bk.any()) or bool(br.any()):
                bad.append(f"chol_inv {name}: an SPD block was flagged")
            indef = A_root.clone()
            indef[3, 5, 5] = -1.0
            Li_, Xi_, bi = ops.chol_inv(indef, False)
            _, _, bi_ref = band.chol_inv_ref(indef, False)
            flag_ok = (bi.tolist() == [k == 3 for k in range(P)]
                       and bi_ref.tolist() == bi.tolist()
                       and bool(torch.isnan(Li_[3]).all())
                       and bool(torch.isnan(Xi_[3]).all())
                       and bool(torch.isfinite(Li_[:3]).all()))
            say(f"kernels: {name} chol_inv indefinite block: flags "
                f"{bi.tolist()} (plain {bi_ref.tolist()}), NaN block "
                f"{bool(torch.isnan(Li_[3]).all())}")
            if not flag_ok:
                bad.append(f"chol_inv {name}: indefinite block not flagged")
            times["chol_inv"] = (lambda: ops.chol_inv(A_odd, True),
                                 lambda: band.chol_inv_ref(A_odd, True),
                                 _k6_library(torch, A_odd))
            costs["chol_inv"] = (3 * A_odd.numel() * sz,
                                 A_odd.shape[0] * 2 * bs ** 3 / 3)
            del Lk, Xk, Lr, Xr, Li_, Xi_, indef

            fac, d = sysm.factorize((diag, sub), fast=True)
            part_i = P - 2
            # K7's solve entry on the factor (the main path's solve; bf16
            # leaves in f32 runs) and on one subdomain's strided slice of it
            # (the GSDD sweep's), read in place
            leaves = factor_leaves(fac)
            rs = torch.as_tensor(rng.normal(size=(P, sysm.n3)), dtype=dtype,
                                 device="cuda")
            _solve_check(torch, name, "block_solve", "cr", leaves, rs,
                         tol["chol"], bad, record)
            _solve_check(torch, name, "block_solve@slice", "cr",
                         [t[:, part_i:part_i + 1] for t in leaves],
                         rs[part_i:part_i + 1].contiguous(), tol["chol"],
                         bad, record)
            del leaves

            # K8
            rhs = torch.as_tensor(rng.normal(size=(sysm.n_vert, 3)),
                                  dtype=dtype, device="cuda")
            z = torch.as_tensor(rng.normal(size=(P, sysm.n3)), dtype=dtype,
                                device="cuda")
            g_args = (rhs, sysm.l2g, sysm.local_valid, d)
            a_args = (z, d, sysm.gath_perm, sysm.gath_segids, sysm.gath_off,
                      sysm.dup)
            gk, gr = ops.h0_gather(*g_args), band.h0_gather_ref(*g_args)
            ak, ar = ops.h0_average(*a_args), band.h0_average_ref(*a_args)
            res["h0_gather"] = [("r", _rel_norm(gk, gr), tol["exact"],
                                 float((gk - gr).abs().max()))]
            res["h0_average"] = [("p", _rel_norm(ak, ar), tol["exact"],
                                  float((ak - ar).abs().max()))]
            pl = (z / d).reshape(-1, 3)[sysm.gath_perm]
            acc8 = torch.zeros((sysm.n_vert + 1, 3), dtype=dtype,
                               device="cuda")
            times["h0_gather"] = (lambda: ops.h0_gather(*g_args),
                                  lambda: band.h0_gather_ref(*g_args), None)
            times["h0_average"] = (
                lambda: ops.h0_average(*a_args),
                lambda: band.h0_average_ref(*a_args),
                lambda: acc8.index_add_(0, sysm.gath_segids, pl))
            nl = sysm.l2g.numel()
            costs["h0_gather"] = ((rhs.numel() + 6 * nl) * sz + 9 * nl,
                                  6 * nl)
            costs["h0_average"] = ((6 * nl + 4 * sysm.n_vert) * sz + 8 * nl
                                   + 8 * (sysm.n_vert + 2), 6 * nl)

            # K13 on the same element Hessians
            h_args = (eh, sysm.scat_perm, sysm.scat_segids, sysm.scat_off,
                      sysm.mass)
            hk, hr = ops.hessian_diag(*h_args), pd.hessian_diag_ref(*h_args)
            res["hessian_diag"] = [("diag", _rel_max(hk, hr), ts["elem"],
                                    float((hk - hr).abs().max()))]
            n_ep, nv = eh.shape[1], sysm.n_vert
            rows12 = torch.stack([eh[(cc * 4 + cc) * 9 + 4 * i]
                                  for cc in range(4) for i in range(3)]
                                 ).view(4, 3, n_ep).permute(2, 0, 1) \
                .reshape(-1, 3).contiguous()
            cidx = sysm.conn_s.t().reshape(-1).long()
            acc13 = torch.zeros((nv + 1, 3), dtype=dtype, device="cuda")
            times["hessian_diag"] = (
                lambda: ops.hessian_diag(*h_args),
                lambda: pd.hessian_diag_ref(*h_args),
                lambda: acc13.index_add_(0, cidx, rows12))
            costs["hessian_diag"] = (
                12 * n_ep * sz + 8 * 4 * n_ep + 8 * (nv + 2) + 4 * nv * sz,
                12 * n_ep + 3 * nv)

            # K16 on one subdomain of the same plan
            nloc = sysm.n3 // 3
            z1 = z[part_i].contiguous()
            lg_args = (rhs, sysm.l2g, sysm.local_valid, d, part_i)
            ls_args = (z1, d, sysm.l2g, sysm.local_valid, part_i, nv)
            gk1 = ops.local_gather_one(*lg_args)
            gr1 = pd.local_gather_one_ref(*lg_args)
            sk1 = ops.local_scatter_one(*ls_args)
            sr1 = pd.local_scatter_one_ref(*ls_args)
            res["local_gather_one"] = [
                ("r", _rel_max(gk1, gr1), ts["elem"],
                 float((gk1 - gr1).abs().max())),
                ("row of K8's gather", _rel_max(gk1, gk[part_i]), 0.0, None)]
            res["local_scatter_one"] = [("p", _rel_max(sk1, sr1), ts["elem"],
                                         float((sk1 - sr1).abs().max()))]
            times["local_gather_one"] = (
                lambda: ops.local_gather_one(*lg_args),
                lambda: pd.local_gather_one_ref(*lg_args), None)
            times["local_scatter_one"] = (
                lambda: ops.local_scatter_one(*ls_args),
                lambda: pd.local_scatter_one_ref(*ls_args), None)
            costs["local_gather_one"] = (9 * nloc * sz + 9 * nloc, 6 * nloc)
            costs["local_scatter_one"] = ((6 * nloc + 3 * nv) * sz + 9 * nloc,
                                          3 * nloc)
            torch.cuda.synchronize()

            for kname, checks in res.items():
                _report(torch, name, kname, checks, times[kname],
                        costs[kname], bad, record)
            say(f"kernels: {name} shapes: band {tuple(diag.shape)} + "
                f"{tuple(sub.shape)}, K6 batches {tuple(A_odd.shape)} and "
                f"{tuple(A_root.shape)}, K7 leaves "
                f"{str(fac.levels[0][1].dtype).split('.')[-1]}, K8 rhs "
                f"{tuple(rhs.shape)} -> r "
                f"{tuple(gk.shape)}")
            del sysm, fac, eh, fk, diag, sub, dg, A_odd
            torch.cuda.empty_cache()
        if bad:
            raise Fail("kernel disagrees with its plain version: "
                       + "; ".join(bad))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def wrap_timed(obj, name, acc, module=None, label=None):
    """Replace obj.name (or module.name) by a synchronised, timed call
    accumulating seconds into acc[label or name]; returns the original.
    The kernel-table splits below wrap System methods and torch.linalg
    calls with it (the syncs perturb the total a little)."""
    import torch
    owner = module if module is not None else obj
    fn = getattr(owner, name)
    label = label or name

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **k)
        torch.cuda.synchronize()
        acc[label] += time.perf_counter() - t0
        return r
    setattr(owner, name, timed)
    return fn


def _h0_split(sim, frames, names=("rebuild_h0", "h0_apply")):
    """ms/frame of each System method in `names` over `frames` more frames,
    each call wrapped in synchronised host timers."""
    import collections
    acc = collections.Counter()
    for name in names:
        wrap_timed(sim.system, name, acc)
    try:
        sim.run(frames)
    finally:
        for name in names:
            delattr(sim.system, name)
    return {k: acc[k] / frames * 1e3 for k in names}


def phase_main(torch, launches_out):
    from dot_tpu_torch.kernels import ops
    from dot_tpu_torch.steppers.core import CRFactor, factor_leaves
    tmp = tempfile.mkdtemp(prefix="dot_smoke_")
    try:
        scene = _bar_scene(tmp)
        out_root = os.path.join(tmp, "out")

        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        sim = _simulator(torch, scene, out_root)
        sim.run(11)
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        launches_out["main"] = launches
        fac = sim.state.chol
        kind = type(fac).__name__
        n_levels = len(fac.levels) if isinstance(fac, CRFactor) else 0
        leaf_dt = sorted({str(t.dtype).split(".")[-1]
                          for t in factor_leaves(fac)})
        split = _h0_split(sim, 3)
        sim.finalize()

        fr = sim.frames
        timed = fr[1:11]
        spf = float(np.mean([r["seconds"] for r in timed]))
        say(f"main: bar17 twist DOT{sim.system.n_parts} f32: "
            f"{sim.mesh.n_elem} tets, {sim.mesh.n_vert} verts, "
            f"n3 {sim.system.n3}, banded {sim.system.banded} "
            f"(nb {sim.system.band_nb}, bs {sim.system.band_bs}); "
            f"Simulator + 11 frames wall {wall:.2f} s")
        say(f"main: H0 factor {kind}, {n_levels} cyclic-reduction levels, "
            f"leaves {leaf_dt}")
        say(f"main: s/frame {spf:.5f} (10 timed frames after 1 warm-up; "
            f"warm-up {fr[0]['seconds']:.3f} s); iters/frame "
            f"{np.mean([r['iters'] for r in timed]):.2f}; LS halvings/frame "
            f"{np.mean([r['halvings'] for r in timed]):.2f}; syncs/frame "
            f"{np.mean([r['syncs'] for r in timed]):.2f}; peak device memory "
            f"{peak / 2**20:.1f} MiB")
        say(f"main: synchronised split over 3 more frames: rebuild_h0 "
            f"{split['rebuild_h0']:.2f} ms/frame, h0_apply "
            f"{split['h0_apply']:.2f} ms/frame (iters "
            f"{[r['iters'] for r in fr[11:]]})")
        say("main: per frame (iters, halvings, syncs, stop, s): "
            + "; ".join(f"{r['iters']},{r['halvings']},{r['syncs']},"
                        f"{r['stop']},{r['seconds']:.3f}" for r in fr))
        say("main: sysE " + " ".join("%.10e" % r["sys_e"] for r in fr))
        say(f"main: kernel launches {launches}")
        n_it = sum(r["iters"] for r in fr[:11])
        say(f"main: K9 launches: lbfgs_first {launches['lbfgs_first']}, "
            f"lbfgs_second {launches['lbfgs_second']} over {n_it} "
            f"iterations (one of each a two-loop); K6 "
            f"{launches['chol_inv']} over 11 rebuilds")
        k7 = launches["block_solve"]
        say(f"main: K7 launches: block_solve {k7} (one a solve; "
            f"{launches['lbfgs_first']} two-loops): {k7 / 11:.2f} a frame "
            "(at most 10)")
        problems = []
        if k7 > 10 * 11 or launches["block_solve"] != launches["lbfgs_first"]:
            problems.append(f"K7 launched {k7} times in 11 frames, "
                            f"{launches['block_solve']} solves for "
                            f"{launches['lbfgs_first']} applies")
        if launches["lbfgs_first"] != launches["lbfgs_second"]:
            problems.append("K9's two entries launched unequally")
        for r in fr:
            if not np.isfinite(r["sys_e"]):
                problems.append(f"frame {r['frame']} sysE not finite")
            if r["stop"] not in ("tol", "rel_dec"):
                problems.append(f"frame {r['frame']} stopped by {r['stop']}")
        for k in MAIN_KERNELS:
            if launches[k] <= 0:
                problems.append(f"kernel {k} never launched on the main path")
        if kind != "CRFactor" or n_levels != 2 or leaf_dt != ["bfloat16"]:
            problems.append(f"H0 factor {kind} with {n_levels} levels and "
                            f"{leaf_dt} leaves, not CR with 2 and bf16")
        out = sim.out
        need = ["config.txt", "iterStats.txt", "log.txt", "info.txt",
                "finalResult_mesh.msh", "status0", "0.obj",
                f"status{sim.frame}", f"{sim.frame}.obj"]
        missing = [f for f in need if not os.path.exists(os.path.join(out, f))]
        if missing:
            problems.append(f"missing outputs {missing}")
        with open(os.path.join(out, "log.txt")) as f:
            n_syse = sum(1 for ln in f if ln.startswith("sysE = "))
        if n_syse != len(fr):
            problems.append(f"log.txt has {n_syse} sysE lines")
        if problems:
            raise Fail("main path: " + "; ".join(problems))

        # the same 3 first frames with the plain versions on the card
        ref = _simulator(torch, scene, out_root, suffix="plain",
                         use_kernels=False)
        ref.run(3)
        ref.finalize()
        a = np.asarray([r["sys_e"] for r in fr[:3]])
        b = np.asarray([r["sys_e"] for r in ref.frames])
        rel = np.abs(a / b - 1.0)
        say(f"main: plain-path sysE {' '.join('%.10e' % v for v in b)}; "
            f"max rel vs kernels {rel.max():.3e} (tol 1e-3); plain "
            f"s/frame {np.mean([r['seconds'] for r in ref.frames]):.5f}; "
            f"plain iters {[r['iters'] for r in ref.frames]}")
        if not rel.max() <= 1e-3:
            raise Fail(f"kernel path and plain path disagree: {rel.max():.3e}")
        return spf
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _scene_variant(scene, name, stepper, warm=2):
    """A copy of the DOT 6 scene file with another timeStepper line and
    warmStart; returns its path."""
    with open(scene) as f:
        text = f.read()
    text = text.replace("timeStepper DOT 6", f"timeStepper {stepper}") \
        .replace("warmStart 2", f"warmStart {warm}")
    path = os.path.join(os.path.dirname(scene), f"{name}.txt")
    with open(path, "w") as f:
        f.write(text)
    return path


def _spd_batch(torch, rng, batch, n, dtype, symmetrize):
    """SPD blocks G G^T / n + I on the card, with a skew part above the
    diagonal that the lower mode must not read and the symmetrized mode
    averages away."""
    G = torch.as_tensor(rng.normal(size=(batch, n, n)), dtype=dtype,
                        device="cuda")
    skew = torch.triu(torch.as_tensor(rng.normal(size=(batch, n, n)),
                                      dtype=dtype, device="cuda"), 1) * 1e-3
    eye = torch.eye(n, dtype=dtype, device="cuda")
    return (G @ G.mT / n + eye + skew
            - (skew.mT if symmetrize else 0.0)).contiguous()


def _k6_library(torch, A):
    """The library yardstick of K6: cholesky_ex + solve_triangular
    against I, one sequence."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)

    def lib():
        Lq = torch.linalg.cholesky_ex(A)[0]
        return torch.linalg.solve_triangular(Lq, eye, upper=False)
    return lib


def _k6_check(torch, ops, band, A, sym, tol, bad, what):
    """K6 on A against its plain version: (checks, launches of the call);
    an SPD block flagged or a call of other than one launch is a fault."""
    ops.reset_launches()
    Lk, Xk, bk = ops.chol_inv(A, sym)
    n_k6 = ops.launches["chol_inv"]
    Lr, Xr, br = band.chol_inv_ref(A, sym)
    if bool(bk.any()) or bool(br.any()):
        bad.append(f"chol_inv {what}: an SPD block was flagged")
    if n_k6 != 1:
        bad.append(f"chol_inv {what}: {n_k6} launches for one call")
    if not (torch.equal(Lk, torch.tril(Lk))
            and torch.equal(Xk, torch.tril(Xk))):
        bad.append(f"chol_inv {what}: nonzero above the diagonal")
    return [("L", _rel_norm(Lk, Lr), tol, float((Lk - Lr).abs().max())),
            ("Linv", _rel_norm(Xk, Xr), tol,
             float((Xk - Xr).abs().max()))], n_k6


def _k9_checks(torch, S, T, g, r, rho, valid, tol, suffix=""):
    """K9's two entries against their plain versions on one history:
    (checks, timed calls, costs) keyed by entry (+ suffix). G and k are
    measured against the scale of their sums (|s_i| |t_j|, max |k|), q and
    the result max-relative."""
    from dot_tpu_torch.kernels import lbfgs, ops
    m, n = S.shape
    sz = S.element_size()
    q_, k_, G_ = ops.lbfgs_first(S, T, g, rho, valid)
    qr, kr, Gr = lbfgs.lbfgs_first_ref(S, T, g, rho, valid)
    o_ = ops.lbfgs_second(T, S, r, kr, Gr, rho, valid)
    orf = lbfgs.lbfgs_second_ref(T, S, r, kr, Gr, rho, valid)
    sn, tn = S.norm(dim=1), T.norm(dim=1)
    gscale = float((sn[:, None] * tn[None, :]).max()) + 1e-300
    kscale = float(kr.abs().max()) + 1e-300
    f, s2 = "lbfgs_first" + suffix, "lbfgs_second" + suffix
    res = {f: [("G", float((G_ - Gr).abs().max()) / gscale, tol,
                float((G_ - Gr).abs().max())),
               ("k", float((k_ - kr).abs().max()) / kscale, tol,
                float((k_ - kr).abs().max())),
               ("q", _rel_max(q_, qr), tol, float((q_ - qr).abs().max()))],
           s2: [("out", _rel_max(o_, orf), tol,
                 float((o_ - orf).abs().max()))]}
    stk = torch.cat([g[None], T]).T.contiguous()
    times = {f: (lambda: ops.lbfgs_first(S, T, g, rho, valid),
                 lambda: lbfgs.lbfgs_first_ref(S, T, g, rho, valid),
                 lambda: (torch.matmul(S, stk),
                          torch.addmv(g, T.T, kr, beta=-1, alpha=-1))),
             s2: (lambda: ops.lbfgs_second(T, S, r, kr, Gr, rho, valid),
                  lambda: lbfgs.lbfgs_second_ref(T, S, r, kr, Gr, rho,
                                                 valid),
                  lambda: (torch.mv(T, r), torch.addmv(r, S.T, kr)))}
    # bytes: S, T and g read, q written (first); T, S and r read, out
    # written (second); operations: the dots and the combination
    costs = {f: ((2 * m + 2) * n * sz, 2 * (m + m * m) * n + 2 * m * n + n),
             s2: ((2 * m + 2) * n * sz, 4 * m * n + n)}
    return res, times, costs


def phase_k6_k9_kernels(torch, record):
    """K6 at the widths its callers give beyond bar17's CR level (the h0
    kernels) and bar135's scan stage and coarse block (the scale phase):
    a 2,000^2 block in both modes ("split2000": the first design split it
    on the host; "lower2000"), the batch-1 block of Newton's exact scan on
    bar17's P = 1 plan ("newton", its band_bs from build_plan(mesh, 1)),
    two widths that are no multiple of the tile ("w37", "w770"); one
    launch a call; indefinite blocks in both modes at batch 1 and 3, the
    bad pivot in the first and in the last tile. K9's two entries at
    bar17's shape (m 5, n = 3 x 16,473 = 49,419) on random histories."""
    from dot_tpu_torch import partition
    from dot_tpu_torch.kernels import band, ops
    from dot_tpu_torch.mesh_gen import bar_mesh
    mesh = bar_mesh(*BAR17, size=(4.0, 1.0, 1.0))
    bs1 = partition.build_plan(mesh, 1).band_bs
    n17 = 3 * mesh.n_vert
    shapes = (("split2000", 1, 2000, True), ("lower2000", 1, 2000, False),
              ("newton", 1, bs1, False), ("w37", 3, 37, True),
              ("w770", 2, 770, False))
    rng = np.random.default_rng(20261018)
    bad = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        tol6 = 1e-10 if dtype == torch.float64 else 1e-5
        sz = 8 if dtype == torch.float64 else 4
        for tag, B, n, sym in shapes:
            A = _spd_batch(torch, rng, B, n, dtype, sym)
            checks, n_k6 = _k6_check(torch, ops, band, A, sym, tol6, bad,
                                     f"{tag} {name}")
            kname = f"chol_inv@{tag}"
            _report(torch, name, kname, checks,
                    (lambda A=A, sym=sym: ops.chol_inv(A, sym),
                     lambda A=A, sym=sym: band.chol_inv_ref(A, sym),
                     _k6_library(torch, A)),
                    (3 * A.numel() * sz, B * 2 * n ** 3 / 3), bad, record,
                    plain_reps=5)
            if name == "float32":
                record[kname].update(launches_per_call=n_k6, batch=B,
                                     width=n, symmetrize=sym)
            del A
        flags = []
        for sym in (True, False):
            for B in (1, 3):
                for where in (5, 765):
                    A = _spd_batch(torch, rng, B, 770, dtype, sym)
                    mid = B // 2
                    A[mid, where, where] = -1.0
                    Lk, Xk, bk = ops.chol_inv(A, sym)
                    want = [b == mid for b in range(B)]
                    others = [b for b in range(B) if b != mid]
                    ok = (bk.tolist() == want
                          and bool(torch.isnan(Lk[mid]).all())
                          and bool(torch.isnan(Xk[mid]).all())
                          and bool(torch.isfinite(Lk[others]).all())
                          and bool(torch.isfinite(Xk[others]).all()))
                    flags.append(ok)
                    if not ok:
                        bad.append(f"chol_inv {name}: indefinite block "
                                   f"(sym {sym}, batch {B}, pivot {where}) "
                                   f"flags {bk.tolist()}")
        say(f"kernels: {name} chol_inv indefinite 770^2 blocks (both modes, "
            f"batch 1 and 3, bad pivot in the first / last tile): "
            f"{sum(flags)} of {len(flags)} flagged and all NaN with finite "
            f"neighbours")
        # K9 at bar17's shape: m 5, all slots holding pairs
        m = 5
        S = torch.as_tensor(rng.normal(size=(m, n17)), dtype=dtype,
                            device="cuda")
        T = S * torch.as_tensor(rng.uniform(0.5, 2.0, size=(m, n17)),
                                dtype=dtype, device="cuda") \
            + 0.1 * torch.as_tensor(rng.normal(size=(m, n17)), dtype=dtype,
                                    device="cuda")
        rho = (S * T).sum(1)
        valid = torch.ones(m, dtype=dtype, device="cuda")
        g = torch.as_tensor(rng.normal(size=n17), dtype=dtype, device="cuda")
        r = torch.as_tensor(rng.normal(size=n17), dtype=dtype, device="cuda")
        ops.reset_launches()
        res, times, costs = _k9_checks(torch, S, T, g, r, rho, valid,
                                       TOL_SCALE[name]["elem"])
        if (ops.launches["lbfgs_first"], ops.launches["lbfgs_second"]) \
                != (1, 1):
            bad.append(f"lbfgs {name}: {ops.launches} launches for one "
                       "call of each entry")
        torch.cuda.synchronize()
        for kname, checks in res.items():
            _report(torch, name, kname, checks, times[kname], costs[kname],
                    bad, record)
        say(f"kernels: {name} shapes: K6 {[(t, B, n) for t, B, n, _ in shapes]}"
            f" (bar17's P = 1 band_bs {bs1}); K9 S, T {tuple(S.shape)}")
        torch.cuda.empty_cache()
    _k31_checks(torch, record, bad)
    if bad:
        raise Fail("kernel disagrees with its plain version: "
                   + "; ".join(bad))


def _k31_checks(torch, record, bad):
    """K31 (schur_update) at the bar135 scan step (133 blocks of 768:
    "schur_update") and a P = 1 scan's (1 x 768: "@p1"), f32 sums of bf16
    products: the lower triangle against the f32 product (1e-6 norm-wise),
    two calls bit for bit, one launch a call; timed with the route it
    replaced (D upcast, Ls rounded to bf16 and upcast twice, an f32 GEMM, a
    subtraction), the library call where the card's torch has one
    (torch.bmm(..., out_dtype=torch.float32) and the subtraction) and the
    bound of the lower triangle (bf16 tensor-core rate)."""
    from dot_tpu_torch.kernels import band, ops
    b16, f32 = torch.bfloat16, torch.float32
    for kname, B, n in (("schur_update", 133, 768), ("schur_update@p1", 1,
                                                      768)):
        g = torch.Generator(device="cuda").manual_seed(20261018 + B)
        Ls = 0.5 / n ** 0.5 * torch.randn((B, n, n), generator=g,
                                          device="cuda")
        N = 0.01 * torch.randn((B, n, n), generator=g, device="cuda")
        D = (3.0 * torch.eye(n, device="cuda") + N + N.mT).to(b16)
        del N
        A = Ls.to(b16)
        ops.reset_launches()
        k1 = torch.tril(ops.schur_update(D, A))
        k2 = torch.tril(ops.schur_update(D, A))
        torch.cuda.synchronize()
        if ops.launches["schur_update"] != 2:
            bad.append(f"{kname}: {ops.launches['schur_update']} launches "
                       "for two calls")
        ref = torch.tril(band.schur_update_ref(D, A))
        same = 0.0 if torch.equal(k1, k2) else 1.0
        checks = [("lower", _rel_norm(k1, ref), 1e-6,
                   float((k1 - ref).abs().max())),
                  ("two calls (bit for bit)", same, 0.0, same)]
        try:
            torch.bmm(A, A.mT, out_dtype=f32)
            lib = lambda: D.to(f32) - torch.bmm(A, A.mT, out_dtype=f32)
        except (TypeError, RuntimeError):
            lib = None
        low = B * n * (n + 1) // 2
        out = torch.empty((B, n, n), device="cuda")
        _report(torch, "float32", kname, checks,
                (lambda: ops.schur_update(D, A, out),
                 lambda: D.to(f32) - Ls.to(b16).to(f32)
                 @ Ls.mT.to(b16).to(f32), lib),
                (A.numel() * 2 + low * 2 + low * 4, 2.0 * low * n,
                 BF16_FLOP_S), bad, record)
        record[kname].update(launches_per_call=1, batch=B, width=n,
                             library=("torch.bmm(out_dtype=float32) - D"
                                      if lib is not None else None))
        del Ls, D, A, k1, k2, ref, out
        torch.cuda.empty_cache()


def phase_pd_kernels(torch, record):
    """K14 and K15 against their plain versions on the bar17 PD band."""
    from dot_tpu_torch.kernels import ops, pd
    from dot_tpu_torch.steppers import System
    from dot_tpu_torch.steppers.core import BTDFactor
    tmp = tempfile.mkdtemp(prefix="dot_smoke_pd_")
    try:
        sim = _simulator(torch, _scene_variant(_bar_scene(tmp), "pd", "LBFGS"),
                         os.path.join(tmp, "out"))
        mesh, cfg, fixed = sim.mesh, sim.cfg, sim.state.fixed
        sim.finalize()
        del sim
        rng = np.random.default_rng(20261018)
        bad = []
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split(".")[-1]
            tol = TOL_SCALE[name]
            sysm = System(mesh, cfg, None, dtype=dtype, device="cuda")
            bp = sysm.pd_band_plan
            w = sysm._pd_weights()
            free = torch.logical_not(fixed).to(dtype)
            sz = w.element_size()
            res, times, costs = {}, {}, {}

            a_args = (sysm.g9, sysm.conn, w, free, sysm.mass, bp)
            fk, fr = ops.pd_assemble(*a_args), pd.pd_assemble_ref(*a_args)
            res["pd_assemble"] = [
                ("band", _rel_norm(fk, fr), tol["sum"],
                 float((fk - fr).abs().max())),
                ("band max", _rel_max(fk, fr), tol["elem"], None)]
            vals = pd.pd_pair_vals_ref(sysm.g9, sysm.conn, w, free
                                       ).reshape(-1)
            acc = torch.zeros(bp.total + 1, dtype=dtype, device="cuda")
            times["pd_assemble"] = (
                lambda: ops.pd_assemble(*a_args),
                lambda: pd.pd_assemble_ref(*a_args),
                lambda: acc.index_add_(0, bp.dest, vals))
            n_ep, nv, n_it = sysm.n_elem_p, sysm.n_vert, bp.items.numel()
            # the kept items once (8 B), each element's g9, w and conn once,
            # free and mass, the run tables, and the band written once
            costs["pd_assemble"] = (
                8 * n_it + (10 * sz + 16) * n_ep + 2 * nv * sz
                + 16 * bp.udest.numel() + 8 * nv + 8 * bp.pad_dest.numel()
                + bp.total * sz, 20 * n_it)
            del fr

            L, d = sysm.build_pd_factor(fixed)
            if not isinstance(L, BTDFactor) or L.linv.shape[1] != 1 \
                    or L.linv.dtype != dtype:
                bad.append(f"pd factor {name}: {type(L).__name__}")
            nb, bs = L.linv.shape[0], L.linv.shape[2]
            rhs = torch.as_tensor(rng.normal(size=(nv, 3)), dtype=dtype,
                                  device="cuda")

            # the whole solve: kernels against the plain versions
            plain = System(mesh, cfg, None, dtype=dtype, device="cuda",
                           use_kernels=False)
            plain._pd_plan = bp
            zk = sysm.pd_solve(L, d, rhs)
            zr = plain.pd_solve(L, d, rhs)
            solve_err = _rel_norm(zk, zr)
            if not solve_err <= tol["sum"]:
                bad.append(f"pd_solve {name}: {solve_err:.3e}")
            torch.cuda.synchronize()
            for kname, checks in res.items():
                _report(torch, name, kname, checks, times[kname],
                        costs[kname], bad, record)
            # K15: pd_solve as one launch of K7's solve entry (the gather,
            # 4 nb - 2 3-column products, the scatter)
            _solve_check(torch, name, "block_solve@pd", "pd",
                         [L.linv, L.sub, bp.inv, bp.perm, d[0]], rhs,
                         tol["sum"], bad, record)
            say(f"kernels: {name} PD band: bs {bs}, nb {nb}, nv_p {bp.nv_p}, "
                f"{n_it} items into {bp.udest.numel()} slots of "
                f"{bp.total}; factor {type(L).__name__} {L.linv.dtype}; "
                f"pd_solve kernels vs plain rel {solve_err:.3e}")
            del sysm, plain, L, fk, vals, acc
            torch.cuda.empty_cache()
        if bad:
            raise Fail("kernel disagrees with its plain version: "
                       + "; ".join(bad))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _factor_kind(fac):
    from dot_tpu_torch.steppers.core import factor_leaves
    dts = sorted({str(t.dtype).split(".")[-1] for t in factor_leaves(fac)})
    shape = tuple(factor_leaves(fac)[0].shape)
    return type(fac).__name__, dts, shape


def phase_steppers(torch, launches_out, record):
    """The non-ADMM steppers and warmStart 5 at bar17 through Simulator."""
    from dot_tpu_torch.kernels import ops
    tmp = tempfile.mkdtemp(prefix="dot_steppers_")
    try:
        base = _bar_scene(tmp)
        out_root = os.path.join(tmp, "out")
        dot = _simulator(torch, base, out_root, suffix="ref",
                         save_every=10 ** 9)
        dot.run(3)
        dot.finalize()
        e_dot = np.asarray([r["sys_e"] for r in dot.frames])
        say(f"steppers: DOT6 warmStart 2 yardstick: iters "
            f"{[r['iters'] for r in dot.frames]}, sysE "
            + " ".join("%.10e" % v for v in e_dot))
        del dot
        torch.cuda.empty_cache()
        total = dict.fromkeys(ops.KERNELS, 0)
        problems = []
        for tag, (stepper, warm, frames, e_tol, need) in STEPPER_RUNS.items():
            scene = _scene_variant(base, tag, stepper, warm)
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            sim = _simulator(torch, scene, out_root, save_every=10 ** 9)
            t1 = time.perf_counter()
            sim.run(frames)
            launches = dict(ops.launches)
            peak = torch.cuda.max_memory_allocated()
            for k, v in launches.items():
                total[k] += v
            sysm, fr = sim.system, sim.frames
            fac = sim.state.chol
            if tag == "Newton":   # its per-iteration factor, built once more
                fac = sim.stepper.factor(sim.state.x, sim.state.fixed)[0]
            kind, leaf_dt, shape = _factor_kind(fac)
            if tag == "Newton":
                # K7's solve entry on the P = 1 factor (f64: its leaves
                # cast), against the plain version
                lv = list(fac)
                rr = torch.randn((1, sysm.n3), device="cuda")
                for dt_ in (torch.float64, torch.float32):
                    nm = str(dt_).split(".")[-1]
                    _solve_check(torch, nm, "block_solve@p1", "btd",
                                 [t.to(dt_) for t in lv], rr.to(dt_),
                                 TOL_H0[nm]["chol"], problems, record)
                del lv, rr
            del fac
            sim.finalize()
            timed = fr[1:] or fr
            say(f"steppers: {tag}: {type(sim.stepper).__name__}, P "
                f"{sysm.n_parts}, n3 {sysm.n3}, banded {sysm.banded} (nb "
                f"{sysm.band_nb}, bs {sysm.band_bs}), factor {kind} "
                f"{leaf_dt} {shape}; Simulator {t1 - t0:.2f} s; s/frame "
                f"{np.mean([r['seconds'] for r in timed]):.5f} "
                f"({len(timed)} frames after 1 warm-up of "
                f"{fr[0]['seconds']:.3f} s); peak {peak / 2**20:.1f} MiB")
            say(f"steppers: {tag}: per frame (iters, halvings, syncs, stop, "
                "s): " + "; ".join(
                    f"{r['iters']},{r['halvings']},{r['syncs']},{r['stop']},"
                    f"{r['seconds']:.3f}" for r in fr))
            say(f"steppers: {tag}: launches "
                f"{ {k: v for k, v in launches.items() if v} }")
            for r in fr:
                if not np.isfinite(r["sys_e"]):
                    problems.append(f"{tag} frame {r['frame']} sysE not "
                                    "finite")
                if r["stop"] not in ("tol", "rel_dec"):
                    problems.append(f"{tag} frame {r['frame']} stopped by "
                                    f"{r['stop']}")
            for k in need + ("ls_trial_energy", "elem_gradient",
                             "direction_pass"):
                if launches[k] <= 0:
                    problems.append(f"{tag}: kernel {k} never launched")
            iters = sum(r["iters"] for r in fr)
            if tag == "LBFGS":
                # one pd_solve an iteration (the H0 apply): one launch of
                # K7's solve entry
                bp = sysm.pd_band_plan
                say(f"steppers: LBFGS: PD band bs {bp.bs}, nb {bp.nb}; "
                    f"K14 {launches['pd_assemble']} launch; pd_solve "
                    f"{launches['block_solve'] / max(iters, 1):.2f} solve "
                    f"launches per iteration (want 1)")
                if (kind != "BTDFactor" or leaf_dt != ["float32"]
                        or shape[1] != 1 or launches["pd_assemble"] != 1
                        or launches["block_solve"] != iters):
                    problems.append(f"LBFGS: factor {kind} {leaf_dt} "
                                    f"{shape}, launches {launches}")
            if tag == "GSDD6":
                want = 2 * sysm.n_parts * iters
                got = launches["local_gather_one"] \
                    + launches["local_scatter_one"]
                say(f"steppers: GSDD6: {iters} sweeps, K16 launches {got} "
                    f"(2 P per sweep: {want})")
                if got != want:
                    problems.append(f"GSDD6: K16 launches {got} != {want}")
            if tag == "DOT6ws5":
                if launches["hessian_diag"] != frames:
                    problems.append(f"DOT6ws5: K13 launched "
                                    f"{launches['hessian_diag']} times in "
                                    f"{frames} frames")
            if tag == "Newton":
                # the exact factorization: f32 scan factor of the P = 1 band
                if (kind != "BTDFactor" or shape[1] != 1
                        or leaf_dt != ["float32"]):
                    problems.append(f"Newton: factor {kind} {leaf_dt} "
                                    f"{shape}")
            if tag == "LBFGSHI" and (
                    sysm.factor_dtype != torch.bfloat16
                    or sysm._solve_dtype != torch.float32):
                problems.append("LBFGSHI: factor dtype "
                                f"{sysm.factor_dtype}")
            if tag == "LBFGSJH6" and (sysm.banded or sysm.plan.part
                                      is not None):
                problems.append("LBFGSJH6: not a dense node plan")
            a = np.asarray([r["sys_e"] for r in fr])
            rel_dot = np.abs(a / e_dot[:len(a)] - 1.0).max()
            del sim, sysm
            torch.cuda.empty_cache()

            ref = _simulator(torch, scene, out_root, suffix="plain",
                             use_kernels=False, save_every=10 ** 9)
            ref.run(frames)
            ref.finalize()
            b = np.asarray([r["sys_e"] for r in ref.frames])
            rel = np.abs(a / b - 1.0).max()
            say(f"steppers: {tag}: sysE "
                + " ".join("%.10e" % v for v in a)
                + f"; vs plain path max rel {rel:.3e} (tol 1e-3; plain "
                f"iters {[r['iters'] for r in ref.frames]}, s/frame "
                f"{np.mean([r['seconds'] for r in ref.frames]):.5f}); vs "
                f"DOT6 max rel {rel_dot:.3e} (tol {e_tol:g})")
            if not rel <= 1e-3:
                problems.append(f"{tag}: kernel and plain paths disagree: "
                                f"{rel:.3e}")
            if not rel_dot <= e_tol:
                problems.append(f"{tag}: sysE off DOT's by {rel_dot:.3e}")
            del ref
            torch.cuda.empty_cache()
        launches_out["steppers"] = total
        for k in STEPPER_KERNELS:
            if total[k] <= 0:
                problems.append(f"kernel {k} never launched on the steppers "
                                "path")
        if problems:
            raise Fail("steppers path: " + "; ".join(problems))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _local_step_inputs(torch, n, dtype, rng):
    """(Dx, u9), each (9, n) on the card: a third random deformation
    gradients (any sign of det), a third inverted near the identity, a
    third near rank 1; duals a tenth of that size."""
    third = n // 3
    f = np.empty((9, n))
    f[:, :third] = np.eye(3).reshape(9, 1) + 0.5 * rng.normal(size=(9, third))
    inv = np.eye(3).reshape(9, 1) + 0.1 * rng.normal(size=(9, third))
    inv[[0, 3, 6]] *= -1.0
    f[:, third:2 * third] = inv
    m = n - 2 * third
    uv = rng.normal(size=(3, m))[:, None] * rng.normal(size=(3, m))[None]
    f[:, 2 * third:] = uv.reshape(9, m) + 1e-3 * rng.normal(size=(9, m))
    u = 0.1 * rng.normal(size=(9, n))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")
    return t(f), t(u)


def phase_admm_kernels(torch, record):
    """K17-K20 and the per-slab / from-F entry points of K1 / K2 against
    their plain versions at the bar17 shapes: K17 and K18 on the ADMM-PD
    system (no plan), the others on the ADMMDD 6 plan."""
    from dot_tpu_torch.kernels import admm as kadmm
    from dot_tpu_torch.kernels import ops
    from dot_tpu_torch.steppers import (ADMMDDStepper, ADMMPDStepper, System)
    tmp = tempfile.mkdtemp(prefix="dot_smoke_admm_k_")
    try:
        sim = _simulator(torch, _scene_variant(_bar_scene(tmp), "dd",
                                               "ADMMDD 6"),
                         os.path.join(tmp, "out"))
        mesh, cfg, plan = sim.mesh, sim.cfg, sim.system.plan
        sd, ap = sim.script_data, sim.stepper.ap
        x0 = sim.state.x.detach().cpu().numpy().astype(np.float64)
        fixed = sim.state.fixed
        sim.finalize()
        del sim
        torch.cuda.empty_cache()
        rng = np.random.default_rng(20261019)
        x_np = x0 + 0.01 * rng.normal(size=x0.shape)
        bad = []
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split(".")[-1]
            tol, th = TOL_SCALE[name], TOL[name]
            res, times, costs = {}, {}, {}

            # ---- K17, its SPD projection, K18: the ADMM-PD system
            pdsys = System(mesh, cfg, None, dtype=dtype, device="cuda")
            pst = ADMMPDStepper(pdsys, sd)
            n, nv, sz = pdsys.n_elem_p, pdsys.n_vert, 4 if dtype == \
                torch.float32 else 8
            Dx, u9 = _local_step_inputs(torch, n, dtype, rng)
            l_args = (Dx, u9, pst.w_e, pst.vol_dtsq, pdsys.u_e, pdsys.lam_e,
                      pdsys.mat)
            zk, duk, ck = ops.admm_local_step(*l_args, want_counts=True)
            zr, dur, cr = kadmm.admm_local_step_ref(*l_args, want_counts=True)
            # an element whose stop test falls the other way for one ulp
            # takes another Newton iteration: z and du are held where the
            # loop counts agree, and the share of the others is bounded
            same = (ck == cr).all(dim=0)
            n_diff = int((~same).sum())
            its, evs = int(ck[0].sum()), int(ck[1].sum())
            res["admm_local_step"] = [
                ("z", _rel_max(zk[:, same], zr[:, same]), th["elem"],
                 float((zk[:, same] - zr[:, same]).abs().max())),
                ("du", _rel_max(duk[:, same], dur[:, same]), th["elem"],
                 float((duk[:, same] - dur[:, same]).abs().max())),
                (f"share of elements whose loop counts differ ({n_diff})",
                 n_diff / n, 1e-3 if dtype == torch.float32 else 1e-4,
                 None)]
            say(f"kernels: {name} admm_local_step: Newton iterations per "
                f"element mean {its / n:.2f} max {int(ck[0].max())}, energy "
                f"evaluations mean {evs / n:.2f} max {int(ck[1].max())}")
            times["admm_local_step"] = (
                lambda: ops.admm_local_step(*l_args),
                lambda: kadmm.admm_local_step_ref(*l_args), None)
            costs["admm_local_step"] = (
                40 * n * sz, K17_FLOPS["svd"] * n + K17_FLOPS["newton"] * its
                + K17_FLOPS["energy"] * evs)

            a6 = torch.as_tensor(rng.normal(size=(6, n)), dtype=dtype,
                                 device="cuda")
            mk, mr = ops.make_pd3(a6), kadmm.make_pd3_ref(a6)
            err_pd = _rel_max(mk, mr)
            say(f"kernels: {name} make_pd3 (K17's SPD projection alone, row "
                f"u): rel {err_pd:.3e} (tol {th['elem']:g})")
            if not err_pd <= th["elem"]:
                bad.append(f"make_pd3 {name}: {err_pd:.3e}")

            M9 = torch.as_tensor(rng.normal(size=(9, n)), dtype=dtype,
                                 device="cuda")
            xx = torch.as_tensor(x_np, dtype=dtype, device="cuda")
            base = torch.as_tensor(rng.normal(size=(nv, 3)), dtype=dtype,
                                   device="cuda")
            off = torch.as_tensor(rng.normal(size=(nv, 3)), dtype=dtype,
                                  device="cuda")
            free = torch.logical_not(fixed).to(dtype)
            s_args = (M9, pdsys.g9, pst.w_e, pdsys.scat_perm,
                      pdsys.scat_segids, pdsys.scat_off, xx)
            ak = ops.dtw_scatter(*s_args, mass=pdsys.mass)
            ar = kadmm.dtw_scatter_ref(*s_args, mass=pdsys.mass)
            rk = ops.dtw_scatter(*s_args, base=base, offset=off, free=free)
            rr = kadmm.dtw_scatter_ref(*s_args, base=base, offset=off,
                                       free=free)
            res["dtw_scatter"] = [
                ("A x", _rel_max(ak, ar), tol["elem"],
                 float((ak - ar).abs().max())),
                ("rhs", _rel_max(rk, rr), tol["elem"],
                 float((rk - rr).abs().max()))]
            corner = torch.randn((4 * n, 3), dtype=dtype, device="cuda")
            cidx = pdsys.conn_s.t().reshape(-1).long()
            acc18 = torch.zeros((nv + 1, 3), dtype=dtype, device="cuda")
            times["dtw_scatter"] = (
                lambda: ops.dtw_scatter(*s_args, base=base, offset=off,
                                        free=free),
                lambda: kadmm.dtw_scatter_ref(*s_args, base=base, offset=off,
                                              free=free),
                lambda: acc18.index_add_(0, cidx, corner))
            costs["dtw_scatter"] = (
                (19 * n + 13 * nv) * sz + 32 * n + 8 * (nv + 2),
                12 * n * 11)
            del zk, zr, duk, dur
            torch.cuda.empty_cache()

            # ---- K19, K20, the two entry points: the ADMMDD 6 plan
            sysm = System(mesh, cfg, plan, dtype=dtype, device="cuda")
            dd = ADMMDDStepper(sysm, sd, ap)
            P, n3, nmax = sysm.n_parts, sysm.n3, dd.nmax
            n = sysm.n_elem_p
            _, wv, _, _ = dd.update_weights(xx, fixed)
            free3f = dd._free3(fixed).reshape(-1).contiguous()
            wp = dd.wp
            valid = sysm.local_valid[..., None]
            xl_flat = dd._to_flat(xx[sysm.l2g] * valid)
            eh = sysm.k.elem_hessian(xl_flat, dd.conn_local, sysm.g9,
                                     sysm.u_e, sysm.lam_e, sysm.vol_w,
                                     sysm.mat, sysm.dt_sq)
            freef = sysm._free(fixed).to(dtype).reshape(-1)
            ml = dd.mass_local.reshape(-1).contiguous()
            b_args = (eh, freef, ml, sysm.own_band_plan, wv, free3f, wp)
            fk = ops.own_band_assemble(*b_args)
            fr = kadmm.own_band_assemble_ref(*b_args)
            n_drop = int((wp.band_dest >= sysm.own_band_plan.total).sum())
            res["own_band_assemble"] = [
                ("band", _rel_norm(fk, fr), TOL_H0[name]["exact"],
                 float((fk - fr).abs().max()))]
            obp = sysm.own_band_plan
            n_ub, n_asm = obp.ub_row.shape[0], obp.src_block.shape[0]
            n_w, n_rows = wp.row.shape[0], free3f.shape[0]
            times["own_band_assemble"] = (
                lambda: ops.own_band_assemble(*b_args),
                lambda: kadmm.own_band_assemble_ref(*b_args), None)
            costs["own_band_assemble"] = (
                eh.numel() * sz + 16 * n_asm + 8 * (n_ub + 1) + 16 * n_ub
                + 2 * freef.numel() * sz + 72 * n_ub
                + 8 * obp.pad_diag.numel() + obp.total * sz
                + (24 + sz) * n_w + (8 + 2 * sz) * n_rows,
                9 * n_asm + 3 * n_w + 2 * n_rows)
            del fr

            a = torch.as_tensor(rng.normal(size=n_rows), dtype=dtype,
                                device="cuda")
            yk = ops.w_matvec(wv, free3f, a, wp)
            yr = kadmm.w_matvec_ref(wv, free3f, a, wp)
            dk = ops.w_matvec(wv, free3f, None, wp, diag_only=True)
            dr = kadmm.w_matvec_ref(wv, free3f, None, wp, diag_only=True)
            res["w_matvec"] = [("W a", _rel_max(yk, yr), tol["elem"],
                                float((yk - yr).abs().max()))]
            res["w_diag"] = [("diag W", _rel_max(dk, dr), tol["elem"],
                              float((dk - dr).abs().max()))]
            wm = wv * free3f[wp.row] * free3f[wp.col]
            va = wm * a[wp.col]
            acc20 = torch.zeros(n_rows, dtype=dtype, device="cuda")
            times["w_matvec"] = (
                lambda: ops.w_matvec(wv, free3f, a, wp),
                lambda: kadmm.w_matvec_ref(wv, free3f, a, wp),
                lambda: acc20.index_add_(0, wp.row, va))
            times["w_diag"] = (
                lambda: ops.w_matvec(wv, free3f, None, wp, diag_only=True),
                lambda: kadmm.w_matvec_ref(wv, free3f, None, wp,
                                           diag_only=True),
                lambda: acc20.index_add_(0, wp.row, wm))
            costs["w_matvec"] = ((sz + 8) * n_w + 8 * (n_rows + 1)
                                 + 4 * n_rows * sz, 4 * n_w + 3 * n_rows)
            costs["w_diag"] = ((sz + 8) * n_w + 8 * (n_rows + 1)
                               + 3 * n_rows * sz, 3 * n_w + 2 * n_rows)

            # K20's line-search entry: the (3, P) W terms in one launch,
            # against its plain version and the launches it replaced (two
            # w_matvec and the sums)
            aug0 = torch.as_tensor(rng.normal(size=n_rows), dtype=dtype,
                                   device="cuda")
            pa = torch.as_tensor(0.1 * rng.normal(size=n_rows), dtype=dtype,
                                 device="cuda")
            q_args = (wv, free3f, aug0, pa, wp, P)

            def q_seq():
                Wa0 = ops.w_matvec(wv, free3f, aug0, wp).view(P, -1)
                Wpa = ops.w_matvec(wv, free3f, pa, wp).view(P, -1)
                a0, p_ = aug0.view(P, -1), pa.view(P, -1)
                return torch.stack([
                    0.5 * torch.sum(a0 * Wa0, dim=1),
                    0.5 * (torch.sum(p_ * Wa0, dim=1)
                           + torch.sum(a0 * Wpa, dim=1)),
                    0.5 * torch.sum(p_ * Wpa, dim=1)])
            qk, qr, qs = ops.w_quad(*q_args), kadmm.w_quad_ref(*q_args), \
                q_seq()
            same = torch.equal(ops.w_quad(*q_args), qk)
            res["w_quad"] = [
                ("a0c, a1c, a2c", _rel_max(qk, qr), tol["elem"],
                 float((qk - qr).abs().max())),
                ("vs 2 w_matvec + sums", _rel_max(qk, qs), tol["elem"], None),
                ("two runs (bit for bit)", 0.0 if same else 1.0, 0.0, None)]
            csr = torch.sparse_csr_tensor(wp.row_off, wp.col, wm,
                                          (n_rows, n_rows))
            two = torch.stack([aug0, pa], dim=1)
            times["w_quad"] = (
                lambda: ops.w_quad(*q_args),
                lambda: kadmm.w_quad_ref(*q_args),
                lambda: csr @ two)
            # each W entry, column and row offset once, the four vectors
            # once, the (3, P) result; per entry two products for the mask
            # and two multiply-adds, per row 14 operations
            costs["w_quad"] = ((sz + 8) * n_w + 8 * (n_rows + 1)
                               + 4 * n_rows * sz + 3 * P * sz,
                               6 * n_w + 14 * n_rows)

            F0 = dd._local_defgrad(xl_flat)
            p_flat = dd._to_flat(torch.as_tensor(
                0.01 * rng.normal(size=(P, nmax, 3)), dtype=dtype,
                device="cuda") * valid)
            Fp = dd._local_defgrad(p_flat)
            alpha = torch.as_tensor([1.0, 0.5, 0.25, 1.0, 0.125, 0.5][:P]
                                    + [1.0] * max(P - 6, 0), dtype=dtype,
                                    device="cuda")
            e_args = (F0, Fp, alpha, sysm.u_e, sysm.lam_e, sysm.vol_w,
                      sysm.mat, P)
            ek = ops.ls_trial_energy_parts(*e_args)
            er = kadmm.ls_trial_energy_parts_ref(*e_args)
            e0k = ops.ls_trial_energy_parts(F0, None, None, *e_args[3:])
            e0r = kadmm.ls_trial_energy_parts_ref(F0, None, None,
                                                  *e_args[3:])
            per_slab = float(((ek - er).abs() / er.abs()).max())
            res["ls_trial_energy_parts"] = [
                ("per slab", per_slab, th["elem"],
                 float((ek - er).abs().max())),
                ("per slab, no direction",
                 float(((e0k - e0r).abs() / e0r.abs()).max()), th["elem"],
                 None)]
            times["ls_trial_energy_parts"] = (
                lambda: ops.ls_trial_energy_parts(*e_args),
                lambda: kadmm.ls_trial_energy_parts_ref(*e_args), None)
            costs["ls_trial_energy_parts"] = (
                (21 * n + 2 * P) * sz, ELEM_FLOPS["ls_trial_energy"] * n)

            g_args = (F0, dd.conn_local, sysm.g9, sysm.u_e, sysm.lam_e,
                      sysm.vol_w, sysm.mat, P * nmax)
            gk = ops.elem_gradient_from_F(*g_args)
            gr = kadmm.elem_gradient_from_F_ref(*g_args)
            # the same forces as K2 on the local rows
            g2 = ops.elem_gradient(xl_flat[:-1].contiguous(), torch.where(
                dd.conn_local == P * nmax, 0, dd.conn_local), dd.conn_local,
                sysm.g9, sysm.u_e, sysm.lam_e, sysm.vol_w, sysm.mat)
            res["elem_gradient_from_F"] = [
                ("grad", _rel_norm(gk, gr), th["grad"],
                 float((gk - gr).abs().max())),
                ("vs K2 at the same rows", _rel_norm(gk, g2), th["grad"],
                 None)]
            forces = torch.randn((4 * n, 3), dtype=dtype, device="cuda")
            lidx = dd.conn_local.t().reshape(-1).long()
            accg = torch.zeros((P * nmax + 1, 3), dtype=dtype, device="cuda")
            times["elem_gradient_from_F"] = (
                lambda: ops.elem_gradient_from_F(*g_args),
                lambda: kadmm.elem_gradient_from_F_ref(*g_args),
                lambda: accg.index_add_(0, lidx, forces))
            costs["elem_gradient_from_F"] = (
                (21 * n + 3 * (P * nmax + 1)) * sz + 16 * n,
                ELEM_FLOPS["elem_gradient"] * n)
            torch.cuda.synchronize()
            for kname, checks in res.items():
                _report(torch, name, kname, checks, times[kname],
                        costs[kname], bad, record,
                        plain_reps=2 if kname == "admm_local_step" else 15)
            n_dev = _work_check(name, "w_quad", times["w_quad"][0], 1,
                                ("w_quad_kernel",), bad)
            seq_ms = _median_ms(torch, q_seq)
            b2b = _back_to_back_ms(torch, times["w_quad"][0])
            seq_b2b = _back_to_back_ms(torch, q_seq)
            say(f"kernels: {name} w_quad: the sequence it replaced (2 "
                f"w_matvec + sums) {seq_ms:.4f} ms; back to back {b2b:.4f} "
                f"ms a call, the sequence {seq_b2b:.4f} ms")
            if dtype == torch.float32:
                record["w_quad"].update(
                    sequence_ms=seq_ms, back_to_back_ms=b2b,
                    sequence_back_to_back_ms=seq_b2b,
                    launches_per_call=n_dev)
            say(f"kernels: {name} ADMM shapes: K17 / K18 on {mesh.n_elem} "
                f"elements and {nv} vertices; own band {obp.total} values "
                f"from {n_asm} tuples in {n_ub} blocks; W {n_w} entries "
                f"({n_drop} in upper-neighbour blocks, dropped) on {n_rows} "
                f"rows; slabs {P} x {n // P} elements; local rows "
                f"{P * nmax}")
            del sysm, dd, eh, fk, F0, Fp, forces, csr, two
            torch.cuda.empty_cache()
        if bad:
            raise Fail("kernel disagrees with its plain version: "
                       + "; ".join(bad))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_admm(torch, launches_out):
    """ADMM-PD and ADMM-DD 6 at bar17 through Simulator."""
    from dot_tpu_torch.kernels import ops
    from dot_tpu_torch.steppers.core import BTDFactor
    tmp = tempfile.mkdtemp(prefix="dot_admm_")
    try:
        base = _bar_scene(tmp)
        out_root = os.path.join(tmp, "out")
        dot = _simulator(torch, base, out_root, suffix="ref",
                         save_every=10 ** 9)
        dot.run(ADMM_FRAMES)
        dot.finalize()
        e_dot = np.asarray([r["sys_e"] for r in dot.frames])
        del dot
        torch.cuda.empty_cache()
        total = dict.fromkeys(ops.KERNELS, 0)
        problems = []
        for tag, (stepper, need) in ADMM_RUNS.items():
            scene = _scene_variant(base, tag, stepper)
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            sim = _simulator(torch, scene, out_root, save_every=10 ** 9)
            t1 = time.perf_counter()
            sim.run(ADMM_FRAMES)
            launches = dict(ops.launches)
            peak = torch.cuda.max_memory_allocated()
            for k, v in launches.items():
                total[k] += v
            sysm, fr, st = sim.system, sim.frames, sim.stepper
            cap = st.max_iter if tag == "ADMM" else 1000
            iters = sum(r["iters"] for r in fr)
            say(f"admm: {tag}: {type(st).__name__}, P {sysm.n_parts}, n3 "
                f"{sysm.n3}, banded {sysm.banded} (nb {sysm.band_nb}, bs "
                f"{sysm.band_bs}); iteration cap {cap}; Simulator "
                f"{t1 - t0:.2f} s; s/frame "
                f"{np.mean([r['seconds'] for r in fr]):.5f}; ms/iteration "
                f"{1e3 * sum(r['seconds'] for r in fr) / max(iters, 1):.3f};"
                f" peak {peak / 2**20:.1f} MiB")
            say(f"admm: {tag}: per frame (iters, syncs, stop, s): "
                + "; ".join(f"{r['iters']},{r['syncs']},{r['stop']},"
                            f"{r['seconds']:.3f}" for r in fr))
            say(f"admm: {tag}: launches "
                f"{ {k: v for k, v in launches.items() if v} }")
            for r in fr:
                if not np.isfinite(r["sys_e"]):
                    problems.append(f"{tag} frame {r['frame']} sysE not "
                                    "finite")
                if r["stop"] not in ("tol", "iter_cap") or (
                        r["stop"] == "iter_cap" and r["iters"] != cap):
                    problems.append(f"{tag} frame {r['frame']} stopped by "
                                    f"{r['stop']} after {r['iters']}")
            for k in need:
                if launches[k] <= 0:
                    problems.append(f"{tag}: kernel {k} never launched")
            if tag == "ADMM":
                kind, leaf_dt, shape = _factor_kind(sim.state.chol)
                say(f"admm: ADMM: global factor {kind} {leaf_dt} {shape}; "
                    f"K17 {launches['admm_local_step'] / max(iters, 1):.2f}, "
                    f"K18 {launches['dtw_scatter'] / max(iters, 1):.2f}, "
                    f"pd_solve {launches['block_solve'] / max(iters, 1):.2f} "
                    f"solve launches per iteration (want 1)")
                if (kind != "BTDFactor" or leaf_dt != ["float32"]
                        or launches["admm_local_step"] != iters
                        or launches["dtw_scatter"] != iters + len(fr)
                        or launches["block_solve"] != iters):
                    problems.append(f"ADMM: factor {kind} {leaf_dt}, "
                                    f"launches {launches}")
            else:
                s_ = sim.state
                free3 = st._free3(s_.fixed)
                xl = st._to_flat(s_.x[sysm.l2g] * sysm.local_valid[..., None])
                L, _ = st._local_h_factor(xl, (s_.w_vals,
                                               free3.reshape(-1)), s_.fixed)
                kind, leaf_dt, shape = _factor_kind(L)
                n_ref = launches["own_band_assemble"]
                say(f"admm: ADMMDD6: banded_local {st.banded_local}; local "
                    f"factor {kind} {leaf_dt} {shape}; consensus factor "
                    f"{tuple(s_.cons_chol.shape)} {s_.cons_chol.dtype}; "
                    f"local refactorizations {n_ref} (K19) in {iters} "
                    f"iterations; K20 family "
                    f"{(launches['w_matvec'] + launches['w_quad']) / max(iters, 1):.2f}"
                    f" (w_matvec {launches['w_matvec'] / max(iters, 1):.2f}, "
                    f"w_quad {launches['w_quad'] / max(iters, 1):.2f}), "
                    f"per-slab "
                    f"K1 {launches['ls_trial_energy_parts'] / max(iters, 1):.2f}"
                    f", from-F K2 "
                    f"{launches['elem_gradient_from_F'] / max(iters, 1):.2f} "
                    "per iteration")
                if (not st.banded_local or not isinstance(L, BTDFactor)
                        or leaf_dt != ["float32"]
                        or shape != (13, 6, 768, 768)
                        or launches["w_quad"] != iters):
                    problems.append(f"ADMMDD6: local factor {kind} "
                                    f"{leaf_dt} {shape}, banded_local "
                                    f"{st.banded_local}, w_quad "
                                    f"{launches['w_quad']} in {iters} "
                                    "iterations")
                del L, s_
            sim.finalize()
            a = np.asarray([r["sys_e"] for r in fr])
            by_tol = all(r["stop"] == "tol" for r in fr)
            rel_dot = np.abs(a / e_dot[:len(a)] - 1.0).max()
            del sim, sysm, st
            torch.cuda.empty_cache()

            # the same frames with the plain versions on the card (the
            # plain local step reads the host inside its loops: seconds a
            # frame)
            t0 = time.perf_counter()
            ref = _simulator(torch, scene, out_root, suffix="plain",
                             use_kernels=False, save_every=10 ** 9)
            ref.run(ADMM_FRAMES)
            ref.finalize()
            b = np.asarray([r["sys_e"] for r in ref.frames])
            rel = np.abs(a / b - 1.0).max()
            say(f"admm: {tag}: sysE " + " ".join("%.10e" % v for v in a)
                + f"; vs plain path max rel {rel:.3e} (tol 1e-3; plain "
                f"iters {[r['iters'] for r in ref.frames]}, s/frame "
                f"{np.mean([r['seconds'] for r in ref.frames]):.3f}); vs "
                f"DOT6 max rel {rel_dot:.3e} ("
                + ("tol 1e-3" if by_tol else "not gated: a frame hit its cap")
                + ")")
            if not rel <= 1e-3:
                problems.append(f"{tag}: kernel and plain paths disagree: "
                                f"{rel:.3e}")
            if by_tol and not rel_dot <= 1e-3:
                problems.append(f"{tag}: sysE off DOT's by {rel_dot:.3e}")
            del ref
            torch.cuda.empty_cache()
        launches_out["admm"] = total
        for k in ADMM_KERNELS:
            if total[k] <= 0:
                problems.append(f"kernel {k} never launched on the admm path")
        if problems:
            raise Fail("admm path: " + "; ".join(problems))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _spikes_scene(tmp, resolution, name, stepper="Newton"):
    """Write the 2D spikes stretch scene (the scene of the repo's 2D golden,
    tests/test_dim2.py:239-260) at `resolution` under `timeStepper
    <stepper>`; return its path."""
    scene = os.path.join(tmp, f"{name}.txt")
    with open(scene, "w") as f:
        f.write(SPIKES_SCENE.format(resolution=resolution, stepper=stepper))
    return scene


def _sim2d(torch, scene, out_root, dtype, suffix="", **kw):
    """The Sim2D run_script_2d would build for `scene` on the card."""
    from dot_tpu_torch.config import Config
    from dot_tpu_torch.dim2 import Sim2D
    cfg = Config.load(scene)
    name = cfg.output_folder_name() + (f"_{suffix}" if suffix else "")
    return Sim2D(cfg, os.path.join(out_root, name), dtype=dtype,
                 device="cuda", mute=True, **kw)


def _dim2_inputs(torch, dtype, rng):
    """Element statics of the full-size spikes mesh and deformed states: a
    third of the vertices jittered (random and inverted triangles), a third
    squashed flat (near-degenerate F), the rest at rest (F = I: R = 0 in the
    flip-SVD, s0 = s1); F0 a third random, a third inverted, a third of
    rank ~1."""
    from dot_tpu_torch.config import Config
    from dot_tpu_torch.dim2 import Mesh2D
    from dot_tpu_torch.kernels import dd2d, soa2d
    cfg = Config(energy="FCR", shape="spikes", resolution=SPIKES_FULL,
                 ym=1e5, pr=0.4, rho=1000.0, handle_ratio=0.03)
    mesh = Mesh2D.from_config(cfg)
    dev = torch.device("cuda")
    n, nv = mesh.n_elem, mesh.n_vert

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    x = mesh.V.copy()
    sel = rng.permutation(nv)
    a, b = sel[:nv // 3], sel[nv // 3: 2 * nv // 3]
    h = float(np.sqrt(mesh.area.mean()))
    x[a, :2] += rng.normal(scale=0.5 * h, size=(len(a), 2))
    x[b, 1] = x[b, 1] * 1e-3
    f0 = np.empty((4, n))
    third = n // 3
    f0[:, :third] = rng.normal(size=(4, third))
    inv = np.eye(2).reshape(4, 1) + 0.1 * rng.normal(size=(4, third))
    inv[[0, 2]] *= -1.0                                            # det < 0
    f0[:, third:2 * third] = inv
    m = n - 2 * third
    uv = rng.normal(size=(2, m))[:, None] * rng.normal(size=(2, m))[None]
    f0[:, 2 * third:] = uv.reshape(4, m) + 1e-7 * rng.normal(size=(4, m))
    f0[:, 0] = (1.0, 0.0, 0.0, 1.0)                      # F = I: R = 0
    f0[:, 1] = (0.0, -2.0, 2.0, 0.0)                     # a scaled rotation
    f0[:, 2] = 0.0                                       # Q = R = 0
    free = np.ones(nv)
    free[rng.permutation(nv)[:nv // 30]] = 0.0
    xt = mesh.V + np.concatenate(
        [rng.normal(scale=0.1 * h, size=(nv, 2)), np.zeros((nv, 1))], axis=1)
    p = np.concatenate([rng.normal(scale=0.01, size=(nv, 2)),
                        np.zeros((nv, 1))], axis=1)
    return mesh, dict(
        conn=t(mesh.conn.T, torch.int32),
        g4=t(mesh.rest_tri_inv.reshape(-1, 4).T), u=t(mesh.u),
        lam=t(mesh.lam), w=t(mesh.area), mass=t(mesh.mass), x=t(x),
        x_tilta=t(xt), p=t(p), free=t(free), F0=t(f0),
        Fp=t(rng.normal(size=(4, n))), h3=t(rng.normal(size=(3, n))),
        alpha=torch.tensor(0.5, dtype=dtype, device=dev),
        plan=soa2d.scatter2d_plan(mesh.conn, nv, dev),
        dense_tab=dd2d.dense_tables(mesh.conn, nv, dev))


def _usv2(U, s, V):
    """U diag(s) V^T of (4, N) / (2, N) component rows, as (4, N)."""
    import torch
    return torch.stack([
        U[2 * i] * s[0] * V[2 * j] + U[2 * i + 1] * s[1] * V[2 * j + 1]
        for i in range(2) for j in range(2)])


def _rows_rel_max(a, b):
    """Largest per-row max error over the row's own scale ((R, N) stacks of
    quantities of different magnitudes)."""
    scale = b.abs().amax(dim=1).clamp_min(1e-300)
    return float(((a - b).abs().amax(dim=1) / scale).max())


def phase_dim2_kernels(torch, record):
    """The 2D kernels (K21-K24, defgrad2d) and the check entries of their
    device functions against the plain versions at the full-size spikes
    scene's shapes, and K6's host split on a 2,000^2 block."""
    from dot_tpu_torch.kernels import band, dd2d, ops, soa2d
    mat = soa2d.FCR2D
    rng = np.random.default_rng(20261020)
    dt_sq = 0.025 ** 2
    bad = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        mesh, d = _dim2_inputs(torch, dtype, rng)
        conn, g4, u, lam, w = d["conn"], d["g4"], d["u"], d["lam"], d["w"]
        plan, tab = d["plan"], d["dense_tab"]
        n, nv, sz = mesh.n_elem, mesh.n_vert, d["x"].element_size()
        n2, n_slot = 2 * nv, tab.udest.shape[0]

        # ---- t1: the device functions, each through its check entry.
        # U, V and Q are not unique (R = 0, s0 = s1, b = 0 with a = c):
        # sigma, U diag(sigma) V^T, the eigenvalues and Q diag(lam) Q^T are
        Uk, sk, Vk = ops.svd2_flip(d["F0"])
        Ur, sr, Vr = soa2d.svd2_flip_ref(d["F0"])
        detU = Uk[0] * Uk[3] - Uk[1] * Uk[2]
        detV = Vk[0] * Vk[3] - Vk[1] * Vk[2]
        lk, Qk = ops.eigh2(d["h3"])
        lr, Qr = soa2d.eigh2_ref(d["h3"])

        def sym_of(l_, Q_):
            return torch.stack([
                l_[0] * Q_[0] * Q_[0] + l_[1] * Q_[1] * Q_[1],
                l_[0] * Q_[0] * Q_[2] + l_[1] * Q_[1] * Q_[3],
                l_[0] * Q_[2] * Q_[2] + l_[1] * Q_[3] * Q_[3]])
        t1 = [("svd2_flip sigma", _rel_max(sk, sr)),
              ("svd2_flip U S V^T", _rel_max(_usv2(Uk, sk, Vk),
                                             _usv2(Ur, sr, Vr))),
              ("svd2_flip U S V^T vs F", _rel_max(_usv2(Uk, sk, Vk),
                                                  d["F0"])),
              ("svd2_flip |det U - 1|", float((detU - 1).abs().max())),
              ("svd2_flip |det V - 1|", float((detV - 1).abs().max())),
              ("eigh2 lam", _rel_max(lk, lr)),
              ("eigh2 Q L Q^T", _rel_max(sym_of(lk, Qk), sym_of(lr, Qr))),
              ("make_pd2", _rel_max(ops.make_pd2(d["h3"]),
                                    soa2d.make_pd2_ref(d["h3"])))]
        for mname, m_ in soa2d.SOA2D_MATERIALS.items():
            t1.append((f"material2d {mname} (Psi, dPsi, d2Psi, BLeft, P)",
                       _rows_rel_max(ops.material2d(d["F0"], u, lam, m_),
                                     soa2d.material2d_ref(d["F0"], u, lam,
                                                          m_))))
        say(f"kernels: {name} elem2d.cuh device functions (rows t1) on "
            f"{n} matrices: " + "; ".join(f"{k} {v:.3e}" for k, v in t1)
            + f" (tol {tol['elem']:g})")
        for k, v in t1:
            if not v <= tol["elem"]:
                bad.append(f"{k} {name}: {v:.3e} > {tol['elem']:g}")

        res, times, costs = {}, {}, {}
        # ---- defgrad2d
        fk, fr = ops.defgrad2d(d["x"], conn, g4), \
            soa2d.defgrad2d_ref(d["x"], conn, g4)
        pk, pr = ops.defgrad2d(d["p"], conn, g4), \
            soa2d.defgrad2d_ref(d["p"], conn, g4)
        res["defgrad2d"] = [
            ("F(x)", _rel_max(fk, fr), tol["elem"],
             float((fk - fr).abs().max())),
            ("F(p)", _rel_max(pk, pr), tol["elem"], None)]
        times["defgrad2d"] = (lambda: ops.defgrad2d(d["x"], conn, g4),
                              lambda: soa2d.defgrad2d_ref(d["x"], conn, g4),
                              None)
        costs["defgrad2d"] = ((3 * nv + 8 * n) * sz + 12 * n, 12 * n)

        # ---- K21
        e_args = (d["F0"], d["Fp"], d["alpha"], u, lam, w, mat)
        k = ops.ls_trial_energy2d(*e_args, want_sigma=True)
        r = soa2d.ls_trial_energy2d_ref(*e_args, want_sigma=True)
        k0 = ops.ls_trial_energy2d(fk, None, None, u, lam, w, mat)
        r0 = soa2d.ls_trial_energy2d_ref(fr, None, None, u, lam, w, mat)
        res["ls_trial_energy2d"] = [
            ("sum", _rel_max(k[0], r[0]), tol["elem"],
             float((k[0] - r[0]).abs())),
            ("sigma", _rel_max(k[1], r[1]), tol["elem"],
             float((k[1] - r[1]).abs().max())),
            ("sum, no direction", _rel_max(k0[0], r0[0]), tol["elem"], None)]
        times["ls_trial_energy2d"] = (
            lambda: ops.ls_trial_energy2d(*e_args),
            lambda: soa2d.ls_trial_energy2d_ref(*e_args), None)
        costs["ls_trial_energy2d"] = ((11 * n + 2) * sz,
                                      ELEM2D_FLOPS["ls_trial_energy2d"] * n)

        # ---- K22
        g_args = (d["x"], d["x_tilta"], d["free"], d["mass"], conn, g4, u,
                  lam, w, mat, dt_sq, plan)
        gk, gr = ops.elem_gradient2d(*g_args), \
            soa2d.elem_gradient2d_ref(*g_args)
        fixed_rows = d["free"] == 0
        res["elem_gradient2d"] = [
            ("grad", _rel_norm(gk, gr), tol["grad"],
             float((gk - gr).abs().max())),
            ("z and fixed rows", float(gk[:, 2].abs().max())
             + float(gk[fixed_rows].abs().max()), 0.0, None)]
        forces = torch.randn(6 * n, dtype=dtype, device="cuda")
        acc = torch.zeros(n2, dtype=dtype, device="cuda")
        times["elem_gradient2d"] = (
            lambda: ops.elem_gradient2d(*g_args),
            lambda: soa2d.elem_gradient2d_ref(*g_args),
            lambda: acc.index_add_(0, plan.gdest, forces))
        costs["elem_gradient2d"] = (
            (11 * nv + 7 * n) * sz + 12 * n + 8 * (3 * n + nv + 1),
            ELEM2D_FLOPS["elem_gradient2d"] * n)

        # ---- K23
        h_args = (d["x"], conn, g4, u, lam, w, mat, dt_sq)
        hk, hr = ops.elem_hessian2d(*h_args), \
            soa2d.elem_hessian2d_ref(*h_args)
        res["elem_hessian2d"] = [("H", _rel_norm(hk, hr), tol["hess"],
                                  float((hk - hr).abs().max()))]
        times["elem_hessian2d"] = (lambda: ops.elem_hessian2d(*h_args),
                                   lambda: soa2d.elem_hessian2d_ref(*h_args),
                                   None)
        costs["elem_hessian2d"] = ((3 * nv + 7 * n + 36 * n) * sz + 12 * n,
                                   ELEM2D_FLOPS["elem_hessian2d"] * n)

        # ---- K24 on the plain version's element Hessians: K26's one pass
        # over the whole mesh as one part
        Hk, dk = ops.dense_assemble2d(hr, d["free"], d["mass"], tab)
        Hr, dr = soa2d.dense_assemble2d_ref(hr, d["free"], d["mass"], tab)
        sym = float((Hk - Hk.t()).abs().max())
        res["dense_assemble2d"] = [
            ("H", _rel_max(Hk, Hr), TOL_SCALE[name]["elem"],
             float((Hk - Hr).abs().max())),
            ("d", _rel_max(dk, dr), TOL_SCALE[name]["elem"], None),
            ("|H - H^T|", sym, 0.0, None)]
        del Hr
        torch.cuda.empty_cache()
        # bit for bit against the plain version's sequential sums on the
        # host (the card's index_add_ sums with atomics, in no fixed order);
        # its d = sqrt(diag) taken on the card (the host's sqrt and the
        # card's differ in the last bit for ~0.7 % of values)
        Hc, _ = soa2d.dense_assemble2d_ref(
            hr.cpu(), d["free"].cpu(), d["mass"].cpu(),
            dd2d.dense_tables(mesh.conn, nv, "cpu"))
        h_same = torch.equal(Hk.cpu(), Hc)
        dc = torch.sqrt(Hc.diagonal().to("cuda"))
        d_off = int((dk != dc).sum())
        res["dense_assemble2d"] += [
            ("H vs host plain (bit for bit)", 0.0 if h_same else 1.0, 0.0,
             None),
            (f"d vs host plain (bit for bit; {d_off} of {n2} differ)",
             0.0 if d_off == 0 else _rel_max(dk, dc), 0.0, None)]
        del Hc, dc
        # a fan around a vertex of 140 neighbours in a strip of 1,101
        # vertices, the ids shuffled: rows of 282 slots (three windows of
        # dd2d.MAX_ROW) spread over 2,202 columns, which the kernel cuts
        # into two pieces (f32) or three (f64): a piece skips the windows
        # left of it and carries its window from chunk to chunk
        kf, fn = 140, 1101
        fi = np.arange(1, kf + 1)
        fj = np.arange(kf + 1, fn - 2)
        fan = rng.permutation(fn)[np.concatenate([
            np.stack([np.zeros(kf, np.int64), fi, fi % kf + 1], axis=1),
            np.stack([fj, fj + 1, fj + 2], axis=1)])]
        fv = (rng.uniform(size=fn) > 0.2).astype(np.float64)
        fv[fan[0, 0]] = 1.0
        f_args = [np.abs(rng.normal(size=(36, fan.shape[0]))), fv,
                  rng.uniform(1.0, 2.0, size=fn)]
        fan_out = []
        for dev in ("cpu", "cuda"):
            ftab = dd2d.dense_tables(fan, fn, dev)
            fH, _ = ops.dense_assemble2d(
                *[torch.as_tensor(a, dtype=dtype, device=dev)
                  for a in f_args], ftab)
            fan_out.append(fH.to("cuda"))
        fan_same = torch.equal(*fan_out)
        res["dense_assemble2d"].append(
            (f"fan of {ftab.max_row}-slot rows over {ftab.n} columns vs "
             "host plain (bit for bit)",
             0.0 if fan_same else 1.0, 0.0, None))
        Sr = soa2d.dense_scale2d_ref(Hk, dk, tab)
        Sk = ops.dense_scale2d(Hk.clone(), dk, tab)
        res["dense_scale2d"] = [
            ("H / d / d", _rel_max(Sk, Sr), TOL_SCALE[name]["elem"],
             float((Sk - Sr).abs().max())),
            ("|diag - 1|", float((Sk.diagonal() - 1).abs().max()),
             4 * torch.finfo(dtype).eps, None)]
        del Sk, Sr
        torch.cuda.empty_cache()
        vals = hr.reshape(-1)[tab.src].contiguous()
        # the library yardstick of an assembly: the zero-filled matrix and
        # its index_add_, both inside the timed call
        k24 = (lambda: ops.dense_assemble2d(hr, d["free"], d["mass"], tab),
               lambda: soa2d.dense_assemble2d_ref(hr, d["free"], d["mass"],
                                                  tab),
               lambda: torch.zeros(n2 * n2, dtype=dtype, device="cuda")
               .index_add_(0, tab.dest, vals))
        times["dense_assemble2d"] = k24
        costs["dense_assemble2d"] = (
            (36 * n + 2 * nv + n2 * n2 + n2) * sz
            + 4 * (2 * tab.items.numel() + 2 * n_slot + n2 + 2),
            36 * n + 4 * n_slot)
        # the scaling touches the assembled slots only: every other entry
        # of H is 0 before and after
        times["dense_scale2d"] = (
            lambda: ops.dense_scale2d(Hk, dk, tab),
            lambda: soa2d.dense_scale2d_ref(Hk, dk, tab), None)
        costs["dense_scale2d"] = ((2 * n_slot + n2) * sz + 8 * n_slot,
                                  4 * n_slot)
        torch.cuda.synchronize()
        for kname, checks in res.items():
            _report(torch, name, kname, checks, times[kname], costs[kname],
                    bad, record, plain_reps=5)
        lpc = {}
        _one_pass_check(torch, "dense_assemble2d", k24[0], name, bad, lpc)
        _back_to_back(torch, name, "dense_assemble2d", k24, record)
        if name == "float32":
            record["dense_assemble2d"].update(launches_per_call=lpc[
                "dense_assemble2d"])
        say(f"kernels: {name} 2D shapes: spikes resolution {SPIKES_FULL}: "
            f"{n} triangles, {nv} vertices, dense matrix {n2}^2 "
            f"({n2 * n2 * sz / 1e9:.3f} GB), {n_slot} assembled slots from "
            f"{36 * n} entries")
        del Hk, vals, hk, hr, d, k24
        torch.cuda.empty_cache()

    if bad:
        raise Fail("kernel disagrees with its plain version: "
                   + "; ".join(bad))


def _dim2_split(sim, frames):
    """ms/frame of the parts of a Newton2D frame over `frames` more frames,
    each call wrapped in synchronised host timers: the assembly (K23, K24
    and its scaling), the Cholesky (K34), the two triangular solves, the
    line-search trials (K21) and the gradient (K22)."""
    import collections
    from dot_tpu_torch.kernels import ops
    acc = collections.Counter()
    sysm = sim.system
    names = ("factorize", "solve", "elastic_energy", "gradient")
    for name in names:
        wrap_timed(sysm, name, acc)
    chol = wrap_timed(None, "whole_chol", acc, module=ops, label="cholesky")
    try:
        sim.run(frames)
    finally:
        ops.whole_chol = chol
        for name in names:
            delattr(sysm, name)
    ms = {k: acc[k] / frames * 1e3 for k in names + ("cholesky",)}
    ms["assembly"] = ms["factorize"] - ms["cholesky"]
    return ms


def phase_dim2(torch, launches_out):
    """The 2D path through Sim2D on scene files written here: the golden
    (spikes, resolution 200, f64, kernels on), then the full-size run.
    Returns the full-size frames' sysE and their dtype."""
    from dot_tpu_torch.kernels import ops
    tmp = tempfile.mkdtemp(prefix="dot_dim2_")
    try:
        out_root = os.path.join(tmp, "out")
        # ---- golden
        gold = _sim2d(torch, _spikes_scene(tmp, 200, "spikes200"), out_root,
                      torch.float64)
        ops.reset_launches()
        gold.run(len(GOLDEN_2D_SPIKES_SYS_E))
        g_launch = {k: ops.launches[k] for k in DIM2_KERNELS}
        gold.finalize()
        vals = np.asarray([r["sys_e"] for r in gold.frames])
        rel = np.abs(vals / np.asarray(GOLDEN_2D_SPIKES_SYS_E) - 1.0)
        z_max = float(gold.state.x[:, 2].abs().max())
        say(f"dim2: golden spikes 200 ({gold.mesh.n_elem} triangles, "
            f"{gold.mesh.n_vert} vertices) Newton f64, kernels on: sysE "
            f"{['%.10e' % v for v in vals]}, max rel {rel.max():.3e} (tol "
            f"2e-4); iters {[r['iters'] for r in gold.frames]}, stops "
            f"{[r['stop'] for r in gold.frames]}; max |z| {z_max:g}; "
            f"launches {g_launch}")
        problems = []
        if not rel.max() <= 2e-4:
            problems.append(f"golden sysE off by {rel.max():.3e}")
        if z_max != 0.0:
            problems.append(f"golden z moved: {z_max:g}")
        if any(v <= 0 for v in g_launch.values()):
            problems.append(f"golden: a 2D kernel never launched: {g_launch}")
        need = ["config.txt", "iterStats.txt", "log.txt", "info.txt",
                "status0", "0.obj", f"status{gold.frame}",
                f"{gold.frame}.obj"]
        missing = [f for f in need
                   if not os.path.exists(os.path.join(gold.out, f))]
        if missing or os.path.exists(os.path.join(gold.out,
                                                  "finalResult_mesh.msh")):
            problems.append(f"golden outputs: missing {missing}")
        del gold
        if problems:
            raise Fail("dim2 path: " + "; ".join(problems))

        # ---- full size: f32, and f64 if f32 does not reach the tolerance
        scene = _spikes_scene(tmp, SPIKES_FULL, "spikes_full")
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[-1]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sim = _sim2d(torch, scene, out_root, dtype, suffix=name,
                         save_every=10 ** 9)
            t1 = time.perf_counter()
            ops.reset_launches()
            sim.run(1 + DIM2_FRAMES)
            launches = dict(ops.launches)
            peak = torch.cuda.max_memory_allocated()
            fr = list(sim.frames)
            timed = fr[1:]
            spf = float(np.mean([r["seconds"] for r in timed]))
            n2 = sim.system.n2
            say(f"dim2: spikes resolution {SPIKES_FULL} Newton {name}: "
                f"{sim.mesh.n_elem} triangles, {sim.mesh.n_vert} vertices, "
                f"dense matrix {n2}^2 "
                f"({n2 * n2 * sim.state.x.element_size() / 1e9:.3f} GB); "
                f"Sim2D {t1 - t0:.2f} s; s/frame {spf:.5f} ({DIM2_FRAMES} "
                f"timed frames after 1 warm-up of {fr[0]['seconds']:.3f} s); "
                f"iters/frame {np.mean([r['iters'] for r in timed]):.2f}; LS "
                f"halvings/frame "
                f"{np.mean([r['halvings'] for r in timed]):.2f}; syncs/frame "
                f"{np.mean([r['syncs'] for r in timed]):.2f}; peak device "
                f"memory {peak / 2**20:.1f} MiB")
            say("dim2: per frame (iters, halvings, syncs, stop, s): "
                + "; ".join(f"{r['iters']},{r['halvings']},{r['syncs']},"
                            f"{r['stop']},{r['seconds']:.3f}" for r in fr))
            say("dim2: sysE " + " ".join("%.10e" % r["sys_e"] for r in fr))
            n_fr = len(fr)
            say("dim2: launches per frame "
                + ", ".join(f"{k} {launches[k] / n_fr:.2f}"
                            for k in DIM2_KERNELS)
                + f"; all { {k: v for k, v in launches.items() if v} }")
            ok = all(np.isfinite(r["sys_e"]) and r["stop"] in ("tol",
                                                                "rel_dec")
                     for r in fr)
            z_max = float(sim.state.x[:, 2].abs().max())
            if ok or dtype == torch.float64:
                break
            say(f"dim2: FINDING: {name} does not reach relTol 1e-5 at this "
                f"size (stops {[r['stop'] for r in fr]}); the phase runs in "
                "float64 instead")
            sim.finalize()
            del sim
        launches_out["dim2"] = launches
        problems = []
        if not ok:
            problems.append(f"a frame is not finite or stopped by "
                            f"{[r['stop'] for r in fr]}")
        if z_max != 0.0:
            problems.append(f"z moved: {z_max:g}")
        for k in DIM2_KERNELS:
            if launches[k] <= 0:
                problems.append(f"kernel {k} never launched on the dim2 path")
        iters = sum(r["iters"] for r in fr)
        if (launches["elem_hessian2d"] != iters
                or launches["dense_assemble2d"] != iters
                or launches["dense_scale2d"] != iters):
            problems.append(f"{iters} Newton iterations but launches "
                            f"{launches}")
        # K34 factors each f32 iteration's matrix in one launch (f64: K33)
        k34 = launches["whole_chol"]
        say(f"dim2: K34 launches {k34} over {iters} Newton iterations "
            f"({name}; want {iters if name == 'float32' else 0})")
        if k34 != (iters if name == "float32" else 0):
            problems.append(f"{iters} Newton iterations, {k34} K34 launches")
        split = _dim2_split(sim, 2)
        more = sim.frames[n_fr:]
        it2 = max(sum(r["iters"] for r in more), 1) / 2
        say(f"dim2: synchronised split over 2 more frames (iters "
            f"{[r['iters'] for r in more]}), ms/frame: factorize "
            f"{split['factorize']:.2f} (assembly K23 + K24 "
            f"{split['assembly']:.2f}, Cholesky {split['cholesky']:.2f}), "
            f"solves {split['solve']:.2f}, line search and energies (K21) "
            f"{split['elastic_energy']:.2f}, gradient (K22) "
            f"{split['gradient']:.2f}; per Newton iteration: Cholesky "
            f"{split['cholesky'] / it2:.2f}, assembly "
            f"{split['assembly'] / it2:.3f}, solves "
            f"{split['solve'] / it2:.2f}")
        sim.finalize()
        a = np.asarray([r["sys_e"] for r in fr])
        dtype_run = sim.system.dtype
        del sim
        torch.cuda.empty_cache()
        if problems:
            raise Fail("dim2 path: " + "; ".join(problems))

        # the same frames with the plain versions on the card
        ref = _sim2d(torch, scene, out_root, dtype_run, suffix="plain",
                     use_kernels=False, save_every=10 ** 9)
        ref.run(len(fr))
        ref.finalize()
        b = np.asarray([r["sys_e"] for r in ref.frames])
        rel = np.abs(a / b - 1.0)
        say(f"dim2: plain-path sysE {' '.join('%.10e' % v for v in b)}; max "
            f"rel vs kernels {rel.max():.3e} (tol 1e-3); plain s/frame "
            f"{np.mean([r['seconds'] for r in ref.frames[1:]]):.5f}; plain "
            f"iters {[r['iters'] for r in ref.frames]}")
        if not rel.max() <= 1e-3:
            raise Fail(f"dim2 kernel path and plain path disagree: "
                       f"{rel.max():.3e}")
        return a, dtype_run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# K26 / K28's one-pass design: device kernels a call (torch.profiler) and
# the only kernel names those calls may run (no zero fill, no memset)
ONE_PASS = {"subdomain_assemble2d": 1, "subdomain_scale2d": 1,
            "pd_assemble2d": 2, "w_assemble2d": 1, "local_h_assemble2d": 1,
            "dense_assemble2d": 1}
ONE_PASS_KERNELS = ("assemble_kernel", "sym_scale_kernel",
                    "pd_pair_vals_kernel")


def _back_to_back_ms(torch, fn, calls=20):
    """ms a call over `calls` calls enqueued back to back between two
    events, better of two rounds: the device's time for a call that takes
    longer there than on the host (its Python checks and allocations then
    overlap the call before), which the single timed call of _median_ms
    adds to it."""
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(2):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        t = a.elapsed_time(b) / calls
        best = t if best is None else min(best, t)
    return best


def _back_to_back(torch, tag, kname, fns, record):
    """Kernel and library back to back (K26 / K28's entries): printed, and
    kept in the f32 record."""
    k = _back_to_back_ms(torch, fns[0])
    lib = _back_to_back_ms(torch, fns[2])
    say(f"kernels: {tag} {kname}: back to back {k:.4f} ms a call, library "
        f"{lib:.4f} ms")
    if tag == "float32":
        record[kname].update(back_to_back_ms=k, library_back_to_back_ms=lib)


def _work_check(tag, kname, fn, want, frags, bad):
    """The device work of one call of `fn`, counted twice: by a CUDA graph
    capture of the call (captured_work) and by torch.profiler
    (device_kernels). The capture must hold `want` kernels, every one
    named by one of `frags`, and nothing else (no memset, no copy); the
    profiler must agree wherever its traces held device events (in this
    long process they lose every event now and then). Returns the
    capture's count."""
    from dot_tpu_torch.profiling import captured_work, device_kernels
    k = device_kernels(fn)
    g = captured_work(fn)
    n, ng = sum(k.values()), sum(g.values())
    others = [name for name in list(k) + list(g)
              if not any(f in name for f in frags)]
    say(f"kernels: {tag} {kname}: {ng} device kernel(s) a call (want "
        f"{want}) in a graph capture: "
        + "; ".join(f"{name[:60]} x{c}" for name, c in g.items())
        + f"; torch.profiler: {n}" + ("" if n else " (the traces held no "
                                        "device event)"))
    if ng != want or n not in (0, want) or others:
        bad.append(f"{kname} {tag}: {ng} device kernels a call in a capture"
                   f", {n} in the profiler's trace, want {want}; others: "
                   f"{others}")
    return ng


def _one_pass_check(torch, kname, fn, tag, bad, launches_per_call):
    """Device kernels of one call of `fn` (K24, K26 / K28's entries): as
    many as ONE_PASS says, all of the one-pass design (no zero fill, no
    memset); the count is kept for the record."""
    launches_per_call[kname] = _work_check(tag, kname, fn, ONE_PASS[kname],
                                           ONE_PASS_KERNELS, bad)


def phase_dd2d_kernels(torch, record):
    """K25-K28, K32 and K33 against their plain versions at the dim2dd
    path's full-size shapes (spikes at resolution 20,000 on the 4-part
    element plan; K28 on the (nV)^2 PD matrix; K33 on the plan's scaled
    subdomain matrices and K32 on their factor), f64 and f32, and
    factorize_fast's global 1e-4 tier on an indefinite subdomain."""
    from dot_tpu_torch import dim2, plan2d, scripts
    from dot_tpu_torch.config import Config
    from dot_tpu_torch.kernels import dd2d, ops, soa2d
    rng = np.random.default_rng(20261017)
    cfg = Config(energy="FCR", time_stepper="DOT", shape="spikes",
                 resolution=SPIKES_FULL, ym=1e5, pr=0.4, rho=1000.0,
                 handle_ratio=0.03, dt=0.025, script="stretch",
                 partition_amt=DD2D_PARTS)
    mesh = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(mesh, cfg.script)
    mesh.fixed_mask = sd.fixed0.copy()
    t0 = time.perf_counter()
    plan = plan2d.build_plan_2d(mesh, DD2D_PARTS)
    t_plan = time.perf_counter() - t0
    n, nv = mesh.n_elem, mesh.n_vert
    h = float(np.sqrt(mesh.area.mean()))
    x0 = np.asarray(sd.x0, np.float64).copy()
    x0[:, :2] += rng.normal(scale=0.3 * h, size=(nv, 2))
    p0 = np.zeros((nv, 3))
    p0[:, :2] = rng.normal(scale=0.01, size=(nv, 2))
    bad = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        tol = TOL_SCALE[name]
        sysm = dim2.System2D(mesh, cfg, dtype=dtype, device="cuda",
                             plan=plan)
        sz = torch.finfo(dtype).bits // 8

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device="cuda")
        x, p = t(x0), t(p0)
        fixed = torch.as_tensor(sd.fixed0, device="cuda")
        conn, g4, mass = sysm.conn, sysm.g4, sysm.mass
        eh = soa2d.elem_hessian2d_ref(x, conn, g4, sysm.u_e, sysm.lam_e,
                                      sysm.vol_w, sysm.mat, sysm.dt_sq)
        free = torch.logical_and(sysm.local_valid, torch.logical_not(
            fixed[sysm.l2g])).to(dtype)
        tab = sysm.asm_tab
        P, N, n2p = tab.n_parts, tab.n_loc, tab.n
        n_slot, n_item = tab.udest.shape[0], tab.items.shape[0]
        res, times, costs, per_call = {}, {}, {}, {}

        # ---- K25
        qk, Fk = ops.quadratic_form2d(p, conn, g4, eh, mass)
        qr, Fr = dd2d.quadratic_form2d_ref(p, conn, g4, eh, mass)
        res["quadratic_form2d"] = [
            ("pHp", _rel_max(qk, qr), tol["elem"], float((qk - qr).abs())),
            ("F(p)", _rel_max(Fk, Fr), tol["elem"],
             float((Fk - Fr).abs().max()))]
        times["quadratic_form2d"] = (
            lambda: ops.quadratic_form2d(p, conn, g4, eh, mass),
            lambda: dd2d.quadratic_form2d_ref(p, conn, g4, eh, mass), None)
        costs["quadratic_form2d"] = (
            (3 * nv + 4 * n + 36 * n + nv + 4 * n + 1) * sz + 12 * n,
            (36 * 3 + 16) * n + 9 * nv)

        # ---- K26 and its scaling entry
        Hk, dk = ops.subdomain_assemble2d(eh, free, sysm.mass_img, tab)
        Hr, dr = dd2d.subdomain_assemble2d_ref(eh, free, sysm.mass_img, tab)
        res["subdomain_assemble2d"] = [
            ("H", _rel_max(Hk, Hr), tol["elem"],
             float((Hk - Hr).abs().max())),
            ("d", _rel_max(dk, dr), tol["elem"], None),
            ("|H - H^T|", float((Hk - Hk.mT).abs().max()), 0.0, None)]
        Sr = dd2d.subdomain_scale2d_ref(Hr, dr, tab)
        del Hr
        Sk = ops.subdomain_scale2d(Hk.clone(), dk, tab)
        res["subdomain_scale2d"] = [
            ("(H / d / d) symmetrized", _rel_max(Sk, Sr), tol["elem"],
             float((Sk - Sr).abs().max())),
            ("|diag - 1|",
             float((Sk.diagonal(dim1=1, dim2=2) - 1).abs().max()),
             4 * torch.finfo(dtype).eps, None)]
        del Sk, Sr
        torch.cuda.empty_cache()
        vals = eh.reshape(-1)[tab.src]
        times["subdomain_assemble2d"] = (
            lambda: ops.subdomain_assemble2d(eh, free, sysm.mass_img, tab),
            lambda: dd2d.subdomain_assemble2d_ref(eh, free, sysm.mass_img,
                                                  tab),
            lambda: torch.zeros(P * n2p * n2p, dtype=dtype, device="cuda")
            .index_add_(0, tab.dest, vals))
        # bytes: the values, free and mass read once, H and d written once,
        # the int32 row tables (items, seg_off, row_off, col) read once
        costs["subdomain_assemble2d"] = (
            (36 * n + 2 * P * N + P * n2p * n2p + P * n2p) * sz
            + 4 * (n_item + 2 * n_slot + P * n2p + 2), n_item + 4 * n_slot)
        Hs = Hk.clone()     # scaled over and over by the timing below
        times["subdomain_scale2d"] = (
            lambda: ops.subdomain_scale2d(Hs, dk, tab),
            lambda: dd2d.subdomain_scale2d_ref(Hs, dk, tab), None)
        costs["subdomain_scale2d"] = ((2 * n_slot + P * n2p) * sz
                                      + 4 * (n_slot + P * n2p + 1),
                                      6 * n_slot)
        _one_pass_check(torch, "subdomain_assemble2d",
                        times["subdomain_assemble2d"][0], name, bad, per_call)
        _one_pass_check(torch, "subdomain_scale2d",
                        times["subdomain_scale2d"][0], name, bad, per_call)

        # ---- the global 1e-4 tier: one indefinite subdomain refactors all
        Hi = Hk.clone()
        Hi[0, 0, 2] = Hi[0, 2, 0] = 10.0 * torch.sqrt(Hi[0, 0, 0]
                                                      * Hi[0, 2, 2])
        Hn = Hk[1:] / dk[1:, :, None] / dk[1:, None, :]
        Hn = (Hn + Hn.mT) / 2
        L_plain = torch.linalg.cholesky(Hn)
        Hn.diagonal(dim1=1, dim2=2).add_(1.0e-4)
        L_shift = torch.linalg.cholesky(Hn)
        del Hn
        s0 = sysm.n_syncs
        Li, _ = sysm.factorize_fast(Hi, dk.clone())
        reads = sysm.n_syncs - s0
        nan0 = bool(torch.isnan(Li[0]).any())
        fin = bool(torch.isfinite(Li[1:]).all())
        e_shift = _rel_norm(Li[1:], L_shift)
        e_plain = _rel_norm(Li[1:], L_plain)
        lim = 1e-10 if dtype == torch.float64 else 1e-4
        say(f"kernels: {name} factorize_fast on an indefinite subdomain "
            f"(P {P}, n2p {n2p}): {reads} host read; subdomain 0 NaN {nan0}, "
            f"the other {P - 1} finite {fin}: rel to cholesky(Hn + 1e-4 I) "
            f"{e_shift:.3e} (tol {lim:g}), to the unshifted factor "
            f"{e_plain:.3e}")
        if not (reads == 1 and nan0 and fin and e_shift <= lim
                and e_plain > e_shift):
            bad.append(f"global 1e-4 tier {name}: reads {reads}, NaN {nan0}, "
                       f"finite {fin}, {e_shift:.3e} / {e_plain:.3e}")
        del Hi, Li, L_plain, L_shift
        torch.cuda.empty_cache()

        # ---- K33: the scaled subdomain matrices' batched Cholesky (f32:
        # its error against an f64 factor of the same matrices, over the
        # library's; f64: against the plain version), bit for bit from
        # run to run, exact zeros above the diagonal, one device kernel a
        # call; its bound as dense_factor_roofline counts it (P n^3 / 3
        # at the f32 rate); plain = the library Cholesky + its NaN passes,
        # library = cholesky_ex alone
        Sn = ops.subdomain_scale2d(Hk.clone(), dk, tab)
        Lk, bad_k = ops.dense_chol(Sn)
        lib, _ = dd2d.dense_chol_ref(Sn)
        if dtype == torch.float32:
            L64, _ = dd2d.dense_chol_ref(Sn.double())
            e_k, e_lib = _rel_norm(Lk.double(), L64), _rel_norm(
                lib.double(), L64)
            k33_err = ("error vs an f64 factor, over the library's "
                       f"({e_k:.3e} / {e_lib:.3e})", e_k / e_lib, 1.5,
                       float((Lk - lib).abs().max()))
            del L64
        else:
            k33_err = ("vs plain (the library Cholesky)", _rel_norm(Lk, lib),
                       1e-12, float((Lk - lib).abs().max()))
        res["dense_chol"] = [
            k33_err,
            ("run to run (bit for bit)",
             0.0 if torch.equal(Lk, ops.dense_chol(Sn)[0]) else 1.0, 0.0,
             None),
            ("|triu(L, 1)|", float(torch.triu(Lk, 1).abs().max()), 0.0, None),
            ("flag", 1.0 if bool(bad_k) else 0.0, 0.0, None)]
        del Lk, lib
        times["dense_chol"] = (lambda: ops.dense_chol(Sn),
                               lambda: dd2d.dense_chol_ref(Sn),
                               lambda: torch.linalg.cholesky_ex(Sn))
        costs["dense_chol"] = (
            (P * n2p * n2p + P * n2p * (n2p + 1) / 2) * sz, P * n2p ** 3 / 3)
        per_call["dense_chol"] = _work_check(
            name, "dense_chol", lambda: ops.dense_chol(Sn), 1,
            ("dense_chol",), bad)

        # ---- K27: the H0 apply's gather / averaging, one subdomain's
        # gather / scatter, around K32's solves of a real factor
        L, d = sysm.factorize_fast(Hk, dk)
        del Hk
        l2g, valid = sysm.l2g, sysm.local_valid
        rk = ops.h0_gather2d(p, l2g, valid, d)
        rr = dd2d.h0_gather2d_ref(p, l2g, valid, d)
        z = sysm.solve_local(L, rr).contiguous()
        avg = (z, d, sysm.gath_perm, sysm.gath_segids, sysm.gath_off,
               sysm.dup)
        ak, ar = ops.h0_average2d(*avg), dd2d.h0_average2d_ref(*avg)
        i = 1
        gk = ops.local_gather_one2d(p, l2g, valid, d, i)
        gr = dd2d.local_gather_one2d_ref(p, l2g, valid, d, i)
        zi = z[i].contiguous()
        sk = ops.local_scatter_one2d(zi, d, l2g, valid, i, nv)
        sr = dd2d.local_scatter_one2d_ref(zi, d, l2g, valid, i, nv)
        local = torch.zeros(nv, dtype=torch.bool, device="cuda")
        local[l2g[i][valid[i]]] = True
        outside = float(sk[~local].abs().max())
        res["h0_gather2d"] = [("r", _rel_max(rk, rr), tol["elem"],
                               float((rk - rr).abs().max()))]
        res["h0_average2d"] = [
            ("p", _rel_max(ak, ar), tol["elem"], float((ak - ar).abs().max())),
            ("|z|", float(ak[:, 2].abs().max()), 0.0, None)]
        res["local_gather_one2d"] = [("r_i", _rel_max(gk, gr), tol["elem"],
                                      float((gk - gr).abs().max()))]
        res["local_scatter_one2d"] = [
            ("p_i", _rel_max(sk, sr), tol["elem"],
             float((sk - sr).abs().max())),
            ("|p| off subdomain 1", outside, 0.0, None)]
        p_l = (z / d).reshape(-1, 2)[sysm.gath_perm]
        acc = torch.zeros((nv + 1, 2), dtype=dtype, device="cuda")
        times["h0_gather2d"] = (
            lambda: ops.h0_gather2d(p, l2g, valid, d),
            lambda: dd2d.h0_gather2d_ref(p, l2g, valid, d), None)
        times["h0_average2d"] = (
            lambda: ops.h0_average2d(*avg),
            lambda: dd2d.h0_average2d_ref(*avg),
            lambda: acc.index_add_(0, sysm.gath_segids, p_l))
        times["local_gather_one2d"] = (
            lambda: ops.local_gather_one2d(p, l2g, valid, d, i),
            lambda: dd2d.local_gather_one2d_ref(p, l2g, valid, d, i), None)
        times["local_scatter_one2d"] = (
            lambda: ops.local_scatter_one2d(zi, d, l2g, valid, i, nv),
            lambda: dd2d.local_scatter_one2d_ref(zi, d, l2g, valid, i, nv),
            None)
        PN = P * N
        costs["h0_gather2d"] = ((2 * PN + 2 * PN + 2 * PN) * sz + 9 * PN,
                                4 * PN)
        costs["h0_average2d"] = ((4 * PN + nv + 3 * nv) * sz + 8 * PN
                                 + 8 * (nv + 2), 2 * PN + 2 * nv)
        costs["local_gather_one2d"] = (6 * N * sz + 9 * N, 4 * N)
        costs["local_scatter_one2d"] = ((4 * N + 3 * nv) * sz + 9 * N, 2 * N)

        # ---- K32: the apply's forward and backward substitution on the
        # factor (f32: its error against an f64 solve of the same factor,
        # over the library pair's; f64: against the pair), bit for bit
        # from run to run and in subdomain i's slice L[i:i + 1]; its bound
        # as dense_solve_roofline counts it (the lower triangles read once)
        lib = dd2d.tri_solve_ref(L, rr)
        if dtype == torch.float32:
            z64 = dd2d.tri_solve_ref(L.double(), rr.double())
            e_k, e_lib = _rel_norm(z.double(), z64), _rel_norm(lib.double(),
                                                               z64)
            k32_err = ("error vs an f64 solve of the factor, over the "
                       f"library pair's ({e_k:.3e} / {e_lib:.3e})",
                       e_k / e_lib, 2.0, float((z - lib).abs().max()))
            del z64
        else:
            k32_err = ("vs plain (the library pair)", _rel_norm(z, lib),
                       tol["sum"], float((z - lib).abs().max()))
        same = torch.equal(z, sysm.solve_local(L, rr))
        same_i = torch.equal(sysm.solve_local(L[i:i + 1], rr[i:i + 1])[0],
                             z[i])
        res["tri_solve"] = [
            k32_err, ("run to run (bit for bit)", 0.0 if same else 1.0, 0.0,
                  None),
            (f"slice L[{i}:{i + 1}] vs its row of the batch (bit for bit)",
             0.0 if same_i else 1.0, 0.0, None)]
        times["tri_solve"] = (lambda: sysm.solve_local(L, rr),
                              lambda: dd2d.tri_solve_ref(L, rr),
                              lambda: dd2d.tri_solve_ref(L, rr))
        entries = P * n2p * (n2p + 1) / 2
        costs["tri_solve"] = (entries * sz + 2 * P * n2p * sz, 4 * entries)
        per_call["tri_solve"] = _work_check(
            name, "tri_solve", lambda: sysm.solve_local(L, rr), 1,
            ("tri_solve",), bad)
        del lib

        # ---- K28: the (nV)^2 PD matrix and the Hessian diagonal
        w = sysm.scalar(sysm.dt_sq) * sysm.vol_w * (2.0 * sysm.u_e
                                                    + sysm.lam_e)
        ptab = dd2d.pd_tables(mesh.conn, nv, "cuda")
        fv = torch.logical_not(fixed).to(dtype)
        Pk, pk = ops.pd_assemble2d(g4, w, fv, mass, ptab)
        Pr, pr = dd2d.pd_assemble2d_ref(g4, w, fv, mass, ptab)
        res["pd_assemble2d"] = [
            ("S", _rel_max(Pk, Pr), tol["elem"], float((Pk - Pr).abs().max())),
            ("d", _rel_max(pk, pr), tol["elem"], None),
            ("|S - S^T|", float((Pk - Pk.t()).abs().max()), 0.0, None)]
        del Pk, Pr
        hk = ops.hessian_diag2d(eh, mass, sysm.scatter_plan)
        hr = dd2d.hessian_diag2d_ref(eh, mass, sysm.scatter_plan)
        res["hessian_diag2d"] = [
            ("diag", _rel_max(hk, hr), tol["elem"],
             float((hk - hr).abs().max())),
            ("|z - 1|", float((hk[:, 2] - 1).abs().max()), 0.0, None)]
        pvals = dd2d.pd_pair_vals2d(g4, w).reshape(-1)[ptab.src]
        dvals = eh[torch.arange(6, device="cuda") * 7].t().reshape(-1)
        dacc = torch.zeros(2 * nv, dtype=dtype, device="cuda")
        times["pd_assemble2d"] = (
            lambda: ops.pd_assemble2d(g4, w, fv, mass, ptab),
            lambda: dd2d.pd_assemble2d_ref(g4, w, fv, mass, ptab),
            lambda: torch.zeros(nv * nv, dtype=dtype, device="cuda")
            .index_add_(0, ptab.dest, pvals))
        times["hessian_diag2d"] = (
            lambda: ops.hessian_diag2d(eh, mass, sysm.scatter_plan),
            lambda: dd2d.hessian_diag2d_ref(eh, mass, sysm.scatter_plan),
            lambda: dacc.index_add_(0, sysm.scatter_plan.gdest, dvals))
        p_slot, p_item = ptab.udest.shape[0], ptab.items.shape[0]
        costs["pd_assemble2d"] = (
            (4 * n + n + 2 * nv + nv * nv + nv) * sz
            + 4 * (p_item + 2 * p_slot + nv + 2), 45 * n + p_item + 4 * p_slot)
        _one_pass_check(torch, "pd_assemble2d", times["pd_assemble2d"][0],
                        name, bad, per_call)
        costs["hessian_diag2d"] = ((6 * n + nv + 3 * nv) * sz + 8 * 3 * n
                                   + 8 * (nv + 1), 6 * n + 2 * nv)
        torch.cuda.synchronize()
        for kname, checks in res.items():
            _report(torch, name, kname, checks, times[kname], costs[kname],
                    bad, record, plain_reps=5)
            if name == "float32" and kname in per_call:
                record[kname]["launches_per_call"] = per_call[kname]
            if kname in ("subdomain_assemble2d", "pd_assemble2d",
                         "tri_solve", "dense_chol"):
                _back_to_back(torch, name, kname, times[kname], record)
        say(f"kernels: {name} 2D decomposed shapes: spikes resolution "
            f"{SPIKES_FULL}, plan {t_plan:.2f} s: P {P}, n2p {n2p} "
            f"({P * n2p * n2p * sz / 1e9:.3f} GB of subdomain matrices), "
            f"{n_slot} assembled slots from {n_item} entries; the PD matrix "
            f"{nv}^2 ({nv * nv * sz / 1e9:.3f} GB), {p_slot} slots")
        del vals, pvals, eh, sysm, Hs, times
        torch.cuda.empty_cache()
    if bad:
        raise Fail("kernel disagrees with its plain version: "
                   + "; ".join(bad))


def phase_k34_kernel(torch, record):
    """K34 (f32) at the two P = 1 shapes of the 2D path: the spikes Newton
    matrix at the scene's start (n 20,342: System2D.factorize's, K34's
    own) and the scaled 2D PD matrix (n 10,171: build_pd_factor's, which
    stays on K33): its error against an f64 factor of the same matrix
    over the library's (tol 1), bit for bit run to run, exact zeros above
    the diagonal, the flag clear, one device kernel a call; timed single
    and back to back beside its plain version (K33's on the batch of one:
    the library Cholesky and its NaN passes), cholesky_ex alone (the
    library yardstick, never called by the port) and its bound (n^3 / 3
    at the f32 rate)."""
    from dot_tpu_torch import dim2, scripts
    from dot_tpu_torch.config import Config
    from dot_tpu_torch.kernels import dd2d, ops
    cfg = Config(energy="FCR", time_stepper="Newton", shape="spikes",
                 resolution=SPIKES_FULL, ym=1e5, pr=0.4, rho=1000.0,
                 handle_ratio=0.03, dt=0.025, script="stretch")
    mesh = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(mesh, cfg.script)
    mesh.fixed_mask = sd.fixed0.copy()
    sysm = dim2.System2D(mesh, cfg, dtype=torch.float32, device="cuda",
                         whole_mesh=True)
    x = torch.as_tensor(sd.x0, dtype=torch.float32, device="cuda")
    fixed = torch.as_tensor(sd.fixed0, device="cuda")
    H, d = ops.dense_assemble2d(sysm.element_hessians(x), sysm._free(fixed),
                                sysm.mass, sysm.dense_tab)
    mats = {"whole_chol": ops.dense_scale2d(H, d, sysm.dense_tab)}
    del H, d
    w = sysm.scalar(sysm.dt_sq) * sysm.vol_w * (2.0 * sysm.u_e + sysm.lam_e)
    ptab = dd2d.pd_tables(mesh.conn, mesh.n_vert, "cuda")
    S, d = ops.pd_assemble2d(sysm.g4, w, sysm._free(fixed), sysm.mass, ptab)
    mats["whole_chol@pd10171"] = ops.subdomain_scale2d(S[None], d[None],
                                                       ptab)[0]
    del S, d, sysm
    torch.cuda.empty_cache()
    bad = []
    for kname, A in mats.items():
        n = A.shape[0]
        L, flag = ops.whole_chol(A)
        lib, _ = dd2d.whole_chol_ref(A)
        L64, _ = dd2d.whole_chol_ref(A.double())
        e_k, e_lib = _rel_norm(L.double(), L64), _rel_norm(lib.double(), L64)
        del L64
        checks = [
            ("error vs an f64 factor, over the library's "
             f"({e_k:.3e} / {e_lib:.3e})", e_k / e_lib, 1.0,
             float((L - lib).abs().max())),
            ("run to run (bit for bit)",
             0.0 if torch.equal(L, ops.whole_chol(A)[0]) else 1.0, 0.0, None),
            ("|triu(L, 1)|", float(torch.triu(L, 1).abs().max()), 0.0, None),
            ("flag", 1.0 if bool(flag) else 0.0, 0.0, None)]
        del L, lib
        fns = (lambda: ops.whole_chol(A), lambda: dd2d.whole_chol_ref(A),
               lambda: torch.linalg.cholesky_ex(A))
        cost = ((n * n + n * (n + 1) / 2) * 4, n ** 3 / 3)
        n_dev = _work_check("float32", kname, fns[0], 1, ("whole_chol",),
                            bad)
        _report(torch, "float32", kname, checks, fns, cost, bad, record,
                plain_reps=5)
        _back_to_back(torch, "float32", kname, fns, record)
        record[kname]["launches_per_call"] = n_dev
        say(f"kernels: float32 {kname}: n {n}, "
            f"{100.0 * record[kname]['bound_ms'] / record[kname]['ms']:.1f} "
            f"% of the f32 peak")
    del mats, A, fns
    torch.cuda.empty_cache()
    if bad:
        raise Fail("K34 disagrees with its plain version: " + "; ".join(bad))


def _dd2d_split(sim, frames):
    """ms/frame of the parts of a DOT 2D frame over `frames` more frames,
    each call wrapped in synchronised host timers: the H0 rebuild (K23,
    K26 and K33's Cholesky), the H0 apply (K27 and K32's
    solves), K25, the line-search trials (K21) and the gradient (K22)."""
    import collections
    import torch
    acc = collections.Counter()
    sysm = sim.system
    names = ("rebuild_h0", "element_hessians", "assemble_subdomains",
             "factorize_fast", "h0_apply", "solve_local", "quadratic_form",
             "elastic_energy", "gradient")
    for name in names:
        wrap_timed(sysm, name, acc)
    from dot_tpu_torch.kernels import ops
    chol = wrap_timed(None, "dense_chol", acc, module=ops, label="cholesky")
    try:
        sim.run(frames)
    finally:
        ops.dense_chol = chol
        for name in names:
            delattr(sysm, name)
    return {k: acc[k] / frames * 1e3 for k in names + ("cholesky",)}


def _dd2d_launch_problems(tag, sysm, launches, fr):
    """The launches each run of the dim2dd path must show: K25 once a DOT
    iteration; K26 once a rebuild (the initial state + once a frame); K27's
    gather and averaging once an H0 apply (one an iteration), GSDD's
    one-subdomain pair P times a sweep, K32 once with each; K28 once a run
    (LBFGS-PD); K33 once a factorization (LBFGS-PD's one; once a rebuild,
    twice where the 1e-4 tier refactors: from once to twice a rebuild)."""
    iters = sum(r["iters"] for r in fr)
    rebuilds = len(fr) + 1
    k = launches
    want = dict.fromkeys(DD2D_KERNELS, 0)
    if tag == "LBFGS":
        want.update(pd_assemble2d=1, subdomain_scale2d=1, dense_chol=1)
    else:
        refactors = k["dense_chol"] - rebuilds
        want.update(subdomain_assemble2d=rebuilds, subdomain_scale2d=rebuilds,
                    dense_chol=rebuilds + min(max(refactors, 0), rebuilds))
        if tag == "GSDD4":
            want.update(local_gather_one2d=sysm.n_parts * iters,
                        local_scatter_one2d=sysm.n_parts * iters,
                        tri_solve=sysm.n_parts * iters)
        else:
            want.update(h0_gather2d=iters, h0_average2d=iters,
                        tri_solve=iters)
        if tag == "DOT4":
            want.update(quadratic_form2d=iters)
    got = {name: k[name] for name in DD2D_KERNELS}
    return [] if got == want else [f"{tag}: launches {got}, want {want}"]


def phase_dim2dd(torch, launches_out):
    """The 2D decomposed path through Sim2D: the spikes golden under DOT 4
    (f64, kernels on), then the full-size scene under DOT 4 (the main run),
    GSDD 4, LBFGS, LBFGSH, LBFGSHI and LBFGSJH 4 in f32 (f64 with a printed
    finding where f32 misses relTol), each against its plain-path run and
    against 2D Newton's frames."""
    from dot_tpu_torch.kernels import ops
    tmp = tempfile.mkdtemp(prefix="dot_dim2dd_")
    try:
        out_root = os.path.join(tmp, "out")
        # ---- golden: DOT 4 at resolution 200, f64, kernels on
        ops.reset_launches()
        gold = _sim2d(torch, _spikes_scene(tmp, 200, "spikes200dot", "DOT 4"),
                      out_root, torch.float64)
        gold.run(len(GOLDEN_2D_SPIKES_SYS_E))
        g_launch = {k: ops.launches[k] for k in DD2D_KERNELS if
                    ops.launches[k]}
        gold.finalize()
        vals = np.asarray([r["sys_e"] for r in gold.frames])
        rel = np.abs(vals / np.asarray(GOLDEN_2D_SPIKES_SYS_E) - 1.0)
        z_max = float(gold.state.x[:, 2].abs().max())
        say(f"dim2dd: golden spikes 200 DOT 4 f64, kernels on: sysE "
            f"{['%.10e' % v for v in vals]}, max rel {rel.max():.3e} (tol "
            f"2e-4); iters {[r['iters'] for r in gold.frames]}, stops "
            f"{[r['stop'] for r in gold.frames]}; max |z| {z_max:g}; "
            f"launches {g_launch}")
        problems = _dd2d_launch_problems("DOT4", gold.system, ops.launches,
                                         gold.frames)
        if not rel.max() <= 2e-4:
            problems.append(f"golden sysE off by {rel.max():.3e}")
        if z_max != 0.0:
            problems.append(f"golden z moved: {z_max:g}")
        del gold
        if problems:
            raise Fail("dim2dd path: " + "; ".join(problems))

        # ---- 2D Newton's frames at full size: the yardstick
        n_max = 1 + max(v[1] for v in DIM2DD_RUNS.values())
        newton = _sim2d(torch, _spikes_scene(tmp, SPIKES_FULL, "newton"),
                        out_root, torch.float32, save_every=10 ** 9)
        newton.run(n_max)
        newton.finalize()
        e_newton = np.asarray([r["sys_e"] for r in newton.frames])
        say(f"dim2dd: Newton f32 yardstick: iters "
            f"{[r['iters'] for r in newton.frames]}, sysE "
            + " ".join("%.10e" % v for v in e_newton))
        del newton
        torch.cuda.empty_cache()

        total = dict.fromkeys(ops.KERNELS, 0)
        for tag, (stepper, frames, e_tol) in DIM2DD_RUNS.items():
            scene = _spikes_scene(tmp, SPIKES_FULL, tag, stepper)
            for dtype in (torch.float32, torch.float64):
                name = str(dtype).split(".")[-1]
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launches()
                t0 = time.perf_counter()
                sim = _sim2d(torch, scene, out_root, dtype,
                             suffix=f"{tag}_{name}", save_every=10 ** 9)
                t1 = time.perf_counter()
                sim.run(1 + frames)
                launches = dict(ops.launches)
                peak = torch.cuda.max_memory_allocated()
                fr = list(sim.frames)
                ok = all(np.isfinite(r["sys_e"])
                         and r["stop"] in ("tol", "rel_dec") for r in fr)
                if ok or dtype == torch.float64:
                    break
                say(f"dim2dd: FINDING: {tag} {name} does not reach relTol "
                    f"1e-5 at this size (stops {[r['stop'] for r in fr]}); "
                    "the run repeats in float64")
                sim.finalize()
                del sim
            for k, v in launches.items():
                total[k] += v
            sysm = sim.system
            timed = fr[1:]
            n2p = sysm.n3 if sysm.plan is not None else sysm.n_vert
            what = "sweeps" if tag == "GSDD4" else "iters"
            say(f"dim2dd: {tag} {name}: {type(sim.stepper).__name__}, P "
                f"{sysm.n_parts}, n2p {n2p}, factor "
                f"{str(sim.state.chol.dtype).split('.')[-1]} "
                f"{tuple(sim.state.chol.shape)}; Sim2D {t1 - t0:.2f} s; "
                f"s/frame {np.mean([r['seconds'] for r in timed]):.5f} "
                f"({frames} timed frames after 1 warm-up of "
                f"{fr[0]['seconds']:.3f} s); {what}/frame "
                f"{np.mean([r['iters'] for r in timed]):.2f}; LS "
                f"halvings/frame {np.mean([r['halvings'] for r in timed]):.2f};"
                f" syncs/frame {np.mean([r['syncs'] for r in timed]):.2f}; "
                f"peak {peak / 2**20:.1f} MiB")
            say(f"dim2dd: {tag}: per frame ({what}, halvings, syncs, stop, s): "
                + "; ".join(f"{r['iters']},{r['halvings']},{r['syncs']},"
                            f"{r['stop']},{r['seconds']:.3f}" for r in fr))
            n_fr = len(fr)
            say(f"dim2dd: {tag}: launches per frame "
                + ", ".join(f"{k} {launches[k] / n_fr:.2f}"
                            for k in DD2D_KERNELS if launches[k])
                + f"; all { {k: v for k, v in launches.items() if v} }")
            problems = _dd2d_launch_problems(tag, sysm, launches, fr)
            if not ok:
                problems.append(f"{tag}: a frame is not finite or stopped by "
                                f"{[r['stop'] for r in fr]}")
            z_max = float(sim.state.x[:, 2].abs().max())
            if z_max != 0.0:
                problems.append(f"{tag}: z moved: {z_max:g}")
            if tag == "LBFGSHI" and sysm._solve_dtype != torch.float32:
                problems.append(f"LBFGSHI: factor dtype {sysm._solve_dtype}")
            if tag == "DOT4":
                s = _dd2d_split(sim, 2)
                more = sim.frames[n_fr:]
                it2 = max(sum(r["iters"] for r in more), 1) / 2
                say(f"dim2dd: DOT4 synchronised split over 2 more frames "
                    f"(iters {[r['iters'] for r in more]}), ms/frame: "
                    f"rebuild {s['rebuild_h0']:.2f} (K23 "
                    f"{s['element_hessians']:.3f}, K26 assembly "
                    f"{s['assemble_subdomains']:.3f}, factorize_fast "
                    f"{s['factorize_fast']:.2f} of which Cholesky "
                    f"{s['cholesky']:.2f}); apply {s['h0_apply']:.2f} (solves "
                    f"{s['solve_local']:.2f}, K27 "
                    f"{s['h0_apply'] - s['solve_local']:.3f}); K25 "
                    f"{s['quadratic_form']:.3f}; line search (K21) "
                    f"{s['elastic_energy']:.2f}; gradient (K22) "
                    f"{s['gradient']:.2f}; per iteration: apply "
                    f"{s['h0_apply'] / it2:.3f}, K25 "
                    f"{s['quadratic_form'] / it2:.3f}")
            sim.finalize()
            a = np.asarray([r["sys_e"] for r in fr])
            rel_n = np.abs(a / e_newton[:len(a)] - 1.0).max()
            del sim, sysm
            torch.cuda.empty_cache()

            ref = _sim2d(torch, scene, out_root, dtype, suffix=f"{tag}_plain",
                         use_kernels=False, save_every=10 ** 9)
            ref.run(len(fr))
            ref.finalize()
            b = np.asarray([r["sys_e"] for r in ref.frames])
            rel = np.abs(a / b - 1.0).max()
            say(f"dim2dd: {tag}: sysE " + " ".join("%.10e" % v for v in a)
                + f"; vs plain path max rel {rel:.3e} (tol 1e-3; plain "
                f"{what} {[r['iters'] for r in ref.frames]}, s/frame "
                f"{np.mean([r['seconds'] for r in ref.frames[1:]]):.5f}); vs "
                f"Newton max rel {rel_n:.3e} (tol {e_tol:g})")
            if not rel <= 1e-3:
                problems.append(f"{tag}: kernel and plain paths disagree: "
                                f"{rel:.3e}")
            if not rel_n <= e_tol:
                problems.append(f"{tag}: sysE off Newton's by {rel_n:.3e}")
            del ref
            torch.cuda.empty_cache()
            if problems:
                raise Fail("dim2dd path: " + "; ".join(problems))
        launches_out["dim2dd"] = total
        missing = [k for k in DD2D_KERNELS if total[k] <= 0]
        if missing:
            raise Fail(f"dim2dd path: kernels never launched: {missing}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _local_step_inputs2(torch, n, dtype, rng):
    """(Dx, u4), each (4, n) on the card: a third random deformation
    gradients around the identity (any sign of det), a third inverted near
    the identity, a third near rank 1; duals a tenth of that size."""
    third = n // 3
    f = np.empty((4, n))
    f[:, :third] = np.eye(2).reshape(4, 1) + 0.5 * rng.normal(size=(4, third))
    inv = np.eye(2).reshape(4, 1) + 0.1 * rng.normal(size=(4, third))
    inv[[0, 2]] *= -1.0
    f[:, third:2 * third] = inv
    m = n - 2 * third
    uv = rng.normal(size=(2, m))[:, None] * rng.normal(size=(2, m))[None]
    f[:, 2 * third:] = uv.reshape(4, m) + 1e-3 * rng.normal(size=(4, m))
    u = 0.1 * rng.normal(size=(4, n))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")
    return t(f), t(u)


def phase_admm2d_kernels(torch, record):
    """K29, K30 and the ADMM-DD entries of K21 / K22 / K26 against their
    plain versions at the dim2admm path's full-size shapes (spikes at
    resolution 20,000; ADMM-DD's tables on its 4-part element plan), f64
    and f32."""
    from dot_tpu_torch import dim2, plan2d, scripts
    from dot_tpu_torch.config import Config
    from dot_tpu_torch.kernels import admm2d, dd2d, ops, soa2d
    rng = np.random.default_rng(20261021)
    cfg = Config(energy="FCR", time_stepper="ADMMDD", shape="spikes",
                 resolution=SPIKES_FULL, ym=1e5, pr=0.4, rho=1000.0,
                 handle_ratio=0.03, dt=0.025, script="stretch",
                 partition_amt=DD2D_PARTS)
    mesh = dim2.Mesh2D.from_config(cfg)
    sd = scripts.init_script(mesh, cfg.script)
    mesh.fixed_mask = sd.fixed0.copy()
    plan = plan2d.build_plan_2d(mesh, DD2D_PARTS)
    n, nv = mesh.n_elem, mesh.n_vert
    h = float(np.sqrt(mesh.area.mean()))
    x0 = np.asarray(sd.x0, np.float64).copy()
    x0[:, :2] += rng.normal(scale=0.3 * h, size=(nv, 2))
    bad = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        tol, tols = TOL[name], TOL_SCALE[name]
        sz = torch.finfo(dtype).bits // 8
        res, times, costs, per_call = {}, {}, {}, {}

        def t(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device="cuda")
        x = t(x0)
        fixed = torch.as_tensor(sd.fixed0, device="cuda")

        # ---- K29 and K30 on the ADMM-PD system (no plan)
        pdsys = dim2.System2D(mesh, cfg, dtype=dtype, device="cuda")
        pst = dim2.ADMMPD2D(pdsys, sd)
        Dx, u4 = _local_step_inputs2(torch, n, dtype, rng)
        l_args = (Dx, u4, pst.w_e, pst.vol_dtsq, pdsys.u_e, pdsys.lam_e,
                  pdsys.mat)
        zk, duk, ck = ops.admm_local_step2d(*l_args, want_counts=True)
        zr, dur, cr = admm2d.admm_local_step2d_ref(*l_args, want_counts=True)
        # a triangle whose stop test falls the other way for one ulp of the
        # device library's angles takes another Newton iteration: z and du
        # are held where the loop counts agree, the share of the others is
        # bounded
        same = (ck == cr).all(dim=0)
        n_diff = int((~same).sum())
        its, evs = int(ck[0].sum()), int(ck[1].sum())
        res["admm_local_step2d"] = [
            ("z", _rel_max(zk[:, same], zr[:, same]), tol["elem"],
             float((zk[:, same] - zr[:, same]).abs().max())),
            ("du", _rel_max(duk[:, same], dur[:, same]), tol["elem"],
             float((duk[:, same] - dur[:, same]).abs().max())),
            (f"share of triangles whose loop counts differ ({n_diff})",
             n_diff / n, 1e-3, None)]
        say(f"kernels: {name} admm_local_step2d: Newton iterations per "
            f"triangle mean {its / n:.2f} max {int(ck[0].max())}, energy "
            f"evaluations mean {evs / n:.2f} max {int(ck[1].max())}")
        times["admm_local_step2d"] = (
            lambda: ops.admm_local_step2d(*l_args),
            lambda: admm2d.admm_local_step2d_ref(*l_args), None)
        costs["admm_local_step2d"] = (
            20 * n * sz, K29_FLOPS["svd"] * n + K29_FLOPS["newton"] * its
            + K29_FLOPS["energy"] * evs)
        del zk, zr, duk, dur

        M4 = t(rng.normal(size=(4, n)))
        base = t(np.concatenate([rng.normal(size=(nv, 2)),
                                 np.zeros((nv, 1))], axis=1))
        off = t(np.concatenate([rng.normal(size=(nv, 2)),
                                np.zeros((nv, 1))], axis=1))
        free_v = torch.logical_not(fixed).to(dtype)
        s_args = (M4, pdsys.g4, pst.w_e, pdsys.scatter_plan, x)
        ak = ops.dtw_scatter2d(*s_args, mass=pdsys.mass)
        ar = admm2d.dtw_scatter2d_ref(*s_args, mass=pdsys.mass)
        rk = ops.dtw_scatter2d(*s_args, base=base, offset=off, free=free_v)
        rr = admm2d.dtw_scatter2d_ref(*s_args, base=base, offset=off,
                                      free=free_v)
        res["dtw_scatter2d"] = [
            ("A x", _rel_max(ak, ar), tols["elem"],
             float((ak - ar).abs().max())),
            ("rhs", _rel_max(rk, rr), tols["elem"],
             float((rk - rr).abs().max())),
            ("|z|", float(ak[:, 2].abs().max()) + float(rk[:, 2].abs().max()),
             0.0, None)]
        corner = torch.randn(6 * n, dtype=dtype, device="cuda")
        acc30 = torch.zeros(2 * nv, dtype=dtype, device="cuda")
        gdest = pdsys.scatter_plan.gdest
        times["dtw_scatter2d"] = (
            lambda: ops.dtw_scatter2d(*s_args, base=base, offset=off,
                                      free=free_v),
            lambda: admm2d.dtw_scatter2d_ref(*s_args, base=base, offset=off,
                                             free=free_v),
            lambda: acc30.index_add_(0, gdest, corner))
        costs["dtw_scatter2d"] = ((9 * n + 13 * nv) * sz
                                  + 8 * (3 * n + nv + 1), 14 * 3 * n)
        del pdsys, pst

        # ---- the ADMM-DD entries on its 4-part tables
        sysm = dim2.System2D(mesh, cfg, dtype=dtype, device="cuda", plan=plan)
        dd = dim2.ADMMDD2D(sysm, sd)
        P, N, n2p = dd.P, dd.N, dd.n2p
        nl = P * dd.epad
        valid = sysm.local_valid[..., None]
        free = dd._free(fixed)
        xl_flat = dd._to_flat(x[sysm.l2g][:, :, :2] * valid)
        F0 = dd._local_defgrad(xl_flat)
        Fp = dd._local_defgrad(dd._to_flat(
            t(0.01 * h * rng.normal(size=(P, N, 2))) * valid))
        alpha = t([1.0, 0.5, 0.25, 0.125][:P] + [1.0] * max(P - 4, 0))
        e_args = (F0, Fp, alpha, dd.lu, dd.llam, dd.lw, sysm.mat, P)
        ek = ops.ls_trial_energy2d_parts(*e_args)
        er = admm2d.ls_trial_energy2d_parts_ref(*e_args)
        e0k = ops.ls_trial_energy2d_parts(F0, None, None, *e_args[3:])
        e0r = admm2d.ls_trial_energy2d_parts_ref(F0, None, None, *e_args[3:])
        res["ls_trial_energy2d_parts"] = [
            ("per slab", float(((ek - er).abs() / er.abs()).max()),
             tol["elem"], float((ek - er).abs().max())),
            ("per slab, no direction",
             float(((e0k - e0r).abs() / e0r.abs()).max()), tol["elem"],
             None)]
        times["ls_trial_energy2d_parts"] = (
            lambda: ops.ls_trial_energy2d_parts(*e_args),
            lambda: admm2d.ls_trial_energy2d_parts_ref(*e_args), None)
        costs["ls_trial_energy2d_parts"] = (
            (11 * nl + 2 * P) * sz, ELEM2D_FLOPS["ls_trial_energy2d"] * nl)

        g_args = (F0, dd.conn_local, dd.lg4, dd.lu, dd.llam, dd.lw, sysm.mat,
                  dd.rows)
        gk = ops.elem_gradient2d_from_F(*g_args)
        gr = admm2d.elem_gradient2d_from_F_ref(*g_args)
        res["elem_gradient2d_from_F"] = [
            ("grad", _rel_norm(gk, gr), tol["grad"],
             float((gk - gr).abs().max()))]
        forces = torch.randn((3 * nl, 2), dtype=dtype, device="cuda")
        lidx = dd.conn_local.t().reshape(-1).long()
        accg = torch.zeros((P * N + 1, 2), dtype=dtype, device="cuda")
        times["elem_gradient2d_from_F"] = (
            lambda: ops.elem_gradient2d_from_F(*g_args),
            lambda: admm2d.elem_gradient2d_from_F_ref(*g_args),
            lambda: accg.index_add_(0, lidx, forces))
        costs["elem_gradient2d_from_F"] = (
            (15 * nl + 2 * P * N) * sz + 8 * (3 * nl + P * N + 1),
            ELEM2D_FLOPS["elem_gradient2d"] * nl)

        eh = soa2d.elem_hessian2d_ref(x, sysm.conn, sysm.g4, sysm.u_e,
                                      sysm.lam_e, sysm.vol_w, sysm.mat,
                                      sysm.dt_sq)
        sfree = torch.cat([torch.logical_not(fixed[dd.shared_ids]).to(dtype),
                           torch.zeros(1, dtype=dtype, device="cuda")])
        w_args = (eh, free, sfree, dd.md_sh, dd.w_tab, dd.c_tab)
        Wk, Ck, dck = ops.w_assemble2d(*w_args)
        Wr, Cr, dcr = admm2d.w_assemble2d_ref(*w_args)
        res["w_assemble2d"] = [
            ("Wm", _rel_max(Wk, Wr), tols["elem"],
             float((Wk - Wr).abs().max())),
            ("C", _rel_max(Ck, Cr), tols["elem"], None),
            ("dc", _rel_max(dck, dcr), tols["elem"], None),
            ("|W - W^T| + |C - C^T|", float((Wk - Wk.mT).abs().max())
             + float((Ck - Ck.mT).abs().max()), 0.0, None)]
        wt, ct = dd.w_tab, dd.c_tab
        wvals = eh.reshape(-1)[wt.src]
        times["w_assemble2d"] = (
            lambda: ops.w_assemble2d(*w_args),
            lambda: admm2d.w_assemble2d_ref(*w_args),
            lambda: torch.zeros(P * n2p * n2p, dtype=dtype, device="cuda")
            .index_add_(0, wt.dest, wvals))
        w_item, w_slot = wt.items.shape[0], wt.udest.shape[0]
        c_slot, nc = ct.udest.shape[0], ct.n
        # the int32 row tables of W and C (items, seg_off, row_off, col)
        costs["w_assemble2d"] = (
            (36 * n + P * N + P * n2p * n2p + 3 * nc + nc * nc + nc) * sz
            + 4 * (2 * w_item + 2 * w_slot + 2 * c_slot + P * n2p + nc
                   + 4), 2 * w_item + 4 * (w_slot + c_slot))
        _one_pass_check(torch, "w_assemble2d", times["w_assemble2d"][0],
                        name, bad, per_call)
        del Ck, Cr, Wr

        ehl = soa2d.elem_hessian2d_ref(xl_flat, dd.conn_local, dd.lg4, dd.lu,
                                       dd.llam, dd.lw, sysm.mat, sysm.dt_sq)
        mass = dd.mass_local + dd.mass_dif * free
        o = dd.own_tab
        # the kernel's W, as on the path: its slot sums are ordered, so it
        # is symmetric bit for bit (the plain one's atomic index_add_ on
        # the card need not be in f32)
        h_args = (ehl, Wk, free, mass, o)
        Hk, dk = ops.local_h_assemble2d(*h_args)
        Hr, dr = admm2d.local_h_assemble2d_ref(*h_args)
        Sk = ops.subdomain_scale2d(Hk.clone(), dk, o)
        Sr = dd2d.subdomain_scale2d_ref(Hr, dr, o)
        res["local_h_assemble2d"] = [
            ("H", _rel_max(Hk, Hr), tols["elem"],
             float((Hk - Hr).abs().max())),
            ("d", _rel_max(dk, dr), tols["elem"], None),
            ("|H - H^T|", float((Hk - Hk.mT).abs().max()), 0.0, None),
            ("K26's scaling over the union slots", _rel_max(Sk, Sr),
             tols["elem"], None)]
        del Sk, Sr, Hr
        torch.cuda.empty_cache()
        hvals = ehl.reshape(-1)[o.src]
        times["local_h_assemble2d"] = (
            lambda: ops.local_h_assemble2d(*h_args),
            lambda: admm2d.local_h_assemble2d_ref(*h_args),
            lambda: torch.zeros(P * n2p * n2p, dtype=dtype, device="cuda")
            .index_add_(0, o.dest, hvals))
        o_item, o_slot = o.items.shape[0], o.udest.shape[0]
        costs["local_h_assemble2d"] = (
            (36 * nl + 2 * P * N + o_slot + P * n2p * n2p + P * n2p) * sz
            + 4 * (o_item + 2 * o_slot + P * n2p + 2), o_item + 6 * o_slot)
        _one_pass_check(torch, "local_h_assemble2d",
                        times["local_h_assemble2d"][0], name, bad, per_call)
        torch.cuda.synchronize()
        for kname, checks in res.items():
            _report(torch, name, kname, checks, times[kname], costs[kname],
                    bad, record,
                    plain_reps=2 if kname == "admm_local_step2d" else 5)
            if name == "float32" and kname in per_call:
                record[kname]["launches_per_call"] = per_call[kname]
            if kname in ("w_assemble2d", "local_h_assemble2d"):
                _back_to_back(torch, name, kname, times[kname], record)
        say(f"kernels: {name} 2D ADMM shapes: K29 / K30 on {n} triangles and "
            f"{nv} vertices; ADMM-DD P {P}, n2p {n2p}, slabs {P} x "
            f"{dd.epad}, {dd.n_shared} shared vertices (C {nc}^2); W "
            f"{w_item} entries in {w_slot} slots; local Hessian {o_item} "
            f"entries in {o_slot} slots (own and W)")
        del sysm, dd, eh, ehl, Wk, Hk, times, wvals, hvals
        torch.cuda.empty_cache()
    if bad:
        raise Fail("kernel disagrees with its plain version: "
                   + "; ".join(bad))


def _admm2d_launch_problems(tag, launches, fr):
    """The launches each run of the dim2admm path must show: ADMM-PD K29
    once an iteration and K30 once an iteration and once a frame (the
    Dirichlet offsets); ADMM-DD w_assemble2d once a frame, the local
    Hessian once a frame and every 20th iteration, K22 from F once an
    iteration and once a frame (initDual), K21 per slab at least twice an
    iteration (e0 and the first trial)."""
    iters = sum(r["iters"] for r in fr)
    nf = len(fr)
    got = {k: launches[k] for k in ADMM2D_KERNELS}
    want = dict.fromkeys(ADMM2D_KERNELS, 0)
    if tag == "ADMM":
        want.update(admm_local_step2d=iters, dtw_scatter2d=iters + nf)
    else:
        want.update(
            w_assemble2d=nf, elem_gradient2d_from_F=iters + nf,
            local_h_assemble2d=sum(1 + (max(r["iters"], 1) - 1) // 20
                                   for r in fr),
            ls_trial_energy2d_parts=got["ls_trial_energy2d_parts"])
        if got["ls_trial_energy2d_parts"] < 2 * iters:
            return [f"{tag}: K21 per slab {got['ls_trial_energy2d_parts']} "
                    f"< 2 x {iters} iterations"]
    return [] if got == want else [f"{tag}: launches {got}, want {want}"]


def _admm2d_split(sim, tag):
    """ms/frame of the parts of one more frame of a 2D ADMM run, each call
    wrapped in synchronised host timers (nested spans are counted in their
    parents too): ADMM-PD's K29, K30, the PD solve, K22 and K21; ADMM-DD's
    weights (K23, K26's W / C entry, the consensus Cholesky), initDual,
    the local Hessian (K23, K26's entry and scaling, the batched
    Cholesky), the local solves, the local gradient (K22 from F + a W
    mat-vec), the W mat-vecs (bmm), the per-slab trials (K21), every
    library triangular solve and Cholesky, the global K22 and K21."""
    import collections
    import torch
    acc = collections.Counter()
    sysm, st = sim.system, sim.stepper
    if tag == "ADMM":
        own = ("_local_step", "_scatter")
        names = ("pd_solve", "gradient", "elastic_energy")
    else:
        own = ("weights", "init_dual", "local_h_factor", "_solve",
               "local_gradient", "_w_matvec", "slab_psi")
        names = ("gradient", "elastic_energy")
    for name in own:
        wrap_timed(st, name, acc)
    for name in names:
        wrap_timed(sysm, name, acc)
    lib = {k: wrap_timed(None, k, acc, module=torch.linalg)
           for k in ("cholesky_ex", "solve_triangular")}
    n0 = len(sim.frames)
    try:
        sim.run(1)
    finally:
        for k, fn in lib.items():
            setattr(torch.linalg, k, fn)
        for name in own:
            delattr(st, name)
        for name in names:
            delattr(sysm, name)
    r = sim.frames[n0]
    ms = {k: v * 1e3 for k, v in acc.items()}
    return r, ms


def phase_dim2admm(torch, launches_out, newton=None):
    """The 2D ADMM family through Sim2D: the spikes golden under ADMM and
    ADMMDD 4 (f64, kernels on), then the full-size scene under both in f32,
    each against its plain path's first frame and against 2D Newton's
    frames (`newton`: the dim2 phase's (sysE, dtype), else run here)."""
    from dot_tpu_torch.kernels import ops
    tmp = tempfile.mkdtemp(prefix="dot_dim2admm_")
    try:
        out_root = os.path.join(tmp, "out")
        problems = []
        # ---- goldens at resolution 200, f64, kernels on
        for tag, (stepper, _) in DIM2ADMM_RUNS.items():
            ops.reset_launches()
            gold = _sim2d(torch, _spikes_scene(tmp, 200, f"gold{tag}",
                                               stepper),
                          out_root, torch.float64)
            gold.run(len(GOLDEN_2D_SPIKES_SYS_E))
            g_launch = {k: ops.launches[k] for k in ADMM2D_KERNELS
                        if ops.launches[k]}
            gold.finalize()
            vals = np.asarray([r["sys_e"] for r in gold.frames])
            rel = np.abs(vals / np.asarray(GOLDEN_2D_SPIKES_SYS_E) - 1.0)
            z_max = float(gold.state.x[:, 2].abs().max())
            say(f"dim2admm: golden spikes 200 {tag} f64, kernels on: sysE "
                f"{['%.10e' % v for v in vals]}, max rel {rel.max():.3e} "
                f"(tol 2e-4); iters {[r['iters'] for r in gold.frames]}, "
                f"stops {[r['stop'] for r in gold.frames]}; max |z| "
                f"{z_max:g}; launches {g_launch}")
            problems += _admm2d_launch_problems(tag, ops.launches,
                                                gold.frames)
            if not rel.max() <= 2e-4:
                problems.append(f"golden {tag} sysE off by {rel.max():.3e}")
            if z_max != 0.0:
                problems.append(f"golden {tag} z moved: {z_max:g}")
            del gold
        if problems:
            raise Fail("dim2admm path: " + "; ".join(problems))

        # ---- 2D Newton's full-size frames: the yardstick
        n_max = 1 + max(v[1] for v in DIM2ADMM_RUNS.values())
        if newton is not None and len(newton[0]) >= n_max:
            e_newton = newton[0]
            say(f"dim2admm: Newton yardstick from the dim2 phase "
                f"({str(newton[1]).split('.')[-1]})")
        else:
            newton = _sim2d(torch, _spikes_scene(tmp, SPIKES_FULL, "newton"),
                            out_root, torch.float32, save_every=10 ** 9)
            newton.run(n_max)
            newton.finalize()
            e_newton = np.asarray([r["sys_e"] for r in newton.frames])
            del newton
            torch.cuda.empty_cache()
            say("dim2admm: Newton f32 yardstick: sysE "
                + " ".join("%.10e" % v for v in e_newton))

        total = dict.fromkeys(ops.KERNELS, 0)
        for tag, (stepper, frames) in DIM2ADMM_RUNS.items():
            scene = _spikes_scene(tmp, SPIKES_FULL, tag, stepper)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            sim = _sim2d(torch, scene, out_root, torch.float32,
                         suffix=tag, save_every=10 ** 9)
            t1 = time.perf_counter()
            sim.run(1 + frames)
            launches = dict(ops.launches)
            peak = torch.cuda.max_memory_allocated()
            for k, v in launches.items():
                total[k] += v
            fr, st = list(sim.frames), sim.stepper
            cap = st.max_iter if tag == "ADMM" else 1000
            timed = fr[1:]
            iters = sum(r["iters"] for r in fr)
            say(f"dim2admm: {tag} float32: {type(st).__name__}, "
                + (f"P {st.P}, n2p {st.n2p}, {st.n_shared} shared vertices; "
                   if tag != "ADMM" else "")
                + f"iteration cap {cap}; Sim2D {t1 - t0:.2f} s; s/frame "
                f"{np.mean([r['seconds'] for r in timed]):.5f} ({frames} "
                f"timed frames after 1 warm-up of {fr[0]['seconds']:.3f} s); "
                f"iters/frame {np.mean([r['iters'] for r in timed]):.2f}; "
                f"syncs/frame {np.mean([r['syncs'] for r in timed]):.2f}; "
                f"ms/iteration "
                f"{1e3 * sum(r['seconds'] for r in fr) / max(iters, 1):.3f};"
                f" peak {peak / 2**20:.1f} MiB")
            say(f"dim2admm: {tag}: per frame (iters, syncs, stop, s): "
                + "; ".join(f"{r['iters']},{r['syncs']},{r['stop']},"
                            f"{r['seconds']:.3f}" for r in fr))
            n_fr = len(fr)
            say(f"dim2admm: {tag}: launches per frame "
                + ", ".join(f"{k} {launches[k] / n_fr:.2f}"
                            for k in ADMM2D_KERNELS if launches[k])
                + f"; all { {k: v for k, v in launches.items() if v} }")
            problems = _admm2d_launch_problems(tag, launches, fr)
            for r in fr:
                if not np.isfinite(r["sys_e"]):
                    problems.append(f"{tag} frame {r['frame']} sysE not "
                                    "finite")
                if r["stop"] not in ("tol", "iter_cap") or (
                        r["stop"] == "iter_cap" and r["iters"] != cap):
                    problems.append(f"{tag} frame {r['frame']} stopped by "
                                    f"{r['stop']} after {r['iters']}")
            z_max = float(sim.state.x[:, 2].abs().max())
            if z_max != 0.0:
                problems.append(f"{tag}: z moved: {z_max:g}")
            r_s, ms = _admm2d_split(sim, tag)
            say(f"dim2admm: {tag} synchronised split over 1 more frame "
                f"({r_s['iters']} iterations, {r_s['stop']}), ms/frame: "
                + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                    ms.items(), key=lambda kv: -kv[1]))
                + f"; per iteration: "
                + ", ".join(f"{k} {v / max(r_s['iters'], 1):.3f}"
                            for k, v in sorted(ms.items(),
                                               key=lambda kv: -kv[1])[:4]))
            sim.finalize()
            a = np.asarray([r["sys_e"] for r in fr])
            by_tol = all(r["stop"] == "tol" for r in fr)
            rel_n = np.abs(a / e_newton[:len(a)] - 1.0).max()
            del sim, st
            torch.cuda.empty_cache()

            # the first frame with the plain versions on the card
            t0 = time.perf_counter()
            ref = _sim2d(torch, scene, out_root, torch.float32,
                         suffix=f"{tag}_plain", use_kernels=False,
                         save_every=10 ** 9)
            ref.run(1)
            ref.finalize()
            b = ref.frames[0]
            rel = abs(a[0] / b["sys_e"] - 1.0)
            say(f"dim2admm: {tag}: sysE " + " ".join("%.10e" % v for v in a)
                + f"; vs plain path (frame 0) rel {rel:.3e} (tol 1e-3; plain "
                f"iters {b['iters']}, stop {b['stop']}, "
                f"{time.perf_counter() - t0:.2f} s with its set-up); vs "
                f"Newton max rel {rel_n:.3e} ("
                + ("tol 1e-3" if by_tol else "not gated: a frame hit its cap")
                + ")")
            if not rel <= 1e-3:
                problems.append(f"{tag}: kernel and plain paths disagree: "
                                f"{rel:.3e}")
            if by_tol and not rel_n <= 1e-3:
                problems.append(f"{tag}: sysE off Newton's by {rel_n:.3e}")
            del ref
            torch.cuda.empty_cache()
            if problems:
                raise Fail("dim2admm path: " + "; ".join(problems))
        launches_out["dim2admm"] = total
        missing = [k for k in ADMM2D_KERNELS if total[k] <= 0]
        if missing:
            raise Fail(f"dim2admm path: kernels never launched: {missing}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _check_scale_kernels(torch, sysm, x, fixed, hist, record):
    """K9-K12 and K5's compact entry point against their plain versions on
    the bar135 plan (f64 and f32), timed with library call and bound."""
    from dot_tpu_torch.kernels import band, coarse, ops
    from dot_tpu_torch.steppers import System
    mesh, cfg, plan = sysm.mesh, sysm.cfg, sysm.plan
    bad = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        tol = TOL_SCALE[name]
        sm = System(mesh, cfg, plan, dtype=dtype, device="cuda")
        xx = x.to(dtype)
        eh = sm.element_hessians(xx)
        sz = eh.element_size()
        res, times, costs = {}, {}, {}

        # K9 on the run's last L-BFGS history and the gradient at x
        S, T, rho, valid = (h.to(dtype) for h in hist)
        m, nv = S.shape[0], sm.n_vert
        S, T = S.reshape(m, -1).contiguous(), T.reshape(m, -1).contiguous()
        n = S.shape[1]
        g = sm.gradient(xx, xx, fixed).reshape(-1).contiguous()
        r = torch.randn(n, dtype=dtype, device="cuda")
        k9 = _k9_checks(torch, S, T, g, r, rho, valid, tol["elem"],
                        "@bar135")
        for d_, k9d in zip((res, times, costs), k9):
            d_.update(k9d)

        # K10, K11 on the real owner map and element Hessians
        cp = sm.coarse_plan
        freev = torch.logical_not(fixed).to(dtype)
        kk = ops.coarse_assemble(eh, sm.conn, freev, sm.mass, cp)
        kr_ = coarse.coarse_assemble_ref(eh, sm.conn, freev, sm.mass, cp)
        res["coarse_assemble"] = [("Kc", _rel_norm(kk, kr_), tol["sum"],
                                   float((kk - kr_).abs().max()))]
        del kr_
        times["coarse_assemble"] = (
            lambda: ops.coarse_assemble(eh, sm.conn, freev, sm.mass, cp),
            lambda: coarse.coarse_assemble_ref(eh, sm.conn, freev, sm.mass,
                                               cp), None)
        cnt, P = cp.counts, sm.n_parts
        n_mixed = cnt["pairs"] // 16
        costs["coarse_assemble"] = (
            (cnt["uniform"] * 144 + n_mixed * 90) * sz
            + 16 * (cnt["uniform"] + n_mixed) + 5 * nv * sz
            + 8 * cp.items.numel() + P * P * 36 * sz,
            cnt["uniform"] * 16 * 324 + cnt["pairs"] * 324
            + cnt["vertices"] * 60)
        rhs = torch.randn((nv, 3), dtype=dtype, device="cuda")
        y = torch.randn(6 * P, dtype=dtype, device="cuda")
        dc = torch.rand(6 * P, dtype=dtype, device="cuda") + 0.5
        rk = ops.coarse_restrict(rhs, freev, dc, cp)
        rr = coarse.coarse_restrict_ref(rhs, freev, dc, cp)
        pk = ops.coarse_prolong(y, dc, freev, cp, rhs)
        pr = coarse.coarse_prolong_ref(y, dc, freev, cp, rhs)
        res["coarse_restrict"] = [("rc", _rel_norm(rk, rr), tol["sum"],
                                   float((rk - rr).abs().max()))]
        res["coarse_prolong"] = [("p", _rel_max(pk, pr), tol["elem"],
                                  float((pk - pr).abs().max()))]
        six = torch.cat([rhs * freev[:, None],
                         torch.linalg.cross(cp.xc, rhs * freev[:, None])],
                        1)
        acc6 = torch.zeros((P, 6), dtype=dtype, device="cuda")
        times["coarse_restrict"] = (
            lambda: ops.coarse_restrict(rhs, freev, dc, cp),
            lambda: coarse.coarse_restrict_ref(rhs, freev, dc, cp),
            lambda: acc6.index_add_(0, cp.own, six))
        times["coarse_prolong"] = (
            lambda: ops.coarse_prolong(y, dc, freev, cp, rhs),
            lambda: coarse.coarse_prolong_ref(y, dc, freev, cp, rhs), None)
        costs["coarse_restrict"] = ((7 * nv + 12 * P) * sz + 8 * nv,
                                    18 * nv)
        costs["coarse_prolong"] = ((12 * P + 10 * nv) * sz + 8 * nv,
                                   30 * nv)

        # K5 (compact) and K12 on the real band tables
        freef = sm._free(fixed).to(dtype).reshape(-1)
        bp = sm.band_plan
        ck = ops.band_compact(eh, freef, sm.mass_flat, bp)
        cr_ = band.band_compact_ref(eh, freef, sm.mass_flat, bp)
        res["band_compact"] = [("compact", _rel_norm(ck, cr_), tol["sum"],
                                float((ck - cr_).abs().max()))]
        n_ub, n_asm = bp.ub_row.shape[0], bp.src_block.shape[0]
        rows = eh.t().reshape(-1, 9)[bp.src_block]
        acc9 = torch.zeros((n_ub, 9), dtype=dtype, device="cuda")
        times["band_compact"] = (
            lambda: ops.band_compact(eh, freef, sm.mass_flat, bp),
            lambda: band.band_compact_ref(eh, freef, sm.mass_flat, bp),
            lambda: acc9.index_add_(0, bp.stage1, rows))
        costs["band_compact"] = (
            eh.numel() * sz + 8 * n_asm + 8 * (n_ub + 1) + 16 * n_ub
            + 2 * freef.numel() * sz + 9 * n_ub * sz, 9 * n_asm)
        lp = band.low_plan(plan, bp, "cuda")
        bdt = torch.bfloat16 if dtype == torch.float32 else dtype
        fk, dk = ops.band_equil_scatter(cr_, lp, bdt)
        # the scan's first stage: the P diagonal blocks of the band's first
        # row, upcast as _btd_scan_equilibrated does (upper half zero)
        P, bs = sm.n_parts, sm.band_bs
        A0 = fk[:P * bs * bs].view(P, bs, bs).to(dtype).clone()
        fr, dr = band.band_equil_scatter_ref(cr_, lp, bdt)
        if bdt == torch.bfloat16:
            # ulps apart: bf16 bit patterns of same-sign values
            ik = fk.view(torch.int16).to(torch.int32)
            ir = fr.view(torch.int16).to(torch.int32)
            same = (fk == fr) | ((ik - ir).abs() <= 1) & (
                torch.sign(fk) == torch.sign(fr))
            n_off = int((fk != fr).sum())
            band_err = 0.0 if bool(same.all()) else 1.0
        else:
            n_off = int((fk != fr).sum())
            band_err = _rel_max(fk, fr)
        del fr
        res["band_equil_scatter"] = [
            (f"band ({n_off} entries differ; ulp rule)", band_err,
             0.0 if bdt == torch.bfloat16 else tol["elem"], band_err),
            ("d", _rel_max(dk, dr), tol["elem"],
             float((dk - dr).abs().max()))]
        n_low = lp.sel.shape[0]
        times["band_equil_scatter"] = (
            lambda: ops.band_equil_scatter(cr_, lp, bdt),
            lambda: band.band_equil_scatter_ref(cr_, lp, bdt), None)
        costs["band_equil_scatter"] = (
            9 * n_ub * sz + 8 * lp.diag_slot.numel() + 16 * n_ub
            + 80 * n_low + 8 * lp.pad_diag.numel()
            + lp.total * fk.element_size() + 3 * lp.diag_slot.numel() * sz,
            3 * 9 * n_low)
        del fk

        # K6 and K7 at this path's shapes: the coarse factor (one (6P)^2
        # block of the run's Kn + 1e-4 I, symmetrized; 0.05 where the plain
        # version flags it, as the path's tier), the scan's first stage
        # (lower triangle read), and the coarse solve's pair on Lc^{-1}
        ch = TOL_H0[name]
        Kn, _ = sm._coarse_matrix(eh, fixed)
        n6 = Kn.shape[0]
        eye6 = torch.eye(n6, dtype=dtype, device="cuda")
        Ac = (Kn + 1e-4 * eye6)[None].contiguous()
        if bool(band.chol_inv_ref(Ac, True)[2].any()):
            Ac = (Kn + 0.05 * eye6)[None].contiguous()
        plain_inv = {}
        for kname, A, sym in (("chol_inv@coarse", Ac, True),
                              ("chol_inv@scan", A0, False)):
            res[kname], _ = _k6_check(torch, ops, band, A, sym, ch["chol"],
                                      bad, f"{kname} {name}")
            plain_inv[kname] = band.chol_inv_ref(A, sym)[1]
            times[kname] = (lambda A=A, sym=sym: ops.chol_inv(A, sym),
                            lambda A=A, sym=sym: band.chol_inv_ref(A, sym),
                            _k6_library(torch, A))
            costs[kname] = (3 * A.numel() * sz,
                            A.shape[0] * 2 * A.shape[-1] ** 3 / 3)
        li = plain_inv["chol_inv@coarse"].contiguous()
        v6 = torch.randn((1, n6), dtype=dtype, device="cuda")
        li0 = li[0]
        # the pair as K7's solve entry: one launch, the library two mv
        _solve_check(torch, name, "block_solve@coarse", "pair", [li0], v6,
                     ch["chol"], bad, record,
                     library=lambda: torch.mv(li0.T, torch.mv(li0, v6[0])))
        torch.cuda.synchronize()
        for kname, checks in res.items():
            _report(torch, name, kname, checks, times[kname], costs[kname],
                    bad, record)
        say(f"kernels: {name} bar135 shapes: S, T {tuple(S.shape)}, elem_h "
            f"{tuple(eh.shape)}, Kc ({P * P}, 36) from {cp.items.numel()} "
            f"items ({cnt}), compact ({n_ub}, 9), {n_low} lower blocks, band "
            f"{lp.total} x {bdt}; K6 {tuple(Ac.shape)} (shift "
            f"{float(Ac[0, 0, 0] - Kn[0, 0]):.2g}) and {tuple(A0.shape)} "
            f"lower-only, K7 {tuple(li.shape)} x {tuple(v6.shape)}")
        del sm, eh, cr_, rows, six, A0, Ac, Kn, li, k9
        del plain_inv
        torch.cuda.empty_cache()
    if bad:
        raise Fail("kernel disagrees with its plain version: "
                   + "; ".join(bad))


def phase_scale(torch, record, launches_out):
    """bar135 DOT -1 1024 f32: the main path, K9-K12 against their plain
    versions on its plan, and the plain path's first 2 frames."""
    from dot_tpu_torch.kernels import ops
    from dot_tpu_torch.steppers.core import BTDFactor, CoarseFactor
    tmp = tempfile.mkdtemp(prefix="dot_scale_")
    try:
        t0 = time.perf_counter()
        scene = _bar_scene(tmp, BAR135, SCALE_SCENE, "bar135")
        t1 = time.perf_counter()
        out_root = os.path.join(tmp, "out")
        torch.cuda.reset_peak_memory_stats()
        sim = _simulator(torch, scene, out_root, save_every=10 ** 9)
        sysm = sim.system
        t2 = time.perf_counter()
        say(f"scale: bar135 {sim.mesh.n_elem} tets, {sim.mesh.n_vert} "
            f"verts; P {sysm.n_parts}, n3 {sysm.n3}, nb {sysm.band_nb}, bs "
            f"{sysm.band_bs}, f32 band "
            f"{(2 * sysm.band_nb - 1) * sysm.band_bs ** 2 * 4 * sysm.n_parts / 2**30:.2f}"
            f" GiB; coarse {sysm.use_coarse}, chunked {sysm._chunk}; mesh "
            f"{t1 - t0:.1f} s, Simulator (load, partition, System, first "
            f"rebuild) {t2 - t1:.1f} s")
        ops.reset_launches()
        sim.run(4)
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        launches_out["scale"] = launches
        fac, kc = sim.state.chol, sim.state.kc_chol
        split = _h0_split(sim, 2, (
            "rebuild_h0", "element_hessians", "_band_compact",
            "_equil_scatter", "_btd_scan_equilibrated", "_coarse_factor",
            "h0_apply", "_coarse_apply"))
        fr = sim.frames
        timed = fr[1:4]
        spf = float(np.mean([r["seconds"] for r in timed]))
        say(f"scale: s/frame {spf:.5f} (3 timed frames after 1 warm-up; "
            f"warm-up {fr[0]['seconds']:.3f} s); iters/frame "
            f"{np.mean([r['iters'] for r in timed]):.2f}; LS halvings/frame "
            f"{np.mean([r['halvings'] for r in timed]):.2f}; syncs/frame "
            f"{np.mean([r['syncs'] for r in timed]):.2f}; peak device memory "
            f"{peak / 2**20:.1f} MiB")
        say(f"scale: synchronised split over 2 more frames (iters "
            f"{[r['iters'] for r in fr[4:]]}), ms/frame: rebuild_h0 "
            f"{split['rebuild_h0']:.2f} (elem H {split['element_hessians']:.2f}"
            f", coarse factor {split['_coarse_factor']:.2f}, compact "
            f"{split['_band_compact']:.2f}, K12 {split['_equil_scatter']:.2f}"
            f", scan {split['_btd_scan_equilibrated']:.2f}); h0_apply "
            f"{split['h0_apply']:.2f} (fine "
            f"{split['h0_apply'] - split['_coarse_apply']:.2f}, coarse "
            f"{split['_coarse_apply']:.2f})")
        say("scale: per frame (iters, halvings, syncs, stop, s): "
            + "; ".join(f"{r['iters']},{r['halvings']},{r['syncs']},"
                        f"{r['stop']},{r['seconds']:.3f}" for r in fr))
        say("scale: sysE " + " ".join("%.10e" % r["sys_e"] for r in fr))
        say(f"scale: kernel launches {launches}")
        problems = []
        if sysm.n_parts != 133 or not sysm.use_coarse:
            problems.append(f"P {sysm.n_parts}, coarse {sysm.use_coarse}")
        leaf_dt = {str(t.dtype) for t in fac} if isinstance(
            fac, BTDFactor) else set()
        if (sysm._chunk is not True or not isinstance(fac, BTDFactor)
                or fac.linv.shape[0] != 8 or fac.linv.shape[-1] != 768
                or leaf_dt != {"torch.bfloat16"}
                or not isinstance(kc, CoarseFactor)):
            problems.append(f"chunked rebuild not engaged: {type(fac)}, "
                            f"{leaf_dt}, kc {type(kc)}")
        for r in fr:
            if not np.isfinite(r["sys_e"]):
                problems.append(f"frame {r['frame']} sysE not finite")
            if r["stop"] not in ("tol", "rel_dec"):
                problems.append(f"frame {r['frame']} stopped by {r['stop']}")
        for k in SCALE_KERNELS:
            if launches[k] <= 0:
                problems.append(f"kernel {k} never launched on the bar135 "
                                "path")
        if problems:
            raise Fail("scale path: " + "; ".join(problems))
        # K7's solve entry on the run's scan factor (bf16 leaves; f64: the
        # leaves cast), against the plain version
        rr = torch.randn((sysm.n_parts, sysm.n3), device="cuda")
        for dt_ in (torch.float64, torch.float32):
            nm = str(dt_).split(".")[-1]
            _solve_check(torch, nm, "block_solve@bar135", "btd",
                         [t if dt_ == torch.float32 else t.to(dt_)
                          for t in fac], rr.to(dt_), TOL_H0[nm]["chol"],
                         problems, record)
            torch.cuda.empty_cache()
        if problems:
            raise Fail("scale path: " + "; ".join(problems))
        del rr

        x = sim.state.x.detach().clone()
        fixed = sim.state.fixed.clone()
        hist = (sim.state.lb_s, sim.state.lb_t, sim.state.lb_rho,
                sim.state.lb_valid)
        sim.finalize()
        plan = sysm.plan
        del sim, fac, kc
        torch.cuda.empty_cache()
        _check_scale_kernels(torch, sysm, x, fixed, hist, record)
        del sysm, hist
        torch.cuda.empty_cache()

        ref = _simulator(torch, scene, out_root, suffix="plain",
                         use_kernels=False, plan=plan, save_every=10 ** 9)
        ref.run(2)
        ref.finalize()
        a = np.asarray([r["sys_e"] for r in fr[:2]])
        b = np.asarray([r["sys_e"] for r in ref.frames])
        rel = np.abs(a / b - 1.0)
        say(f"scale: plain-path sysE {' '.join('%.10e' % v for v in b)}; "
            f"max rel vs kernels {rel.max():.3e} (tol 1e-3); plain "
            f"s/frame {np.mean([r['seconds'] for r in ref.frames]):.5f}; "
            f"plain iters {[r['iters'] for r in ref.frames]}")
        if not rel.max() <= 1e-3:
            raise Fail(f"bar135 kernel path and plain path disagree: "
                       f"{rel.max():.3e}")
        return spf
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated; kernels2d runs the 2D kernel "
                         "checks of `kernels` alone")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        say("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "dot_tpu_torch")):
        say("FAIL: dot_tpu_torch not found beside chip_smoke.py")
        return 1
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    record = {}
    launches = {}
    newton2d = None
    try:
        if "probe" in phases:
            phase_probe(torch)
        if "build" in phases:
            phase_build(torch)
        if "kernels" in phases:
            phase_kernels(torch, record)
            phase_h0_kernels(torch, record)
            phase_k6_k9_kernels(torch, record)
            phase_pd_kernels(torch, record)
            phase_admm_kernels(torch, record)
        if "kernels" in phases or "kernels2d" in phases:
            phase_dim2_kernels(torch, record)
            phase_dd2d_kernels(torch, record)
            phase_k34_kernel(torch, record)
            phase_admm2d_kernels(torch, record)
        if "golden" in phases:
            phase_golden(torch)
        if "main" in phases:
            phase_main(torch, launches)
        if "steppers" in phases:
            phase_steppers(torch, launches, record)
        if "admm" in phases:
            phase_admm(torch, launches)
        if "scale" in phases:
            phase_scale(torch, record, launches)
        if "dim2" in phases:
            newton2d = phase_dim2(torch, launches)
        if "dim2dd" in phases:
            phase_dim2dd(torch, launches)
        if "dim2admm" in phases:
            phase_dim2admm(torch, launches, newton2d)
    except Exception as exc:  # report the phase's failure and exit non-zero
        import traceback
        traceback.print_exc()
        say(f"FAIL: {type(exc).__name__}: {exc}")
        return 1
    if set(phases) != set(ALL_PHASES):
        say(f"partial run ({args.phases}): no result line")
        return 0

    # launches: all paths' runs together, and each path's own count; the
    # times are at the bar17 shapes (the 2D kernels: the full-size spikes
    # scene's), K6, K7 and K9 also at bar135's own ("bar135"), K6 at the
    # other widths of its callers (split2000, lower2000, newton, w37, w770)
    kernels = []
    for name, (route, source, replaces) in SOURCES.items():
        by_path = {path: launches[path][name] for path in PATHS}
        extra = {}
        for k, v in record.items():
            if k.startswith(name + "@"):
                tag = k.split("@")[1]
                if tag == "bar135":
                    extra.setdefault(tag, {}).update(v)
                elif tag in ("coarse", "scan"):
                    extra.setdefault("bar135", {})[tag] = v
                else:
                    extra[tag] = v
        kernels.append(dict(name=name, route=route, source=source,
                            replaces=replaces,
                            launches=sum(by_path.values()),
                            launches_by_path=by_path, **record[name],
                            **extra))
    say(f"smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(nvidia_smi())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
