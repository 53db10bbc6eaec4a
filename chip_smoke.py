"""Chip smoke test of amgcl_tpu_torch on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the hand-written
   kernels (``amgcl_tpu_torch/csrc/*.cu``) from the checkout.
2. Drives the main path once through the package's entry points:
   ``poisson3d(128)`` → ``make_solver(A, AMGParams(dtype=float32),
   CG(maxiter=100, tol=1e-6), refine=3)``, then solves twice. On the card
   the stencil levels are built on the device, the host loop below them
   aggregates with the device MIS, and every eligible level runs the
   fused V-cycle legs. Every kernel's launch count is set to 0 just
   before and read just after; the run fails unless the levels have
   2,097,152 / 262,144 / 32,768 / 1,006 rows and CG takes 16 ± 1
   iterations (the JAX package's under its device setup), L2's MIS gives
   the same aggregates on the card and the CPU, the true residual (host
   float64) is ≤ 1e-6, every kernel
   on the path launched (each fused leg once per V-cycle at every level
   that carries it) and no plain version ran.
   Then the earlier path: the same problem built on the host
   (``device_setup=False``: greedy aggregates) with the fused handles
   removed, so the cycle composes its legs; held to 4 levels of 2,097,152
   / 262,144 / 32,768 / 1,331 rows and 12 ± 1 iterations (the JAX
   package's under its host setup), and every earlier kernel must launch
   on one of the two paths.
3. Holds each kernel against its plain PyTorch version on the main path's
   own operators (random vectors from a seeded numpy generator), and times
   kernel, plain version and, where one PyTorch call computes the same
   function, that call (CUDA events, median of 20 after warm-up, L2 flushed
   before each launch), beside the least time the card could take. A fused
   leg is also timed beside the chain of earlier kernels it replaces.
4. The unstructured phase: ``fe_like_problem()`` (poisson3Db's profile,
   85,623 rows) → ``make_solver(A, AMGParams(dtype=float32),
   BiCGStab(maxiter=100, tol=1e-6), refine=3)``, solved cold and warm, on
   two paths, each with the counts set to 0 just before and read just
   after: U1 in the identity order, right-preconditioned; U2
   RCM-permuted, left-preconditioned. Each fails outside its levels
   (85,623 / 24,046 / 1,891 and 85,623 / 24,067 / 1,909 rows, windowed
   ELL / windowed ELL / dense), a true residual above 1e-6, iterations
   outside ±10% of the JAX package's count on the CPU (54 and 51), or any
   plain-version call; the windowed-ELL kernels and the BiCGStab tail must
   each launch on one of the two. Then each of those kernels is held
   against its plain version and timed at the L0 and L1 operators and
   transfers of both orders, as in 3; the BiCGStab tail's two dots must
   equal, bit for bit, the tails' summation order
   (``fused_vec.ordered_tail_dots``) on its own r' and r̂.
5. The block path B1 (U1's and U2's hierarchies freed first):
   ``poisson3d_block(48, 3)`` (110,592 3×3 block rows, 331,776 unknowns)
   → ``make_solver(A, AMGParams(dtype=float32), BiCGStab(maxiter=200,
   tol=1e-6))``, solved cold and warm with the counts set to 0 just
   before and read just after. It fails unless the hierarchy has 4
   levels of 110,592 / 13,591 / 2,556 / 667 block rows with every A, P
   and R a block windowed ELL of 3×3 blocks, BiCGStab takes 12 ± 1
   iterations (the JAX package's count on the CPU), the reported
   residual is ≤ 1e-6, the true one (host float64) ≤ 1e-6 plus
   2u·‖|A||x|‖/‖b‖ (u = 2⁻²⁴: at this size the float64 solution rounded
   to float32 already misses 1e-6, as tests/test_torch_block.py shows),
   every block kernel mode and the BiCGStab tail launched and no plain
   version ran. The same system with ``refine=3`` must reach a true
   residual ≤ 1e-6 in 23 ± 2 iterations (the JAX package's: 23), through
   the block residual kernel in float64. Then each block kernel mode is
   held against its plain version and timed at L0 A, P, R and L1 A (the
   square modes at L0 A and L1 A), in float32 and at L0 A in float64,
   beside torch's BSR product as the library yardstick; every mode also
   on L0 A's structure with random, non-symmetric blocks, the correction
   with a random, non-symmetric scale.
6. Path D2 (B1's hierarchies freed first): U2's system and call with
   ``AMGParams(dtype=float32, matrix_format="dwin")``, cold and warm,
   counts set to 0 just before and read just after; the dense window
   declines the device MIS, so the levels are the host setup's. It fails
   unless the
   levels have 85,623 / 25,145 / 1,998 rows, every level operator is a
   dense window of 11,264 / 10,240 / 2,048 columns holding 3,858,235,392 /
   1,030,225,920 / 16,777,216 bytes of blocks, the smoothed transfers'
   M and Mᵀ are dense windows too (the JAX package converts them in the
   hierarchy's format), BiCGStab takes 50 ± 10% iterations (the JAX
   package's U2 count on the CPU under its host setup), the true
   residual is ≤ 1e-6, every
   dense-window kernel launched and no plain version ran. Then each
   dense-window kernel is held against its plain version and timed at
   L0 and L1 in float32 and at L1 in float64, the SpMV beside torch.bmm.
7. Path K1: U1's system and call under ``BiCGStabL(L=2, maxiter=100,
   tol=1e-6)``, cold and warm. It fails unless U1's levels are built,
   BiCGStab(L) takes 48–68 iterations (10% around the JAX package's 53–62
   on the CPU over the rhs and five rhs perturbed by 1e-6 relative),
   the true residual is ≤ 1e-6, axpby_dot launched at least once per
   iteration, no plain version ran, and a further warm solve makes at
   most 8 host syncs beside one per BiCG step. Then axpby_dot is held
   against its plain version and timed at n = 85,623 in float32 and
   float64, its dot bit for bit with ``fused_vec.ordered_tail_dots`` on
   its own z.
8. The GMRES family (K1's hierarchy freed first). Path G1:
   ``fe_like_problem(85623, nnz_target=6*85623)`` (five nearest
   neighbours) → ``make_solver(A, AMGParams(dtype=float32),
   GMRES(maxiter=100, tol=1e-6), refine=3)``, cold and warm, the counts
   set to 0 just before and read just after. It fails unless the levels
   are 85,623 / 14,704 / 1,836 rows, windowed ELL with K 16 at L0 /
   windowed ELL / dense, GMRES takes 41 ± 10% iterations (the JAX
   package's on the CPU), the true residual is ≤ 1e-6, the gather kernel
   launched at least once an Arnoldi step (every L0 product of left
   GMRES), no plain version ran, and a further warm solve makes at most
   8 host syncs beside one per Arnoldi step. Path G1r: the same system in
   RCM order under FGMRES, held likewise to 85,623 / 14,597 / 1,844 rows,
   an L0 window of 7,168 columns with 81 distinct starts (the path on
   which the starts matter) and 49 ± 10% iterations. Then the gather
   kernel is held against its plain version and timed at G1's and G1r's
   L0, G1's float64 refinement operator and random operators with
   differing starts at K = 4, 8 and 12 in float32 and float64, beside
   B.8 and torch's CSR product. LGMRES, IDR(s), Richardson(maxiter=100)
   and PreOnly each solve G1's system once with the same call: 42, 65
   and 200 ± 10% iterations and a true residual ≤ 1e-6; PreOnly exactly
   4 (one application, three refinements), its residual reported. Path
   G2: poisson3d(128) under GMRES with the main path's call otherwise:
   20 ± 1 iterations, a true residual ≤ 1e-6, dia_spmv launched.
9. Path S1, the sharded stencil solver on one card (the GMRES family's
   hierarchies freed first): ``DistStencilSolver(poisson3d(128)[0],
   make_mesh(4), AMGParams(dtype=float32), CG(maxiter=100, tol=1e-6))``,
   four z-slab shards driven by one process, solved cold and warm with
   the counts set to 0 just before the setup and read just after. It
   fails unless two levels of 2,097,152 and 262,144 rows are built over
   the shards, in slabs of (32, 128, 128) and (16, 64, 64), with a
   replicated tail from 32,768 rows; CG takes 13 ± 1 iterations (the JAX
   package's on the CPU); the reported residual is ≤ 1e-6 and the true
   one (host float64) ≤ 1e-3 (float32 without refinement: the JAX
   package reaches 1.941e-04); each framed leg launched once per
   V-cycle per shard at each sharded level, dia_spmv (the halo
   product's interior) launched, no plain version ran; and a further
   warm solve makes at most 4 host syncs beside one per CG iteration.
   The same system on a one-shard mesh (zero halos) must take the same
   iterations within one. Then each framed leg is held against its
   plain version and timed at S1's L0 and L1 on an interior shard (both
   halos real) and a boundary shard, beside the base mode on the same
   slab and the least time for its bytes.

10. Every smoother and coarsening of the JAX package (``A8_PATHS``), each
   through make_solver at full size (``--phase10`` runs it alone).
11. The compositions and configuration (``A9_PATHS``, ``--phase11`` runs
   it alone): MX1 (a float64 Krylov loop over the main path's float32
   hierarchy), DF1 (df32 refinement), RB1 and RB1h (a rebuild of a
   drifting poisson3d(128), device-built and host-built), DL1
   (deflation), NS1, DM1 and AP1 (runtime configurations: nested,
   dummy, ILU(0) alone), SC1 (Schur pressure correction on
   stokes_like(512)), CP1 (CPR on reservoir_like(96, 3) and its rebuild)
   and BK1 (B1's system through make_block_solver). Each is held to its
   iteration window, its true residual, its structure (``a9_reach``), its
   kernels and zero plain-version calls.
12. bfloat16 hierarchies under a float32 Krylov loop (``BF_PATHS``,
   ``--phase12`` runs it alone): BF1 (the main path's call with
   ``AMGParams(dtype=bfloat16)``, ``solver_dtype=float32``: L0/L1 built on
   the device with both fused legs in bfloat16), BF1h (its host build,
   legs composed), BF1s (SPAI-1, whose products are DIA SpMVs), BF2 (U1's
   system, BiCGStab left-preconditioned) and BF2s (SPAI-1 there: the
   windowed-ELL SpMV). Each is held to a true residual ≤ 1e-6, fewer
   than (1 + refine)·maxiter iterations (BF1 at most twice the main
   path's 16, BF1h twice the host setup's 12, BF2 three times the
   float32 hierarchy's count under
   the same call), its structure (``bf_reach``), its
   bfloat16 modes launched and zero plain-version calls, and prints its
   hierarchy's bytes and peak memory (BF1, BF1h and BF2 beside the
   float32 hierarchy's of the same call). Then every bfloat16 mode (B.1, B.2, the fused legs,
   B.8, B.9) is held against its plain version on BF1's L0/L1 and BF2's
   L0 operators (within u·Σ|terms|, u = 2⁻⁸, with the largest difference
   in bfloat16 ULPs) and timed, its bound in bfloat16 bytes.

13. The accelerator setup (``--phase13`` runs it alone): RO1 (U1's
   system under a random symmetric permutation, U1's call with
   ``reorder="rcm"``, the advisor's verdict for "auto" printed; then
   ``reorder="off"``, the default; levels and count held to the JAX
   package's under its device setup and ``AMGCL_TPU_REORDER=rcm``: 85,623
   / 24,056 / 1,918 rows, 55 ± 10%), RO2 (a scrambled band,
   ``reorder="auto"``: the
   plan must fire and L0 be DIA), RB2 (U1's system built twice and
   rebuilt with RB2_SCALES through the plans, then RO1 rebuilt from
   values in the caller's order: every build and rebuild equal to a
   fresh build bit for bit, with the same count), DI1 (the main path
   with ``device_inv=True``: the device inverse kept, the count within
   one of the main path's) and MIS1 (the device MIS on U1's strength
   graph, twice on the card and once on the CPU, all equal).
14. Serving (``--phase14`` runs it alone): SV1 (the main path's system,
   float32 SA + SPAI-0 + CG(maxiter=100, tol=1e-6), refine 0, through
   ``SolverService(batch=8)``: a ``solve_batch`` of 8 seeded columns,
   column 0 the main path's rhs, cold (the bucket's CUDA graph captured)
   and warm, then 13 ``submit``s, one full bucket and one of 5 padded
   with zero columns), BC1 (``BlockCG`` on SV1's system and hierarchy,
   B = 8) and SV2 (U1's system under BiCGStab(maxiter=100, tol=1e-6),
   B = 4). Each column's reported residual must be ≤ 1e-6, its host
   float64 true residual at most twice that of the same column's
   single-rhs solve through the same bundle, and (but in BC1) its count
   within ±1 of that solve's; BC1's count no more than SV1's worst CG
   column's. Each bucket is captured once, and its replay must equal the
   eager per-column apply bit for bit; no plain version may run. Prints
   the kernels launched (by their wrappers, and inside graph replays),
   captures and capture seconds, a warm batch's time and solves/s beside
   the sequential single-rhs solves', its busy share and peak memory.
15. The solver farm and the open-loop storm (``--phase15`` runs it
   alone): FM1, ``SolverFarm(batch=8)`` with t-main (the main path's
   system, float32 SA + SPAI-0 + CG(maxiter=100, tol=1e-6), refine 0: a
   registry miss), t-share (the same CSR bit for bit: a hit, the pool's
   bytes unchanged), t-u1 (U1's system under BiCGStab(maxiter=100,
   tol=1e-6): a miss), t-step (the main system scaled by 1.05: a miss,
   since its pattern's entry has live co-owners; then by 1.10: a rebuild
   of its own entry); then 0.75 of the used bytes as the budget
   and two round-robin rounds of one seeded rhs per tenant. Each answer's
   reported residual ≤ 1e-6, its count equal to the same bundle's
   single-rhs solve's and its true residual at most twice that one's;
   round 2 equal to round 1 bit for bit; at least one eviction and one
   readmission, 3 misses, rebuilds ≥ 1 + readmissions, the pool within
   its budget after every batch, each readmitted bucket captured once
   with its replay equal to the eager apply bit for bit; around every
   eviction the allocated bytes fall by ≥ 90% of the charge released,
   and t-main's operator evicted and readmitted comes back to within 10%
   of them. ST1 on FM1's farm, the budget lifted, requests alternating
   between t-main and t-u1: the closed-loop rate R of a warm round of
   full buckets, ``run_storm`` of Poisson 0.5 R for 8 s and bursts over
   0.25 R for 6 s (8 every 2 s), seed 19, and ``run_ladder`` at 0.25,
   0.5, 1.0 and 1.5 R, 4 s a rung, with its knee: no ``error`` outcome,
   every ok answer held to FM1's rule, /metrics scraped over loopback
   with tenant labels and no scrape error. Within 120 s, no plain
   version; the launches of both join the kernels line.

With the device setup as the default, the windows of the paths whose
host-loop levels it changes come from the JAX package's counts under its
device setup at full size (note at MAIN_LEVEL_ROWS); D2 and N1 decline
the device MIS and build as under the host setup.

Prints one JSON line of kernel records, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, when
no CUDA device is present or any phase fails.
"""

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
import weakref

import numpy as np
import scipy.sparse as sp
import torch

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and non-tensor-core
#: float32 / float64 operations per second
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
#: the bfloat16 modes load bfloat16 and compute in float registers
PEAK_OPS[torch.bfloat16] = PEAK_OPS[torch.float32]

#: the main path's levels and the JAX package's CG count on the CPU under
#: its host setup (AMGCL_TPU_DEVICE_SETUP=0): the earlier path's window
LEVEL_ROWS = [2097152, 262144, 32768, 1331]
ITERS_EXPECTED = 12

#: The setup on the card (device MIS, segment-sum plans) is the default,
#: as on an accelerator in the JAX package; it changes every level a path
#: builds in the host loop. The constants below are the JAX package's
#: level rows and counts under AMGCL_TPU_DEVICE_SETUP=1, taken on the CPU
#: at each path's full size and call (``reference_counts.py --a10-full``):
#: correctness constants, not speeds. The windows around them are those
#: the paths had under the host setup (±1, ±2, ±10%, exact).
MAIN_LEVEL_ROWS = [2097152, 262144, 32768, 1006]
MAIN_ITERS = 16

#: the unstructured paths: level rows, level formats, and BiCGStab
#: iterations (summed over refinement restarts)
U_LEVELS = {"U1": [85623, 24046, 1891], "U2": [85623, 24067, 1909]}
U_FORMATS = ["WindowedEllMatrix", "WindowedEllMatrix", "DenseMatrix"]
U_ITERS = {"U1": 54, "U2": 51}

#: the block path: level block rows and BiCGStab iterations without and
#: with refinement
B1_LEVELS = [110592, 13591, 2556, 667]
B1_ITERS = 12
B1_ITERS_REFINED = 23

#: path D2 (U2's system on dense-window operators), which declines the
#: device MIS (``models/amg.device_mis_declined``) and so builds as under
#: the host setup: level rows, each level operator's window and block
#: bytes (float32), and the JAX package's BiCGStab iterations for U2 under
#: its host setup
D2_LEVELS = [85623, 25145, 1998]
D2_WINDOWS = [11264, 10240, 2048]
D2_BYTES = [3858235392, 1030225920, 16777216]
D2_ITERS = 50
#: path K1 (U1 under BiCGStab(2)): U1's levels, and the least and most
#: iterations over the rhs and five rhs perturbed by 1e-6 relative
#: (``--a10-full --spread K1``: 62, 55, 54, 53, 62, 57), since BiCGStab(2)'s
#: count under refinement moves that far with the rhs's last bits; K1 is
#: held to 10% around that range
K1_LEVELS = U_LEVELS["U1"]
K1_ITERS = (53, 62)
#: phase 8, the GMRES family: G1 (fe_like_problem(85623, nnz_target=
#: 6*85623), identity order, GMRES) and G1r (RCM order, FGMRES) levels,
#: formats, G1r's L0 window and distinct starts (the fine level's, which
#: the setup does not touch), and the iterations (summed over refinement);
#: G2 (poisson3d(128) under GMRES) likewise
G1_LEVELS = [85623, 14704, 1836]
G1R_LEVELS = [85623, 14597, 1844]
G_FORMATS = ["WindowedEllMatrix", "WindowedEllMatrix", "DenseMatrix"]
G1_ITERS = 41
G1R_ITERS = 49
G1R_WINDOW = 7168
G1R_STARTS = 81
G2_ITERS = 20
G_OTHER_ITERS = {"LGMRES": 42, "IDRs": 65, "Richardson": 200, "PreOnly": 4}
#: phase 9, path S1 (poisson3d(128) over four z-slab shards of one card):
#: the sharded levels' rows and slab dims, the replicated tail's rows and
#: CG's iterations
S1_SHARDS = 4
S1_LEVELS = [2097152, 262144]
S1_SLABS = [(32, 128, 128), (16, 64, 64)]
S1_TAIL = 32768
S1_ITERS = 13
#: phase 13, path RO1 (U1's system under RO1_SEED's permutation,
#: reordered by RCM, U1's call): level rows and iterations
RO1_LEVELS = [85623, 24056, 1918]
RO1_ITERS = 55

#: the same paths' level rows and counts under the host setup (greedy
#: pass, scipy products), the JAX package's on the CPU: printed beside
#: each path's reading as its "before"; B1's are also the constants
#: tests/test_torch_block.py holds both packages to at full size
B_LEVELS = [110592, 13310, 1049, 68]
B_ITERS = 7
B_ITERS_REFINED = 13
HOST_SETUP = {
    "main": (LEVEL_ROWS, ITERS_EXPECTED), "DF1": (None, 12),
    "RB1": (None, 12), "BF1": (LEVEL_ROWS, None),
    "U1": ([85623, 23695, 1561], 51), "U2": ([85623, 25145, 1998], 50),
    "K1": ([85623, 23695, 1561], 51), "BF2": ([85623, 23695, 1561], None),
    "BF2s": ([85623, 23695, 1561], None),
    "B1": (B_LEVELS, B_ITERS), "B1 refine=3": (None, B_ITERS_REFINED),
    "BK1": (None, B_ITERS), "G1": ([85623, 14002, 1232], 40),
    "G1r": ([85623, 15367, 1672], 46), "G1 LGMRES": (None, 42),
    "G1 IDRs": (None, 60), "G1 Richardson": (None, 200), "G2": (None, 14),
    "S1": (None, 9)}


def check_levels(label, rows, fmts, want_rows, want_fmts, failures):
    """A path's level rows and formats, exactly; prints them, and the
    host setup's (HOST_SETUP)."""
    print("[%s] levels: %s %s (expected %s %s; host setup %s)"
          % (label, rows, fmts, want_rows, want_fmts,
             HOST_SETUP.get(label, (None,))[0]))
    if rows != want_rows or fmts != want_fmts:
        failures.append("%s: levels %s %s, expected %s %s"
                        % (label, rows, fmts, want_rows, want_fmts))


def check_iters(label, iters, want, failures, within=None, rel=None):
    """A path's count within ``within`` of ``want``, or within ``rel`` of
    it relative; prints both."""
    slack = within if rel is None else rel * want
    print("[%s] iterations: %d (expected %d ± %g; host setup %s)"
          % (label, iters, want, slack,
             HOST_SETUP.get(label, (None, None))[1]))
    if abs(iters - want) > slack:
        failures.append("%s: %d iterations, expected %d ± %g"
                        % (label, iters, want, slack))

SOURCES = {"dia": "amgcl_tpu_torch/csrc/dia.cu",
           "vec": "amgcl_tpu_torch/csrc/vec.cu",
           "vcycle": "amgcl_tpu_torch/csrc/vcycle.cu",
           "well": "amgcl_tpu_torch/csrc/well_block.cu",
           "densewin": "amgcl_tpu_torch/csrc/densewin.cu",
           "gather": "amgcl_tpu_torch/csrc/gather.cu"}
REPLACES = {
    "dia_spmv": "amgcl_tpu/ops/pallas_spmv.py:318",
    "dia_residual": "amgcl_tpu/ops/pallas_spmv.py:389",
    "dia_scaled_correction": "amgcl_tpu/ops/pallas_spmv.py:389",
    "dia_spmv_dots": "amgcl_tpu/ops/pallas_spmv.py:461",
    "dia_residual_dot": "amgcl_tpu/ops/pallas_spmv.py:552",
    "xr_update": "amgcl_tpu/ops/fused_vec.py:251",
    "fused_down_sweep": "amgcl_tpu/ops/pallas_vcycle.py:274",
    "fused_up_sweep": "amgcl_tpu/ops/pallas_vcycle.py:491",
    "windowed_ell_spmv": "amgcl_tpu/ops/unstructured.py:339",
    "windowed_ell_residual": "amgcl_tpu/ops/unstructured.py:397",
    "windowed_ell_scaled_correction": "amgcl_tpu/ops/unstructured.py:397",
    "windowed_ell_spmv_dots": "amgcl_tpu/ops/unstructured.py:477",
    "bicgstab_tail": "amgcl_tpu/ops/fused_vec.py:251",
    "windowed_ell_block_spmv": "amgcl_tpu/ops/unstructured.py:567",
    "windowed_ell_block_residual": "amgcl_tpu/ops/unstructured.py:623",
    "windowed_ell_block_scaled_correction":
        "amgcl_tpu/ops/unstructured.py:623",
    "windowed_ell_block_spmv_dots": "amgcl_tpu/ops/unstructured.py:687",
    "dense_window_spmv": "amgcl_tpu/ops/densewin.py:235",
    "dense_window_residual": "amgcl_tpu/ops/densewin.py:279",
    "dense_window_scaled_correction": "amgcl_tpu/ops/densewin.py:279",
    "axpby_dot": "amgcl_tpu/ops/fused_vec.py:251",
    "gather_spmv": "amgcl_tpu/ops/pallas_gather.py:78",
    "fused_down_sweep.framed": "amgcl_tpu/ops/pallas_vcycle.py:187",
    "fused_up_sweep.framed": "amgcl_tpu/ops/pallas_vcycle.py:477",
}
#: the kernels with a bfloat16 mode (phase 12): each wrapper's
#: ``bf16_launches`` counts its bfloat16 launches, recorded as
#: ``<name>.bf16``
BF16_MODES = ("dia_spmv", "dia_residual", "dia_scaled_correction",
              "fused_down_sweep", "fused_up_sweep", "windowed_ell_spmv",
              "windowed_ell_residual", "windowed_ell_scaled_correction")
for _k in BF16_MODES:
    REPLACES[_k + ".bf16"] = REPLACES[_k]
FUSED = ("fused_down_sweep", "fused_up_sweep")
#: the framed modes of the fused legs, run by path S1 only
FRAMED = ("fused_down_sweep.framed", "fused_up_sweep.framed")
#: the measured fields of a kernel's record in the kernels line
RECORD_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
#: kernels of the unstructured paths, each launched on U1 or U2
UNSTRUCTURED = ("windowed_ell_spmv", "windowed_ell_residual",
                "windowed_ell_scaled_correction", "windowed_ell_spmv_dots",
                "bicgstab_tail")
#: kernels the block path must launch
BLOCK = ("windowed_ell_block_spmv", "windowed_ell_block_residual",
         "windowed_ell_block_scaled_correction",
         "windowed_ell_block_spmv_dots", "bicgstab_tail")
#: kernels path D2 must launch
DENSEWIN = ("dense_window_spmv", "dense_window_residual",
            "dense_window_scaled_correction")
#: kernels the earlier (host-setup, composed) path must launch
EARLIER = ("dia_residual", "dia_scaled_correction", "dia_spmv_dots",
           "dia_residual_dot", "xr_update")
#: kernels the main path must launch: the fused legs at the stencil
#: levels, the DIA legs at the host-built level, CG and the refinement
ON_PATH = EARLIER + FUSED


def source_of(name):
    name = name.replace(".bf16", "")
    if name in ("xr_update", "bicgstab_tail", "axpby_dot"):
        return SOURCES["vec"]
    if name.startswith("windowed_ell"):
        return SOURCES["well"]
    if name.startswith("dense_window"):
        return SOURCES["densewin"]
    if name == "gather_spmv":
        return SOURCES["gather"]
    return SOURCES["vcycle" if name in FUSED + FRAMED else "dia"]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def wrappers():
    from amgcl_tpu_torch.ops import densewin_kernels as dwk
    from amgcl_tpu_torch.ops import dia_kernels as dk
    from amgcl_tpu_torch.ops import fused_vec as fv
    from amgcl_tpu_torch.ops import gather_kernels as gk
    from amgcl_tpu_torch.ops import vcycle_kernels as vk
    from amgcl_tpu_torch.ops import well_block_kernels as wbk
    from amgcl_tpu_torch.ops import well_kernels as wk
    return {"fused_down_sweep": (vk.fused_down_sweep,
                                 vk.fused_down_sweep_plain),
            "fused_up_sweep": (vk.fused_up_sweep, vk.fused_up_sweep_plain),
            "fused_down_sweep.framed": (vk.fused_down_sweep_framed,
                                        vk.fused_down_sweep_framed_plain),
            "fused_up_sweep.framed": (vk.fused_up_sweep_framed,
                                      vk.fused_up_sweep_framed_plain),
            "dia_spmv": (dk.dia_spmv, dk.dia_spmv_plain),
            "dia_residual": (dk.dia_residual, dk.dia_residual_plain),
            "dia_scaled_correction": (dk.dia_scaled_correction,
                                      dk.dia_scaled_correction_plain),
            "dia_spmv_dots": (dk.dia_spmv_dots, dk.dia_spmv_dots_plain),
            "dia_residual_dot": (dk.dia_residual_dot,
                                 dk.dia_residual_dot_plain),
            "xr_update": (fv.xr_update, fv.xr_update_plain),
            "windowed_ell_spmv": (wk.windowed_ell_spmv,
                                  wk.windowed_ell_spmv_plain),
            "windowed_ell_residual": (wk.windowed_ell_residual,
                                      wk.windowed_ell_residual_plain),
            "windowed_ell_scaled_correction": (
                wk.windowed_ell_scaled_correction,
                wk.windowed_ell_scaled_correction_plain),
            "windowed_ell_spmv_dots": (wk.windowed_ell_spmv_dots,
                                       wk.windowed_ell_spmv_dots_plain),
            "bicgstab_tail": (fv.bicgstab_tail, fv.bicgstab_tail_plain),
            "windowed_ell_block_spmv": (wbk.windowed_ell_block_spmv,
                                        wbk.windowed_ell_block_spmv_plain),
            "windowed_ell_block_residual": (
                wbk.windowed_ell_block_residual,
                wbk.windowed_ell_block_residual_plain),
            "windowed_ell_block_scaled_correction": (
                wbk.windowed_ell_block_scaled_correction,
                wbk.windowed_ell_block_scaled_correction_plain),
            "windowed_ell_block_spmv_dots": (
                wbk.windowed_ell_block_spmv_dots,
                wbk.windowed_ell_block_spmv_dots_plain),
            "dense_window_spmv": (dwk.dense_window_spmv,
                                  dwk.dense_window_spmv_plain),
            "dense_window_residual": (dwk.dense_window_residual,
                                      dwk.dense_window_residual_plain),
            "dense_window_scaled_correction": (
                dwk.dense_window_scaled_correction,
                dwk.dense_window_scaled_correction_plain),
            "axpby_dot": (fv.axpby_dot, fv.axpby_dot_plain),
            "gather_spmv": (gk.gather_spmv, gk.gather_spmv_plain)}


def reset_counts():
    W = wrappers()
    for kern, plain in W.values():
        kern.launches = 0
        plain.calls = 0
    for k in BF16_MODES:
        W[k][0].bf16_launches = 0


def read_counts():
    """({kernel: launches}, {kernel: plain calls}); the launches also
    hold ``<name>.bf16``, the bfloat16 launches of each BF16_MODES
    kernel (its ``<name>`` count holds every dtype's)."""
    W = wrappers()
    launches = {k: kern.launches for k, (kern, _) in W.items()}
    launches.update({k + ".bf16": W[k][0].bf16_launches
                     for k in BF16_MODES})
    return launches, {k: plain.calls for k, (_, plain) in W.items()}


@contextlib.contextmanager
def counts_paused():
    """Launches and plain calls inside the block are not counted: on
    leaving, every count is what it was on entering (a comparison run
    inside a path's counting window)."""
    launches, calls = read_counts()
    try:
        yield
    finally:
        W = wrappers()
        for k, (kern, plain) in W.items():
            kern.launches, plain.calls = launches[k], calls[k]
        for k in BF16_MODES:
            W[k][0].bf16_launches = launches[k + ".bf16"]


# -- phase 2: the main path and the earlier path ------------------------------

def drive(A, rhs, failures, label, device_setup=None, composed=False):
    """Build and solve twice through make_solver with the counts set to 0
    just before and read just after. ``composed`` removes every fused
    handle, so the cycle composes its legs. Returns (solve, counts,
    summary)."""
    from amgcl_tpu_torch import AMGParams, CG, make_solver
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solve = make_solver(A, AMGParams(dtype=torch.float32),
                        CG(maxiter=100, tol=1e-6), refine=3,
                        device_setup=device_setup)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    amg = solve.precond
    hier = amg.hierarchy
    if composed:
        for lv in hier.levels:
            lv.down = lv.up = None
    split = amg.setup_split
    print("[%s] setup: %.3f s wall (make_solver), %.3f s in AMG._build: "
          "%.3f s device build, %.3f s host loop and move to the device; "
          "device build on: %s; peak device memory %.1f MB"
          % (label, t_setup, amg.setup_seconds, split["device_build_s"],
             split["host_s"], amg.device_built,
             torch.cuda.max_memory_allocated() / 2**20))
    print(amg)
    for i, lv in enumerate(hier.levels):
        print("[%s] level %d: %d rows, %s, fused down: %s (zero guess: %s),"
              " fused up: %s%s"
              % (label, i, lv.A.shape[0], type(lv.A).__name__,
                 lv.down is not None,
                 lv.down is not None and lv.down.w is not None,
                 lv.up is not None,
                 ", halo planes %d" % lv.up.halo_planes
                 if lv.up is not None else ""))
    # count V-cycles: one per preconditioner application
    cycles = [0]
    apply = hier.apply

    def counted(r):
        cycles[0] += 1
        return apply(r)

    hier.apply = counted
    x, info = solve(rhs)
    print("[%s] solve 1 (cold): %d iterations, reported resid %.3e, %.4f s"
          % (label, info.iters, info.resid, info.wall_time_s))
    first, _ = read_counts()
    cycles_first = cycles[0]
    x, info = solve(rhs)
    counts, plain_calls = read_counts()
    print("[%s] solve 2 (warm): %d iterations, reported resid %.3e, %.4f s"
          % (label, info.iters, info.resid, info.wall_time_s))
    x64 = x.double().cpu().numpy()
    true_res = float(np.linalg.norm(rhs - A.spmv(x64))
                     / np.linalg.norm(rhs))
    print("[%s] true relative residual (host float64): %.3e"
          % (label, true_res))
    warm = {k: counts[k] - first[k] for k in counts}
    warm_cycles = cycles[0] - cycles_first
    print("[%s] launches (setup + 2 solves): %s" % (label, json.dumps(counts)))
    print("[%s] launches in the warm solve (%d V-cycles): %s; per CG "
          "iteration: %s" % (label, warm_cycles, json.dumps(warm), json.dumps(
              {k: round(v / max(info.iters, 1), 3)
               for k, v in warm.items()})))
    print("[%s] plain-version calls: %s" % (label, json.dumps(plain_calls)))
    rows = [h[0].nrows for h in amg.host_levels]
    if device_setup is False:
        # the host setup: the JAX package's shapes and count
        if rows != LEVEL_ROWS:
            failures.append("%s: levels %s, expected %s"
                            % (label, rows, LEVEL_ROWS))
        if abs(info.iters - ITERS_EXPECTED) > 1:
            failures.append("%s: %d iterations, expected %d ± 1"
                            % (label, info.iters, ITERS_EXPECTED))
    else:
        # device-built L0-L2, the device MIS below: the JAX package's
        # shapes and count under its device setup
        check_levels(label, rows, [], MAIN_LEVEL_ROWS, [], failures)
        check_iters(label, info.iters, MAIN_ITERS, failures, within=1)
    if not (np.all(np.isfinite(x64)) and true_res <= 1e-6):
        failures.append("%s: true residual %.3e > 1e-6" % (label, true_res))
    if any(plain_calls.values()):
        failures.append("%s: plain versions ran: %s" % (label, plain_calls))
    # each fused leg runs once per V-cycle at every level that carries it
    for name, attr in (("fused_down_sweep", "down"), ("fused_up_sweep", "up")):
        per_cycle = sum(getattr(lv, attr) is not None for lv in hier.levels)
        if warm[name] != per_cycle * warm_cycles:
            failures.append("%s: %s launched %d times in %d V-cycles over "
                            "%d levels" % (label, name, warm[name],
                                           warm_cycles, per_cycle))
    return solve, counts, {
        "setup_s": t_setup, "device_build_s": split["device_build_s"],
        "host_setup_s": split["host_s"], "warm_solve_s": info.wall_time_s,
        "iters": info.iters, "resid": info.resid, "true_resid": true_res,
        "warm_launches": warm, "warm_cycles": warm_cycles}


def device_build_again(A):
    """The device build once more, its kernels and the fine level's DIA
    packing already warm: what a rebuild of the same structure costs."""
    from amgcl_tpu_torch import AMGParams
    from amgcl_tpu_torch.ops import stencil_device as sdev
    t0 = time.perf_counter()
    got = sdev.device_build(A, AMGParams(dtype=torch.float32),
                            torch.device("cuda"))
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    print("device build again (warm): %.3f s for %d levels"
          % (t, len(got["levels"])))
    return t


def main_path(failures):
    from amgcl_tpu_torch import poisson3d
    t0 = time.perf_counter()
    A, rhs = poisson3d(128)
    print("problem: poisson3d(128), %d rows, %d nnz, built in %.3f s"
          % (A.nrows, A.nnz, time.perf_counter() - t0))
    # the CUDA context is created here, not inside the first setup, so
    # the two paths' setup times compare
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    print("CUDA context: %.3f s" % (time.perf_counter() - t0))
    solve, counts, summary = drive(A, rhs, failures, "main")
    summary["device_build_again_s"] = device_build_again(A)
    lv0 = solve.precond.hierarchy.levels[0]
    if not solve.precond.device_built or lv0.down is None or lv0.up is None:
        failures.append("main: the stencil levels were not built on the "
                        "device with both fused legs at level 0")
    for k in ON_PATH:
        if counts[k] == 0:
            failures.append("main: kernel %s never launched" % k)
    profile_solve(solve, rhs, summary["warm_solve_s"] * 1e3)
    summary["host_loop_mis"] = host_loop_mis(solve.precond, failures)
    # the earlier path: host setup (the greedy pass below L2), composed
    # legs; held to the JAX package's host-setup count, while the main
    # path's levels below L2 come from the device MIS
    _, earlier, e_summary = drive(A, rhs, failures, "earlier",
                                  device_setup=False, composed=True)
    print("main path %d iterations (device setup), earlier path %d (host "
          "setup)" % (summary["iters"], e_summary["iters"]))
    for k in EARLIER:
        if counts[k] == 0 and earlier[k] == 0:
            failures.append("kernel %s launched on neither path" % k)
    summary["earlier_path"] = e_summary
    summary["earlier_launches"] = earlier
    return solve, counts, summary


def host_loop_mis(amg, failures):
    """The device MIS of the main path's first host-loop level (L2), once
    more on the card and on the CPU at the eps_strong its build used: the
    same aggregates as each other and as many as the level below has
    rows. Returns the aggregate count."""
    from amgcl_tpu_torch.coarsening.device_mis import aggregates_on_device
    A2 = amg.host_levels[2][0]
    eps = 2 * amg._level_ctx[0]["eps_strong"]     # halved after its use
    (agg, n), (agg_c, n_c) = (aggregates_on_device(A2, eps, d)
                              for d in ("cuda", "cpu"))
    n_next = amg.host_levels[3][0].nrows
    print("main: L2's device MIS at eps_strong %g: %d aggregates on the "
          "card, %d on the CPU, equal: %s; L3 has %d rows"
          % (eps, n, n_c, np.array_equal(agg, agg_c), n_next))
    if not (n == n_c == n_next and np.array_equal(agg, agg_c)):
        failures.append("main: L2's MIS gives %d aggregates on the card, "
                        "%d on the CPU (equal %s), L3 %d rows"
                        % (n, n_c, np.array_equal(agg, agg_c), n_next))
    return n


def windowed_busy(label, solve, rhs, warm_s, window=None):
    """profile_solve over a whole warm solve (``window`` None), or over
    ``window`` iterations of the (outer) solver without refinement, each
    timed unprofiled first: the profiler's own processing of a long
    solve's events takes tens of seconds to minutes."""
    if window is None:
        return profile_solve(solve, rhs, warm_s * 1e3)
    bundle = getattr(solve, "inner", solve)
    kept = bundle.solver.maxiter, bundle.refine
    bundle.solver.maxiter, bundle.refine = window, 0
    try:
        _, w_info = solve(rhs)
        print("[%s] profile window: %d iterations, refine 0, %.4f s "
              "unprofiled" % (label, w_info.iters, w_info.wall_time_s))
        return profile_solve(solve, rhs, w_info.wall_time_s * 1e3)
    finally:
        bundle.solver.maxiter, bundle.refine = kept


def profile_solve(solve, rhs, warm_ms):
    """One more warm solve under torch.profiler: device time by kernel and
    the device's busy share of that solve's wall time (profiler overhead
    included in the wall). Its busy time over the unprofiled warm solve's
    wall (``warm_ms``) is printed as an estimate that combines two
    solves."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(rhs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print("profiled warm solve: no device time recorded "
              "(device busy share not measured)")
        return None
    busy = sum(r[0] for r in rows)
    print("profiled warm solve: wall %.3f ms, device busy %.3f ms (%.1f%%"
          " of the same solve's wall)" % (wall_ms, busy, 100 * busy / wall_ms))
    print("estimate over two solves: profiled busy / unprofiled warm wall "
          "%.3f ms = %.1f%%" % (warm_ms, 100 * busy / warm_ms))
    for ms, count, key in rows[:12]:
        print("  %9.3f ms %5d x  %s" % (ms, count, key[:90]))
    return busy / warm_ms


# -- phase 3: kernel against plain version, timings -------------------------

_FLUSH = None
#: device spin before each timed call, about 1 ms at the H100's clocks
_SPIN_CYCLES = 2_000_000


def time_ms(fn, reps=20, warmup=3):
    """Median device time of one call: CUDA events around each call, with
    a 512 MiB write before it that evicts the 50 MB L2, and a device spin
    before that, so that the host has enqueued the call before the device
    reaches it (a slow host then adds no idle gap to a short kernel)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(_SPIN_CYCLES)
        _FLUSH.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def live_entries(M):
    """Stored DIA entries whose column lies inside the operator: the
    multiply-adds a product needs."""
    n, m = M.shape
    return sum(max(0, min(n, m - d) - max(0, -d)) for d in M.offsets)


def bound(nbytes, ops, dtype):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def library_csr(M):
    """A DIA or windowed-ELL operator as a CUDA sparse CSR tensor of its
    stored nonzeros (the library yardstick; the port never calls it)."""
    n, m = M.shape
    if hasattr(M, "window_starts"):
        K = M.K
        cols = (M.cols_local.long() + M.window_starts.long()[:, None, None]
                ).reshape(-1, K)[:n].cpu().numpy()
        vals = M.vals.reshape(-1, K)[:n].double().cpu().numpy()
        rows = np.repeat(np.arange(n), K).reshape(n, K)
        keep = (vals != 0) & (cols < m)
    else:
        data = M.data.double().cpu().numpy()
        parts = []
        for k, d in enumerate(M.offsets):
            i = np.arange(max(0, -d), min(n, m - d))
            parts.append((i, i + d, data[k, i]))
        rows, cols, vals = (np.concatenate(a) for a in zip(*parts))
        keep = vals != 0
    C = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=(n, m))
    C.sort_indices()
    return torch.sparse_csr_tensor(
        torch.as_tensor(C.indptr, dtype=torch.int64),
        torch.as_tensor(C.indices, dtype=torch.int64),
        torch.as_tensor(C.data).to(M.dtype), size=(n, m)).to("cuda")


def compare_and_time(name, kern, plain, args, rtol, scale, dot_terms, lib,
                     nbytes, ops, dtype):
    """Run a kernel and its plain version on the same operands, then time
    both and, where there is one, the library call. They agree when every
    vector entry is within rtol · scale and every dot j within
    rtol · Σ|a b| for each (j, a, b) that ``dot_terms(want)`` lists (the
    sums run in another order). Returns the record fields and ``ok``."""
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g - p_).abs().max())
              for g, p_ in zip(got, want)
              if g is not None and g.dim() == 1)
    ok = err <= rtol * scale
    dot_err = 0.0
    for j, a, b in dot_terms(want):
        g, p_ = float(got[j]), float(want[j])
        mag = float((a.double() * b.double()).abs().sum())
        dot_err = max(dot_err, abs(g - p_) / mag)
        ok = ok and abs(g - p_) <= rtol * mag
    ms = time_ms(lambda: kern(*args))
    plain_ms = time_ms(lambda: plain(*args))
    lib_ms = None
    if lib is not None:
        try:
            lib_ms = time_ms(lib)
        except RuntimeError as e:      # a yardstick, not the port
            print("library call for %s unavailable: %s"
                  % (name, str(e).splitlines()[0]))
    b_ms, b_by = bound(nbytes, ops, dtype)
    return {"max_abs_err": err, "dot_rel_err": dot_err, "ok": ok, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def ordered_dots_hold(kern, args, x):
    """Whether a DIA dot kernel's dots equal, bit for bit, the first
    design's summation order (``dia_kernels.ordered_dot``) applied to its
    own output y (or r) and x."""
    from amgcl_tpu_torch.ops import dia_kernels as dk
    out = kern(*args)
    y = out[0].cpu().numpy()
    pairs = [(out[1], y)] + ([(out[2], x.cpu().numpy())]
                             if len(out) > 2 else [])
    ok = all(float(d).hex() == float(dk.ordered_dot(y, b)).hex()
             for d, b in pairs)
    print("%-22s dots bit for bit with the first design's order: %s"
          % (kern.__name__, "ok" if ok else "FAIL"))
    return ok


def ordered_tail_dots_hold(kern, args, at, rhat=None):
    """Whether a tail kernel's dots, the entries of its output after
    ``at``, equal, bit for bit, the tails' summation order
    (``fused_vec.ordered_tail_dots``) applied to its own r' (or z), the
    entry ``at``, and r̂."""
    from amgcl_tpu_torch.ops import fused_vec as fv
    out = kern(*args)
    want = fv.ordered_tail_dots(out[at].cpu().numpy(), None if rhat is None
                                else rhat.cpu().numpy())
    ok = [float(d).hex() for d in out[at + 1:]] \
        == [float(w).hex() for w in want]
    print("%-22s dots bit for bit with the tails' order: %s"
          % (kern.__name__, "ok" if ok else "FAIL"))
    return ok


def check_kernels(solve, failures):
    from amgcl_tpu_torch.ops import device as dev
    hier = solve.precond.hierarchy
    L = hier.levels
    rng = np.random.RandomState(20261016)

    def vec(n, dtype):
        return torch.as_tensor(rng.standard_normal(n)).to(
            device="cuda", dtype=dtype)

    def absprod(M, x):
        """|A| |x|, entry by entry: the size of the product's terms."""
        return dev.DiaMatrix(M.offsets, M.data.abs(), M.shape).mv(x.abs())

    W = wrappers()
    cases = [
        # (kernel, label, operator)
        ("dia_spmv", "L0 A", L[0].A), ("dia_spmv", "L1 A", L[1].A),
        ("dia_residual", "L0 A", L[0].A), ("dia_residual", "L1 A", L[1].A),
        ("dia_residual", "L2 A", L[2].A),
        ("dia_residual", "L0 M", L[0].P.M),
        ("dia_residual", "L0 Mt", L[0].R.Mt),
        ("dia_residual", "L1 Mt", L[1].R.Mt),
        ("dia_residual", "L0 A f64", solve.A_dev64),
        ("dia_scaled_correction", "L0 A", L[0].A),
        ("dia_scaled_correction", "L1 A", L[1].A),
        ("dia_spmv_dots", "L0 A", L[0].A),
        ("dia_residual_dot", "L0 A", L[0].A),
        ("xr_update", "L0 n", L[0].A),
    ]
    records = {}
    # the correction's weights are the level's own SPAI-0 scale
    weights = {"L0 A": L[0].relax.scale, "L1 A": L[1].relax.scale}
    for name, label, M in cases:
        kern, plain = W[name]
        dt = M.dtype
        n, m = M.shape
        s = M.data.element_size()
        x, f = vec(m, dt), vec(n, dt)
        off = M.offsets_t
        live = live_entries(M)
        ax = absprod(M, x)
        # |Δ| ≤ rtol · (the largest sum of |terms| of one output entry)
        scale = float((ax + f.abs()).max())
        rtol = 1e-5 if dt == torch.float32 else 1e-12
        dots = lambda want: []
        lib = None
        if name == "dia_spmv":
            args = (off, M.data, x)
            nbytes, ops = (M.data.numel() + m + n) * s, 2 * live
            scale = float(ax.max())
            C = library_csr(M)
            lib = lambda: torch.mv(C, x)
        elif name == "dia_residual":
            args = (off, M.data, f, x)
            nbytes, ops = (M.data.numel() + m + 2 * n) * s, 2 * live
            C = library_csr(M)
            lib = lambda: torch.addmv(f, C, x, alpha=-1.0)
        elif name == "dia_scaled_correction":
            w = weights[label]
            args = (off, M.data, w, f, x)
            nbytes, ops = (M.data.numel() + m + 3 * n) * s, 2 * live + 2 * n
            scale = float((w.abs() * (ax + f.abs()) + x.abs()).max())
        elif name == "dia_spmv_dots":
            # host offsets, as the main path passes them
            args = (M.offsets, M.data, x)
            nbytes, ops = (M.data.numel() + m + n) * s, 2 * live + 4 * n
            scale = float(ax.max())
            dots = lambda want: [(1, want[0], want[0]), (2, want[0], x)]
        elif name == "dia_residual_dot":
            args = (M.offsets, M.data, f, x)
            nbytes, ops = (M.data.numel() + m + 2 * n) * s, 2 * live + 2 * n
            dots = lambda want: [(1, want[0], want[0])]
        else:                                       # xr_update
            p, q = vec(n, dt), vec(n, dt)
            alpha = torch.tensor(0.37, dtype=dt, device="cuda")
            args = (alpha, p, q, x, f)
            nbytes, ops = 6 * n * s, 6 * n
            scale = float(x.abs().max() + f.abs().max()
                          + 0.37 * (p.abs().max() + q.abs().max()))
            dots = lambda want: [(2, want[1], want[1])]
        r = compare_and_time(name, kern, plain, args, rtol, scale, dots, lib,
                             nbytes, ops, dt)
        print("%-22s %-9s n=%-8d ndiag=%-4d %s  err %.3e (tol %.3e)  "
              "dot rel err %.2e  ms %.4f  plain %.4f  library %s  "
              "bound %.4f (%s)  %s"
              % (name, label, n, len(M.offsets), str(dt).split(".")[-1],
                 r["max_abs_err"], rtol * scale, r["dot_rel_err"], r["ms"],
                 r["plain_ms"], "%.4f" % r["library_ms"]
                 if r["library_ms"] is not None else "none",
                 r["bound_ms"], r["bound_by"], "ok" if r["ok"] else "FAIL"))
        if not r["ok"]:
            failures.append("%s %s disagrees with its plain version"
                            % (name, label))
        if name in ("dia_spmv_dots", "dia_residual_dot") \
                and not ordered_dots_hold(kern, args, x):
            failures.append("%s %s: dots differ from the first design's "
                            "order on its own output" % (name, label))
        if name not in records:      # the first case is the L0 shape
            records[name] = {k: r[k] for k in RECORD_KEYS}
            records[name]["shape"] = (
                "n=%d, %s" % (n, dt) if name == "xr_update" else
                "%s %dx%d, %d diagonals, %s"
                % (label, n, m, len(M.offsets), dt))
    return records


def check_fused(solve, failures):
    """The fused legs against their plain versions on the hierarchy's own
    L0 and L1 operators (down in zero-guess mode, the main path's, and in
    base mode; up), timed beside the plain version, the bound and the
    chain of earlier kernels each leg replaces."""
    from amgcl_tpu_torch.ops import device as dev
    from amgcl_tpu_torch.ops import vcycle_kernels as vk
    L = solve.precond.hierarchy.levels
    rng = np.random.RandomState(20261017)
    rtol = 1e-5
    records = {}

    def vec(n):
        return torch.as_tensor(rng.standard_normal(n)).to(
            device="cuda", dtype=torch.float32)

    for i in (0, 1):
        lv = L[i]
        A, M, Mt, w, T = lv.A, lv.P.M, lv.R.Mt, lv.relax.scale, lv.R.T
        dims, (n, nc) = T.fine, T.shape
        f, u, uc = vec(n), vec(n), vec(nc)
        s = A.data.element_size()
        for mode in ("zero", "base", "up"):
            if mode == "up":
                name = "fused_up_sweep"
                # the offsets as host ints, as the main path passes them
                args = (A.offsets, A.data, M.offsets, M.data, w, f, u, uc,
                        dims)
                tile = vk.up_tile(A.offsets, M.offsets, dims)
                # Σ|terms| of each entry: the plain version on |operands|
                # with the operators negated, so every subtraction adds
                terms = vk.fused_up_sweep_plain(
                    A.offsets_t, -A.data.abs(), M.offsets_t, -M.data.abs(),
                    w.abs(), f.abs(), u.abs(), uc.abs(), dims)

                def composed():
                    return lv.relax.apply_post(A, f, u + lv.P.mv(uc))
                nbytes = (A.data.numel() + M.data.numel() + 4 * n + nc) * s
                ops = 2 * (live_entries(A) + live_entries(M)) + 4 * n
                ops_name = "M"
            else:
                name = "fused_down_sweep"
                zero = mode == "zero"
                x = w if zero else u
                # the offsets as host ints, as the main path passes them
                args = (A.offsets, A.data, Mt.offsets, Mt.data, f, x, dims,
                        zero)
                tile = vk.down_tile(A.offsets, Mt.offsets, dims)
                terms = vk.fused_down_sweep_plain(
                    A.offsets_t, -A.data.abs(), Mt.offsets_t,
                    -Mt.data.abs(), f.abs(), x.abs(), dims, zero)

                def composed():
                    ui = lv.relax.apply(A, f) if zero else u
                    return lv.R.mv(dev.residual(f, A, ui))
                nbytes = (A.data.numel() + Mt.data.numel() + 2 * n + nc
                          + (n if zero else 0)) * s
                ops = 2 * (live_entries(A) + live_entries(Mt)) + n \
                    + (n if zero else 0)
                ops_name = "Mt"
            kern, plain = wrappers()[name]
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            pairs = list(zip(*(v if isinstance(v, tuple) else (v,)
                               for v in (got, want, terms))))
            err = max(float((g - p_).abs().max()) for g, p_, _ in pairs)
            ratio = max(float(((g - p_).abs() / t.clamp_min(1e-30)).max())
                        for g, p_, t in pairs)
            ok = all(bool(((g - p_).abs() <= rtol * t).all())
                     for g, p_, t in pairs)
            ms = time_ms(lambda: kern(*args))
            plain_ms = time_ms(lambda: plain(*args))
            composed_ms = time_ms(composed)
            b_ms, b_by = bound(nbytes, ops, torch.float32)
            label = "L%d %s" % (i, mode)
            print("%-22s %-8s n=%-8d nA=%-3d n%s=%-3d float32  err %.3e "
                  "(max |err|/Σ|terms| %.2e, tol %.0e)  ms %.4f  plain %.4f"
                  "  composed %.4f  bound %.4f (%s, %.1f MB)%s  %s"
                  % (name, label, n, len(A.offsets), ops_name,
                     len(M.offsets if mode == "up" else Mt.offsets), err,
                     ratio, rtol, ms, plain_ms, composed_ms, b_ms, b_by,
                     nbytes / 1e6, "  tile %s" % (tile,),
                     "ok" if ok else "FAIL"))
            if not ok:
                failures.append("%s %s disagrees with its plain version"
                                % (name, label))
            if name not in records:   # the first case: L0, main-path mode
                records[name] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "composed_ms": composed_ms,
                    "shape": "%s, fine %s, %d + %d diagonals, float32"
                             % (label, "x".join(map(str, dims)),
                                len(A.offsets), len(M.offsets if mode == "up"
                                                    else Mt.offsets))}
    return records


# -- phase 4: the unstructured paths -----------------------------------------

def describe_levels(label, solve):
    """Per level: rows, format, K, window and distinct window starts, and
    the K of the transfers' M and Mᵀ. Returns the rows and formats."""
    rows, fmts = [], []
    for i, lv in enumerate(solve.precond.hierarchy.levels):
        A = lv.A
        rows.append(A.shape[0])
        fmts.append(type(A).__name__)
        extra = ""
        if hasattr(A, "window_starts"):
            extra = ", K %d, window %d, %d distinct window starts" % (
                A.K, A.win, len(set(A.window_starts.tolist())))
        if lv.P is not None:
            extra += "; M %s K %s, Mt %s K %s" % (
                type(lv.P.M).__name__, getattr(lv.P.M, "K", "-"),
                type(lv.R.Mt).__name__, getattr(lv.R.Mt, "K", "-"))
        print("[%s] level %d: %d rows, %s%s" % (label, i, A.shape[0],
                                                 fmts[-1], extra))
    return rows, fmts


def solve_cold_warm(A, rhs, label, solver, refine, make_kw=None, **params):
    """make_solver with a float32 hierarchy (AMGParams ``params`` beside
    the dtype; make_solver's keywords ``make_kw``) and ``solver``, then a
    cold and a warm solve, the counts set to 0 just before the setup and
    read just after the warm solve. Returns (solve, x, info, counts,
    plain_calls, warm_launches, setup_s)."""
    from amgcl_tpu_torch import AMGParams, make_solver
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    solve = make_solver(A, AMGParams(dtype=torch.float32, **params), solver,
                        refine=refine, **(make_kw or {}))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    print("[%s] setup: %.3f s wall (make_solver), %.3f s in AMG._build; "
          "peak device memory %.1f MB above the %.1f MB held before it"
          % (label, t_setup, solve.precond.setup_seconds,
             (torch.cuda.max_memory_allocated() - base) / 2**20,
             base / 2**20))
    x, info = solve(rhs)
    print("[%s] solve 1 (cold): %d iterations, reported resid %.3e, %.4f s"
          % (label, info.iters, info.resid, info.wall_time_s))
    first, _ = read_counts()
    x, info = solve(rhs)
    counts, plain_calls = read_counts()
    print("[%s] solve 2 (warm): %d iterations, reported resid %.3e, %.4f s; "
          "peak device memory over setup and both solves %.1f MB above the "
          "%.1f MB held before" % (
              label, info.iters, info.resid, info.wall_time_s,
              (torch.cuda.max_memory_allocated() - base) / 2**20,
              base / 2**20))
    warm = {k: counts[k] - first[k] for k in counts if counts[k]}
    print("[%s] launches (setup + 2 solves): %s"
          % (label, json.dumps({k: v for k, v in counts.items() if v})))
    print("[%s] launches in the warm solve: %s; per iteration: %s"
          % (label, json.dumps(warm), json.dumps(
              {k: round(v / max(info.iters, 1), 3) for k, v in warm.items()})))
    print("[%s] plain-version calls: %s"
          % (label, sum(plain_calls.values())))
    return solve, x, info, counts, plain_calls, warm, t_setup


def drive_unstructured(A, rhs, failures, label, side):
    """make_solver with BiCGStab, solved cold and warm (solve_cold_warm).
    Returns (solve, counts, summary)."""
    from amgcl_tpu_torch import BiCGStab
    solve, x, info, counts, plain_calls, warm, t_setup = solve_cold_warm(
        A, rhs, label, BiCGStab(maxiter=100, tol=1e-6, precond_side=side),
        3)
    print(solve.precond)
    rows, fmts = describe_levels(label, solve)
    x64 = x.double().cpu().numpy()
    true_res = float(np.linalg.norm(rhs - A.spmv(x64))
                     / np.linalg.norm(rhs))
    print("[%s] true relative residual (host float64): %.3e"
          % (label, true_res))
    check_levels(label, rows, fmts, U_LEVELS[label], U_FORMATS, failures)
    check_iters(label, info.iters, U_ITERS[label], failures, rel=0.1)
    if not (np.all(np.isfinite(x64)) and true_res <= 1e-6):
        failures.append("%s: true residual %.3e > 1e-6" % (label, true_res))
    if any(plain_calls.values()):
        failures.append("%s: plain versions ran: %s" % (label, plain_calls))
    return solve, counts, {
        "setup_s": t_setup, "warm_solve_s": info.wall_time_s,
        "iters": info.iters, "resid": info.resid, "true_resid": true_res,
        "levels": rows, "warm_launches": warm}


def unstructured_paths(failures):
    """Paths U1 (identity order, right side) and U2 (RCM order, left
    side) of the tutorial deployment. Returns ({label: solve},
    {label: counts}, summary, (A, rhs, perm)): the problem and U2's RCM
    permutation, which D2 and K1 reuse."""
    from amgcl_tpu_torch import fe_like_problem
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    t0 = time.perf_counter()
    A, rhs = fe_like_problem()
    print("problem: fe_like_problem(), %d rows, %d nnz, built in %.3f s"
          % (A.nrows, A.nnz, time.perf_counter() - t0))
    solves, counts, summary = {}, {}, {}
    solves["U1"], counts["U1"], summary["U1"] = drive_unstructured(
        A, rhs, failures, "U1", "right")
    profile_solve(solves["U1"], rhs, summary["U1"]["warm_solve_s"] * 1e3)
    t0 = time.perf_counter()
    perm = cuthill_mckee(A)
    Ap, rhs_p = permute(A, perm), rhs[perm]
    print("[U2] RCM permutation: %.3f s" % (time.perf_counter() - t0))
    solves["U2"], counts["U2"], summary["U2"] = drive_unstructured(
        Ap, rhs_p, failures, "U2", "left")
    for k in UNSTRUCTURED:
        if counts["U1"][k] + counts["U2"][k] == 0:
            failures.append("kernel %s launched on neither U1 nor U2" % k)
    if counts["U2"]["windowed_ell_spmv"] == 0:
        failures.append("U2: windowed_ell_spmv never launched")
    return solves, counts, summary, (A, rhs, perm)


def check_unstructured_kernels(solves, failures):
    """Each windowed-ELL kernel and the BiCGStab tail against its plain
    version at the L0 and L1 operators and transfers of both orders,
    timed as in check_kernels. |Δ| ≤ rtol · Σ|terms| per entry (rtol 1e-5
    in float32, 1e-12 in float64: the sums run in another order); each
    dot within rtol of the sum of its absolute products. The first case
    of a kernel is its record: the L0 shape of the path it runs on."""
    from amgcl_tpu_torch.ops import well_kernels as wk
    W = wrappers()
    rng = np.random.RandomState(20261018)
    L1, L2 = solves["U1"].precond.hierarchy.levels, \
        solves["U2"].precond.hierarchy.levels
    cases = [
        # (kernel, label, operator, smoother scale)
        ("windowed_ell_spmv", "U2 L0 A", L2[0].A, None),
        ("windowed_ell_spmv", "U1 L0 A", L1[0].A, None),
        ("windowed_ell_spmv", "U2 L1 A", L2[1].A, None),
        ("windowed_ell_residual", "U1 L0 A", L1[0].A, None),
        ("windowed_ell_residual", "U1 L1 A", L1[1].A, None),
        ("windowed_ell_residual", "U1 L0 M", L1[0].P.M, None),
        ("windowed_ell_residual", "U1 L0 Mt", L1[0].R.Mt, None),
        ("windowed_ell_residual", "U1 L1 M", L1[1].P.M, None),
        ("windowed_ell_residual", "U1 L1 Mt", L1[1].R.Mt, None),
        ("windowed_ell_residual", "U2 L0 A", L2[0].A, None),
        ("windowed_ell_residual", "U2 L1 A", L2[1].A, None),
        ("windowed_ell_residual", "U2 L0 M", L2[0].P.M, None),
        ("windowed_ell_residual", "U2 L0 Mt", L2[0].R.Mt, None),
        ("windowed_ell_residual", "U2 L1 Mt", L2[1].R.Mt, None),
        ("windowed_ell_residual", "U1 L0 A f64", solves["U1"].A_dev64, None),
        ("windowed_ell_residual", "U2 L0 A f64", solves["U2"].A_dev64, None),
        ("windowed_ell_scaled_correction", "U1 L0 A", L1[0].A,
         L1[0].relax.scale),
        ("windowed_ell_scaled_correction", "U1 L1 A", L1[1].A,
         L1[1].relax.scale),
        ("windowed_ell_scaled_correction", "U2 L0 A", L2[0].A,
         L2[0].relax.scale),
        ("windowed_ell_scaled_correction", "U2 L1 A", L2[1].A,
         L2[1].relax.scale),
        ("windowed_ell_spmv_dots", "U1 L0 A w", L1[0].A, None),
        ("windowed_ell_spmv_dots", "U1 L0 A", L1[0].A, None),
        ("windowed_ell_spmv_dots", "U2 L0 A w", L2[0].A, None),
        ("windowed_ell_spmv_dots", "U1 L0 A f64 w", solves["U1"].A_dev64,
         None),
        ("bicgstab_tail", "U1 L0 n", L1[0].A, None),
    ]
    records = {}
    for name, label, M, scale_w in cases:
        kern, plain = W[name]
        dt = M.dtype
        n, m = M.shape
        s = M.vals.element_size()

        def vec(k):
            return torch.as_tensor(rng.standard_normal(k)).to(
                device="cuda", dtype=dt)
        x, f = vec(m), vec(n)
        geo = (M.window_starts, M.cols_local, M.vals)
        # the rows the kernel reads: n of the n_tiles·1,024 stored (the
        # last tile's padding rows are never read)
        fmt_bytes = n * M.K * (s + 4) + M.window_starts.numel() * 4
        nnz = int((M.vals != 0).sum())
        terms = wk.windowed_ell_spmv_plain(M.window_starts, M.cols_local,
                                           M.vals.abs(), x.abs(), n)
        rtol = 1e-5 if dt == torch.float32 else 1e-12
        scale = float((terms + f.abs()).max())
        # each y entry's own error is bounded by its terms, and so are
        # the dots'
        dots = lambda want: []
        lib = None
        if name == "windowed_ell_spmv":
            args = geo + (x, n)
            nbytes, ops = fmt_bytes + (m + n) * s, 2 * nnz
            scale = float(terms.max())
            C = library_csr(M)
            lib = lambda: torch.mv(C, x)
        elif name == "windowed_ell_residual":
            args = geo + (f, x, n)
            nbytes, ops = fmt_bytes + (m + 2 * n) * s, 2 * nnz + n
            C = library_csr(M)
            lib = lambda: torch.addmv(f, C, x, alpha=-1.0)
        elif name == "windowed_ell_scaled_correction":
            w = scale_w
            args = geo + (w, f, x, n)
            nbytes, ops = fmt_bytes + (m + 3 * n) * s, 2 * nnz + 3 * n
            scale = float((w.abs() * (terms + f.abs()) + x.abs()).max())
        elif name == "windowed_ell_spmv_dots":
            w = vec(n) if label.endswith(" w") else None
            args = geo + (x, w, n)
            nbytes = fmt_bytes + (m + n + (n if w is not None else 0)) * s
            ops = 2 * nnz + (6 if w is not None else 4) * n
            scale = float(terms.max())
            dots = lambda want: [(1, terms, 2 * terms), (2, terms, x)] + (
                [] if w is None else [(3, terms, w)])
        else:                                       # bicgstab_tail
            ph, sh, t, rh = vec(n), vec(n), vec(n), vec(n)
            alpha = torch.tensor(0.37, dtype=dt, device="cuda")
            omega = torch.tensor(-1.3, dtype=dt, device="cuda")
            args = (alpha, ph, omega, sh, f, t, x, rh)
            nbytes, ops = 8 * n * s, 10 * n
            scale = float(x.abs().max() + f.abs().max() + 1.3 * (
                ph.abs().max() + sh.abs().max() + t.abs().max()))
            # r' = s − ω t may cancel: the dots scale with |s| + |ω t|
            rn_terms = f.abs() + 1.3 * t.abs()
            dots = lambda want: [(2, rn_terms, 2 * rn_terms),
                                 (3, rh, rn_terms)]
        r = compare_and_time(name, kern, plain, args, rtol, scale, dots, lib,
                             nbytes, ops, dt)
        print("%-30s %-13s n=%-6d K=%-3d win=%-6d %s  err %.3e (tol %.3e)  "
              "dot rel err %.2e  ms %.4f  plain %.4f  library %s  "
              "bound %.4f (%s, %.2f MB)  %s"
              % (name, label, n, M.K, M.win, str(dt).split(".")[-1],
                 r["max_abs_err"], rtol * scale, r["dot_rel_err"], r["ms"],
                 r["plain_ms"], "%.4f" % r["library_ms"]
                 if r["library_ms"] is not None else "none",
                 r["bound_ms"], r["bound_by"], nbytes / 1e6,
                 "ok" if r["ok"] else "FAIL"))
        if not r["ok"]:
            failures.append("%s %s disagrees with its plain version"
                            % (name, label))
        if name == "bicgstab_tail" \
                and not ordered_tail_dots_hold(kern, args, 1, rh):
            failures.append("bicgstab_tail %s: dots differ from the tails' "
                            "order on its own output" % label)
        if name not in records:
            records[name] = {k: r[k] for k in RECORD_KEYS}
            records[name]["shape"] = (
                "n=%d, %s" % (n, dt) if name == "bicgstab_tail" else
                "%s %dx%d, K %d, window %d, %s"
                % (label, n, m, M.K, M.win, dt))
        elif label == "U1 L0 A" and name == "windowed_ell_spmv":
            # U1's L0 beside the record's U2 L0: the same K, x gathered
            # from a window of the whole matrix
            records[name]["U1 L0"] = {k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms")}
    return records


# -- phase 5: the block path ---------------------------------------------------

def describe_block_levels(solve):
    """Per level: block rows, and for A, P and R the format, block, K and
    window. Returns False unless every one is a 3×3 block windowed ELL."""
    ok = True
    for i, lv in enumerate(solve.precond.hierarchy.levels):
        parts = []
        for tag, M in (("A", lv.A), ("P", lv.P), ("R", lv.R)):
            if M is None:
                continue
            block = getattr(M, "block", None)
            ok = ok and type(M).__name__ == "WindowedEllMatrix" \
                and block == (3, 3)
            parts.append("%s %s %dx%d block %s K %s window %s" % (
                tag, type(M).__name__, M.shape[0], M.shape[1], block,
                getattr(M, "K", "-"), getattr(M, "win", "-")))
        print("[B1] level %d: %s" % (i, "; ".join(parts)))
    return ok


def block_path(failures):
    """Path B1: the block configuration of the benchmark, cold and warm,
    then the same system with refine=3. Returns (solve, refined solve,
    counts, summary)."""
    from amgcl_tpu_torch import BiCGStab, poisson3d_block
    t0 = time.perf_counter()
    A, rhs = poisson3d_block(48, 3)
    print("problem: poisson3d_block(48, 3), %d block rows, %d unknowns, "
          "%d stored 3x3 blocks, built in %.3f s"
          % (A.nrows, A.nrows * 3, A.nnz, time.perf_counter() - t0))
    S = A.to_scipy()
    solve, x, info, counts, plain_calls, warm, t_setup = solve_cold_warm(
        A, rhs, "B1", BiCGStab(maxiter=200, tol=1e-6), 0)
    print(solve.precond)
    all_well = describe_block_levels(solve)
    x64 = x.double().cpu().numpy()
    nb = np.linalg.norm(rhs)
    true_res = float(np.linalg.norm(rhs - S @ x64) / nb)
    floor = 2.0 ** -24 * float(np.linalg.norm(abs(S) @ np.abs(x64)) / nb)
    print("[B1] true relative residual (host float64): %.3e; limit 1e-6 + "
          "2u·‖|A||x|‖/‖b‖ = %.3e" % (true_res, 1e-6 + 2 * floor))
    rows = [lv.A.shape[0] for lv in solve.precond.hierarchy.levels]
    if not all_well:
        failures.append("B1: not every level a 3x3 block windowed ELL")
    check_levels("B1", rows, [], B1_LEVELS, [], failures)
    check_iters("B1", info.iters, B1_ITERS, failures, within=1)
    if not (np.all(np.isfinite(x64)) and info.resid <= 1e-6
            and true_res <= 1e-6 + 2 * floor):
        failures.append("B1: reported residual %.3e, true %.3e (limits "
                        "1e-6, %.3e)" % (info.resid, true_res,
                                         1e-6 + 2 * floor))
    if any(plain_calls.values()):
        failures.append("B1: plain versions ran: %s" % plain_calls)
    for k in BLOCK:
        if counts[k] == 0:
            failures.append("B1: kernel %s never launched" % k)
    profile_solve(solve, rhs, info.wall_time_s * 1e3)
    summary = {"setup_s": t_setup, "warm_solve_s": info.wall_time_s,
               "iters": info.iters, "resid": info.resid,
               "true_resid": true_res, "levels": rows,
               "warm_launches": warm}
    # the float64 refinement: the outer residual on a float64 block
    # windowed ELL, the true residual to 1e-6
    refined, xr, info_r, counts_r, plain_r, _, _ = solve_cold_warm(
        A, rhs, "B1 refine=3", BiCGStab(maxiter=200, tol=1e-6), 3)
    tr = float(np.linalg.norm(rhs - S @ xr.double().cpu().numpy()) / nb)
    print("[B1 refine=3] true relative residual (host float64): %.3e" % tr)
    a64 = refined.A_dev64
    if not (getattr(a64, "block", None) == (3, 3)
            and a64.dtype == torch.float64 and tr <= 1e-6
            and counts_r["windowed_ell_block_residual"] > 0
            and not any(plain_r.values())):
        failures.append("B1 refine=3: true residual %.3e, A_dev64 %s, "
                        "plain calls %s" % (tr, type(a64).__name__,
                                            sum(plain_r.values())))
    check_iters("B1 refine=3", info_r.iters, B1_ITERS_REFINED, failures,
                within=2)
    summary["refined"] = {"iters": info_r.iters, "true_resid": tr,
                          "warm_solve_s": info_r.wall_time_s}
    return solve, refined, counts, summary


def library_block(M):
    """A block windowed-ELL operator as a CUDA sparse tensor of its stored
    blocks: torch's BSR (cuSPARSE bsrmv), built directly from the blocks,
    where torch's product takes it, else CSR of the unblocked matrix.
    Returns (tensor, kind); the port never calls it."""
    n, m = M.shape
    b, K = M.block[0], M.K
    cols = (M.cols_local.long() + M.window_starts.long()[:, None, None]
            ).reshape(-1, K)[:n].cpu().numpy()
    vals = M.vals.reshape(-1, K, b, b)[:n].cpu().numpy()
    keep = (cols < m) & np.any(vals != 0, axis=(2, 3))
    rows = np.repeat(np.arange(n), K).reshape(n, K)[keep]
    order = np.lexsort((cols[keep], rows))
    cols, vals = cols[keep][order], vals[keep][order]
    ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device="cuda")
    bsr = torch.sparse_bsr_tensor(
        idx(ptr), idx(cols), torch.as_tensor(vals, device="cuda"),
        size=(n * b, m * b))
    try:
        x = torch.ones(m * b, dtype=M.dtype, device="cuda")
        torch.mv(bsr, x)
        torch.addmv(torch.ones(n * b, dtype=M.dtype, device="cuda"), bsr, x,
                    alpha=-1.0)
        torch.cuda.synchronize()
        return bsr, "BSR"
    except RuntimeError as e:      # a yardstick, not the port
        print("torch BSR product unavailable for %dx%d nodes of %dx%d: %s; "
              "using CSR" % (n, m, b, b, str(e).splitlines()[0]))
    C = sp.bsr_matrix((vals, cols, ptr), shape=(n * b, m * b)).tocsr()
    C.sort_indices()
    return torch.sparse_csr_tensor(
        idx(C.indptr), idx(C.indices), torch.as_tensor(C.data, device="cuda"),
        size=C.shape), "CSR"


def check_block_kernels(solve, refined, failures):
    """Each block kernel mode against its plain version at L0 A, P, R
    and L1 A (the square modes at L0 A and L1 A), in float32, and at L0 A
    in float64, and each mode on L0 A's structure with random blocks,
    timed as in check_kernels. |Δ| ≤ rtol · Σ|terms| per
    entry (rtol 1e-5 in float32, 1e-12 in float64); each dot within rtol
    of the sum of its absolute products. The first case of a kernel is
    its record: the L0 operator it runs on in a V-cycle."""
    from amgcl_tpu_torch.ops import well_block_kernels as wbk
    W = wrappers()
    rng = np.random.RandomState(20261019)
    L = solve.precond.hierarchy.levels
    a64 = refined.A_dev64
    # B1's blocks and SPAI-0 scales are symmetric, so a kernel that read
    # a block or a scale transposed would agree on them: L0 A's structure
    # with random blocks, and a random scale
    A0 = L[0].A
    rand_vals = torch.as_tensor(rng.standard_normal(tuple(A0.vals.shape))
                                ).to(A0.vals) * (A0.vals != 0)
    A0_rand = type(A0)(A0.window_starts, A0.cols_local, rand_vals, A0.shape,
                       A0.win, A0.block)
    S_rand = torch.as_tensor(rng.standard_normal((A0.shape[0], 3, 3))
                             ).to(A0.vals)
    cases = [
        # (kernel, label, operator, smoother scale)
        ("windowed_ell_block_spmv", "B1 L0 P", L[0].P, None),
        ("windowed_ell_block_spmv", "L0 A random", A0_rand, None),
        ("windowed_ell_block_spmv", "B1 L0 R", L[0].R, None),
        ("windowed_ell_block_spmv", "B1 L0 A", L[0].A, None),
        ("windowed_ell_block_spmv", "B1 L1 A", L[1].A, None),
        ("windowed_ell_block_spmv", "B1 L0 A f64", a64, None),
        ("windowed_ell_block_residual", "B1 L0 A", L[0].A, None),
        ("windowed_ell_block_residual", "L0 A random", A0_rand, None),
        ("windowed_ell_block_residual", "B1 L0 P", L[0].P, None),
        ("windowed_ell_block_residual", "B1 L0 R", L[0].R, None),
        ("windowed_ell_block_residual", "B1 L1 A", L[1].A, None),
        ("windowed_ell_block_residual", "B1 L0 A f64", a64, None),
        ("windowed_ell_block_scaled_correction", "B1 L0 A", L[0].A,
         L[0].relax.scale),
        ("windowed_ell_block_scaled_correction", "L0 A random", A0_rand,
         S_rand),
        ("windowed_ell_block_scaled_correction", "B1 L1 A", L[1].A,
         L[1].relax.scale),
        ("windowed_ell_block_scaled_correction", "B1 L0 A f64", a64,
         L[0].relax.scale.double()),
        ("windowed_ell_block_spmv_dots", "B1 L0 A w", L[0].A, None),
        ("windowed_ell_block_spmv_dots", "L0 A random w", A0_rand, None),
        ("windowed_ell_block_spmv_dots", "B1 L0 A", L[0].A, None),
        ("windowed_ell_block_spmv_dots", "B1 L1 A w", L[1].A, None),
        ("windowed_ell_block_spmv_dots", "B1 L0 A f64 w", a64, None),
    ]
    records = {}
    for name, label, M, S in cases:
        kern, plain = W[name]
        dt = M.dtype
        n, m = M.shape
        b = M.block[0]
        s = M.vals.element_size()

        def vec(k):
            return torch.as_tensor(rng.standard_normal(k)).to(
                device="cuda", dtype=dt)
        x, f = vec(m * b), vec(n * b)
        geo = (M.window_starts, M.cols_local, M.vals)
        # the nodes the kernel reads: n of the n_tiles·1,024 stored
        fmt_bytes = n * M.K * (4 + b * b * s) + M.window_starts.numel() * 4
        nnz = int(((M.vals != 0).flatten(3).any(-1)
                   & (M.cols_local.long() + M.window_starts.long()[
                       :, None, None] < m)).sum())
        terms = wbk.windowed_ell_block_spmv_plain(
            M.window_starts, M.cols_local, M.vals.abs(), x.abs(), n)
        rtol = 1e-5 if dt == torch.float32 else 1e-12
        scale = float((terms + f.abs()).max())
        dots = lambda want: []
        lib, kind = None, None
        vec_in, vec_out = m * b * s, n * b * s
        if name == "windowed_ell_block_spmv":
            args = geo + (x, n)
            nbytes, ops = fmt_bytes + vec_in + vec_out, 2 * nnz * b * b
            scale = float(terms.max())
            C, kind = library_block(M)
            lib = lambda: torch.mv(C, x)
        elif name == "windowed_ell_block_residual":
            args = geo + (f, x, n)
            nbytes = fmt_bytes + vec_in + 2 * vec_out
            ops = 2 * nnz * b * b + n * b
            C, kind = library_block(M)
            lib = lambda: torch.addmv(f, C, x, alpha=-1.0)
        elif name == "windowed_ell_block_scaled_correction":
            args = geo + (S, f, x, n)
            nbytes = fmt_bytes + vec_in + 2 * vec_out + n * b * b * s
            ops = 2 * nnz * b * b + n * b + 2 * n * b * b + n * b
            corr = torch.einsum("nij,nj->ni", S.abs(),
                                (terms + f.abs()).reshape(-1, b))
            scale = float((corr.reshape(-1) + x.abs()).max())
        else:
            w = vec(n * b) if label.endswith(" w") else None
            args = geo + (x, w, n)
            nbytes = fmt_bytes + vec_in + vec_out \
                + (vec_out if w is not None else 0)
            ops = 2 * nnz * b * b + (6 if w is not None else 4) * n * b
            scale = float(terms.max())
            dots = lambda want: [(1, terms, 2 * terms), (2, terms, x)] + (
                [] if w is None else [(3, terms, w)])
        r = compare_and_time(name, kern, plain, args, rtol, scale, dots, lib,
                             nbytes, ops, dt)
        print("%-36s %-13s n=%-6d m=%-6d K=%-3d win=%-6d %s  err %.3e (tol "
              "%.3e)  dot rel err %.2e  ms %.4f  plain %.4f  library %s  "
              "bound %.4f (%s, %.2f MB)  %s"
              % (name, label, n, m, M.K, M.win, str(dt).split(".")[-1],
                 r["max_abs_err"], rtol * scale, r["dot_rel_err"], r["ms"],
                 r["plain_ms"], "%.4f (%s)" % (r["library_ms"], kind)
                 if r["library_ms"] is not None else "none",
                 r["bound_ms"], r["bound_by"], nbytes / 1e6,
                 "ok" if r["ok"] else "FAIL"))
        if not r["ok"]:
            failures.append("%s %s disagrees with its plain version"
                            % (name, label))
        if name not in records:
            records[name] = {k: r[k] for k in RECORD_KEYS}
            records[name]["shape"] = (
                "%s %dx%d nodes of 3x3, K %d, window %d, %s%s"
                % (label, n, m, M.K, M.win, dt,
                   "; library: torch %s" % kind if kind else ""))
    return records


# -- phase 6: path D2, U2's system on dense-window operators -----------------

def dense_window_path(A, rhs, perm, failures):
    """Path D2: U2's system (RCM order, left side) with
    ``AMGParams(matrix_format="dwin")``, cold and warm. Every level
    operator is a dense window, and so are the smoothed transfers' M and
    Mᵀ, which both packages convert in the hierarchy's format; the
    float64 refinement operator goes through auto (windowed ELL). Returns
    (solve, counts, summary)."""
    from amgcl_tpu_torch import BiCGStab
    from amgcl_tpu_torch.ops.densewin import DenseWindowMatrix
    from amgcl_tpu_torch.utils.adapters import permute
    Ap, rhs_p = permute(A, perm), rhs[perm]
    # the default setup, which declines the device MIS for the dense
    # window (models/amg.device_mis_declined): its coarse levels,
    # numbered by root priority, keep none of the fine level's band, and
    # L1's windows would span the level, past the width rule
    solve, x, info, counts, plain_calls, warm, t_setup = solve_cold_warm(
        Ap, rhs_p, "D2", BiCGStab(maxiter=100, tol=1e-6,
                                  precond_side="left"), 3,
        matrix_format="dwin")
    print(solve.precond)
    print("[D2] device MIS declined: %s" % solve.precond.mis_declined)
    if solve.precond.mis_declined is None:
        failures.append("D2: the device MIS was not declined")
    rows, wins, blk_bytes, all_dwin = [], [], [], True
    for i, lv in enumerate(solve.precond.hierarchy.levels):
        parts = []
        for tag, M in (("A", lv.A), ("M", getattr(lv.P, "M", None)),
                       ("Mt", getattr(lv.R, "Mt", None))):
            if M is None:
                continue
            dwin = isinstance(M, DenseWindowMatrix)
            all_dwin = all_dwin and dwin
            parts.append("%s %s %dx%d window %s, %s bytes" % (
                tag, type(M).__name__, M.shape[0], M.shape[1],
                getattr(M, "win", "-"),
                M.blocks.numel() * M.blocks.element_size() if dwin
                else M.bytes()))
        print("[D2] level %d: %s" % (i, "; ".join(parts)))
        rows.append(lv.A.shape[0])
        wins.append(getattr(lv.A, "win", None))
        blk_bytes.append(lv.A.blocks.numel() * lv.A.blocks.element_size()
                         if isinstance(lv.A, DenseWindowMatrix) else None)
    a64 = solve.A_dev64
    print("[D2] Krylov operator: the hierarchy's L0 (%s); refinement "
          "operator: %s %s" % (solve.A_dev is solve.precond.hierarchy
                               .levels[0].A, type(a64).__name__, a64.dtype))
    x64 = x.double().cpu().numpy()
    true_res = float(np.linalg.norm(rhs_p - Ap.spmv(x64))
                     / np.linalg.norm(rhs_p))
    print("[D2] true relative residual (host float64): %.3e" % true_res)
    if rows != D2_LEVELS or wins != D2_WINDOWS or blk_bytes != D2_BYTES \
            or not all_dwin:
        failures.append("D2: levels %s, windows %s, block bytes %s (every "
                        "A, M, Mt a dense window: %s), expected %s %s %s"
                        % (rows, wins, blk_bytes, all_dwin, D2_LEVELS,
                           D2_WINDOWS, D2_BYTES))
    if abs(info.iters - D2_ITERS) > 0.1 * D2_ITERS:
        failures.append("D2: %d iterations, expected %d ± 10%%"
                        % (info.iters, D2_ITERS))
    if not (np.all(np.isfinite(x64)) and true_res <= 1e-6):
        failures.append("D2: true residual %.3e > 1e-6" % true_res)
    if any(plain_calls.values()):
        failures.append("D2: plain versions ran: %s" % plain_calls)
    for k in DENSEWIN:
        if counts[k] == 0:
            failures.append("D2: kernel %s never launched" % k)
    profile_solve(solve, rhs_p, info.wall_time_s * 1e3)
    return solve, counts, {
        "setup_s": t_setup, "warm_solve_s": info.wall_time_s,
        "iters": info.iters, "resid": info.resid, "true_resid": true_res,
        "levels": rows, "windows": wins, "block_bytes": blk_bytes,
        "warm_launches": warm}


def check_densewin_kernels(solve, failures):
    """Each dense-window kernel against its plain version at D2's L0 and
    L1 operators in float32 and at L1 in float64 (the same blocks,
    widened), timed as in check_kernels, the SpMV beside torch.bmm and
    the residual beside torch.baddbmm(f, B, x_windows, alpha=-1) over the
    tiles' x windows (gathered, and f padded to whole tiles, before the
    timed call); no one call computes the correction. |Δ| ≤ rtol ·
    Σ|terms| per entry (rtol 1e-5 in float32, 1e-12 in float64). The
    bound counts the blocks, the starts, x once and each other vector
    once; the operations are the multiply-adds over every stored entry,
    zeros included, which the kernel does."""
    from amgcl_tpu_torch.ops import densewin_kernels as dwk
    from amgcl_tpu_torch.ops.densewin import DenseWindowMatrix
    W = wrappers()
    LIB_NAME = {"dense_window_spmv": "torch.bmm",
                "dense_window_residual": "torch.baddbmm(alpha=-1)"}
    rng = np.random.RandomState(20261020)
    L = solve.precond.hierarchy.levels
    A1 = L[1].A
    A1_64 = DenseWindowMatrix(A1.window_starts, A1.blocks.double(),
                              A1.shape, A1.win)
    ops_cases = [("L0 A", L[0].A, L[0].relax.scale),
                 ("L1 A", A1, L[1].relax.scale),
                 ("L1 A f64", A1_64, L[1].relax.scale.double())]
    records = {}
    for name in DENSEWIN:
        kern, plain = W[name]
        for label, M, scale_w in ops_cases:
            dt = M.dtype
            n, m = M.shape
            s = M.blocks.element_size()
            nt, tile, win = M.blocks.shape

            def vec(k):
                return torch.as_tensor(rng.standard_normal(k)).to(
                    device="cuda", dtype=dt)
            x, f = vec(m), vec(n)
            geo = (M.window_starts, M.blocks)
            fmt_bytes = M.blocks.numel() * s + 4 * nt
            ops = 2 * M.blocks.numel()
            terms = dwk.dense_window_spmv_plain(M.window_starts,
                                                M.blocks.abs(), x.abs(), n)
            rtol = 1e-5 if dt == torch.float32 else 1e-12
            lib = None
            if name != "dense_window_scaled_correction":
                xp = torch.cat([x, x.new_zeros(win)])
                xw = xp[M.window_starts.long()[:, None]
                        + torch.arange(win, device="cuda")].unsqueeze(-1)
            if name == "dense_window_spmv":
                args = geo + (x, n)
                nbytes = fmt_bytes + (m + n) * s
                scale = float(terms.max())
                lib = lambda: torch.bmm(M.blocks, xw)
            elif name == "dense_window_residual":
                args = geo + (f, x, n)
                nbytes, ops = fmt_bytes + (m + 2 * n) * s, ops + n
                scale = float((terms + f.abs()).max())
                ft = torch.cat([f, f.new_zeros(nt * tile - n)]).reshape(
                    nt, tile, 1)
                lib = lambda: torch.baddbmm(ft, M.blocks, xw, alpha=-1)
            else:
                w = scale_w
                args = geo + (w, f, x, n)
                nbytes, ops = fmt_bytes + (m + 3 * n) * s, ops + 3 * n
                scale = float((w.abs() * (terms + f.abs()) + x.abs()).max())
            del terms
            r = compare_and_time(name, kern, plain, args, rtol, scale,
                                 lambda want: [], lib, nbytes, ops, dt)
            print("%-30s %-9s n=%-6d m=%-6d tiles=%-5d win=%-6d %s  err %.3e "
                  "(tol %.3e)  ms %.4f  plain %.4f  library %s  bound %.4f "
                  "(%s, %.1f MB)  %s"
                  % (name, label, n, m, nt, win, str(dt).split(".")[-1],
                     r["max_abs_err"], rtol * scale, r["ms"], r["plain_ms"],
                     "%.4f (%s, windows gathered before)"
                     % (r["library_ms"], LIB_NAME.get(name))
                     if r["library_ms"] is not None else "none",
                     r["bound_ms"], r["bound_by"], nbytes / 1e6,
                     "ok" if r["ok"] else "FAIL"))
            if not r["ok"]:
                failures.append("%s %s disagrees with its plain version"
                                % (name, label))
            if name not in records:
                records[name] = {k: r[k] for k in RECORD_KEYS}
                records[name]["shape"] = (
                    "D2 %s %dx%d, %d tiles of %d x %d, %s%s"
                    % (label, n, m, nt, tile, win, dt,
                       "; library: %s over x windows gathered before the "
                       "timed call" % LIB_NAME[name] if lib else ""))
            lib = xw = ft = None
    return records


# -- phase 7: path K1, U1's system under BiCGStab(L) -------------------------

def count_syncs(fn):
    """Run ``fn`` with torch's sync debug mode on and return the number of
    synchronizing CUDA operations it reported."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def bicgstabl_path(A, rhs, failures):
    """Path K1: U1's system (identity order) under BiCGStab(2), right
    side, refine=3, cold and warm; then one more warm solve under torch's
    sync debug mode, counting host syncs against BiCG steps. Returns
    (solve, counts, summary)."""
    from amgcl_tpu_torch import BiCGStabL
    from amgcl_tpu_torch.ops import fused_vec as fv
    solve, x, info, counts, plain_calls, warm, t_setup = solve_cold_warm(
        A, rhs, "K1", BiCGStabL(L=2, maxiter=100, tol=1e-6), 3)
    print(solve.precond)
    rows, fmts = describe_levels("K1", solve)
    x64 = x.double().cpu().numpy()
    true_res = float(np.linalg.norm(rhs - A.spmv(x64)) / np.linalg.norm(rhs))
    print("[K1] true relative residual (host float64): %.3e" % true_res)
    check_levels("K1", rows, fmts, K1_LEVELS, U_FORMATS, failures)
    lo, hi = K1_ITERS
    print("[K1] iterations: %d (expected 10%% around %d–%d; host setup "
          "%d)" % (info.iters, lo, hi, HOST_SETUP["K1"][1]))
    if not 0.9 * lo <= info.iters <= 1.1 * hi:
        failures.append("K1: %d iterations, outside 10%% around %d–%d"
                        % (info.iters, lo, hi))
    if not (np.all(np.isfinite(x64)) and true_res <= 1e-6):
        failures.append("K1: true residual %.3e > 1e-6" % true_res)
    if any(plain_calls.values()):
        failures.append("K1: plain versions ran: %s" % plain_calls)
    # one axpby_dot launch per BiCG step, committed or not
    if warm.get("axpby_dot", 0) < info.iters:
        failures.append("K1: axpby_dot launched %d times in a warm solve of "
                        "%d iterations" % (warm.get("axpby_dot", 0),
                                           info.iters))
    steps = fv.axpby_dot.launches
    syncs = count_syncs(lambda: solve(rhs))
    steps = fv.axpby_dot.launches - steps
    # beside one sync per BiCG step: each of at most four solver starts
    # and each refinement norm, at most four (one each)
    print("[K1] host syncs in a warm solve: %d for %d BiCG steps (limit: "
          "steps + 8)" % (syncs, steps))
    if syncs > steps + 8:
        failures.append("K1: %d host syncs for %d BiCG steps" % (syncs,
                                                                 steps))
    profile_solve(solve, rhs, info.wall_time_s * 1e3)
    return solve, counts, {
        "setup_s": t_setup, "warm_solve_s": info.wall_time_s,
        "iters": info.iters, "resid": info.resid, "true_resid": true_res,
        "levels": rows, "warm_launches": warm, "syncs": syncs,
        "bicg_steps": steps}


def check_axpby_dot(failures):
    """axpby_dot against its plain version at K1's n = 85,623 in float32
    and float64, timed as in check_kernels; z within rtol of Σ|terms| per
    entry and ⟨z, z⟩ within rtol of Σ terms²."""
    kern, plain = wrappers()["axpby_dot"]
    rng = np.random.RandomState(20261021)
    n = K1_LEVELS[0]
    records = {}
    for dt in (torch.float32, torch.float64):
        x, y = (torch.as_tensor(rng.standard_normal(n)).to(
            device="cuda", dtype=dt) for _ in range(2))
        a = torch.tensor(-0.37, dtype=dt, device="cuda")
        b = torch.tensor(1.0, dtype=dt, device="cuda")
        terms = 0.37 * x.abs() + y.abs()
        rtol = 1e-5 if dt == torch.float32 else 1e-12
        s = x.element_size()
        r = compare_and_time("axpby_dot", kern, plain, (a, x, b, y), rtol,
                             float(terms.max()),
                             lambda want: [(1, terms, terms)], None,
                             3 * n * s, 5 * n, dt)
        print("%-30s n=%-6d %s  err %.3e (tol %.3e)  dot rel err %.2e  ms "
              "%.4f  plain %.4f  bound %.4f (%s)  %s"
              % ("axpby_dot", n, str(dt).split(".")[-1], r["max_abs_err"],
                 rtol * float(terms.max()), r["dot_rel_err"], r["ms"],
                 r["plain_ms"], r["bound_ms"], r["bound_by"],
                 "ok" if r["ok"] else "FAIL"))
        if not r["ok"]:
            failures.append("axpby_dot %s disagrees with its plain version"
                            % dt)
        if not ordered_tail_dots_hold(kern, (a, x, b, y), 0):
            failures.append("axpby_dot %s: dot differs from the tails' "
                            "order on its own output" % dt)
        if "axpby_dot" not in records:
            records["axpby_dot"] = {k: r[k] for k in RECORD_KEYS}
            records["axpby_dot"]["shape"] = "K1 n=%d, %s" % (n, dt)
    return records


# -- phase 8: the GMRES family, paths G1, G1r and G2 --------------------------

def g1_problem():
    from amgcl_tpu_torch import fe_like_problem
    t0 = time.perf_counter()
    A, rhs = fe_like_problem(G1_LEVELS[0], nnz_target=6 * G1_LEVELS[0])
    print("problem: fe_like_problem(85623, nnz_target=6*85623), %d rows, "
          "%d nnz, built in %.3f s" % (A.nrows, A.nnz,
                                       time.perf_counter() - t0))
    return A, rhs


def true_residual(A, rhs, x):
    x64 = x.double().cpu().numpy()
    if not np.all(np.isfinite(x64)):
        return float("inf")
    return float(np.linalg.norm(rhs - A.spmv(x64)) / np.linalg.norm(rhs))


def gmres_path(A, rhs, failures, label, solver, levels, iters):
    """One path of phase 8 through make_solver (float32 hierarchy,
    refine=3), cold and warm, the counts set to 0 just before the setup
    and read just after the warm solve: the levels (rows, formats and L0's
    K), the iterations within 10% of ``iters``, a true residual ≤ 1e-6,
    no plain version, and the gather kernel launched at least once an
    Arnoldi step. Then one more warm solve under torch's sync debug mode:
    at most 8 host syncs beside one per Arnoldi step (each Arnoldi step
    runs one gather launch). Returns (solve, counts, summary)."""
    from amgcl_tpu_torch.ops import gather_kernels as gk
    solve, x, info, counts, plain_calls, warm, t_setup = solve_cold_warm(
        A, rhs, label, solver, 3)
    print(solve.precond)
    rows, fmts = describe_levels(label, solve)
    L0 = solve.precond.hierarchy.levels[0].A
    true_res = true_residual(A, rhs, x)
    print("[%s] true relative residual (host float64): %.3e"
          % (label, true_res))
    if L0.K != 16:
        failures.append("%s: L0 K %d, expected 16" % (label, L0.K))
    check_levels(label, rows, fmts, levels, G_FORMATS, failures)
    check_iters(label, info.iters, iters, failures, rel=0.1)
    if true_res > 1e-6:
        failures.append("%s: true residual %.3e > 1e-6" % (label, true_res))
    if any(plain_calls.values()):
        failures.append("%s: plain versions ran: %s" % (label, plain_calls))
    if warm.get("gather_spmv", 0) < info.iters:
        failures.append("%s: gather_spmv launched %d times in a warm solve "
                        "of %d iterations" % (label, warm.get(
                            "gather_spmv", 0), info.iters))
    steps = gk.gather_spmv.launches
    syncs = count_syncs(lambda: solve(rhs))
    steps = gk.gather_spmv.launches - steps
    print("[%s] host syncs in a warm solve: %d for %d Arnoldi steps (limit: "
          "steps + 8)" % (label, syncs, steps))
    if syncs > steps + 8:
        failures.append("%s: %d host syncs for %d Arnoldi steps"
                        % (label, syncs, steps))
    profile_solve(solve, rhs, info.wall_time_s * 1e3)
    return solve, counts, {
        "setup_s": t_setup, "warm_solve_s": info.wall_time_s,
        "iters": info.iters, "resid": info.resid, "true_resid": true_res,
        "levels": rows, "warm_launches": warm, "syncs": syncs,
        "arnoldi_steps": steps}


def other_solvers(A, rhs, failures):
    """LGMRES, IDR(s), Richardson and PreOnly once each on G1's system and
    call (refine=3), the counts set to 0 just before the setup and read
    just after the solve. Each must reach its iterations within 10% (the
    JAX package's on the CPU; IDR(s) on the port's own shadow space) and a
    true residual ≤ 1e-6, PreOnly exactly 4 iterations (one application
    and three refinements) with its residual only reported, and none may
    run a plain version. Returns ({solver: counts}, summary)."""
    import amgcl_tpu_torch as T
    from amgcl_tpu_torch import AMGParams, make_solver
    counts, summary = {}, {}
    for name, kw in (("LGMRES", {}), ("IDRs", {}), ("Richardson", {}),
                     ("PreOnly", None)):
        solver = getattr(T, name)(**({} if kw is None else dict(
            maxiter=100, tol=1e-6)))
        label = "G1 " + name
        reset_counts()
        t0 = time.perf_counter()
        solve = make_solver(A, AMGParams(dtype=torch.float32), solver,
                            refine=3)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        x, info = solve(rhs)
        counts[name], plain_calls = read_counts()
        true_res = true_residual(A, rhs, x)
        print("[%s] setup %.3f s; %d iterations, reported resid %.3e, true "
              "%.3e, %.4f s; launches: %s" % (
                  label, t_setup, info.iters, info.resid, true_res,
                  info.wall_time_s, json.dumps(
                      {k: v for k, v in counts[name].items() if v})))
        want = G_OTHER_ITERS[name]
        if name == "PreOnly":
            if info.iters != want or not np.isfinite(info.resid):
                failures.append("%s: %d iterations, reported resid %.3e, "
                                "expected %d" % (label, info.iters,
                                                 info.resid, want))
        else:
            check_iters(label, info.iters, want, failures, rel=0.1)
            if true_res > 1e-6:
                failures.append("%s: true residual %.3e > 1e-6"
                                % (label, true_res))
        if any(plain_calls.values()):
            failures.append("%s: plain versions ran: %s"
                            % (label, plain_calls))
        # LGMRES's and IDR(s)'s operator products run the gather kernel;
        # Richardson and PreOnly take only residuals (B.9)
        if counts[name]["gather_spmv"] == 0 and name in ("LGMRES", "IDRs"):
            failures.append("%s: gather_spmv never launched" % label)
        summary[name] = {"setup_s": t_setup, "solve_s": info.wall_time_s,
                         "iters": info.iters, "resid": info.resid,
                         "true_resid": true_res}
        del solve
    return counts, summary


def g2_path(failures):
    """Path G2: poisson3d(128) under GMRES(maxiter=100, tol=1e-6) with the
    main path's call otherwise (float32, device-built stencil levels,
    refine=3): 14 ± 1 iterations (the JAX package's on the CPU), a true
    residual ≤ 1e-6, dia_spmv launched (left GMRES's operator product on
    the DIA level: B.1's first path) and no plain version. Returns
    (counts, summary)."""
    from amgcl_tpu_torch import GMRES, poisson3d
    A, rhs = poisson3d(128)
    solve, x, info, counts, plain_calls, warm, t_setup = solve_cold_warm(
        A, rhs, "G2", GMRES(maxiter=100, tol=1e-6), 3)
    true_res = true_residual(A, rhs, x)
    print("[G2] true relative residual (host float64): %.3e" % true_res)
    check_iters("G2", info.iters, G2_ITERS, failures, within=1)
    if true_res > 1e-6:
        failures.append("G2: true residual %.3e > 1e-6" % true_res)
    if any(plain_calls.values()):
        failures.append("G2: plain versions ran: %s" % plain_calls)
    if counts["dia_spmv"] == 0:
        failures.append("G2: dia_spmv never launched")
    profile_solve(solve, rhs, info.wall_time_s * 1e3)
    return counts, {"setup_s": t_setup, "warm_solve_s": info.wall_time_s,
                    "iters": info.iters, "resid": info.resid,
                    "true_resid": true_res, "warm_launches": warm}


def random_gather_operator(K, dtype, rng):
    """A random scalar windowed ELL of 30,000 rows and columns in tiles of
    1,024, windows of 2,048 columns at starts that differ from tile to
    tile, about a quarter of the slots padding, tile 7 without entries."""
    from amgcl_tpu_torch.ops.unstructured import WindowedEllMatrix
    n, tile, win = 30000, 1024, 2048
    n_tiles = -(-n // tile)
    starts = rng.randint(0, (n - win) // 1024 + 1, n_tiles) * 1024
    cols = (rng.rand(n_tiles, tile, K) * win).astype(np.int32)
    vals = rng.standard_normal((n_tiles, tile, K))
    pad = rng.rand(n_tiles, tile, K) < 0.25
    cols[pad], vals[pad] = 0, 0.0
    starts[7] = n
    cols[7], vals[7] = 0, 0.0
    dev = lambda a, dt: torch.as_tensor(a).to(device="cuda", dtype=dt)
    return WindowedEllMatrix(dev(starts, torch.int32),
                             dev(cols, torch.int32), dev(vals, dtype),
                             (n, n), win)


def check_gather(g1, g1r, failures):
    """The gather kernel against its plain version on G1's L0, G1r's L0
    (81 distinct window starts), G1's float64 refinement operator and
    random operators with differing starts and an empty tile at K = 4, 8
    and 12 in float32 and float64, timed as in check_kernels, beside B.8
    (windowed_ell_spmv) on the same operator and torch's CSR product;
    |Δ| ≤ rtol · Σ|terms| per row (rtol 1e-5 in float32, 1e-12 in
    float64). The bound counts the n rows' cols and vals, x and y once.
    The first case is the record."""
    from amgcl_tpu_torch.ops import well_kernels as wk
    kern, plain = wrappers()["gather_spmv"]
    rng = np.random.RandomState(20261017)
    cases = [("G1 L0 A", g1.precond.hierarchy.levels[0].A),
             ("G1r L0 A", g1r.precond.hierarchy.levels[0].A),
             ("G1 L0 A f64", g1.A_dev64)]
    for K in (4, 8, 12):
        for dt in (torch.float32, torch.float64):
            cases.append(("random K%d %s" % (K, str(dt).split(".")[-1]),
                          random_gather_operator(K, dt, rng)))
    records = {}
    for label, M in cases:
        dt = M.dtype
        n, m = M.shape
        s = M.vals.element_size()
        x = torch.as_tensor(rng.standard_normal(m)).to(device="cuda",
                                                       dtype=dt)
        geo = (M.window_starts, M.cols_local, M.vals)
        terms = plain(M.window_starts, M.cols_local, M.vals.abs(), x.abs(),
                      n)
        rtol = 1e-5 if dt == torch.float32 else 1e-12
        nnz = int((M.vals.reshape(-1, M.K)[:n] != 0).sum())
        nbytes = n * M.K * (s + 4) + M.window_starts.numel() * 4 \
            + (m + n) * s
        C = library_csr(M)
        r = compare_and_time("gather_spmv", kern, plain, geo + (x, n), rtol,
                             float(terms.max()), lambda want: [],
                             lambda: torch.mv(C, x), nbytes, 2 * nnz, dt)
        well_ms = time_ms(lambda: wk.windowed_ell_spmv(*geo, x, n))
        print("%-12s %-20s n=%-6d K=%-3d win=%-6d starts=%-3d %s  err %.3e "
              "(tol %.3e)  ms %.4f  B.8 %.4f  plain %.4f  library %.4f  "
              "bound %.4f (%s, %.2f MB)  %s"
              % ("gather_spmv", label, n, M.K, M.win,
                 len(set(M.window_starts.tolist())),
                 str(dt).split(".")[-1], r["max_abs_err"],
                 rtol * float(terms.max()), r["ms"], well_ms,
                 r["plain_ms"], r["library_ms"] or float("nan"),
                 r["bound_ms"], r["bound_by"], nbytes / 1e6,
                 "ok" if r["ok"] else "FAIL"))
        if not r["ok"]:
            failures.append("gather_spmv %s disagrees with its plain version"
                            % label)
        if "gather_spmv" not in records:
            records["gather_spmv"] = {k: r[k] for k in RECORD_KEYS}
            records["gather_spmv"]["b8_ms"] = well_ms
            records["gather_spmv"]["shape"] = (
                "%s %dx%d, K %d, window %d, %s" % (label, n, m, M.K, M.win,
                                                   dt))
    return records


def gmres_family(failures):
    """Phase 8: G1 (GMRES, identity order), G1r (FGMRES, RCM order), the
    other solvers on G1's system, then G2 (GMRES on poisson3d(128)), and
    the gather kernel's check. Returns ({path: counts}, summary,
    records)."""
    from amgcl_tpu_torch import FGMRES, GMRES
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    A, rhs = g1_problem()
    counts, summary = {}, {}
    g1, counts["G1"], summary["G1"] = gmres_path(
        A, rhs, failures, "G1", GMRES(maxiter=100, tol=1e-6), G1_LEVELS,
        G1_ITERS)
    perm = cuthill_mckee(A)
    Ap, rhs_p = permute(A, perm), rhs[perm]
    g1r, counts["G1r"], summary["G1r"] = gmres_path(
        Ap, rhs_p, failures, "G1r", FGMRES(maxiter=100, tol=1e-6),
        G1R_LEVELS, G1R_ITERS)
    L0 = g1r.precond.hierarchy.levels[0].A
    starts = len(set(L0.window_starts.tolist()))
    if L0.win != G1R_WINDOW or starts != G1R_STARTS:
        failures.append("G1r: L0 window %d with %d distinct starts, "
                        "expected %d and %d" % (L0.win, starts, G1R_WINDOW,
                                                G1R_STARTS))
    records = check_gather(g1, g1r, failures)
    del g1, g1r
    gc.collect()
    torch.cuda.empty_cache()
    other, summary["others"] = other_solvers(A, rhs, failures)
    counts["others"] = {k: sum(c[k] for c in other.values())
                        for k in counts["G1"]}
    counts["G2"], summary["G2"] = g2_path(failures)
    gc.collect()
    torch.cuda.empty_cache()
    return counts, summary, records


# -- phase 9: path S1, the sharded stencil solver on one card -----------------

def sharded_solve(A, rhs, shards, label, **params):
    """Build DistStencilSolver over ``shards`` shards of the card (AMGParams
    ``params`` beside the dtype) and solve cold and warm, the counts set
    to 0 just before the setup and read just after, V-cycles counted.
    Returns (solver, x, info, counts, plain calls, warm launches, warm
    V-cycles, setup seconds)."""
    from amgcl_tpu_torch import AMGParams, CG, DistStencilSolver, make_mesh
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = DistStencilSolver(A, make_mesh(shards), AMGParams(
        dtype=torch.float32, **params), CG(maxiter=100, tol=1e-6))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    hier = s.hier
    print("[%s] setup: %.3f s wall over %d shards on %s; peak device memory"
          " %.1f MB" % (label, t_setup, shards, s.mesh,
                        torch.cuda.max_memory_allocated() / 2**20))
    print(s)
    for i, lv in enumerate(hier.levels):
        fz = lv.fused
        print("[%s] sharded level %d: slab %s, %d/%d/%d diagonals (A/M/Mt), "
              "blocks %s, framed down: %s (H %s), framed up: %s (hp %s)"
              % (label, i, lv.ldims, len(lv.a_flats), len(lv.m_flats),
                 len(lv.mt_flats), lv.blocks, fz is not None and fz.down_ok,
                 fz.H if fz is not None else None,
                 fz is not None and fz.up_ok,
                 fz.hp if fz is not None else None))
    print("[%s] replicated tail from %d rows: %s" % (
        label, hier.n_rep, [h[0].nrows for h in hier.rep_amg.host_levels]))
    cycles = [0]
    apply = hier.shard_apply

    def counted(r):
        cycles[0] += 1
        return apply(r)

    hier.shard_apply = counted
    x, info = s(rhs)
    print("[%s] solve 1 (cold): %d iterations, reported resid %.3e, %.4f s"
          % (label, info.iters, info.resid, info.wall_time_s))
    first, _ = read_counts()
    c_first = cycles[0]
    x, info = s(rhs)
    counts, plain_calls = read_counts()
    warm = {k: counts[k] - first[k] for k in counts}
    print("[%s] solve 2 (warm): %d iterations, reported resid %.3e, %.4f s"
          % (label, info.iters, info.resid, info.wall_time_s))
    print("[%s] launches in the warm solve (%d V-cycles): %s"
          % (label, cycles[0] - c_first,
             json.dumps({k: v for k, v in warm.items() if v})))
    return s, x, info, counts, plain_calls, warm, cycles[0] - c_first, \
        t_setup


def sharded_path(failures):
    """Path S1: poisson3d(128) over four z-slab shards of the card, cold
    and warm; then a further warm solve under torch's sync debug mode and
    one profiled, and the same system on one shard. Returns (solver,
    counts, summary)."""
    from amgcl_tpu_torch import poisson3d
    A, rhs = poisson3d(128)
    s, x, info, counts, plain_calls, warm, n_cycles, t_setup = \
        sharded_solve(A, rhs, S1_SHARDS, "S1")
    true_res = true_residual(A, rhs, x)
    print("[S1] true relative residual (host float64): %.3e" % true_res)
    hier = s.hier
    slabs = [lv.ldims for lv in hier.levels]
    if s.meta[:-1] != S1_LEVELS or slabs != S1_SLABS \
            or hier.n_rep != S1_TAIL:
        failures.append("S1: sharded levels %s in slabs %s, tail from %d "
                        "rows; expected %s, %s, %d"
                        % (s.meta[:-1], slabs, hier.n_rep, S1_LEVELS,
                           S1_SLABS, S1_TAIL))
    # the replicated tail aggregates with the device MIS
    check_iters("S1", info.iters, S1_ITERS, failures, within=1)
    if not (info.resid <= 1e-6 and true_res <= 1e-3):
        failures.append("S1: reported residual %.3e (limit 1e-6), true "
                        "%.3e (limit 1e-3)" % (info.resid, true_res))
    if any(plain_calls.values()):
        failures.append("S1: plain versions ran: %s" % plain_calls)
    for name, ok in (("fused_down_sweep.framed", "down_ok"),
                     ("fused_up_sweep.framed", "up_ok")):
        levels = sum(lv.fused is not None and getattr(lv.fused, ok)
                     for lv in hier.levels)
        if levels == 0 or warm[name] != S1_SHARDS * levels * n_cycles:
            failures.append("S1: %s launched %d times in %d V-cycles over "
                            "%d shards at %d levels" % (
                                name, warm[name], n_cycles, S1_SHARDS,
                                levels))
    # the halo product's interior at L0: once a CG iteration and once for
    # the first residual, on every shard
    if warm["dia_spmv"] != S1_SHARDS * (info.iters + 1):
        failures.append("S1: dia_spmv launched %d times for %d iterations "
                        "over %d shards" % (warm["dia_spmv"], info.iters,
                                            S1_SHARDS))
    iters_before = info.iters
    syncs = count_syncs(lambda: s(rhs))
    print("[S1] host syncs in a warm solve: %d for %d CG iterations (limit:"
          " iterations + 4)" % (syncs, iters_before))
    if syncs > iters_before + 4:
        failures.append("S1: %d host syncs for %d CG iterations"
                        % (syncs, iters_before))
    profile_solve(s, rhs, info.wall_time_s * 1e3)
    summary = {"setup_s": t_setup, "warm_solve_s": info.wall_time_s,
               "iters": info.iters, "resid": info.resid,
               "true_resid": true_res, "levels": s.meta, "slabs": slabs,
               "warm_launches": {k: v for k, v in warm.items() if v},
               "syncs": syncs}
    return s, counts, summary, (A, rhs)


def one_shard_parity(A, rhs, iters, failures):
    """The S1 system on a one-shard mesh: the halos are zeros, the framed
    legs run on zero frames and the halo product is the DIA SpMV on the
    slab. Its iterations must be S1's within one. Its host syncs and busy
    share are read as S1's are."""
    s, x, info, _, plain_calls, warm, _, t_setup = sharded_solve(
        A, rhs, 1, "S1 1 shard")
    true_res = true_residual(A, rhs, x)
    print("[S1 1 shard] true relative residual (host float64): %.3e"
          % true_res)
    if abs(info.iters - iters) > 1 or true_res > 1e-3:
        failures.append("S1 on one shard: %d iterations (S1 %d), true "
                        "residual %.3e" % (info.iters, iters, true_res))
    if any(plain_calls.values()):
        failures.append("S1 on one shard: plain versions ran: %s"
                        % plain_calls)
    if warm["dia_spmv"] != info.iters + 1:
        failures.append("S1 on one shard: dia_spmv launched %d times for "
                        "%d iterations" % (warm["dia_spmv"], info.iters))
    syncs = count_syncs(lambda: s(rhs))
    print("[S1 1 shard] host syncs in a warm solve: %d for %d CG iterations"
          % (syncs, info.iters))
    profile_solve(s, rhs, info.wall_time_s * 1e3)
    return {"setup_s": t_setup, "warm_solve_s": info.wall_time_s,
            "iters": info.iters, "true_resid": true_res, "syncs": syncs}


def reach_span(h, n, length, *offsets):
    """The rows [lo, hi) of a frame of ``length`` rows that a product
    chain with these offset sets reaches from the tile rows [h, h + n)."""
    lo = h + sum(min(min(o), 0) for o in offsets)
    hi = h + n + sum(max(max(o), 0) for o in offsets)
    return max(lo, 0), min(hi, length)


def reach_rows(h, n, length, *offsets):
    lo, hi = reach_span(h, n, length, *offsets)
    return hi - lo


def check_framed(s, failures):
    """Each framed leg against its plain version at S1's L0 and L1 on an
    interior shard (both halos real) and the first shard (a zero halo
    below), on seeded random f, u and uc framed by their neighbours' rows:
    |Δ| ≤ 1e-5 · Σ|terms| per entry. Timed as in check_kernels beside the
    base mode on the same slab (the slab alone, zero beyond it) and the
    least time for the bytes read and written once. The first case, L0
    interior in the path's mode, is the record."""
    from amgcl_tpu_torch.ops import vcycle_kernels as vk
    from amgcl_tpu_torch.parallel.dist_stencil import _halo_extend
    rng = np.random.RandomState(20261018)
    rtol = 1e-5
    records = {}
    nd = S1_SHARDS

    def slabs(n, dev):
        v = torch.as_tensor(rng.standard_normal(n * nd)).to(
            device=dev, dtype=torch.float32)
        return [p.contiguous() for p in torch.tensor_split(v, nd)]

    for i, lv in enumerate(s.hier.levels):
        fz = lv.fused
        dev = lv.adata[0].device
        lz, d1, d0 = fz.ldims
        nl, s2 = lz * d1 * d0, 2 * d1 * d0
        cz, c1, c0 = fz.lcoarse
        nc = cz * c1 * c0
        f, u, uc = slabs(nl, dev), slabs(nl, dev), slabs(nc, dev)
        f_fr, u_fr = _halo_extend(f, fz.H), _halo_extend(u, fz.H)
        u_up = _halo_extend(u, fz.hp * s2)
        uc_fr = _halo_extend(uc, fz.hp * c1 * c0)
        offs_a, offs_m, offs_mt = lv.a_flats, lv.m_flats, lv.mt_flats
        nA, nM, nMt = len(offs_a), len(offs_m), len(offs_mt)
        H, Hm = fz.H, fz.hp * s2
        L, Lm = nl + 2 * H, nl + 2 * Hm
        # the rows each leg reads: down, A at the rows Mᵀ reaches from the
        # tile, f there too (and where A reaches from them in zero-guess
        # mode), u or w where A reaches from them; up, M and u at the rows
        # A reaches from the tile, uc at the coarse planes under the rows
        # M reaches from those
        rows_a = reach_rows(H, nl, L, offs_mt)
        rows_u = reach_rows(H, nl, L, offs_mt, offs_a)
        rows_m = reach_rows(Hm, nl, Lm, offs_a)
        lo, hi = reach_span(Hm, nl, Lm, offs_a, offs_m)
        uc_rows = (((hi - 1) // s2) - (lo // s2) + 1) * c1 * c0
        for j, where in ((1, "interior"), (0, "boundary")):
            for mode in ("zero", "base", "up"):
                if mode == "up":
                    name = "fused_up_sweep.framed"
                    args = (offs_a, lv.adata[j], offs_m, fz.m_fr[j],
                            lv.scale[j], f[j], u_up[j], uc_fr[j], fz.ldims,
                            fz.hp)
                    terms = vk.fused_up_sweep_framed_plain(
                        offs_a, -lv.adata[j].abs(), offs_m,
                        -fz.m_fr[j].abs(), lv.scale[j].abs(), f[j].abs(),
                        u_up[j].abs(), uc_fr[j].abs(), fz.ldims, fz.hp)
                    base = (vk.fused_up_sweep, (
                        offs_a, lv.adata[j], offs_m,
                        fz.m_fr[j][:, Hm:Hm + nl].contiguous(), lv.scale[j],
                        f[j], u[j], uc[j], fz.ldims))
                    nbytes = ((nM + 1) * rows_m + uc_rows
                              + (nA + 3) * nl) * 4
                    ops = 2 * (nM + 1) * rows_m + (2 * nA + 3) * nl
                else:
                    name = "fused_down_sweep.framed"
                    zero = mode == "zero"
                    x = fz.w_fr[j] if zero else u_fr[j]
                    args = (offs_a, fz.a_fr[j], offs_mt, fz.mt_fr[j],
                            f_fr[j], x, fz.ldims, H, zero)
                    terms = vk.fused_down_sweep_framed_plain(
                        offs_a, -fz.a_fr[j].abs(), offs_mt,
                        -fz.mt_fr[j].abs(), f_fr[j].abs(), x.abs(),
                        fz.ldims, H, zero)
                    # the offsets as host ints, as the main path passes
                    # them: a tensor's are copied to the host at each call
                    base = (vk.fused_down_sweep, (
                        offs_a, lv.adata[j], offs_mt,
                        fz.mt_fr[j][:, H:H + nl].contiguous(), f[j],
                        lv.scale[j] if zero else u[j], fz.ldims, zero))
                    rows_f = rows_u if zero else rows_a
                    nbytes = (nA * rows_a + nMt * nl + rows_f + rows_u + nc
                              + (nl if zero else 0)) * 4
                    ops = (2 * nA * rows_a + 2 * nMt * nl + 2 * nl
                           + (rows_u if zero else 0))
                kern, plain = wrappers()[name]
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                pairs = list(zip(*(v if isinstance(v, tuple) else (v,)
                                   for v in (got, want, terms))))
                err = max(float((g - p_).abs().max()) for g, p_, _ in pairs)
                ratio = max(float(((g - p_).abs() / t.clamp_min(1e-30))
                                  .max()) for g, p_, t in pairs)
                ok = all(bool(((g - p_).abs() <= rtol * t).all())
                         for g, p_, t in pairs)
                ms = time_ms(lambda: kern(*args))
                plain_ms = time_ms(lambda: plain(*args))
                base_ms = time_ms(lambda: base[0](*base[1]))
                b_ms, b_by = bound(nbytes, ops, torch.float32)
                label = "L%d %s %s" % (i, where, mode)
                print("%-24s %-20s slab %s H %d hp %d  err %.3e (max |err|/"
                      "Σ|terms| %.2e, tol %.0e)  ms %.4f  plain %.4f  base "
                      "mode %.4f  bound %.4f (%s, %.1f MB)  %s"
                      % (name, label, "x".join(map(str, fz.ldims)), fz.H,
                         fz.hp, err, ratio, rtol, ms, plain_ms, base_ms,
                         b_ms, b_by, nbytes / 1e6, "ok" if ok else "FAIL"))
                if not ok:
                    failures.append("%s %s disagrees with its plain version"
                                    % (name, label))
                if name not in records:
                    records[name] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "base_ms": base_ms,
                        "shape": "S1 %s, slab %s, H %d, hp %d, float32"
                                 % (label, "x".join(map(str, fz.ldims)),
                                    fz.H, fz.hp)}
    return records


def sharded_stencil(failures):
    """Phase 9: path S1, its kernels' check, then the one-shard parity.
    Returns (counts, summary, records)."""
    t0 = time.perf_counter()
    s, counts, summary, (A, rhs) = sharded_path(failures)
    records = check_framed(s, failures)
    iters = summary["iters"]
    del s
    gc.collect()
    torch.cuda.empty_cache()
    summary["one_shard"] = one_shard_parity(A, rhs, iters, failures)
    gc.collect()
    torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t0
    print("phase 9: %.1f s" % summary["phase_s"])
    return counts, summary, records


# -- phase 10: every smoother and coarsening of the JAX package ----------------

#: the paths of phase 10: label -> (system, AMGParams fields, solver,
#: refine). Systems: "poisson" poisson3d(128); "fe" U1's (fe_like_problem(),
#: identity order); "elastic" q1_elasticity2d(512) and "elastic_block" the
#: same as 2x2 blocks; "block" B1's poisson3d_block(48, 3). ILK and ILP
#: take a float64 hierarchy: with a float32 one the JAX package itself
#: needs 141 and 153 BiCGStab iterations at 12,000 rows of the same
#: system, past the maxiter of 100 (reference_counts.py). No full-size
#: count of the JAX package is at hand for these (it would take a
#: full-size run on the CPU), so each path's iterations, summed over its
#: 1 + refine solves, are held below (1 + refine) times its maxiter, and
#: the CPU tests (tests/test_torch_relaxation.py,
#: tests/test_torch_coarsening.py) hold the same configuration's
#: small-size counts to the JAX package's exactly
A8_PATHS = {
    "J1": ("poisson", "relax=DampedJacobi()", "cg", 3),
    "C1": ("poisson", "relax=Chebyshev()", "cg", 3),
    "A1": ("poisson", "coarsening=Aggregation()", "cg", 3),
    "P1": ("fe", "relax=Spai1()", "bicgstab", 3),
    "GS1": ("fe", "relax=GaussSeidel()", "bicgstab", 3),
    "IL0": ("fe", "relax=ILU0()", "bicgstab", 3),
    "ILT": ("fe", "relax=ILUT()", "bicgstab", 3),
    "ILK": ("fe", "relax=ILUK(k=1), dtype=float64", "bicgstab", 3),
    "ILP": ("fe", "relax=ILUP(), dtype=float64", "bicgstab", 3),
    "R1": ("fe", "coarsening=RugeStuben()", "bicgstab", 3),
    "R1p": ("fe", "coarsening=RugeStuben(splitting='pmis')", "bicgstab", 3),
    "E1": ("fe", "coarsening=SmoothedAggrEMin()", "bicgstab", 3),
    "A2": ("fe", "coarsening=Aggregation()", "bicgstab", 3),
    "N1": ("elastic", "coarsening=SmoothedAggregation("
           "nullspace=rigid_body_modes(coords))", "cg500", 3),
    "N1b": ("elastic_block", "coarsening=AsScalar(SmoothedAggregation()), "
            "relax=AsBlock(Spai1())", "cg500", 3),
    "B1j": ("block", "relax=DampedJacobi()", "bicgstab200", 0),
}


#: phase-10 paths whose busy share is read over a window of this many
#: iterations without refinement (``windowed_busy``), as SC1's: their
#: whole solves run 40–400 iterations of many small launches, whose
#: profiles took 15–30 s each on the card's host
A8_PROFILE_WINDOW = {label: 20 for label in ("P1", "GS1", "IL0", "ILT",
                                              "ILK", "ILP", "N1", "N1b")}


def a8_params(label, coords=None):
    """The AMGParams fields of a phase-10 path (A8_PATHS' text), made
    from the package's names and the system's node coordinates."""
    import amgcl_tpu_torch as T
    return {
        "J1": lambda: dict(relax=T.DampedJacobi()),
        "C1": lambda: dict(relax=T.Chebyshev()),
        "A1": lambda: dict(coarsening=T.Aggregation()),
        "P1": lambda: dict(relax=T.Spai1()),
        "GS1": lambda: dict(relax=T.GaussSeidel()),
        "IL0": lambda: dict(relax=T.ILU0()),
        "ILT": lambda: dict(relax=T.ILUT()),
        "ILK": lambda: dict(relax=T.ILUK(k=1), dtype=torch.float64),
        "ILP": lambda: dict(relax=T.ILUP(), dtype=torch.float64),
        "R1": lambda: dict(coarsening=T.RugeStuben()),
        "R1p": lambda: dict(coarsening=T.RugeStuben(splitting="pmis")),
        "E1": lambda: dict(coarsening=T.SmoothedAggrEMin()),
        "A2": lambda: dict(coarsening=T.Aggregation()),
        "N1": lambda: dict(coarsening=T.SmoothedAggregation(
            nullspace=T.rigid_body_modes(coords))),
        "N1b": lambda: dict(coarsening=T.AsScalar(T.SmoothedAggregation()),
                            relax=T.AsBlock(T.Spai1())),
        "B1j": lambda: dict(relax=T.DampedJacobi()),
    }[label]()
#: kernels each path of phase 10 must launch (its rows of PERF.md §6)
A8_KERNELS = {
    "J1": ON_PATH,
    "C1": ("dia_residual", "dia_spmv_dots", "dia_residual_dot", "xr_update",
           "fused_down_sweep"),
    "A1": EARLIER,
    "S1j": FRAMED + ("dia_spmv",),
    "P1": ("windowed_ell_spmv", "windowed_ell_residual",
           "windowed_ell_spmv_dots", "bicgstab_tail"),
    "GS1": ("windowed_ell_scaled_correction", "windowed_ell_residual",
            "bicgstab_tail"),
    "B1j": ("windowed_ell_block_scaled_correction",
            "windowed_ell_block_spmv_dots", "bicgstab_tail"),
    "N1": ("dia_scaled_correction", "dia_spmv_dots", "dia_residual_dot",
           "windowed_ell_spmv", "windowed_ell_scaled_correction",
           "gather_spmv"),
    "N1b": ("windowed_ell_block_residual", "windowed_ell_block_spmv_dots"),
}
for _p in ("IL0", "ILT", "ILK", "ILP"):
    A8_KERNELS[_p] = ("windowed_ell_spmv", "windowed_ell_residual",
                      "bicgstab_tail")
for _p in ("R1", "R1p", "E1", "A2"):
    A8_KERNELS[_p] = ("windowed_ell_scaled_correction", "gather_spmv",
                      "bicgstab_tail")


def a8_solver(label):
    from amgcl_tpu_torch import CG, BiCGStab
    return {"cg": CG(maxiter=100, tol=1e-6),
            "cg500": CG(maxiter=500, tol=1e-6),
            "bicgstab": BiCGStab(maxiter=100, tol=1e-6),
            "bicgstab200": BiCGStab(maxiter=200, tol=1e-6)}[
                A8_PATHS[label][2]]


def a8_reach(label, solve):
    """What a phase-10 path's configuration puts on each level, and the
    structural reasons it reaches its kernels; returns (report lines,
    faults). Run on the card by phase 10 and on the CPU at small sizes by
    tests/test_torch_coarsening.py."""
    from amgcl_tpu_torch.ops.structured import TentativeP
    from amgcl_tpu_torch.ops.vcycle import _scalar_scale
    amg = solve.precond
    levels = amg.hierarchy.levels
    lines, faults = [], []
    for i, lv in enumerate(levels):
        relax = lv.relax
        lines.append("level %d: %d rows, A %s%s, P %s, smoother %s, fused "
                     "down %s (w %s), up %s" % (
                         i, lv.A.shape[0], type(lv.A).__name__,
                         " %dx%d" % lv.A.block
                         if getattr(lv.A, "block", (1, 1)) != (1, 1) else "",
                         type(lv.P).__name__, type(relax).__name__,
                         lv.down is not None,
                         lv.down is not None and lv.down.w is not None,
                         lv.up is not None))
    inner = levels[:-1]
    if label == "J1":
        if not (amg.device_built and amg.setup_split["device_build_s"] > 0):
            faults.append("the device build was not taken")
        for i, lv in enumerate(inner[:2]):
            w = lv.relax.scale
            if lv.down is None or lv.down.w is not w or lv.up is None \
                    or lv.up.w is not w:
                faults.append("level %d lacks a fused leg with the Jacobi "
                              "w" % i)
    elif label == "C1":
        if amg.device_built:
            faults.append("the device build took Chebyshev")
        for i, lv in enumerate(inner[:2]):
            if lv.down is None or lv.down.w is not None or lv.up is not None:
                faults.append("level %d: expected the base down leg and a "
                              "composed up leg" % i)
    elif label == "A1":
        if not isinstance(inner[0].P, TentativeP):
            faults.append("level 0 has no plain grid transfer")
    elif label == "GS1":
        if any(_scalar_scale(lv.relax, lv.A.dtype) is not None
               for lv in inner):
            faults.append("the fused legs would take the colour masks")
    elif label in ("N1b", "B1j"):
        if getattr(inner[0].A, "block", None) != (
                (2, 2) if label == "N1b" else (3, 3)):
            faults.append("level 0 is not a block windowed ELL")
    if len(levels) < 2:
        faults.append("one level only")
    return lines, faults


def a8_problem(system):
    """(A, rhs, coords) of a phase-10 system."""
    import amgcl_tpu_torch as T
    if system == "poisson":
        A, rhs = T.poisson3d(128)
        return A, rhs, None
    if system == "fe":
        A, rhs = T.fe_like_problem()
        return A, rhs, None
    if system == "block":
        A, rhs = T.poisson3d_block(48, 3)
        return A, rhs, None
    A, rhs, coords = T.q1_elasticity2d(512)
    return (A.to_block(2) if system == "elastic_block" else A), rhs, coords


def a8_path(label, A, rhs, coords, failures):
    """One phase-10 path through make_solver, float32 hierarchy: set-up,
    a cold and a warm solve with the counts set to 0 just before the
    setup and read just after, V-cycles counted; then one more warm solve
    profiled. Returns (counts, summary)."""
    from amgcl_tpu_torch import make_solver, AMGParams
    system, _, _, refine = A8_PATHS[label]
    solver = a8_solver(label)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    prm = dict(dtype=torch.float32)
    prm.update(a8_params(label, coords))
    solve = make_solver(A, AMGParams(**prm), solver, refine=refine)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    amg = solve.precond
    split = amg.setup_split
    if amg.mis_declined:
        print("[%s] device MIS declined: %s" % (label, amg.mis_declined))
    print("[%s] %s: setup %.3f s (device build %.3f s, host %.3f s), peak "
          "device memory %.1f MB above %.1f MB" % (
              label, A8_PATHS[label][1], t_setup, split["device_build_s"],
              split["host_s"],
              (torch.cuda.max_memory_allocated() - base) / 2**20,
              base / 2**20))
    lines, faults = a8_reach(label, solve)
    for line in lines:
        print("[%s] %s" % (label, line))
    hier = amg.hierarchy
    cycles = [0]
    apply = hier.apply

    def counted(r):
        cycles[0] += 1
        return apply(r)

    hier.apply = counted
    x, info = solve(rhs)
    cold = info.wall_time_s
    first, _ = read_counts()
    c_first = cycles[0]
    x, info = solve(rhs)
    counts, plain_calls = read_counts()
    n_cycles = cycles[0] - c_first
    warm = {k: counts[k] - first[k] for k in counts if counts[k] - first[k]}
    S = A.to_scipy()
    x64 = x.double().cpu().numpy()
    nb = np.linalg.norm(rhs)
    true_res = float(np.linalg.norm(rhs - S @ x64) / nb) \
        if np.all(np.isfinite(x64)) else float("inf")
    limit = 1e-6
    if refine == 0:
        # B1's rule: float32 x cannot reach 1e-6 at this size
        limit += 2 * 2.0 ** -24 * float(np.linalg.norm(abs(S) @ np.abs(x64))
                                        / nb)
    print("[%s] %d iterations (maxiter %d, refine %d), reported resid "
          "%.3e, true %.3e (limit %.3e), health %s; cold %.4f s, warm %.4f "
          "s, %d V-cycles warm" % (label, info.iters, solver.maxiter, refine,
                                   info.resid, true_res, limit, info.health,
                                   cold, info.wall_time_s, n_cycles))
    print("[%s] kernels launched (setup + 2 solves): %s" % (
        label, json.dumps({k: v for k, v in counts.items() if v})))
    print("[%s] launches in the warm solve: %s" % (label, json.dumps(warm)))
    for f in faults:
        failures.append("%s: %s" % (label, f))
    # iterations are summed over the 1 + refine solves: held below
    # (1 + refine) times maxiter
    if info.iters >= (1 + refine) * solver.maxiter or info.resid > 1e-6 \
            or true_res > limit:
        failures.append("%s: %d iterations (maxiter %d, refine %d), "
                        "reported %.3e, true residual %.3e (limit %.3e)" % (
                            label, info.iters, solver.maxiter, refine,
                            info.resid, true_res, limit))
    if any(plain_calls.values()):
        failures.append("%s: plain versions ran: %s" % (label, plain_calls))
    for k in A8_KERNELS[label]:
        if counts[k] == 0:
            failures.append("%s: kernel %s never launched" % (label, k))
    for name, attr in (("fused_down_sweep", "down"),
                       ("fused_up_sweep", "up")):
        per_cycle = sum(getattr(lv, attr) is not None for lv in hier.levels)
        if warm.get(name, 0) != per_cycle * n_cycles:
            failures.append("%s: %s launched %d times in %d V-cycles over "
                            "%d levels" % (label, name, warm.get(name, 0),
                                           n_cycles, per_cycle))
    busy = windowed_busy(label, solve, rhs, info.wall_time_s,
                         A8_PROFILE_WINDOW.get(label))
    summary = {"setup_s": t_setup,
               "device_build_s": split["device_build_s"],
               "cold_solve_s": cold, "warm_solve_s": info.wall_time_s,
               "busy": busy, "iters": info.iters, "resid": info.resid,
               "true_resid": true_res,
               "levels": [lv.A.shape[0] for lv in hier.levels],
               "warm_launches": warm}
    del solve, amg, hier
    gc.collect()
    torch.cuda.empty_cache()
    return counts, summary


def a8_sharded(failures):
    """Path S1j: S1's configuration with damped Jacobi: the framed legs
    take the Jacobi w. Held to S1's rules. Returns (counts, summary)."""
    from amgcl_tpu_torch import DampedJacobi, poisson3d
    A, rhs = poisson3d(128)
    s, x, info, counts, plain_calls, warm, n_cycles, t_setup = \
        sharded_solve(A, rhs, S1_SHARDS, "S1j", relax=DampedJacobi())
    true_res = true_residual(A, rhs, x)
    print("[S1j] %d iterations, reported resid %.3e, true %.3e (limits "
          "1e-6, 1e-3)" % (info.iters, info.resid, true_res))
    hier = s.hier
    if s.meta[:-1] != S1_LEVELS or hier.n_rep != S1_TAIL:
        failures.append("S1j: sharded levels %s, tail from %d rows"
                        % (s.meta[:-1], hier.n_rep))
    if info.iters >= 100 or not (info.resid <= 1e-6 and true_res <= 1e-3):
        failures.append("S1j: %d iterations, reported residual %.3e, true "
                        "%.3e" % (info.iters, info.resid, true_res))
    if any(plain_calls.values()):
        failures.append("S1j: plain versions ran: %s" % plain_calls)
    for i, lv in enumerate(hier.levels):
        fz = lv.fused
        w = [0.72 / a[lv.a_flats.index(0)] for a in lv.adata]
        if fz is None or not (fz.down_ok and fz.up_ok) or any(
                not torch.allclose(x, y) for x, y in zip(lv.scale, w)):
            failures.append("S1j: level %d lacks framed legs with the "
                            "Jacobi w" % i)
    for name, ok in (("fused_down_sweep.framed", "down_ok"),
                     ("fused_up_sweep.framed", "up_ok")):
        levels = sum(lv.fused is not None and getattr(lv.fused, ok)
                     for lv in hier.levels)
        if warm[name] != S1_SHARDS * levels * n_cycles:
            failures.append("S1j: %s launched %d times in %d V-cycles"
                            % (name, warm[name], n_cycles))
    for k in A8_KERNELS["S1j"]:
        if counts[k] == 0:
            failures.append("S1j: kernel %s never launched" % k)
    busy = profile_solve(s, rhs, info.wall_time_s * 1e3)
    return counts, {"setup_s": t_setup, "warm_solve_s": info.wall_time_s,
                    "busy": busy, "iters": info.iters, "resid": info.resid,
                    "true_resid": true_res, "levels": s.meta,
                    "warm_launches": {k: v for k, v in warm.items() if v}}


def a8_family(failures, only=None):
    """Phase 10: the paths of A8_PATHS and S1j, each system made once.
    Returns ({label: counts}, {label: summary})."""
    t_phase = time.perf_counter()
    counts, summary = {}, {}
    order = ["poisson", "fe", "elastic", "elastic_block", "block"]
    for system in order:
        labels = [p for p, v in A8_PATHS.items() if v[0] == system
                  and (only is None or p in only)]
        if system == "poisson" and (only is None or "S1j" in only):
            counts["S1j"], summary["S1j"] = a8_sharded(failures)
            gc.collect()
            torch.cuda.empty_cache()
        if not labels:
            continue
        t0 = time.perf_counter()
        A, rhs, coords = a8_problem(system)
        print("problem %s: %d rows, %d stored entries, made in %.3f s"
              % (system, A.nrows, A.nnz, time.perf_counter() - t0))
        for label in labels:
            t0 = time.perf_counter()
            counts[label], summary[label] = a8_path(label, A, rhs, coords,
                                                    failures)
            summary[label]["path_s"] = time.perf_counter() - t0
            print("[%s] path: %.1f s" % (label, summary[label]["path_s"]))
        del A
        gc.collect()
    print("phase 10: %.1f s" % (time.perf_counter() - t_phase))
    return counts, summary


# -- phase 11: compositions and configuration (A.9) ---------------------------

#: the paths of phase 11: label -> (system, configuration, refine).
#: Systems: "poisson" poisson3d(128); "fe" U1's (fe_like_problem(),
#: identity order); "stokes" stokes_like(512) (two 262,144-row velocity
#: blocks, 262,144 pressure rows); "reservoir" reservoir_like(96, 3)
#: (884,736 cells of 3 unknowns); "block_scalar" B1's poisson3d_block(48,
#: 3) as a scalar CSR. Every hierarchy is float32. No full-size count of
#: the JAX package is at hand (it would take a full-size run on the CPU),
#: so each path's iterations, summed over its 1 + refine solves, are held
#: below (1 + refine) times its maxiter and the CPU tests
#: (tests/test_torch_compose.py, tests/test_torch_runtime.py) hold the
#: same configurations' small-size counts to the JAX package's exactly;
#: DF1 is held to the main path's 12 ± 1, BK1 to B1's 7, and RB1, RB1h
#: and CP1's rebuilt solves to a fresh build's count on the same system
A9_PATHS = {
    "MX1": ("poisson", "AMGParams(), CG(maxiter=100, tol=1e-6), "
            "solver_dtype=float64", 0),
    "DF1": ("poisson", "main path, refine_dtype='df32'", 3),
    "RB1": ("poisson", "main path, then rebuild(A·(1 + 0.05·step)) from "
            "the last x, RB1_STEPS step(s)", 3),
    "RB1h": ("poisson", "RB1 with device_setup=False", 3),
    "DL1": ("poisson", "deflated_solver(A, Z = [1, x, y, z], AMGParams(), "
            "CG(maxiter=100, tol=1e-6))", 3),
    "NS1": ("poisson", "config: nested (cg, maxiter 4, tol 1e-2, over "
            "amg), fgmres(maxiter=100, tol=1e-6)", 3),
    "DM1": ("poisson", "config: dummy, cg(maxiter=1000, tol=1e-6)", 3),
    "AP1": ("fe", "config: relaxation ilu0, bicgstab(maxiter=500, "
            "tol=1e-6)", 3),
    "SC1": ("stokes", "SchurPressureCorrection(A, pmask, adjust_p=2), "
            "FGMRES(maxiter=500, tol=1e-6)", 3),
    "CP1": ("reservoir", "CPR(A), BiCGStab(maxiter=200, tol=1e-6), then "
            "rebuild(2A)", 3),
    "BK1": ("block_scalar", "make_block_solver(A, 3, AMGParams(), "
            "BiCGStab(maxiter=200, tol=1e-6))", 0),
}
#: paths whose busy share is read over a window of this many iterations
#: of their (outer) solver without refinement, not over a whole solve
#: (SC1: two whole FGMRES(30) restart cycles; DM1's 430 and AP1's 114
#: iterations of small launches took many seconds to profile)
A9_PROFILE_WINDOW = {"SC1": 60, "DM1": 60, "AP1": 60}
#: kernels each phase-11 path must launch (its rows of PERF.md §6)
A9_KERNELS = {
    "MX1": ("dia_spmv_dots", "dia_residual_dot", "xr_update",
            "fused_down_sweep", "fused_up_sweep"),
    "DM1": ("dia_spmv_dots", "dia_residual_dot", "xr_update",
            "dia_residual"),
    "AP1": ("windowed_ell_spmv", "windowed_ell_spmv_dots", "bicgstab_tail"),
    "SC1": ("dia_spmv", "dia_residual"),
    "CP1": ("windowed_ell_block_spmv_dots", "bicgstab_tail",
            "fused_down_sweep", "fused_up_sweep"),
    "BK1": BLOCK,
}
for _p in ("DF1", "RB1", "RB1h", "DL1", "NS1"):
    A9_KERNELS[_p] = A9_KERNELS["MX1"]


def a9_deflation_vectors(n):
    """The constant and the three coordinate functions of poisson3d(n)'s
    grid, scaled to [0, 1]: (n³, 4)."""
    i = np.arange(n ** 3)
    return np.stack([np.ones(n ** 3), i % n, (i // n) % n, i // n ** 2],
                    axis=1) / np.array([1.0, n - 1, n - 1, n - 1])


def a9_make(label, A, extra, **dev):
    """Build phase 11's bundle ``label`` on ``A`` (``extra``: the pressure
    mask of SC1, the deflation vectors of DL1) through the entry points a
    user calls; ``dev`` holds ``device`` and ``device_setup``."""
    import amgcl_tpu_torch as T
    cg = T.CG(maxiter=100, tol=1e-6)
    if label == "MX1":
        return T.make_solver(A, T.AMGParams(), cg,
                             solver_dtype=torch.float64, **dev)
    if label == "DF1":
        return T.make_solver(A, T.AMGParams(), cg, refine=3,
                             refine_dtype="df32", **dev)
    if label in ("RB1", "RB1h"):
        if label == "RB1h":
            dev = dict(dev, device_setup=False)
        return T.make_solver(A, T.AMGParams(), cg, refine=3, **dev)
    if label == "DL1":
        return T.deflated_solver(A, extra, T.AMGParams(), cg, refine=3,
                                 **dev)
    if label == "NS1":
        return T.make_solver_from_config(A, {
            "precond.class": "nested", "precond.solver.type": "cg",
            "precond.solver.maxiter": 4, "precond.solver.tol": 1e-2,
            "precond.precond.class": "amg", "solver.type": "fgmres",
            "solver.tol": 1e-6, "solver.maxiter": 100}, refine=3, **dev)
    if label == "DM1":
        return T.make_solver_from_config(A, {
            "precond.class": "dummy", "solver.type": "cg",
            "solver.maxiter": 1000, "solver.tol": 1e-6}, refine=3, **dev)
    if label == "AP1":
        return T.make_solver_from_config(A, {
            "precond.class": "relaxation", "precond.relax.type": "ilu0",
            "solver.type": "bicgstab", "solver.maxiter": 500,
            "solver.tol": 1e-6}, refine=3, **dev)
    if label == "SC1":
        return T.make_solver(
            A, T.SchurPressureCorrection(A, extra, adjust_p=2, **dev),
            T.FGMRES(maxiter=500, tol=1e-6), refine=3,
            device=dev.get("device"))
    if label == "CP1":
        return T.make_solver(A, T.CPR(A, **dev),
                             T.BiCGStab(maxiter=200, tol=1e-6), refine=3,
                             device=dev.get("device"))
    return T.make_block_solver(A, 3, T.AMGParams(),
                               T.BiCGStab(maxiter=200, tol=1e-6), **dev)


def a9_reach(label, solve):
    """What a phase-11 bundle puts where, and the structural reasons it
    reaches its kernels; returns (report lines, faults). Run on the card
    by phase 11 and on the CPU at small sizes by
    tests/test_torch_compose.py."""
    import amgcl_tpu_torch as T
    from amgcl_tpu_torch.ops.device import DiaMatrix
    from amgcl_tpu_torch.ops.unstructured import WindowedEllMatrix
    from amgcl_tpu_torch.relaxation.ilu0 import ILU0State
    bundle = getattr(solve, "inner", solve)
    pre = bundle.precond
    hier = pre.hierarchy
    lines, faults = [], []
    # a Schur hierarchy moves its full system to the device only when
    # asked, and make_solver converts A itself for it
    own = not isinstance(pre, T.SchurPressureCorrection) \
        and bundle.A_dev is getattr(hier, "system_matrix", None)
    lines.append("Krylov operator %s %s (the hierarchy's own: %s), "
                 "preconditioner %s, refinement %s" % (
                     type(bundle.A_dev).__name__, bundle.A_dev.dtype, own,
                     type(pre).__name__, bundle.refine_mode))
    amgs = [("", pre)] if isinstance(pre, T.AMG) else []
    if isinstance(pre, T.SchurPressureCorrection):
        amgs = [("u ", pre.u_amg), ("p ", pre.p_amg)]
    elif isinstance(pre, T.CPR):
        amgs = [("p ", pre.p_amg)]
    elif isinstance(pre, T.NestedPreconditioner):
        amgs = [("inner ", pre.inner)]
    for name, amg in amgs:
        for i, lv in enumerate(amg.hierarchy.levels):
            lines.append("%slevel %d: %d rows, A %s%s, fused down %s, up %s"
                         % (name, i, lv.A.shape[0], type(lv.A).__name__,
                            " %dx%d" % lv.A.block
                            if getattr(lv.A, "block", (1, 1)) != (1, 1)
                            else "", lv.down is not None,
                            lv.up is not None))
        lines.append("%sdevice build: %s" % (name, amg.device_built))
    if label == "MX1":
        if not (isinstance(bundle.A_dev, DiaMatrix)
                and bundle.A_dev.dtype == torch.float64
                and bundle.A_dev is not hier.system_matrix):
            faults.append("the Krylov operator is not a float64 DIA apart "
                          "from the hierarchy's")
    elif label == "DF1" and bundle.refine_mode != "df32":
        faults.append("refinement mode %s" % bundle.refine_mode)
    if label in ("RB1", "RB1h") and pre.device_built != (label == "RB1"):
        faults.append("device build taken: %s" % pre.device_built)
    if label == "DL1" and tuple(hier.Z.shape[1:]) != (4,):
        faults.append("deflation space %s" % (tuple(hier.Z.shape),))
    if label == "NS1" and not isinstance(pre, T.NestedPreconditioner):
        faults.append("not a nested preconditioner")
    if label == "AP1" and not isinstance(getattr(hier, "state", None),
                                         ILU0State):
        faults.append("the single level does not hold ILU(0)")
    if label == "DM1" and not isinstance(pre, T.DummyPreconditioner):
        faults.append("not the identity preconditioner")
    if label == "SC1" and len(pre.p_amg.hierarchy.levels) < 2:
        faults.append("the pressure hierarchy has one level")
    if label == "CP1":
        if not pre.p_amg.device_built:
            faults.append("the pressure AMG did not take the device build")
        if not (isinstance(bundle.A_dev, WindowedEllMatrix)
                and bundle.A_dev.block == (3, 3)):
            faults.append("the Krylov operator is not a 3x3 block "
                          "windowed ELL")
    if label == "BK1" and getattr(hier.levels[0].A, "block",
                                  None) != (3, 3):
        faults.append("level 0 is not a 3x3 block windowed ELL")
    return lines, faults


def a9_problem(system):
    """(A, rhs, extra) of a phase-11 system at full size."""
    import amgcl_tpu_torch as T
    if system == "poisson":
        A, rhs = T.poisson3d(128)
        return A, rhs, a9_deflation_vectors(128)
    if system == "fe":
        A, rhs = T.fe_like_problem()
        return A, rhs, None
    if system == "stokes":
        A, pmask = T.stokes_like(512)
        return A, np.ones(A.nrows), pmask
    if system == "reservoir":
        A, rhs = T.reservoir_like(96, 3)
        return A, rhs, None
    A, rhs = T.poisson3d_block(48, 3)
    return A.unblock(), rhs, None


def a9_limit(A, rhs, x, refine):
    """The true-residual limit: 1e-6, plus B1's 2u·‖|A||x|‖/‖b‖ for a
    float32 x without refinement."""
    if refine or x.dtype == torch.float64:
        return 1e-6
    S = A.to_scipy()
    x64 = x.double().cpu().numpy()
    return 1e-6 + 2 * 2.0 ** -24 * float(
        np.linalg.norm(abs(S) @ np.abs(x64)) / np.linalg.norm(rhs))


def a9_timed_build(build):
    """(result, seconds, peak device MB above the allocation before) of
    ``build()``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = build()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() - base) / 2**20)


def a9_fresh(label, A, rhs, extra, x0=None):
    """A fresh build of ``label`` on a copy of ``A`` that holds none of
    its pattern caches, as a new matrix from an application would, and
    its solve, outside the path's counts. Returns (info, seconds, peak
    MB)."""
    from amgcl_tpu_torch import CSR
    with counts_paused():
        fresh, t_fresh, mb = a9_timed_build(lambda: a9_make(
            label, CSR(A.ptr, A.col, A.val, A.ncols), extra))
        _, info = fresh(rhs, x0=x0)
    del fresh
    gc.collect()
    return info, t_fresh, mb


#: drift steps of RB1 and RB1h (each a rebuild and a fresh build): one,
#: since phase 13's RB2 runs three rebuilds through the segment-sum plans
RB1_STEPS = 1


def a9_rebuild_steps(label, solve, A, rhs, x, extra, failures):
    """RB1/RB1h: RB1_STEPS drift steps of examples/time_dependent.py, each
    rebuilt, solved from the last x and held to a fresh build's count on
    the same system from the same x; RB1h also to its device transfers
    being kept. Returns the steps' summaries."""
    from amgcl_tpu_torch import CSR
    steps = []
    for step in range(1, RB1_STEPS + 1):
        A_t = CSR(A.ptr, A.col, A.val * (1 + 0.05 * step), A.ncols)
        kept = [(lv.P, lv.R) for lv in solve.precond.hierarchy.levels[:-1]]
        _, t_rebuild, mb = a9_timed_build(lambda: solve.rebuild(A_t))
        x_new, info = solve(rhs, x0=x)
        true_res = true_residual(A_t, rhs, x_new)
        info_f, t_fresh, mb_f = a9_fresh(label, A_t, rhs, extra, x0=x)
        reused = all(lv.P is P and lv.R is R for lv, (P, R) in zip(
            solve.precond.hierarchy.levels, kept))
        print("[%s] step %d: rebuild %.3f s, peak %.1f MB (fresh build "
              "%.3f s, peak %.1f MB), %d iterations (fresh %d), reported "
              "%.3e, true %.3e, %.4f s; device transfers kept: %s" % (
                  label, step, t_rebuild, mb, t_fresh, mb_f, info.iters,
                  info_f.iters, info.resid, true_res, info.wall_time_s,
                  reused))
        if info.iters != info_f.iters or true_res > 1e-6 \
                or info.resid > 1e-6:
            failures.append("%s step %d: %d iterations (fresh build %d), "
                            "true residual %.3e" % (
                                label, step, info.iters, info_f.iters,
                                true_res))
        if label == "RB1h" and not reused:
            failures.append("RB1h step %d: device transfers converted "
                            "again" % step)
        steps.append({"rebuild_s": t_rebuild, "fresh_setup_s": t_fresh,
                      "rebuild_peak_mb": mb, "fresh_peak_mb": mb_f,
                      "iters": info.iters, "fresh_iters": info_f.iters,
                      "true_resid": true_res,
                      "solve_s": info.wall_time_s})
        x = x_new
    return steps


def a9_cpr_rebuild(solve, A, rhs, failures):
    """CP1's rebuild: the values doubled, through make_solver.rebuild
    (CPR.partial_update), held to a fresh CPR's count on the same
    system."""
    from amgcl_tpu_torch import CSR
    A2 = CSR(A.ptr, A.col, A.val * 2.0, A.ncols)
    _, t_rebuild, mb = a9_timed_build(lambda: solve.rebuild(A2))
    x, info = solve(rhs)
    true_res = true_residual(A2, rhs, x)
    info_f, t_fresh, mb_f = a9_fresh("CP1", A2, rhs, None)
    print("[CP1] rebuild(2A): %.3f s, peak %.1f MB (fresh build %.3f s, "
          "peak %.1f MB), %d iterations (fresh build %d), reported %.3e, "
          "true %.3e" % (t_rebuild, mb, t_fresh, mb_f, info.iters,
                         info_f.iters, info.resid, true_res))
    if info.iters != info_f.iters or true_res > 1e-6:
        failures.append("CP1 rebuild: %d iterations (fresh build %d), true "
                        "residual %.3e" % (info.iters, info_f.iters,
                                           true_res))
    return {"rebuild_s": t_rebuild, "fresh_setup_s": t_fresh,
            "rebuild_peak_mb": mb, "fresh_peak_mb": mb_f,
            "iters": info.iters, "fresh_iters": info_f.iters,
            "true_resid": true_res}


def a9_path(label, A, rhs, extra, failures):
    """One phase-11 path: set-up, a cold and a warm solve with the counts
    set to 0 just before the setup and read just after (the rebuilds of
    RB1, RB1h and CP1 and their solves included, the fresh builds they
    are compared with not), then one more warm solve profiled. Returns
    (counts, summary)."""
    import warnings
    system, _, refine = A9_PATHS[label]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        solve = a9_make(label, A, extra)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        maxiter = getattr(solve, "inner", solve).solver.maxiter
        lines, faults = a9_reach(label, solve)
        for line in lines:
            print("[%s] %s" % (label, line))
        x, info = solve(rhs)
        cold = info.wall_time_s
        x, info = solve(rhs)
    print("[%s] %s: setup %.3f s, peak device memory %.1f MB above %.1f MB"
          % (label, A9_PATHS[label][1], t_setup,
             (torch.cuda.max_memory_allocated() - base) / 2**20,
             base / 2**20))
    true_res = true_residual(A, rhs, x)
    limit = a9_limit(A, rhs, x, refine)
    print("[%s] %d iterations (maxiter %d, refine %d), reported resid "
          "%.3e, true %.3e (limit %.3e), health %s; cold %.4f s, warm %.4f "
          "s" % (label, info.iters, maxiter, refine, info.resid, true_res,
                 limit, info.health, cold, info.wall_time_s))
    for w in caught:
        print("[%s] warning: %s" % (label, w.message))
        if label == "DF1":
            faults.append("warning: %s" % w.message)
    if info.iters >= (1 + refine) * maxiter or info.resid > 1e-6 \
            or true_res > limit:
        faults.append("%d iterations (maxiter %d, refine %d), reported "
                      "%.3e, true residual %.3e (limit %.3e)" % (
                          info.iters, maxiter, refine, info.resid, true_res,
                          limit))
    if label == "RB1h":
        check_iters(label, info.iters, ITERS_EXPECTED, faults, within=1)
    if label in ("DF1", "RB1"):
        check_iters(label, info.iters, MAIN_ITERS, faults, within=1)
    if label == "BK1":
        check_iters(label, info.iters, B1_ITERS, faults, within=0)
    summary = {"setup_s": t_setup, "cold_solve_s": cold,
               "warm_solve_s": info.wall_time_s, "iters": info.iters,
               "resid": info.resid, "true_resid": true_res}
    if label in ("RB1", "RB1h"):
        summary["steps"] = a9_rebuild_steps(label, solve, A, rhs, x, extra,
                                            failures)
    elif label == "CP1":
        summary["rebuild"] = a9_cpr_rebuild(solve, A, rhs, failures)
    counts, plain_calls = read_counts()
    print("[%s] kernels launched: %s" % (
        label, json.dumps({k: v for k, v in counts.items() if v})))
    for f in faults:
        failures.append("%s: %s" % (label, f))
    if any(plain_calls.values()):
        failures.append("%s: plain versions ran: %s" % (label, plain_calls))
    for k in A9_KERNELS[label]:
        if counts[k] == 0:
            failures.append("%s: kernel %s never launched" % (label, k))
    summary["busy"] = windowed_busy(label, solve, rhs, info.wall_time_s,
                                    A9_PROFILE_WINDOW.get(label))
    del solve
    gc.collect()
    torch.cuda.empty_cache()
    return counts, summary


def a9_family(failures, only=None):
    """Phase 11: the paths of A9_PATHS, each system made once. Returns
    ({label: counts}, {label: summary})."""
    t_phase = time.perf_counter()
    counts, summary = {}, {}
    for system in ("poisson", "fe", "stokes", "reservoir", "block_scalar"):
        labels = [p for p, v in A9_PATHS.items() if v[0] == system
                  and (only is None or p in only)]
        if not labels:
            continue
        t0 = time.perf_counter()
        A, rhs, extra = a9_problem(system)
        print("problem %s: %d rows, %d stored entries, made in %.3f s"
              % (system, A.nrows, A.nnz, time.perf_counter() - t0))
        for label in labels:
            t0 = time.perf_counter()
            counts[label], summary[label] = a9_path(label, A, rhs, extra,
                                                    failures)
            summary[label]["path_s"] = time.perf_counter() - t0
            print("[%s] path: %.1f s" % (label, summary[label]["path_s"]))
        del A
        gc.collect()
    print("phase 11: %.1f s" % (time.perf_counter() - t_phase))
    return counts, summary


# -- phase 12: bfloat16 hierarchies under a float32 Krylov loop ---------------

#: phase 12's paths: (system, call, refine). A bfloat16 hierarchy
#: (``AMGParams(dtype=torch.bfloat16)``) under a float32 Krylov loop
#: (``solver_dtype=torch.float32``) with float64 refinement, the JAX
#: package's "TPU-lean mixed precision" configuration (tests/test_amg.py)
BF_PATHS = {
    "BF1": ("poisson", "CG(maxiter=100, tol=1e-6); L0/L1 built on the "
            "device, fused legs", 3),
    "BF1h": ("poisson", "BF1 with device_setup=False, legs composed", 3),
    "BF1s": ("poisson", "BF1 with relax=Spai1() (host build)", 3),
    "BF2": ("fe", "U1's system, BiCGStab(maxiter=100, tol=1e-6, "
            "precond_side='left')", 3),
    "BF2s": ("fe", "BF2 with relax=Spai1()", 3),
}
#: the bfloat16 modes each phase-12 path must launch
BF_KERNELS = {
    "BF1": ("fused_down_sweep.bf16", "fused_up_sweep.bf16"),
    "BF1h": ("dia_residual.bf16", "dia_scaled_correction.bf16"),
    "BF1s": ("dia_spmv.bf16", "dia_residual.bf16"),
    "BF2": ("windowed_ell_residual.bf16",
            "windowed_ell_scaled_correction.bf16"),
    "BF2s": ("windowed_ell_spmv.bf16", "windowed_ell_residual.bf16"),
}
#: bfloat16's unit roundoff: the kernels' tolerance against their plain
#: versions, relative to the sum of a result's |terms|
BF16_U = 2.0 ** -8
#: phase-12 paths whose busy share is read over a window of this many
#: iterations without refinement (``windowed_busy``): 100 and more
#: iterations of small launches
BF_PROFILE_WINDOW = {"BF2": 30, "BF2s": 30}


def bf_make(label, A, dtype=torch.bfloat16, **dev):
    """Build phase 12's bundle ``label`` on ``A`` through make_solver, its
    hierarchy in ``dtype`` (bfloat16; float32 for the comparison build)
    under a float32 Krylov loop; ``dev`` holds ``device``."""
    import amgcl_tpu_torch as T
    prm = T.AMGParams(dtype=dtype)
    if label.endswith("s"):
        prm.relax = T.Spai1()
    solver = T.CG(maxiter=100, tol=1e-6) if label.startswith("BF1") \
        else T.BiCGStab(maxiter=100, tol=1e-6, precond_side="left")
    solve = T.make_solver(A, prm, solver, solver_dtype=torch.float32,
                          refine=BF_PATHS[label][2],
                          device_setup=False if label == "BF1h" else None,
                          **dev)
    if label == "BF1h":
        # the earlier path's cycle: every leg composed
        for lv in solve.precond.hierarchy.levels:
            lv.down = lv.up = None
    return solve


def bf_reach(label, solve):
    """The structure phase 12 holds path ``label`` to: (lines, faults)."""
    hier = solve.precond.hierarchy
    lines, faults = [], []
    for i, lv in enumerate(hier.levels):
        lines.append("level %d: %d rows, %s %s, fused down %s, up %s%s" % (
            i, lv.A.shape[0], type(lv.A).__name__,
            str(lv.A.dtype).split(".")[-1], lv.down is not None,
            lv.up is not None, ", K %d" % lv.A.K
            if hasattr(lv.A, "K") else ""))
    if any(lv.A.dtype != torch.bfloat16 for lv in hier.levels):
        faults.append("a level operator is not bfloat16")
    if solve.A_dev.dtype != torch.float32:
        faults.append("the Krylov operator is %s" % solve.A_dev.dtype)
    rows = [lv.A.shape[0] for lv in hier.levels]
    if label == "BF1h" and rows != LEVEL_ROWS:
        faults.append("levels %s, expected %s" % (rows, LEVEL_ROWS))
    if label == "BF1":
        # device-built L0-L2, the device MIS below: the main path's
        check_levels(label, rows, [], MAIN_LEVEL_ROWS, [], faults)
    if label == "BF1":
        lv0 = hier.levels[0]
        if not solve.precond.device_built or lv0.down is None \
                or lv0.up is None or lv0.down.w is None:
            faults.append("L0 was not built on the device with both fused "
                          "legs (zero guess included)")
    if label.startswith("BF2"):
        fmts = [type(lv.A).__name__ for lv in hier.levels]
        check_levels(label, rows, fmts, U_LEVELS["U1"], U_FORMATS, faults)
    return lines, faults


def by_dtype(counts):
    """Launches with each BF16_MODES kernel's count split: ``<name>`` its
    float32 and float64 launches, ``<name>.bf16`` its bfloat16 ones."""
    out = dict(counts)
    for k in BF16_MODES:
        out[k] = counts[k] - counts[k + ".bf16"]
    return out


def bf_path(label, A, rhs, failures):
    """One phase-12 path: set-up, a cold and a warm solve with the counts
    set to 0 just before the setup and read just after, then (BF1, BF1h,
    BF2) the float32 hierarchy of the same call built and solved (counts
    paused) for its bytes, peak memory and iterations, and one more warm
    solve profiled. Returns (counts by
    dtype, summary, solve)."""
    _, call, refine = BF_PATHS[label]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    solve = bf_make(label, A)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    lines, faults = bf_reach(label, solve)
    for line in lines:
        print("[%s] %s" % (label, line))
    x, info = solve(rhs)
    cold = info.wall_time_s
    x, info = solve(rhs)
    counts, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    nbytes = solve.precond.hierarchy.bytes()
    maxiter = solve.solver.maxiter
    true_res = true_residual(A, rhs, x)
    print("[%s] %s, refine %d: setup %.3f s, %d iterations, reported "
          "resid %.3e, true %.3e; cold %.4f s, warm %.4f s"
          % (label, call, refine, t_setup, info.iters, info.resid, true_res,
             cold, info.wall_time_s))
    # the float32 hierarchy of the same call, for its bytes, peak and
    # iterations (BF1, BF1h and BF2; BF1s and BF2s, which only add
    # a launching path for B.1 and B.8, skip it)
    iters32 = bytes32 = peak32 = None
    if not label.endswith("s"):
        with counts_paused():
            torch.cuda.reset_peak_memory_stats()
            base32 = torch.cuda.memory_allocated()
            s32 = bf_make(label, A, torch.float32)
            iters32 = s32(rhs)[1].iters
            peak32 = torch.cuda.max_memory_allocated() - base32
            bytes32 = s32.precond.hierarchy.bytes()
            del s32
            gc.collect()
            torch.cuda.empty_cache()
        print("[%s] hierarchy bytes (AMG.bytes) %d against %d in float32 "
              "(%.3f); peak device memory over setup and both solves %.1f "
              "MB against %.1f MB for the float32 hierarchy's setup and one "
              "solve, which takes %d iterations"
              % (label, nbytes, bytes32, nbytes / bytes32, peak / 2**20,
                 peak32 / 2**20, iters32))
    else:
        print("[%s] hierarchy bytes (AMG.bytes) %d; peak device memory "
              "over setup and both solves %.1f MB" % (label, nbytes,
                                                     peak / 2**20))
    split = by_dtype(counts)
    print("[%s] launches by kernel and dtype (setup + 2 solves): %s"
          % (label, json.dumps({k: v for k, v in split.items() if v})))
    print("[%s] plain-version calls: %s" % (label, sum(plain_calls.values())))
    if info.iters >= (1 + refine) * maxiter or not (
            np.all(np.isfinite(x.double().cpu().numpy()))
            and true_res <= 1e-6):
        faults.append("%d iterations (maxiter %d, refine %d), true residual "
                      "%.3e > 1e-6" % (info.iters, maxiter, refine,
                                       true_res))
    # BF1 at most twice the main path's float32 count under the same
    # setup (16 under the device setup, BF1h's 12 under the host setup);
    # BF2 at most three times the float32 hierarchy's count under the
    # same call: its left-preconditioned solves stop at the
    # preconditioned residual, and the refinement then takes up to
    # 1 + refine of them where the float32 hierarchy takes two (PERF.md §6)
    main32 = ITERS_EXPECTED if label == "BF1h" else MAIN_ITERS
    if label in ("BF1", "BF1h") and info.iters > 2 * main32:
        faults.append("%d iterations, more than twice the main path's %d"
                      % (info.iters, main32))
    if label == "BF2" and info.iters > 3 * iters32:
        faults.append("%d iterations, more than three times the float32 "
                      "hierarchy's %d" % (info.iters, iters32))
    if any(plain_calls.values()):
        faults.append("plain versions ran: %s" % plain_calls)
    for k in BF_KERNELS[label]:
        if counts[k] == 0:
            faults.append("bfloat16 mode %s never launched" % k)
    for f in faults:
        failures.append("%s: %s" % (label, f))
    busy = windowed_busy(label, solve, rhs, info.wall_time_s,
                         BF_PROFILE_WINDOW.get(label))
    return split, {"setup_s": t_setup, "cold_solve_s": cold,
                   "warm_solve_s": info.wall_time_s, "iters": info.iters,
                   "resid": info.resid, "true_resid": true_res,
                   "iters_float32": iters32,
                   "bytes": nbytes, "bytes_float32": bytes32,
                   "peak_mb": peak / 2**20, "peak_float32_mb":
                   None if peak32 is None else peak32 / 2**20,
                   "busy": busy}, solve


def bf16_ulps(a, b):
    """The largest distance between two bfloat16 tensors in units in the
    last place: their bit patterns mapped to integers in value order."""
    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return int((key(a) - key(b)).abs().max()) if a.numel() else 0


def check_bf16_kernels(bf1, bf2, failures):
    """Each bfloat16 mode against its plain version on the paths' own
    operators: B.1 and B.2 on BF1's L0 and L1 (A, M, Mᵀ), the fused legs
    at BF1's L0 and L1, B.8 and B.9 on BF2's L0 (A, M, Mᵀ), random
    bfloat16 vectors. |Δ| ≤ u · Σ|terms| per entry (u = 2⁻⁸; the modes
    round as their plain versions, so the ULP report is expected to be
    0), timed as in check_kernels with the bound in bfloat16 bytes.
    Returns the records, keyed ``<name>.bf16``."""
    from amgcl_tpu_torch.ops import device as dev
    from amgcl_tpu_torch.ops import vcycle_kernels as vk
    from amgcl_tpu_torch.ops import well_kernels as wk
    W = wrappers()
    rng = np.random.RandomState(20261019)
    bf = torch.bfloat16
    L, U = bf1.precond.hierarchy.levels, bf2.precond.hierarchy.levels

    def vec(n):
        return torch.as_tensor(rng.standard_normal(n)).to(device="cuda",
                                                           dtype=bf)
    cases = [("dia_spmv", "BF1 L0 A", L[0].A), ("dia_spmv", "BF1 L1 A",
                                                L[1].A),
             ("dia_residual", "BF1 L0 A", L[0].A),
             ("dia_residual", "BF1 L1 A", L[1].A),
             ("dia_residual", "BF1 L0 M", L[0].P.M),
             ("dia_residual", "BF1 L0 Mt", L[0].R.Mt),
             ("dia_scaled_correction", "BF1 L0 A", L[0].A),
             ("dia_scaled_correction", "BF1 L1 A", L[1].A),
             ("windowed_ell_spmv", "BF2 L0 A", U[0].A),
             ("windowed_ell_residual", "BF2 L0 A", U[0].A),
             ("windowed_ell_residual", "BF2 L0 M", U[0].P.M),
             ("windowed_ell_residual", "BF2 L0 Mt", U[0].R.Mt),
             ("windowed_ell_scaled_correction", "BF2 L0 A", U[0].A)]
    weights = {"BF1 L0 A": L[0].relax.scale, "BF1 L1 A": L[1].relax.scale,
               "BF2 L0 A": U[0].relax.scale}
    records = {}

    def record(key, label, r, ulps, shape):
        print("%-36s %-10s err %.3e (tol %.3e)  ulps %d  ms %.4f  plain "
              "%.4f  library %s  bound %.4f (%s)  %s"
              % (key, label, r["max_abs_err"], r["tol"], ulps, r["ms"],
                 r["plain_ms"], "%.4f" % r["library_ms"]
                 if r["library_ms"] is not None else "none", r["bound_ms"],
                 r["bound_by"], "ok" if r["ok"] else "FAIL"))
        if not r["ok"]:
            failures.append("%s %s disagrees with its plain version"
                            % (key, label))
        if key not in records:       # the first case: the path's L0
            records[key] = {k: r[k] for k in RECORD_KEYS}
            records[key].update(ulps=ulps, shape=shape)
        else:
            records[key].setdefault("more", {})[label] = {
                "ms": r["ms"], "ulps": ulps, "bound_ms": r["bound_ms"]}

    for name, label, M in cases:
        kern, plain = W[name]
        n, m = M.shape
        x, f = vec(m), vec(n)
        w = weights.get(label)
        lib = None
        if hasattr(M, "window_starts"):
            geo = (M.window_starts, M.cols_local, M.vals)
            fmt_bytes = n * M.K * (2 + 4) + M.window_starts.numel() * 4
            nnz = int((M.vals != 0).sum())
            terms = wk.windowed_ell_spmv_plain(
                M.window_starts, M.cols_local, M.vals.abs().float(),
                x.abs().float(), n)
            args = {"windowed_ell_spmv": geo + (x, n),
                    "windowed_ell_residual": geo + (f, x, n),
                    "windowed_ell_scaled_correction":
                        geo + (w, f, x, n)}[name]
            shape = "%s %dx%d, K %d, window %d, bfloat16" % (
                label, n, m, M.K, M.win)
        else:
            off = M.offsets_t
            fmt_bytes = M.data.numel() * 2
            nnz = live_entries(M)
            terms = dev.DiaMatrix(M.offsets, M.data.abs().float(),
                                  M.shape).mv(x.abs().float())
            args = {"dia_spmv": (off, M.data, x),
                    "dia_residual": (off, M.data, f, x),
                    "dia_scaled_correction": (off, M.data, w, f, x)}[name]
            shape = "%s %dx%d, %d diagonals, bfloat16" % (
                label, n, m, len(M.offsets))
        # Σ|terms| of each entry, in float32
        if name.endswith("spmv"):
            scale = terms
            nbytes, ops = fmt_bytes + (m + n) * 2, 2 * nnz
            C = library_csr(M)
            lib = lambda: torch.mv(C, x)
        elif name.endswith("residual"):
            scale = terms + f.abs().float()
            nbytes, ops = fmt_bytes + (m + 2 * n) * 2, 2 * nnz + n
            C = library_csr(M)
            lib = lambda: torch.addmv(f, C, x, alpha=-1.0)
        else:
            scale = w.abs().float() * (terms + f.abs().float()) \
                + x.abs().float()
            nbytes, ops = fmt_bytes + (m + 3 * n) * 2, 2 * nnz + 3 * n
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = bool(((got.float() - want.float()).abs()
                   <= BF16_U * scale).all())
        r = {"max_abs_err": err, "ok": ok, "tol": BF16_U * float(scale.max()),
             "ms": time_ms(lambda: kern(*args)),
             "plain_ms": time_ms(lambda: plain(*args)), "library_ms": None}
        if lib is not None:
            try:
                r["library_ms"] = time_ms(lib)
            except RuntimeError as e:      # a yardstick, not the port
                print("library call for %s.bf16 unavailable: %s"
                      % (name, str(e).splitlines()[0]))
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops, bf)
        record(name + ".bf16", label, r, bf16_ulps(got, want), shape)

    # the fused legs at BF1's L0 and L1: zero guess (the path's mode),
    # base and up
    for i in (0, 1):
        lv = L[i]
        A, M, Mt, w, T = lv.A, lv.P.M, lv.R.Mt, lv.relax.scale, lv.R.T
        if lv.down is None or lv.up is None:
            failures.append("BF1 L%d: no fused legs to check" % i)
            continue
        dims, (n, nc) = T.fine, T.shape
        f, u, uc = vec(n), vec(n), vec(nc)
        f32 = lambda t: t.abs().float()
        for mode in ("zero", "base", "up"):
            if mode == "up":
                name = "fused_up_sweep"
                args = (A.offsets, A.data, M.offsets, M.data, w, f, u, uc,
                        dims)
                terms = vk.fused_up_sweep_plain(
                    A.offsets_t, -f32(A.data), M.offsets_t, -f32(M.data),
                    f32(w), f32(f), f32(u), f32(uc), dims)
                nbytes = (A.data.numel() + M.data.numel() + 4 * n + nc) * 2
                ops = 2 * (live_entries(A) + live_entries(M)) + 4 * n
                nops = len(M.offsets)
            else:
                name = "fused_down_sweep"
                zero = mode == "zero"
                xw = w if zero else u
                args = (A.offsets, A.data, Mt.offsets, Mt.data, f, xw, dims,
                        zero)
                terms = vk.fused_down_sweep_plain(
                    A.offsets_t, -f32(A.data), Mt.offsets_t, -f32(Mt.data),
                    f32(f), f32(xw), dims, zero)
                nbytes = (A.data.numel() + Mt.data.numel() + 2 * n + nc
                          + (n if zero else 0)) * 2
                ops = 2 * (live_entries(A) + live_entries(Mt)) + n \
                    + (n if zero else 0)
                nops = len(Mt.offsets)
            kern, plain = W[name]
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            trip = list(zip(*(v if isinstance(v, tuple) else (v,)
                              for v in (got, want, terms))))
            err = max(float((g.float() - p_.float()).abs().max())
                      for g, p_, _ in trip)
            ok = all(bool(((g.float() - p_.float()).abs()
                           <= BF16_U * t).all()) for g, p_, t in trip)
            r = {"max_abs_err": err, "ok": ok,
                 "tol": max(BF16_U * float(t.max()) for _, _, t in trip),
                 "ms": time_ms(lambda: kern(*args)),
                 "plain_ms": time_ms(lambda: plain(*args)),
                 "library_ms": None}
            r["bound_ms"], r["bound_by"] = bound(nbytes, ops, bf)
            ulps = max(bf16_ulps(g, p_) for g, p_, _ in trip)
            label = "BF1 L%d %s" % (i, mode)
            record(name + ".bf16", label, r, ulps,
                   "%s, fine %s, %d + %d diagonals, bfloat16, tile %s" % (
                       label, "x".join(map(str, dims)), len(A.offsets), nops,
                       (vk.up_tile(A.offsets, M.offsets, dims, bf)
                        if mode == "up" else
                        vk.down_tile(A.offsets, Mt.offsets, dims, bf)),))
    return records


def bf16_family(failures, only=None):
    """Phase 12: the paths of BF_PATHS, each system made once, then every
    bfloat16 mode held against its plain version on BF1's and BF2's
    operators. Returns ({label: counts}, {label: summary}, records)."""
    from amgcl_tpu_torch import fe_like_problem, poisson3d
    t_phase = time.perf_counter()
    counts, summary, keep = {}, {}, {}
    for system, make in (("poisson", lambda: poisson3d(128)),
                         ("fe", fe_like_problem)):
        labels = [p for p, v in BF_PATHS.items() if v[0] == system
                  and (only is None or p in only)]
        if not labels:
            continue
        A, rhs = make()
        for label in labels:
            t0 = time.perf_counter()
            counts[label], summary[label], solve = bf_path(label, A, rhs,
                                                           failures)
            summary[label]["path_s"] = time.perf_counter() - t0
            print("[%s] path: %.1f s" % (label, summary[label]["path_s"]))
            if label in ("BF1", "BF2"):
                keep[label] = solve
            del solve
            gc.collect()
            torch.cuda.empty_cache()
        del A
        gc.collect()
    records = {}
    if "BF1" in keep and "BF2" in keep:
        records = check_bf16_kernels(keep["BF1"], keep["BF2"], failures)
    del keep
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 12: %.1f s" % (time.perf_counter() - t_phase))
    return counts, summary, records


# -- phase 13: the accelerator setup -----------------------------------------

#: RO1: the seed of the random symmetric permutation of U1's system (a
#: mesh numbered in arbitrary order)
RO1_SEED = 1701
#: RO2: the JAX package's advisor fixture (a band of half-width 4 under a
#: random symmetric permutation, telemetry/structure.permuted_banded)
#: with strongly coupled values, at a size under the executed reorder's
#: 3,000,000-nonzero ceiling
RO2_ROWS = 300_000
#: RB2's value scales: exact (power-of-two) drifts, under which a fresh
#: build's transfer operators equal the ones a rebuild keeps, bit for bit
RB2_SCALES = (2.0, 0.5, 4.0)
#: kernels RO1's call (U1's: right-preconditioned BiCGStab, refine=3)
#: must launch on the reordered hierarchy
RO1_KERNELS = ("windowed_ell_residual", "windowed_ell_scaled_correction",
               "windowed_ell_spmv_dots", "bicgstab_tail")
#: kernels RO2 must launch on its reordered DIA levels
RO2_KERNELS = ("dia_residual", "dia_scaled_correction", "dia_spmv_dots",
               "xr_update")


def device_tensors(obj, depth=0):
    """The tensors an object of the port holds, depth first (its
    attributes, lists and nested objects of the package)."""
    if torch.is_tensor(obj):
        return [obj]
    if depth > 3 or obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        items = obj
    elif type(obj).__module__.startswith("amgcl_tpu_torch") \
            and hasattr(obj, "__dict__"):
        items = vars(obj).values()
    else:
        return []
    return [t for v in items for t in device_tensors(v, depth + 1)]


def hierarchy_differences(a, b):
    """Where two AMGs differ: host levels (ptr, col, values) and device
    values (level operators, transfers, smoother states, the coarse
    inverse), compared bit for bit. An empty list when they are equal."""
    out = []
    if len(a.host_levels) != len(b.host_levels):
        return ["%d levels against %d" % (len(a.host_levels),
                                          len(b.host_levels))]
    for i, ((Ai, _, _), (Bi, _, _)) in enumerate(zip(a.host_levels,
                                                     b.host_levels)):
        for f in ("ptr", "col", "val"):
            if not np.array_equal(getattr(Ai, f), getattr(Bi, f)):
                out.append("host level %d: %s" % (i, f))
    for i, (lv, lw) in enumerate(zip(a.hierarchy.levels,
                                     b.hierarchy.levels)):
        for part in ("A", "P", "R", "relax"):
            ts = device_tensors(getattr(lv, part))
            us = device_tensors(getattr(lw, part))
            if len(ts) != len(us) or not all(
                    t.shape == u.shape and t.dtype == u.dtype
                    and torch.equal(t, u) for t, u in zip(ts, us)):
                out.append("device level %d: %s" % (i, part))
    if not torch.equal(a.hierarchy.coarse.inv, b.hierarchy.coarse.inv):
        out.append("coarse inverse")
    return out


def plan_kinds(amg):
    """Each host level's Galerkin route: the segment-sum plan's kind,
    "oversize" past its flop guard, or "scipy"."""
    kinds = []
    for _, P, _ in amg.host_levels[:-1]:
        plan = getattr(P, "_seg_plan", None)
        kinds.append(plan.kind if plan is not None else "oversize"
                     if getattr(P, "_seg_plan_oversize", None) else "scipy")
    return kinds


def u1_call():
    from amgcl_tpu_torch import BiCGStab
    return BiCGStab(maxiter=100, tol=1e-6, precond_side="right")


def ro1_path(A, rhs, failures):
    """RO1: U1's system under a random symmetric permutation, U1's call
    with ``reorder="rcm"`` (auto declines it, printed with the advisor's
    gains), then the same with ``reorder="off"``. Returns (solve, counts,
    summary, (Ap, rhs_p))."""
    from amgcl_tpu_torch.telemetry import structure as st
    from amgcl_tpu_torch.utils.adapters import permute
    p = np.random.RandomState(RO1_SEED).permutation(A.nrows)
    Ap, rhs_p = permute(A, p), rhs[p]
    t0 = time.perf_counter()
    auto, _, adv = st.auto_variant(Ap)
    print("[RO1] advisor (%.3f s): identity best %s %d bytes; %s; "
          "reorder='auto' variant: %s" % (
              time.perf_counter() - t0, adv["identity"]["best"],
              adv["identity"]["bytes"], "; ".join(
                  "%s best %s gain %s" % (v["variant"], v["best"],
                                          v["gain"])
                  for v in adv["variants"]), auto))
    solve, x, info, counts, plain_calls, warm, t_setup = solve_cold_warm(
        Ap, rhs_p, "RO1", u1_call(), 3, make_kw=dict(reorder="rcm"))
    plan = solve.precond.reorder_plan
    print(solve.precond)
    rows, fmts = describe_levels("RO1", solve)
    print("[RO1] reorder: variant %s, predicted gain %s (forced; the "
          "advisor's best %s)" % (
              None if plan is None else plan["variant"],
              None if plan is None else plan["predicted_gain"],
              adv.get("best", {}).get("gain")))
    true_res = true_residual(Ap, rhs_p, x)
    print("[RO1] true relative residual in the caller's order (host "
          "float64): %.3e" % true_res)
    if plan is None or plan["variant"] != "rcm":
        failures.append("RO1: the reorder did not fire")
    check_levels("RO1", rows, fmts, RO1_LEVELS, U_FORMATS, failures)
    check_iters("RO1", info.iters, RO1_ITERS, failures, rel=0.1)
    if true_res > 1e-6:
        failures.append("RO1: true residual %.3e > 1e-6" % true_res)
    if any(plain_calls.values()):
        failures.append("RO1: plain versions ran: %s" % plain_calls)
    for k in RO1_KERNELS:
        if counts[k] == 0:
            failures.append("RO1: kernel %s never launched" % k)
    print("[RO1] operator products: windowed_ell_spmv %d, gather_spmv %d"
          % (counts["windowed_ell_spmv"], counts["gather_spmv"]))
    with counts_paused():
        off, x_off, info_off, _, _, _, t_off = solve_cold_warm(
            Ap, rhs_p, "RO1 off", u1_call(), 3, make_kw=dict(reorder="off"))
        rows_off, fmts_off = describe_levels("RO1 off", off)
    print("[RO1] warm solve: reordered %.4f s, %d iterations, levels %s; "
          "reorder='off' %.4f s, %d iterations, levels %s %s"
          % (info.wall_time_s, info.iters, rows, info_off.wall_time_s,
             info_off.iters, rows_off, fmts_off))
    del off
    gc.collect()
    return solve, counts, {
        "setup_s": t_setup, "warm_solve_s": info.wall_time_s,
        "iters": info.iters, "true_resid": true_res, "levels": rows,
        "formats": fmts, "off_warm_solve_s": info_off.wall_time_s,
        "off_iters": info_off.iters, "off_levels": rows_off,
        "off_setup_s": t_off}, (Ap, rhs_p)


def ro2_path(failures):
    """RO2: the scrambled band under CG with ``reorder="auto"``: the
    advisor's plan must fire (gain at least 1.15) and put the fine level
    on DIA. Returns (counts, summary)."""
    from amgcl_tpu_torch import CG, CSR
    from amgcl_tpu_torch.telemetry import structure as st
    Ab = st.permuted_banded(RO2_ROWS, bw=4, seed=RO1_SEED)[0]
    rows_b = Ab.expanded_rows()
    A = CSR(Ab.ptr, Ab.col, np.where(rows_b == Ab.col, 8.5, -1.0),
            Ab.ncols)
    rhs = np.ones(A.nrows)
    solve, x, info, counts, plain_calls, warm, t_setup = solve_cold_warm(
        A, rhs, "RO2", CG(maxiter=100, tol=1e-6), 3,
        make_kw=dict(reorder="auto"))
    plan = solve.precond.reorder_plan
    print(solve.precond)
    rows, fmts = describe_levels("RO2", solve)
    true_res = true_residual(A, rhs, x)
    print("[RO2] reorder: %s; true relative residual %.3e" % (
        None if plan is None else "variant %s, predicted gain %s"
        % (plan["variant"], plan["predicted_gain"]), true_res))
    if plan is None or plan["predicted_gain"] < 1.15 \
            or fmts[0] != "DiaMatrix":
        failures.append("RO2: plan %s, L0 %s" % (
            None if plan is None else plan["predicted_gain"], fmts[0]))
    if info.iters >= 4 * 100 or true_res > 1e-6:
        failures.append("RO2: %d iterations, true residual %.3e"
                        % (info.iters, true_res))
    if any(plain_calls.values()):
        failures.append("RO2: plain versions ran: %s" % plain_calls)
    for k in RO2_KERNELS:
        if counts[k] == 0:
            failures.append("RO2: kernel %s never launched" % k)
    return counts, {"setup_s": t_setup, "warm_solve_s": info.wall_time_s,
                    "iters": info.iters, "true_resid": true_res,
                    "levels": rows, "formats": fmts,
                    "predicted_gain": None if plan is None
                    else plan["predicted_gain"]}


def rb2_path(A, rhs, ro1, Ap, rhs_p, failures):
    """RB2: U1's system and call built twice (the builds must agree bit
    for bit), then three rebuilds with RB2_SCALES through the cached
    plans, each against a fresh build of the same values: host levels
    and device values bit for bit, the same count; then one rebuild of
    RO1 with values in the caller's order, through val_perm. Returns
    (counts, summary)."""
    from amgcl_tpu_torch import AMGParams, CSR, make_solver

    def build(M, **kw):
        return make_solver(CSR(M.ptr, M.col, M.val, M.ncols),
                           AMGParams(dtype=torch.float32), u1_call(),
                           refine=3, **kw)

    reset_counts()
    solve, t_setup, mb = a9_timed_build(lambda: build(A))
    with counts_paused():
        twin, t_twin, _ = a9_timed_build(lambda: build(A))
        diff = hierarchy_differences(solve.precond, twin.precond)
    del twin
    print("[RB2] setup %.3f s (again %.3f s), peak %.1f MB; levels %s, "
          "Galerkin routes %s; two builds differ in: %s" % (
              t_setup, t_twin, mb,
              [h[0].nrows for h in solve.precond.host_levels],
              plan_kinds(solve.precond), diff or "nothing"))
    if diff:
        failures.append("RB2: two builds of one system differ in %s" % diff)
    steps = []
    for s in RB2_SCALES:
        As = CSR(A.ptr, A.col, A.val * s, A.ncols)
        _, t_rb, mb_rb = a9_timed_build(lambda: solve.rebuild(As))
        x, info = solve(rhs)
        with counts_paused():
            fresh, t_f, mb_f = a9_timed_build(lambda: build(As))
            _, info_f = fresh(rhs)
            diff = hierarchy_differences(solve.precond, fresh.precond)
        del fresh
        gc.collect()
        true_res = true_residual(As, rhs, x)
        print("[RB2] scale %g: rebuild %.3f s, peak %.1f MB (fresh build "
              "%.3f s, peak %.1f MB); %d iterations (fresh %d), true "
              "residual %.3e; differs from the fresh build in: %s"
              % (s, t_rb, mb_rb, t_f, mb_f, info.iters, info_f.iters,
                 true_res, diff or "nothing"))
        if diff or info.iters != info_f.iters or true_res > 1e-6:
            failures.append("RB2 scale %g: differs in %s, %d iterations "
                            "(fresh %d), true residual %.3e" % (
                                s, diff, info.iters, info_f.iters,
                                true_res))
        steps.append({"scale": s, "rebuild_s": t_rb, "fresh_setup_s": t_f,
                      "iters": info.iters, "fresh_iters": info_f.iters,
                      "true_resid": true_res})
    # RO1's hierarchy lives in its RCM frame; the caller's values are in
    # the original order
    As = CSR(Ap.ptr, Ap.col, Ap.val * 2.0, Ap.ncols)
    _, t_rb, _ = a9_timed_build(lambda: ro1.rebuild(As))
    x, info = ro1(rhs_p)
    with counts_paused():
        fresh, t_f, _ = a9_timed_build(lambda: build(As, reorder="rcm"))
        _, info_f = fresh(rhs_p)
        diff = hierarchy_differences(ro1.precond, fresh.precond)
    del fresh
    true_res = true_residual(As, rhs_p, x)
    print("[RB2] RO1 rebuild in the caller's order: %.3f s (fresh build "
          "%.3f s); %d iterations (fresh %d), true residual %.3e; differs "
          "from the fresh build in: %s" % (t_rb, t_f, info.iters,
                                           info_f.iters, true_res,
                                           diff or "nothing"))
    if diff or info.iters != info_f.iters or true_res > 1e-6:
        failures.append("RB2 RO1 rebuild: differs in %s, %d iterations "
                        "(fresh %d), true residual %.3e" % (
                            diff, info.iters, info_f.iters, true_res))
    counts, plain_calls = read_counts()
    if any(plain_calls.values()):
        failures.append("RB2: plain versions ran: %s" % plain_calls)
    return counts, {"setup_s": t_setup, "steps": steps,
                    "ro1_rebuild_s": t_rb, "ro1_fresh_setup_s": t_f,
                    "ro1_iters": info.iters}


def di1_path(failures):
    """DI1: the main path's call with ``device_inv=True``: the coarsest
    level inverted on the card (the gate's residual printed); the count
    within one of the main path's, built beside it. Returns (counts,
    summary)."""
    from amgcl_tpu_torch import CG, poisson3d
    A, rhs = poisson3d(128)
    with counts_paused():
        main, _, info_m, _, _, _, _ = solve_cold_warm(
            A, rhs, "DI1 main", CG(maxiter=100, tol=1e-6), 3)
        inv_main = main.precond.hierarchy.coarse.inv
    del main
    solve, x, info, counts, plain_calls, warm, t_setup = solve_cold_warm(
        A, rhs, "DI1", CG(maxiter=100, tol=1e-6), 3,
        make_kw=dict(device_inv=True))
    coarse = solve.precond.hierarchy.coarse
    rnorm = coarse.device_rnorm
    gap = float((coarse.inv.double() - inv_main.double()).abs().max()
                / inv_main.double().abs().max())
    true_res = true_residual(A, rhs, x)
    print("[DI1] coarsest %d rows; device inverse ||AX - I||_F/sqrt(n) = "
          "%s (kept below 1e-3), largest difference from the host float64 "
          "inverse %.3e of its largest entry; %d iterations (main path "
          "%d), true residual %.3e" % (
              coarse.inv.shape[0], rnorm, gap, info.iters, info_m.iters,
              true_res))
    if rnorm is None or not rnorm < 1e-3:
        failures.append("DI1: device inverse residual %s" % rnorm)
    if abs(info.iters - info_m.iters) > 1 or true_res > 1e-6:
        failures.append("DI1: %d iterations (main path %d), true residual "
                        "%.3e" % (info.iters, info_m.iters, true_res))
    if any(plain_calls.values()):
        failures.append("DI1: plain versions ran: %s" % plain_calls)
    return counts, {"setup_s": t_setup, "iters": info.iters,
                    "main_iters": info_m.iters, "rnorm": rnorm,
                    "inverse_gap": gap, "true_resid": true_res}


def mis1_path(A, failures):
    """MIS1: the device MIS on U1's strength graph, twice on the card and
    once on the CPU: all three must agree. Returns the summary."""
    from amgcl_tpu_torch.coarsening.device_mis import aggregates_on_device
    got, times = [], []
    for dev_ in ("cuda", "cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got.append(aggregates_on_device(A, 0.08, dev_))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    same = [n == got[0][1] and np.array_equal(a, got[0][0])
            for a, n in got[1:]]
    print("[MIS1] %d rows: %d aggregates; card %.3f s and %.3f s, CPU "
          "%.3f s (strength graph included); second card run equal: %s, "
          "CPU equal: %s" % (A.nrows, got[0][1], times[0], times[1],
                             times[2], same[0], same[1]))
    if not all(same):
        failures.append("MIS1: card runs equal %s, CPU equal %s"
                        % tuple(same))
    return {"n_agg": got[0][1], "card_s": times[:2], "cpu_s": times[2]}


def p13_family(failures, only=None):
    """Phase 13: RO1, RO2, RB2, DI1 and MIS1 (those in ``only``, all
    without). Returns ({label: counts}, {label: summary})."""
    from amgcl_tpu_torch import fe_like_problem
    t_phase = time.perf_counter()
    want = {"RO1", "RO2", "RB2", "DI1", "MIS1"} if only is None else only
    counts, summary = {}, {}
    A, rhs = fe_like_problem()
    if want & {"RO1", "RB2"}:
        ro1, counts["RO1"], summary["RO1"], (Ap, rhs_p) = ro1_path(
            A, rhs, failures)
        if "RB2" in want:
            counts["RB2"], summary["RB2"] = rb2_path(A, rhs, ro1, Ap, rhs_p,
                                                     failures)
        del ro1
        gc.collect()
        torch.cuda.empty_cache()
    if "MIS1" in want:
        summary["MIS1"] = mis1_path(A, failures)
    if "RO2" in want:
        counts["RO2"], summary["RO2"] = ro2_path(failures)
    if "DI1" in want:
        counts["DI1"], summary["DI1"] = di1_path(failures)
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 13: %.1f s" % (time.perf_counter() - t_phase))
    return counts, summary


# -- phase 14: serving (A.11a) -------------------------------------------------

#: SV1's and BC1's bucket, SV2's, and the requests SV1 submits: one full
#: bucket and one of 5 padded with 3 zero columns
SV_B = 8
SV2_B = 4
SV_SUBMITS = 13
SV_SEED = 1811
#: kernels each path must launch, by their wrappers (the Krylov side's
#: per-column products and tails) or inside its graph replays (which
#: launch the preconditioner's kernels without Python); a bucket's
#: warm-up and capture are kept out of the wrapper counts
SV_KERNELS = {
    "SV1": ("fused_down_sweep", "fused_up_sweep", "dia_residual",
            "dia_scaled_correction", "dia_spmv_dots", "dia_residual_dot",
            "xr_update"),
    "SV2": ("windowed_ell_residual", "windowed_ell_scaled_correction",
            "windowed_ell_spmv_dots", "bicgstab_tail"),
    "BC1": ("fused_down_sweep", "fused_up_sweep", "dia_spmv",
            "dia_residual"),
}


def uncounted_captures(pre):
    """Keep the bucket captures of StackedPrecond ``pre`` out of the
    wrapper counts: a wrapper called while a graph is captured records
    its kernel, which runs at each replay, and the one warm-up apply
    before it is not the path's own work. The wrapper holds ``pre``
    weakly, so that it makes no reference cycle: a released bundle's
    preconditioner, graphs and hierarchy are freed at once (phase 15
    measures that). Returns ``pre``."""
    ref = weakref.ref(pre)
    capture = type(pre)._capture

    def counted_apart(*args):
        with counts_paused():
            return capture(ref(), *args)

    pre._capture = counted_apart
    return pre


def window_replays(pre, before):
    """Replays of each bucket since the snapshot ``before`` (a copy of
    ``pre.replays`` taken when the window opened)."""
    return {B: v - before.get(B, 0) for B, v in pre.replays.items()
            if v - before.get(B, 0)}


def sv_columns(rhs, B, seed):
    """B seeded right-hand sides (standard normal), column 0 the path's
    own rhs."""
    R = np.random.default_rng(seed).standard_normal((rhs.shape[0], B))
    R[:, 0] = rhs
    return R


def sv_singles(bundle, R):
    """Each column's single-rhs solve through ``bundle`` (counts paused,
    one warm-up first): (iterations, x columns, seconds of the B
    sequential solves)."""
    with counts_paused():
        bundle(R[:, 0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [bundle(R[:, b]) for b in range(R.shape[1])]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return [info.iters for _, info in got], [x for x, _ in got], secs


def sv_hold(label, A, R, x, per, singles, tol, failures, counts=True):
    """Each column: reported residual ≤ tol, host float64 true residual at
    most twice its single-rhs solve's, iterations within ±1 of it (with
    ``counts``). Returns the true residuals."""
    s_iters, s_x, _ = singles
    trues = []
    for b in range(R.shape[1]):
        t = true_residual(A, R[:, b], x[:, b])
        ts = true_residual(A, R[:, b], s_x[b])
        trues.append(t)
        bad = []
        if not per["resid"][b] <= tol:
            bad.append("reported resid %.3e > %g" % (per["resid"][b], tol))
        if not t <= 2 * ts:
            bad.append("true resid %.3e > 2 x single %.3e" % (t, ts))
        if counts and abs(per["iters"][b] - s_iters[b]) > 1:
            bad.append("%d iterations, single %d" % (per["iters"][b],
                                                     s_iters[b]))
        print("[%s] column %d: %d iterations (single %d), reported %.3e, "
              "true %.3e (single %.3e)%s" % (
                  label, b, per["iters"][b], s_iters[b], per["resid"][b], t,
                  ts, "" if not bad else " FAIL: " + "; ".join(bad)))
        if bad:
            failures.append("%s column %d: %s" % (label, b, "; ".join(bad)))
    return trues


def sv_graphs(label, pre, failures):
    """Each captured bucket's replay against the eager per-column apply,
    bit for bit, on a seeded block (counts paused); returns the
    preconditioner kernels one replay launches, counted on the eager
    apply of the same bucket."""
    rng = np.random.default_rng(SV_SEED + 1)
    per_replay = {}
    with counts_paused():
        for n, B, dtype in list(pre._buckets):
            R = torch.as_tensor(rng.standard_normal((B, n)), dtype=dtype,
                                device="cuda").T
            got = pre(R)
            reset_counts()
            want = pre.eager(R)
            launched, _ = read_counts()
            per_replay[B] = {k: v for k, v in launched.items()
                             if v and not k.endswith(".bf16")}
            same = torch.equal(got, want)
            print("[%s] bucket B=%d: replay equal to the eager per-column "
                  "apply bit for bit: %s; one replay runs %s" % (
                      label, B, same, json.dumps(per_replay[B])))
            if not same:
                failures.append("%s: bucket %d replay differs from the eager"
                                " apply by %.3e" % (label, B, float(
                                    (got - want).abs().max())))
    return per_replay


def sv_report(label, pre, replays, counts, plain_calls, per_replay,
              failures):
    """Print the path's launches, its buckets' captures and its window's
    replays (``replays``), and check its kernels and plain calls; returns
    the launches inside those replays by kernel, derived as the window's
    replays of each bucket times the kernels one eager apply of that
    bucket launches (a replay runs every kernel its capture recorded,
    which is that apply's; sv_timing holds a graph batch's trace against
    an uncaptured batch's)."""
    launched = {k: v for k, v in counts.items() if v}
    replayed = {}
    for B, per in per_replay.items():
        for k, v in per.items():
            replayed[k] = replayed.get(k, 0) + v * replays.get(B, 0)
    print("[%s] lowering %s; captures by bucket %s, capture seconds %s, "
          "replays in the window %s" % (
              label, pre.lowering, json.dumps(pre.captures),
              json.dumps({b: round(v, 4) for b, v in pre.capture_s.items()}),
              json.dumps(replays)))
    print("[%s] kernels launched by their wrappers (the Krylov side; "
          "captures not counted): %s" % (label, json.dumps(launched)))
    print("[%s] kernel launches inside the window's graph replays (derived: "
          "replays x one eager apply's launches): %s"
          % (label, json.dumps(replayed)))
    print("[%s] plain-version calls: %d" % (label, sum(plain_calls.values())))
    if pre.lowering != "per-column-graph":
        failures.append("%s: lowering %s" % (label, pre.lowering))
    if any(plain_calls.values()):
        failures.append("%s: plain versions ran: %s" % (label, plain_calls))
    for k in SV_KERNELS[label]:
        if not counts[k] + replayed.get(k, 0):
            failures.append("%s: kernel %s never launched" % (label, k))
    return replayed


#: warm batches timed for each reading (the median is kept)
SV_TIMED = 3


def sv_profile(label, svc, R, pre):
    """One warm batch under torch.profiler: the device's busy time and the
    port's kernels the trace shows by symbol (measured; a graph replay's
    kernels are in the trace as an eager launch's are). The profiler
    takes one batch to warm up first, whose events it drops: a trace
    begun with the batch missed its first kernels in some runs. Returns
    (busy ms, profiled wall ms, {symbol: count}); busy and the symbols
    None without device events."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        svc.solve_batch(R)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        svc.solve_batch(R)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    # the step's own span ("ProfilerStep*") carries device time too
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    if not rows:
        print("[%s] profiled warm batch (%s): no device time recorded (busy "
              "share and kernels not measured)" % (label, pre.lowering))
        return None, wall_ms, None
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    port = {e.key: e.count for e in rows if "amgcl_port::" in e.key}
    print("[%s] profiled warm batch (%s): wall %.3f ms, device busy %.3f ms "
          "(%.1f%%), the port's kernels in the trace %d" % (
              label, pre.lowering, wall_ms, busy, 100 * busy / wall_ms,
              sum(port.values())))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print("  %9.3f ms %5d x  %s" % (e.self_device_time_total / 1e3,
                                        e.count, e.key[:90]))
    return busy, wall_ms, port


def sv_timing(label, svc, R, singles, pre, lowerings=None):
    """Warm batches under each lowering of ``lowerings`` in turn (the
    bucket's graph alone without; set on ``pre`` and restored): the
    median wall of SV_TIMED batches and its solves/s beside the B
    sequential single-rhs solves', then one profiled batch
    (sv_profile), whose busy time over that median is the busy share.
    With the graph and the uncaptured apply both read, their traces'
    port kernels are compared symbol by symbol (the replays ran what the
    wrappers launch eagerly). Counts paused. Returns the first reading's
    figures with every reading under ``readings``."""
    from amgcl_tpu_torch.serve import GRAPH, UNCAPTURED
    kept = pre.lowering
    B = R.shape[1]
    readings, traced = [], {}
    with counts_paused():
        try:
            for lowering in lowerings or (GRAPH,):
                pre.lowering = lowering
                svc.solve_batch(R)
                walls = []
                for _ in range(SV_TIMED):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    svc.solve_batch(R)
                    walls.append(time.perf_counter() - t0)
                warm = statistics.median(walls)
                print("[%s] warm batch of %d (%s): %.2f ms (median of %s), "
                      "%.2f solves/s; %d sequential single-rhs solves: "
                      "%.2f ms, %.2f solves/s (x%.2f)" % (
                          label, B, lowering, warm * 1e3,
                          ", ".join("%.2f" % (w * 1e3) for w in walls),
                          B / warm, B, singles[2] * 1e3, B / singles[2],
                          singles[2] / warm))
                busy, pwall, port = sv_profile(label, svc, R, pre)
                if port is not None:
                    traced.setdefault(lowering, port)
                readings.append({
                    "lowering": lowering, "warm_batch_ms": warm * 1e3,
                    "batch_solves_per_s": B / warm,
                    "busy_share": None if busy is None
                    else busy / (warm * 1e3),
                    "busy_share_profiled": None if busy is None
                    else busy / pwall,
                    "port_kernels_traced": None if port is None
                    else sum(port.values())})
        finally:
            pre.lowering = kept
    if len(readings) > 1:
        print("[%s] busy shares by lowering: %s" % (label, json.dumps(
            [(r["lowering"], r["busy_share"]) for r in readings])))
    same = None
    if GRAPH in traced and UNCAPTURED in traced:
        same = traced[GRAPH] == traced[UNCAPTURED]
        diff = {k: (traced[GRAPH].get(k, 0), traced[UNCAPTURED].get(k, 0))
                for k in set(traced[GRAPH]) | set(traced[UNCAPTURED])
                if traced[GRAPH].get(k, 0) != traced[UNCAPTURED].get(k, 0)}
        print("[%s] the graph batch's trace shows the uncaptured batch's "
              "port kernels symbol by symbol: %s%s" % (
                  label, same, "" if same else " (graph, uncaptured): "
                  + json.dumps({k[:60]: v for k, v in diff.items()})))
    first = readings[0]
    return {"warm_batch_ms": first["warm_batch_ms"],
            "batch_solves_per_s": first["batch_solves_per_s"],
            "single_ms": singles[2] * 1e3,
            "single_solves_per_s": B / singles[2],
            "busy_share": first["busy_share"], "readings": readings,
            "traces_agree": same}


def sv1_path(A, rhs, failures):
    """SV1: the main path's system through SolverService(batch=8): a
    solve_batch of 8 seeded columns, cold then warm, then 13 submits (one
    full bucket and one of 5 padded with zero columns). Returns (bundle,
    singles, counts, summary)."""
    from amgcl_tpu_torch import AMGParams, CG, make_solver
    from amgcl_tpu_torch.serve import SolverService
    R = sv_columns(rhs, SV_B, SV_SEED)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = make_solver(A, AMGParams(dtype=torch.float32),
                         CG(maxiter=100, tol=1e-6), refine=0, batch=SV_B)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    pre = uncounted_captures(bundle.stacked_precond())
    before = dict(pre.replays)
    svc = SolverService(bundle)
    x, rep = svc.solve_batch(R)
    print("[SV1] setup %.3f s; solve_batch of %d (cold, captures the bucket):"
          " %.4f s, iterations %s" % (t_setup, SV_B, rep.wall_time_s,
                                      rep.extra["per_rhs"]["iters"]))
    x, rep = svc.solve_batch(R)
    print("[SV1] solve_batch (warm): %.4f s, %.2f solves/s"
          % (rep.wall_time_s, rep.solves_per_sec))
    with svc:
        futs = [svc.submit(R[:, k % SV_B]) for k in range(SV_SUBMITS)]
        got = [f.result(timeout=300) for f in futs]
        stats = svc.stats()
    counts, plain_calls = read_counts()
    replays = window_replays(pre, before)
    peak = torch.cuda.max_memory_allocated()
    singles = sv_singles(bundle, R)
    sv_hold("SV1", A, R, x, rep.extra["per_rhs"], singles, 1e-6, failures)
    sub_x = torch.stack([xk for xk, _ in got], dim=1)
    sub_R = np.stack([R[:, k % SV_B] for k in range(SV_SUBMITS)], axis=1)
    sub_s = tuple([s[k % SV_B] for k in range(SV_SUBMITS)]
                  for s in singles[:2]) + (singles[2],)
    sv_hold("SV1 submits", A, sub_R, sub_x,
            {"iters": [r.iters for _, r in got],
             "resid": [r.resid for _, r in got]}, sub_s, 1e-6, failures)
    spans = got[-1][1].serve
    print("[SV1] submits: batches %d, padded slots %d, buckets %s; last "
          "request's spans %s; stats spans %s" % (
              stats["batches"], stats["padded_slots"],
              sorted({r.serve["bucket_B"] for _, r in got}),
              json.dumps(spans), json.dumps(stats["spans_ms"])))
    if stats["padded_slots"] == 0:
        failures.append("SV1: the 13 submits made no padded bucket")
    if pre.captures != {SV_B: 1}:
        failures.append("SV1: captures %s, expected one of bucket %d"
                        % (pre.captures, SV_B))
    per_replay = sv_graphs("SV1", pre, failures)
    replayed = sv_report("SV1", pre, replays, counts, plain_calls,
                         per_replay, failures)
    # the graph against the same bundle's uncaptured per-column apply,
    # alternated: what the bucket's graph does to a warm batch
    from amgcl_tpu_torch.serve import GRAPH, UNCAPTURED
    timing = sv_timing("SV1", svc, R, singles, pre,
                       (GRAPH, UNCAPTURED, GRAPH, UNCAPTURED))
    print("[SV1] peak device memory over setup, batches and submits: %.1f MB"
          % (peak / 2**20))
    return bundle, singles, counts, {
        "setup_s": t_setup, "iters": rep.extra["per_rhs"]["iters"],
        "captures": pre.captures, "capture_s": pre.capture_s,
        "replays": replays, "replayed_launches": replayed,
        "padded_slots": stats["padded_slots"], "peak_mb": peak / 2**20,
        **timing}


def bc1_path(A, rhs, bundle, singles, failures):
    """BC1: BlockCG on SV1's system and hierarchy, B = 8, with a stacked
    preconditioner and bucket graph of its own (the bundle's copy drops
    SV1's, so no replay of SV1's is counted here): each column's reported
    residual ≤ tol, its true one at most twice its single-rhs BlockCG
    solve's, and the block's count no more than SV1's worst CG column.
    Returns (counts, summary)."""
    import copy
    from amgcl_tpu_torch.serve import BlockCG, SolverService
    R = sv_columns(rhs, SV_B, SV_SEED)
    bc = copy.copy(bundle)
    bc.solver = BlockCG(maxiter=100, tol=1e-6)
    bc._stacked = None
    pre = uncounted_captures(bc.stacked_precond())
    svc = SolverService(bc)
    reset_counts()
    before = dict(pre.replays)
    torch.cuda.reset_peak_memory_stats()
    x, rep = svc.solve_batch(R)
    x, rep = svc.solve_batch(R)
    counts, plain_calls = read_counts()
    replays = window_replays(pre, before)
    peak = torch.cuda.max_memory_allocated()
    per = rep.extra["per_rhs"]
    bc_singles = sv_singles(bc, R)
    sv_hold("BC1", A, R, x, per, bc_singles, 1e-6, failures, counts=False)
    worst = max(singles[0])
    print("[BC1] BlockCG %d iterations (per column %s), worst CG column %d"
          % (rep.iters, per["iters"], worst))
    if rep.iters > worst:
        failures.append("BC1: %d iterations > the worst CG column's %d"
                        % (rep.iters, worst))
    if pre is bundle.stacked_precond() or pre.captures != {SV_B: 1}:
        failures.append("BC1: captures %s, expected one bucket of its own"
                        % pre.captures)
    per_replay = sv_graphs("BC1", pre, failures)
    replayed = sv_report("BC1", pre, replays, counts, plain_calls,
                         per_replay, failures)
    timing = sv_timing("BC1", svc, R, singles, pre)
    print("[BC1] peak device memory: %.1f MB" % (peak / 2**20))
    return counts, {"iters": rep.iters, "per_rhs_iters": per["iters"],
                    "worst_cg": worst, "replays": replays,
                    "replayed_launches": replayed,
                    "peak_mb": peak / 2**20, **timing}


def sv2_path(failures):
    """SV2: U1's system (fe_like_problem, identity order) under
    BiCGStab(maxiter=100, tol=1e-6), refine 0, B = 4 through
    solve_batch. Returns (counts, summary)."""
    from amgcl_tpu_torch import AMGParams, BiCGStab, fe_like_problem, \
        make_solver
    from amgcl_tpu_torch.serve import SolverService
    A, rhs = fe_like_problem()
    R = sv_columns(rhs, SV2_B, SV_SEED + 2)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = make_solver(A, AMGParams(dtype=torch.float32),
                         BiCGStab(maxiter=100, tol=1e-6), refine=0,
                         batch=SV2_B)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    pre = uncounted_captures(bundle.stacked_precond())
    before = dict(pre.replays)
    svc = SolverService(bundle)
    x, rep = svc.solve_batch(R)
    x, rep = svc.solve_batch(R)
    counts, plain_calls = read_counts()
    replays = window_replays(pre, before)
    peak = torch.cuda.max_memory_allocated()
    print("[SV2] setup %.3f s; warm solve_batch of %d: iterations %s"
          % (t_setup, SV2_B, rep.extra["per_rhs"]["iters"]))
    singles = sv_singles(bundle, R)
    sv_hold("SV2", A, R, x, rep.extra["per_rhs"], singles, 1e-6, failures)
    per_replay = sv_graphs("SV2", pre, failures)
    replayed = sv_report("SV2", pre, replays, counts, plain_calls,
                         per_replay, failures)
    timing = sv_timing("SV2", svc, R, singles, pre)
    print("[SV2] peak device memory: %.1f MB" % (peak / 2**20))
    return counts, {"setup_s": t_setup, "iters": rep.extra["per_rhs"]["iters"],
                    "captures": pre.captures, "replays": replays,
                    "replayed_launches": replayed,
                    "peak_mb": peak / 2**20, **timing}


def p14_family(failures, only=None):
    """Phase 14: SV1, BC1 and SV2 (those in ``only``, all without; BC1
    runs on SV1's bundle). Returns ({label: counts}, {label: summary})."""
    from amgcl_tpu_torch import poisson3d
    t_phase = time.perf_counter()
    want = {"SV1", "BC1", "SV2"} if only is None else only
    counts, summary = {}, {}
    if want & {"SV1", "BC1"}:
        A, rhs = poisson3d(128)
        bundle, singles, c, sm = sv1_path(A, rhs, failures)
        if "SV1" in want:
            counts["SV1"], summary["SV1"] = c, sm
        if "BC1" in want:
            counts["BC1"], summary["BC1"] = bc1_path(A, rhs, bundle, singles,
                                                     failures)
        del bundle
        gc.collect()
        torch.cuda.empty_cache()
    if "SV2" in want:
        counts["SV2"], summary["SV2"] = sv2_path(failures)
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 14: %.1f s" % (time.perf_counter() - t_phase))
    return counts, summary


# -- phase 15: the solver farm and the open-loop storm (A.11b) ---------------

#: FM1's bucket, and the seeds of its requests and of ST1's schedule
FM_B = 8
FM_SEED = 1911
ST_SEED = 19
#: ST1's ladder in multiples of the closed-loop rate R, and a rung's length
ST_LADDER = (0.25, 0.5, 1.0, 1.5)
ST_RUNG_S = 4.0
#: phase 15's time limit (s)
P15_LIMIT_S = 120.0
#: the entry each FM1 tenant maps onto (t-share shares t-main's)
FM_ENTRY = {"t-main": "main", "t-share": "main", "t-u1": "u1",
            "t-step": "step"}
#: kernels each window must launch, by the wrappers or in graph replays:
#: the main system's (SV1's) and U1's (SV2's)
FM_KERNELS = tuple(dict.fromkeys(SV_KERNELS["SV1"] + SV_KERNELS["SV2"]))


class FarmWatch:
    """Phase 15's instrumentation of one SolverFarm, by wrapping methods
    on the instance (the farm's code is unchanged): each entry's stacked
    preconditioners by generation (a readmission makes a new one) with
    their captures and replays after every batch, kept by value so that a
    released generation is freed; the allocated bytes around every
    eviction beside the charge the pool released; each readmission's
    seconds and allocated bytes; the pool after every batch."""

    def __init__(self, farm):
        self.farm = farm
        self.gens = []
        self.evictions = []
        self.readmissions = []
        self.batches = []
        self.names = {}
        evict, readmit = farm._evict_uid_locked, farm._readmit_admitting_locked

        def evict_uid(uid):
            charge = farm.pool.resident().get(uid, 0)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            evict(uid)
            torch.cuda.synchronize()
            self.evictions.append({
                "entry": self.names.get(uid, uid), "charge": charge,
                "before": before, "after": torch.cuda.memory_allocated()})

        def readmit_entry(entry):
            n0 = farm._n_readmissions
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            readmit(entry)
            torch.cuda.synchronize()
            if farm._n_readmissions > n0:
                self.readmissions.append({
                    "entry": self.names.get(entry.uid, entry.uid),
                    "wall_s": time.perf_counter() - t0,
                    "rebuild_s": entry.rebuild_s, "before": before,
                    "after": torch.cuda.memory_allocated(),
                    "charge": farm.pool.resident().get(entry.uid, 0)})

        farm._evict_uid_locked = evict_uid
        farm._readmit_admitting_locked = readmit_entry

    def watch(self, name, entry):
        """Follow ``entry`` (once): its bundle's stacked preconditioners
        (captures kept out of the wrapper counts) and its batches."""
        if entry.uid in self.names:
            return
        self.names[entry.uid] = name
        bundle, svc, farm, gens = (entry.obj, entry.payload["service"],
                                   self.farm, self.gens)
        make, run = bundle.stacked_precond, svc._run_batch

        def stacked_precond():
            fresh = bundle._stacked is None
            pre = make()
            if fresh:
                uncounted_captures(pre)
                pre.fm_gen = len(gens)
                gens.append({"entry": name, "captures": {}, "replays": {}})
            return pre

        def run_batch(batch):
            try:
                return run(batch)
            finally:
                pre = bundle._stacked
                if pre is not None and hasattr(pre, "fm_gen"):
                    gens[pre.fm_gen].update(captures=dict(pre.captures),
                                            replays=dict(pre.replays))
                self.batches.append({
                    "entry": name, "requests": len(batch),
                    "used": farm.pool.used,
                    "total": None if farm.pool.unlimited
                    else farm.pool.total,
                    "allocated": torch.cuda.memory_allocated()})

        bundle.stacked_precond = stacked_precond
        svc._run_batch = run_batch

    def snapshot(self):
        return [dict(g["replays"]) for g in self.gens]

    def replays_since(self, snap):
        """{entry: {B: replays}} since ``snap``."""
        out = {}
        for i, g in enumerate(self.gens):
            was = snap[i] if i < len(snap) else {}
            for B, v in g["replays"].items():
                if v - was.get(B, 0):
                    row = out.setdefault(g["entry"], {})
                    row[B] = row.get(B, 0) + v - was.get(B, 0)
        return out


def fm_bytes_split(bundle):
    """What an entry's charge (``AMG.bytes()``) holds: the distinct
    storages of the hierarchy and the device-built prefix, those of the
    plans' device index arrays, and beside them ``Hierarchy.bytes()``
    (operators, transfers, smoother states and the coarse inverse summed
    part by part, a shared tensor again in each part: the counterpart of
    the JAX package's leaf walk)."""
    from amgcl_tpu_torch.utils.devices import held_tensors, storage_bytes
    amg = bundle.precond
    hier = storage_bytes(held_tensors(amg.hierarchy, amg._dev_prefix),
                         amg.device)
    plans = storage_bytes(held_tensors(
        [seg._dev for seg in amg._plan_segments()]), amg.device)
    return {"charge": amg.bytes(), "hierarchy": hier, "plans": plans,
            "leaf_walk": amg.hierarchy.bytes()}


def fm_replayed(watch, replays, per_column):
    """Kernel launches inside graph replays, derived: each entry's
    replays of bucket B times B times the launches of one column's eager
    apply on that entry (the bucket's graph replays the per-column apply
    it captured; sv_graphs holds each replay to the eager apply)."""
    out = {}
    for name, rows in replays.items():
        for B, n in rows.items():
            for k, v in per_column.get(name, {}).items():
                out[k] = out.get(k, 0) + int(round(v * B * n))
    return out


def fm_per_column(label, farm, watch, failures):
    """Each resident entry's bucket graphs against the eager per-column
    apply, bit for bit (sv_graphs), and the launches of one column's
    eager apply, by entry."""
    per_column = {}
    for uid, name in watch.names.items():
        entry = farm._entry_by_uid(uid)
        pre = entry.obj._stacked if entry is not None else None
        if pre is None or not pre._buckets:
            continue
        per_B = sv_graphs("%s %s" % (label, name), pre, failures)
        B, row = next(iter(per_B.items()))
        per_column[name] = {k: v / B for k, v in row.items()}
    return per_column


def fm_answers(label, A_of, answers, singles, failures):
    """FM1's rule for each answer ``(tenant, k, x, rep)``: reported
    residual ≤ 1e-6, the count equal to the same bundle's single-rhs
    solve of that rhs, and the host float64 true residual at most twice
    that solve's (checked on the host where x is not that solve's bit
    for bit). Returns (answers, bit-for-bit equal to the single solve)."""
    same = 0
    bad = []
    for tenant, k, x, rep in answers:
        s_x, s_iters, s_true, rhs = singles[tenant][k]
        why = []
        if not rep.resid <= 1e-6:
            why.append("reported %.3e" % rep.resid)
        if rep.iters != s_iters:
            why.append("%d iterations, single %d" % (rep.iters, s_iters))
        if torch.equal(x, s_x):
            same += 1
        else:
            t = true_residual(A_of[tenant], rhs, x)
            if not t <= 2 * s_true:
                why.append("true %.3e > 2 x single %.3e" % (t, s_true))
        if why:
            bad.append("%s rhs %d: %s" % (tenant, k, "; ".join(why)))
    print("[%s] %d answers: %d bit for bit the single-rhs solve's, %d "
          "failing the residual rule" % (label, len(answers), same, len(bad)))
    for b in bad[:8]:
        failures.append("%s: %s" % (label, b))
    if len(bad) > 8:
        failures.append("%s: %d more answers failing" % (label, len(bad) - 8))
    return len(answers), same


def fm_singles(farm, systems, rhs_sets):
    """Each tenant's single-rhs solves through its own bundle (counts
    paused, the entries resident): {tenant: [(x, iters, true residual,
    rhs), ...]} in the order of ``rhs_sets[tenant]``."""
    out = {}
    with counts_paused():
        for t, rows in rhs_sets.items():
            bundle = farm.tenants[t].entry.obj
            out[t] = []
            for rhs in rows:
                x, info = bundle(rhs)
                out[t].append((x, info.iters,
                               true_residual(systems[t], rhs, x), rhs))
    return out


def fm_round(farm, rhs_of):
    """Submit one request per tenant of ``rhs_of`` at once; wait for all.
    Returns {tenant: (x, report)}."""
    futs = [(t, farm.submit(t, rhs)) for t, rhs in rhs_of.items()]
    return {t: f.result(timeout=600) for t, f in futs}


def fm_memory_probe(farm, watch, rhs, failures):
    """t-main's operator evicted and readmitted on its own (t-main and
    t-share submitting, as in the rounds): the allocated bytes fall by at
    least 90% of the charge the pool released, and after the readmission
    (its bucket's graph captured again) come back to within 10% of their
    value before the eviction."""
    pair = {t: rhs[t] for t in ("t-main", "t-share")}
    fm_round(farm, pair)
    uid = farm.tenants["t-main"].entry.uid
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    charge = farm.pool.resident().get(uid, 0)
    n_evict = len(watch.evictions)
    farm.evict("t-main")
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    fm_round(farm, pair)
    torch.cuda.synchronize()
    back = torch.cuda.memory_allocated()
    others = len(watch.evictions) - n_evict - 1
    print("[FM1] probe: allocated %.1f MB before t-main's eviction, %.1f MB "
          "after (charge released %.1f MB, drop %.1f%% of it), %.1f MB after "
          "its readmission (%+.2f%%); other evictions meanwhile: %d" % (
              before / 2**20, after / 2**20, charge / 2**20,
              100 * (before - after) / max(charge, 1), back / 2**20,
              100 * (back - before) / before, others))
    if before - after < 0.9 * charge:
        failures.append("FM1 probe: the eviction freed %d bytes, under 90%% "
                        "of the %d charged" % (before - after, charge))
    if abs(back - before) > 0.1 * before:
        failures.append("FM1 probe: %d bytes allocated after the readmission "
                        "against %d before the eviction" % (back, before))
    return {"before": before, "after": after, "charge": charge,
            "readmitted": back, "other_evictions": others}


def fm1_path(failures):
    """FM1: SolverFarm(batch=8) on the card with t-main (the main path's
    system), t-share (the same CSR bit for bit: a hit), t-u1 (U1's system
    under BiCGStab), t-step (the main system scaled by 1.05: a miss, its
    pattern's entry having live co-owners; then by 1.10: a rebuild of its
    own entry), then 0.75 of the used bytes as the budget and two
    round-robin rounds of one seeded rhs per tenant. (A diagonal scaled
    by 1.10 stalls smoothed aggregation's coarsening at L1 in both
    packages, and one scaled by 1.05 declines the device build below L0:
    a whole-matrix scale keeps the main system's hierarchy, so t-step's
    time steps are those.) Returns (farm, watch, systems, rhs, counts,
    summary)."""
    from amgcl_tpu_torch import (AMGParams, BiCGStab, CG, fe_like_problem,
                                 poisson3d)
    from amgcl_tpu_torch.ops.csr import CSR
    from amgcl_tpu_torch.serve import SolverFarm
    A, _ = poisson3d(128)
    Au, _ = fe_like_problem()

    def stepped(s):
        return CSR(A.ptr, A.col, A.val * s, A.ncols)

    prm = AMGParams(dtype=torch.float32)
    systems = {"t-main": A, "t-share": CSR(A.ptr, A.col, A.val.copy(),
                                          A.ncols),
               "t-u1": Au, "t-step": stepped(1.05)}
    farm = SolverFarm(batch=FM_B, metrics_port=0)
    watch = FarmWatch(farm)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    steps = [("t-main", systems["t-main"], "miss"),
             ("t-share", systems["t-share"], "hit"),
             ("t-u1", Au, "miss"), ("t-step", systems["t-step"], "miss"),
             ("t-step", stepped(1.10), "rebuild")]
    setup_s = []
    for tenant, M, want in steps:
        used0 = farm.pool.used
        solver = BiCGStab(maxiter=100, tol=1e-6) if tenant == "t-u1" \
            else CG(maxiter=100, tol=1e-6)
        t0 = time.perf_counter()
        out = farm.register(tenant, M, solver=solver, precond=prm)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        entry = farm.tenants[tenant].entry
        watch.watch(FM_ENTRY[tenant], entry)
        split = fm_bytes_split(entry.obj)
        setup_s.append({"tenant": tenant, "outcome": out["outcome"],
                        "s": secs, "bytes": out["bytes"], **split})
        print("[FM1] register %s: %s in %.3f s; charge %.1f MB (distinct "
              "storages: hierarchy %.1f MB, plans' device index arrays %.1f "
              "MB; Hierarchy.bytes() %.1f MB), pool %.1f MB, allocated %.1f "
              "MB" % (tenant, out["outcome"], secs, out["bytes"] / 2**20,
                      split["hierarchy"] / 2**20, split["plans"] / 2**20,
                      split["leaf_walk"] / 2**20, farm.pool.used / 2**20,
                      torch.cuda.memory_allocated() / 2**20))
        if out["outcome"] != want:
            failures.append("FM1: %s registered as a %s, expected a %s"
                            % (tenant, out["outcome"], want))
        if want == "hit" and farm.pool.used != used0:
            failures.append("FM1: the hit changed the pool's bytes (%d -> "
                            "%d)" % (used0, farm.pool.used))
    systems["t-step"] = steps[-1][1]
    used = farm.pool.used
    cap = int(0.75 * used)
    farm.set_max_bytes(cap)
    print("[FM1] budget 0.75 x %.1f MB = %.1f MB: resident %s, pool %.1f MB,"
          " allocated %.1f MB" % (
              used / 2**20, cap / 2**20,
              sorted(watch.names[u] for u in farm.pool.resident()),
              farm.pool.used / 2**20, torch.cuda.memory_allocated() / 2**20))
    rng = np.random.default_rng(FM_SEED)
    rhs = {t: rng.standard_normal(M.nrows) for t, M in systems.items()}
    rounds = [fm_round(farm, rhs) for _ in range(2)]
    probe = fm_memory_probe(farm, watch, rhs, failures)
    counts, plain_calls = read_counts()
    replays = watch.replays_since([])
    st = farm.stats()
    peak = torch.cuda.max_memory_allocated()
    # the same bundles' single-rhs solves, every entry resident again
    farm.set_max_bytes(0)
    with counts_paused():
        fm_round(farm, rhs)
    singles = fm_singles(farm, systems, {t: [rhs[t]] for t in systems})
    answers = [(t, 0, x, rep) for got in rounds for t, (x, rep) in
               got.items()]
    fm_answers("FM1", systems, answers, singles, failures)
    for t in systems:
        if not torch.equal(rounds[0][t][0], rounds[1][t][0]):
            failures.append("FM1: %s's round-2 x differs from round 1's" % t)
    per_column = fm_per_column("FM1", farm, watch, failures)
    replayed = fm_replayed(watch, replays, per_column)
    for row in st["tenants"]:
        print("[FM1] tenant %s: %s, %d requests, resident %s (%.1f MB), "
              "latency %s" % (row["tenant"], row["outcome"], row["requests"],
                              row["resident"], row["bytes"] / 2**20,
                              json.dumps(row.get("latency_ms"))))
    reg = st["registry"]
    print("[FM1] registry hits %d, misses %d, rebuilds %d; evictions %d, "
          "readmissions %d, batches %d" % (
              reg["hits"], reg["misses"], reg["rebuilds"], st["evictions"],
              st["readmissions"], st["batches"]))
    for ev in watch.evictions:
        print("[FM1] eviction of %s: allocated %.1f -> %.1f MB, charge "
              "released %.1f MB (drop %.1f%%)" % (
                  ev["entry"], ev["before"] / 2**20, ev["after"] / 2**20,
                  ev["charge"] / 2**20, 100 * (ev["before"] - ev["after"])
                  / max(ev["charge"], 1)))
        if ev["before"] - ev["after"] < 0.9 * ev["charge"]:
            failures.append("FM1: evicting %s freed %d bytes, under 90%% of "
                            "the %d released" % (ev["entry"], ev["before"]
                                                 - ev["after"], ev["charge"]))
    for rd in watch.readmissions:
        print("[FM1] readmission of %s: %.3f s (rebuild %.3f s), allocated "
              "%.1f -> %.1f MB, charge %.1f MB" % (
                  rd["entry"], rd["wall_s"], rd["rebuild_s"] or 0.0,
                  rd["before"] / 2**20, rd["after"] / 2**20,
                  rd["charge"] / 2**20))
    for b in watch.batches:
        if b["total"] is not None and b["used"] > b["total"]:
            failures.append("FM1: pool at %d bytes over its %d after a batch"
                            % (b["used"], b["total"]))
    print("[FM1] after each batch (entry, requests, pool MB / budget MB, "
          "allocated MB): %s" % json.dumps(
              [(b["entry"], b["requests"], round(b["used"] / 2**20, 1),
                None if b["total"] is None else round(b["total"] / 2**20, 1),
                round(b["allocated"] / 2**20, 1)) for b in watch.batches]))
    if st["evictions"] < 1 or st["readmissions"] < 1:
        failures.append("FM1: %d evictions, %d readmissions"
                        % (st["evictions"], st["readmissions"]))
    if reg["misses"] != 3:
        failures.append("FM1: %d registry misses, expected 3" % reg["misses"])
    if reg["rebuilds"] < 1 + st["readmissions"]:
        failures.append("FM1: %d rebuilds < 1 + %d readmissions"
                        % (reg["rebuilds"], st["readmissions"]))
    fm_window("FM1", counts, plain_calls, replays, replayed, failures)
    return farm, watch, systems, rhs, counts, {
        "setup": setup_s, "budget_bytes": cap,
        "evictions": [dict(e) for e in watch.evictions],
        "readmissions": [dict(r) for r in watch.readmissions],
        "registry": {k: reg[k] for k in ("hits", "misses", "rebuilds")},
        "batches": st["batches"], "probe": probe,
        "iters": {t: rounds[0][t][1].iters for t in systems},
        "replays": replays, "replayed_launches": replayed,
        "peak_mb": peak / 2**20}


def fm_window(label, counts, plain_calls, replays, replayed, failures):
    """Print a window's launches (by the wrappers; inside replays,
    derived) and hold it to no plain call and every FM_KERNELS kernel
    launched."""
    print("[%s] graph replays in the window by entry and bucket: %s"
          % (label, json.dumps(replays)))
    print("[%s] kernels launched by their wrappers (captures not counted): "
          "%s" % (label, json.dumps({k: v for k, v in counts.items() if v})))
    print("[%s] kernel launches inside the window's graph replays (derived: "
          "replays x B x one column's eager apply): %s"
          % (label, json.dumps(replayed)))
    print("[%s] plain-version calls: %d" % (label, sum(plain_calls.values())))
    if any(plain_calls.values()):
        failures.append("%s: plain versions ran: %s" % (label, {
            k: v for k, v in plain_calls.items() if v}))
    for k in FM_KERNELS:
        if not counts[k] + replayed.get(k, 0):
            failures.append("%s: kernel %s never launched" % (label, k))


def fm_profile(farm, tenant, rhs):
    """One warm full bucket of ``tenant`` through the farm under
    torch.profiler (the profiler warms up on one bucket first): the
    device's busy time over the batch's wall. Counts paused. Returns
    (busy ms or None, wall ms)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    reqs = {k: rhs for k in range(FM_B)}

    def bucket():
        futs = [farm.submit(tenant, r) for r in reqs.values()]
        for f in futs:
            f.result(timeout=600)
        torch.cuda.synchronize()

    with counts_paused(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        bucket()
        prof.step()
        t0 = time.perf_counter()
        bucket()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 if rows \
        else None
    print("[ST1] profiled warm bucket of %d %s requests: wall %.3f ms, device "
          "busy %s" % (FM_B, tenant, wall_ms, "not measured (no device time "
                       "recorded)" if busy is None else "%.3f ms (%.1f%%)"
                       % (busy, 100 * busy / wall_ms)))
    return busy, wall_ms


def st1_path(farm, watch, systems, rhs, failures):
    """ST1: on FM1's farm with the budget lifted, requests alternating
    between t-main and t-u1: the closed-loop rate R of one warm round of
    full buckets, then run_storm of Poisson 0.5 R for 8 s and bursts over
    0.25 R for 6 s (every 2 s, 8 at a time), seed 19, then run_ladder at
    0.25, 0.5, 1.0 and 1.5 R for 4 s a rung and its knee. No outcome may
    be an error, every ok answer meets FM1's residual rule, and the
    scraper reads /metrics with tenant labels and no scrape error.
    Returns (counts, summary)."""
    import urllib.request
    from amgcl_tpu_torch.serve import storm as S
    from amgcl_tpu_torch.telemetry import load as L
    tenants = ("t-main", "t-u1")
    rng = np.random.default_rng(FM_SEED + 1)
    rhs_sets = {t: [rhs[t], rng.standard_normal(systems[t].nrows)]
                for t in tenants}
    singles = fm_singles(farm, systems, rhs_sets)
    as32 = {t: [torch.as_tensor(r, dtype=torch.float32) for r in rows]
            for t, rows in rhs_sets.items()}
    snap = watch.snapshot()
    reset_counts()
    # R: one warm round of full buckets (the first round captures them)
    for timed in (False, True):
        t0 = time.perf_counter()
        futs = [farm.submit(t, as32[t][k % 2]) for t in tenants
                for k in range(FM_B)]
        for f in futs:
            f.result(timeout=600)
        wall = time.perf_counter() - t0
    R = len(tenants) * FM_B / wall
    print("[ST1] closed-loop rate R: %.3f solves/s (a warm round of %d full "
          "buckets in %.2f ms)" % (R, len(tenants), wall * 1e3))
    answers, last, scrapers = [], [None], []
    submit = farm.submit

    def rhs_for(tenant, rid):
        last[0] = (tenant, (rid // 2) % 2)
        return as32[tenant][last[0][1]]

    def recording_submit(tenant, r, **kw):
        fut = submit(tenant, r, **kw)
        t, k = last[0]
        fut.add_done_callback(lambda f, t=t, k=k: answers.append(
            (t, k) + f.result()) if f.exception() is None else None)
        return fut

    class CountedScraper(S._Scraper):
        def start(self):
            scrapers.append(self)
            return super().start()

    farm.submit = recording_submit
    kept = S._Scraper
    S._Scraper = CountedScraper
    try:
        sched = S.build_schedule(
            [S.poisson_phase(0.5 * R, 8.0),
             S.burst_phase(0.25 * R, 6.0, burst_every_s=2.0, burst_len=8)],
            tenants=tenants, seed=ST_SEED)
        for row in sched:
            row["tenant"] = tenants[row["rid"] % 2]
        storm = S.run_storm(farm, sched, rhs_for, drain_timeout_s=120.0)
        page = urllib.request.urlopen(farm.metrics_url, timeout=10).read() \
            .decode()
        n_storm, same_storm = fm_answers("ST1 storm", systems, answers,
                                         singles, failures)
        answers.clear()
        rungs = S.run_ladder(farm, [f * R for f in ST_LADDER], ST_RUNG_S,
                             rhs_for, tenants=tenants, seed=ST_SEED,
                             drain_timeout_s=120.0)
        n_ladder, same_ladder = fm_answers("ST1 ladder", systems, answers,
                                           singles, failures)
        answers.clear()
    finally:
        S._Scraper = kept
        del farm.submit
    counts, plain_calls = read_counts()
    replays = watch.replays_since(snap)
    busy, pwall = fm_profile(farm, "t-main", as32["t-main"][0])
    per_column = fm_per_column("ST1", farm, watch, failures)
    replayed = fm_replayed(watch, replays, per_column)
    summ = storm["summary"]
    lat = summ.get("latency_ms") or {}
    print("[ST1] storm: %d requests, offered %.3f, achieved %s, goodput %s "
          "solves/s; latency from the scheduled arrival p50 %s, p99 %s ms; "
          "outcomes %s; spans %s ms" % (
              summ["requests"], summ["offered_rps"], summ["achieved_rps"],
              summ["goodput_rps"], lat.get("p50"), lat.get("p99"),
              json.dumps(summ["outcomes"]), json.dumps(summ["spans_ms"])))
    curve = L.ladder_curve(rungs)
    knee = L.detect_knee(curve)
    for row in curve:
        print("[ST1] rung %.3f solves/s offered: measured %s, achieved %s, "
              "goodput %s, p50 %s, p99 %s ms, shed %s, timeouts %s, queue "
              "depth max %s" % (
                  row["offered_rps"], row["measured_offered_rps"],
                  row["achieved_rps"], row["goodput_rps"], row["p50_ms"],
                  row["p99_ms"], row["shed_rate"], row["timeout_rate"],
                  row["queue_depth_max"]))
    print("[ST1] knee: %s" % json.dumps(knee))
    outcomes = dict(summ["outcomes"])
    for r in rungs:
        for k, v in r["summary"]["outcomes"].items():
            outcomes[k] = outcomes.get(k, 0) + v
    if outcomes.get("error") or outcomes.get("pending"):
        failures.append("ST1: outcomes %s" % outcomes)
    errors = sum(s.errors for s in scrapers)
    rows = len(storm["gauges"]) + sum(len(r["gauges"]) for r in rungs)
    labelled = 'tenant="t-main"' in page and 'tenant="t-u1"' in page
    print("[ST1] /metrics over loopback: %d scrapers, %d samples, %d scrape "
          "errors, tenant labels %s" % (len(scrapers), rows, errors,
                                        labelled))
    if not rows or errors or not labelled:
        failures.append("ST1: %d scraped samples, %d scrape errors, tenant "
                        "labels %s" % (rows, errors, labelled))
    fm_window("ST1", counts, plain_calls, replays, replayed, failures)
    return counts, {
        "closed_loop_rps": R, "storm": {k: summ.get(k) for k in (
            "requests", "outcomes", "offered_rps", "achieved_rps",
            "goodput_rps", "latency_ms", "sched_lag_ms", "spans_ms",
            "span_share")},
        "answers": {"storm": [n_storm, same_storm],
                    "ladder": [n_ladder, same_ladder]},
        "curve": curve, "knee": knee, "outcomes": outcomes,
        "scrape": {"samples": rows, "errors": errors},
        "busy_share": None if busy is None else busy / pwall,
        "replays": replays, "replayed_launches": replayed}


def p15_family(failures, only=None):
    """Phase 15: FM1, then ST1 on FM1's farm (``only`` names FM1 alone to
    skip ST1). Returns ({label: counts}, {label: summary})."""
    t_phase = time.perf_counter()
    counts, summary = {}, {}
    farm, watch, systems, rhs, counts["FM1"], summary["FM1"] = \
        fm1_path(failures)
    if only is None or "ST1" in only:
        counts["ST1"], summary["ST1"] = st1_path(farm, watch, systems, rhs,
                                                 failures)
    for g in watch.gens:
        if any(v != 1 for v in g["captures"].values()):
            failures.append("phase 15: %s's bucket graphs captured %s times"
                            % (g["entry"], g["captures"]))
    print("[phase 15] preconditioner generations (a readmission makes one): "
          "%s" % json.dumps(watch.gens))
    farm.close()
    del farm, watch
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print("phase 15: %.1f s" % secs)
    if secs > P15_LIMIT_S:
        failures.append("phase 15 took %.1f s, over its %.0f s"
                        % (secs, P15_LIMIT_S))
    return counts, summary


def main(argv=()):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    print(card_line())
    print("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    from amgcl_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.lib()
    print("kernel build: %.2f s (nvcc, %s)"
          % (time.perf_counter() - t0, " + ".join(cuda_lib.SOURCES)))
    failures = []
    if argv and argv[0] in ("--phase10", "--phase11", "--phase12",
                            "--phase13", "--phase14", "--phase15"):
        # phase 10, 11, 12, 13, 14 or 15 alone, for the paths named (all
        # without names); no result line
        family = {"--phase10": a8_family, "--phase11": a9_family,
                  "--phase12": bf16_family, "--phase13": p13_family,
                  "--phase14": p14_family,
                  "--phase15": p15_family}[argv[0]]
        summary = family(failures, set(argv[1:]) or None)[1]
        print("%s paths: %s" % (argv[0][2:], json.dumps(summary)))
        for f in failures:
            print("FAIL: %s" % f, file=sys.stderr)
        return 1 if failures else 0
    solve, counts, summary = main_path(failures)
    records = check_kernels(solve, failures)
    records.update(check_fused(solve, failures))
    print("main path: %s" % json.dumps(summary))
    # release the poisson3d hierarchies, so that the unstructured paths'
    # peak device memory is their own
    del solve
    gc.collect()
    torch.cuda.empty_cache()
    u_solves, u_counts, u_summary, (A_u, rhs_u, perm) = unstructured_paths(
        failures)
    records.update(check_unstructured_kernels(u_solves, failures))
    print("unstructured paths: %s" % json.dumps(u_summary))
    # release U1's and U2's hierarchies, so that the block path's peak
    # device memory is its own
    del u_solves
    gc.collect()
    torch.cuda.empty_cache()
    b_solve, b_refined, b_counts, b_summary = block_path(failures)
    records.update(check_block_kernels(b_solve, b_refined, failures))
    print("block path: %s" % json.dumps(b_summary))
    # release B1's hierarchies, so that D2's peak device memory is its own
    del b_solve, b_refined
    gc.collect()
    torch.cuda.empty_cache()
    d_solve, d_counts, d_summary = dense_window_path(A_u, rhs_u, perm,
                                                     failures)
    records.update(check_densewin_kernels(d_solve, failures))
    print("dense-window path: %s" % json.dumps(d_summary))
    del d_solve
    gc.collect()
    torch.cuda.empty_cache()
    k_solve, k_counts, k_summary = bicgstabl_path(A_u, rhs_u, failures)
    records.update(check_axpby_dot(failures))
    print("BiCGStab(L) path: %s" % json.dumps(k_summary))
    del k_solve
    gc.collect()
    torch.cuda.empty_cache()
    g_counts, g_summary, g_records = gmres_family(failures)
    records.update(g_records)
    print("GMRES family paths: %s" % json.dumps(g_summary))
    s_counts, s_summary, s_records = sharded_stencil(failures)
    records.update(s_records)
    print("sharded stencil path: %s" % json.dumps(s_summary))
    a_counts, a_summary = a8_family(failures)
    print("phase 10 paths: %s" % json.dumps(a_summary))
    n_counts, n_summary = a9_family(failures)
    print("phase 11 paths: %s" % json.dumps(n_summary))
    bf_counts, bf_summary, bf_records = bf16_family(failures)
    records.update(bf_records)
    print("phase 12 paths: %s" % json.dumps(bf_summary))
    p13_counts, p13_summary = p13_family(failures)
    print("phase 13 paths: %s" % json.dumps(p13_summary))
    p14_counts, p14_summary = p14_family(failures)
    print("phase 14 paths: %s" % json.dumps(p14_summary))
    p15_counts, p15_summary = p15_family(failures)
    print("phase 15 paths: %s" % json.dumps(p15_summary))
    kernels = []
    for name in REPLACES:
        rec = records.get(name)
        if rec is None:
            failures.append("kernel %s has no record" % name)
            continue
        # phase 12's counts split by dtype (by_dtype): a kernel's float32
        # and float64 launches there, or its bfloat16 ones
        phase12 = {p: c[name] for p, c in bf_counts.items()}
        later = {"D2": d_counts[name], "K1": k_counts[name],
                 **{p: c[name] for p, c in g_counts.items()},
                 "S1": s_counts[name],
                 **{p: c[name] for p, c in a_counts.items()},
                 **{p: c[name] for p, c in n_counts.items()}, **phase12,
                 **{p: c[name] for p, c in p13_counts.items()},
                 **{p: c[name] for p, c in p14_counts.items()},
                 **{p: c[name] for p, c in p15_counts.items()}}
        if name.endswith(".bf16"):
            by_path = phase12
        elif name in FRAMED:
            by_path = {"S1": s_counts[name], "S1j": a_counts["S1j"][name]}
        elif name in UNSTRUCTURED:
            by_path = {"U1": u_counts["U1"][name],
                       "U2": u_counts["U2"][name], "B1": b_counts[name],
                       **later}
        elif name in BLOCK or name in DENSEWIN or name in ("axpby_dot",
                                                           "gather_spmv"):
            by_path = {"B1": b_counts[name], **later}
        else:
            by_path = {"main": counts[name], "B1": b_counts[name], **later}
        # launches on the main path, or over the paths a kernel serves
        launches = by_path.get("main") or sum(by_path.values())
        # phases 14 and 15: launches inside each path's graph replays
        # (derived: the window's replays x one eager apply's launches,
        # sv_report and fm_replayed)
        replayed = {p: sm["replayed_launches"][name]
                    for p, sm in list(p14_summary.items())
                    + list(p15_summary.items())
                    if sm["replayed_launches"].get(name)}
        kernels.append({
            "name": name, "route": "cuda",
            "source": source_of(name),
            "replaces": REPLACES[name], "launches": launches,
            "launches_by_path": by_path,
            **({"replayed_by_path": replayed} if replayed else {}), **rec})
    if failures:
        for f in failures:
            print("FAIL: %s" % f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
