"""Iteration counts of the JAX package and of the port on the CPU at
reduced sizes: the ILU smoothers on a scaled-down U1 system, and the
compositions of chip_smoke.py's phase 11.

    JAX_PLATFORMS=cpu python reference_counts.py [ROWS]
    JAX_PLATFORMS=cpu python reference_counts.py --a9
    JAX_PLATFORMS=cpu python reference_counts.py --a10
    JAX_PLATFORMS=cpu python reference_counts.py --a10-full [LABEL ...]
    JAX_PLATFORMS=cpu python reference_counts.py --a14
    JAX_PLATFORMS=cpu python reference_counts.py --a14-sides
    JAX_PLATFORMS=cpu python reference_counts.py --b17 [--full] [--first] [LABEL ...]
    JAX_PLATFORMS=cpu python reference_counts.py --b19 [--first] [LABEL ...]

``fe_like_problem(ROWS)`` (12,000 rows by default, U1's nonzeros a row)
with each of ILU(0), ILU(k=1) and ILU(p=1) under
``BiCGStab(maxiter=100, tol=1e-6)``, refine=3, as chip_smoke.py's paths
IL0, ILK and ILP call it, once with a float32 and once with a float64
hierarchy: one line per case with both packages' iterations (summed over
the refinement's restarts) and reported residuals. A full-size run (U1's
85,623 rows) is a chip-sized job this script is not meant for. It is the
source of chip_smoke.py's choice of float64 hierarchies for ILK and ILP.

``--a9`` runs each phase-11 configuration (``chip_smoke.A9_PATHS``) with
float32 hierarchies as the smoke calls it, on its system cut to a size
this CPU takes in seconds (poisson3d(32), fe_like_problem(12000) with
U1's nonzeros a row, stokes_like(128), reservoir_like(24, 3),
poisson3d_block(16, 3)), in both packages: one line per path with both
iteration counts (summed over refinement) and reported residuals. RB1's
rebuild steps and CP1's rebuild are left out.

``--a10`` runs the paths whose hierarchies the device setup changes, in
both packages with their setup on the device (``AMGCL_TPU_DEVICE_SETUP=1``
for the JAX package, ``device_setup=True`` for the port) and, for the JAX
package, with its host setup as well (``AMGCL_TPU_DEVICE_SETUP=0``), at
reduced sizes with float32 hierarchies as chip_smoke.py calls them: the
main path's call on poisson3d(64) (two device-built levels, the host
loop's MIS at 16³ as at 32³ in poisson3d(128)), U1/U2/K1 on U1's
system cut to 12,000 rows (RCM order and the left side for U2,
BiCGStab(2) for K1), D2 (U2 on dense windows),
G1/G1r on G1's system cut to 12,000 rows (GMRES; RCM and FGMRES) with
LGMRES and Richardson, B1 on poisson3d_block(16, 3) without and with
refine=3, and RO1: U1's cut system under chip_smoke.py's random
symmetric permutation, reordered by RCM (``AMGCL_TPU_REORDER=rcm``,
``reorder="rcm"``). One line per path: the JAX package's count under
the host setup, then both packages' counts (summed over the refinement)
and reported residuals under the device setup, and the coarse rows. The
JAX package's host setup runs its native set-up library's passes
(``amgcl_tpu/native.py``) where ``g++`` is present, as it is here; since
the port has its own copy of that library (``amgcl_tpu_torch/native.py``)
its host setup takes the same passes, so the host-setup counts quoted
from this script are both packages' native route.

``--a10-full [LABEL ...]`` runs the JAX package alone, under
``AMGCL_TPU_DEVICE_SETUP=1`` and ``AMGCL_TPU_REORDER=off`` (``rcm`` for
RO1), on each moved path of chip_smoke.py at its full size and with its
call: main (poisson3d(128), CG, refine=3), DF1 (the same with
``refine_dtype="df32"``), G2 (GMRES there), S1 (DistStencilSolver over a
four-device mesh: set ``XLA_FLAGS=--xla_force_host_platform_device_count=4``),
U1, U2, K1 and RO1 (``fe_like_problem()``), G1, G1r, LGMRES, IDRs and
Richardson (G1's system), B1 and B1 refine=3 (``poisson3d_block(48, 3)``)
and BK1 (its scalar form through make_block_solver). One line per path:
the iterations (summed over refinement), the reported residual, the
level rows and the seconds. chip_smoke.py's windows for these paths cite
these lines. With ``--port`` before the labels, the port runs each path
too (but S1), on the CPU with ``device_setup=True``; with ``--spread``,
each solve also runs on five rhs perturbed by 1e-6 relative, as
``--a14-sides`` does, and the line lists the six counts. Each path runs in seconds to a few minutes on an 8-core CPU;
poisson3d(128) takes a few GiB.

``--a14`` runs bfloat16 hierarchies under a float32 Krylov loop
(``AMGParams(dtype=bfloat16)``, ``solver_dtype=float32``) in both
packages at reduced sizes: chip_smoke.py's BF1 configuration on
poisson3d(32) and poisson3d(48), the JAX package's own bfloat16 test
(tests/test_amg.py, poisson3d(12)), fe_like_problem(12000) under
right-preconditioned ``BiCGStab(maxiter=200, tol=1e-6)`` without
refinement, and BF2's own call (left side, refine=3) on U1's system cut
to 12,000 rows: one line per case with both iteration counts and
reported residuals. ``--a14-sides`` runs that bfloat16 hierarchy on
fe_like_problem(12000) (the default nonzeros a row, and U1's) under
BiCGStab right- and left-preconditioned, without and with refine=3, on
the rhs and five rhs perturbed by 1e-6 relative: one line of both
packages' counts per case (the spread of a count under such a
perturbation).

``--b17`` runs chip_smoke.py's phase-16 calls, a bfloat16 hierarchy under
the JAX package's default bfloat16 Krylov loop (no ``solver_dtype``), at
reduced sizes in both packages: BFK1 (``CG(maxiter=100, tol=1e-6)``,
refine=3) on poisson3d(32) and poisson3d(48), BFK2
(``BiCGStabL(L=2, maxiter=100, tol=1e-6)``, refine=3) and BFG1
(``coarsening=RugeStuben()``, ``BiCGStab(maxiter=100, tol=1e-6,
precond_side="left")``, refine=3) on U1's system cut to 12,000 rows (U1's
nonzeros a row). Each call runs on the rhs and on five rhs perturbed by
1e-6 relative (:func:`perturbed`): one line per case with both packages'
six counts (summed over the refinement), their true relative residuals
(host float64) and the port's level rows. The JAX package's bfloat16
``jnp.linalg.solve`` is refused on the CPU, so BiCGStab(L)'s Gram
system runs there in float32 with its solution rounded once to bfloat16,
the port's rule (``ops/device.small_solve``). ``--full`` runs the JAX
package alone at the paths' full sizes (poisson3d(128),
``fe_like_problem()``) on the rhs: its count, true residual, level rows
and seconds; LABELs pick paths. ``--first`` runs the same calls with
refine=0: the first refinement pass alone, a bfloat16 solve from x = 0
that no float64 restart perturbs. Set ``AMGCL_TPU_DEVICE_SETUP=1`` for
the JAX package's device setup of BFK1 at full size, whose coarsest
level (1,006 rows) is the port's. With ``--first`` each line also gives
the first :data:`B17_HISTORY` entries of the residual history (the
solvers' ``record_history``) of the first rhs, in both packages, and
the relative difference between the two, entry by entry; there the
five other rhs are perturbed by 2⁻⁸ relative (a 1e-6 perturbation
vanishes when the rhs is rounded to bfloat16), and each package's
spread is, entry by entry, the largest relative difference of a
perturbed rhs's history from the first rhs's. ``--full --first`` then
runs the port's same call on the CPU on the card's route (device
setup, the default on a CUDA device) and prints its history too:
chip_smoke.py's P16_FIRST holds the card's first pass to it. The
JAX package on the CPU takes its XLA path (composed V-cycle legs,
bfloat16 products and sums as XLA rounds them, the CPU's format
thresholds), not the arithmetic of its TPU kernels, which the port's
kernels follow; at full size its history parts from the port's.

``--b19`` runs chip_smoke.py's phase-17 calls as ``--b17`` runs phase
16's, at reduced sizes only, in both packages: BFB1, B1's call
(``BiCGStab(maxiter=200, tol=1e-6)``, refine=3) under
``AMGParams(dtype=bfloat16)`` on poisson3d_block(16, 3) with
``coarse_enough=300`` (four levels, as ``--a10`` cuts B1) and on
poisson3d_block(24, 3), and BFD2, D2's call (U2's system in RCM order,
``matrix_format="dwin"``, left ``BiCGStab(maxiter=100, tol=1e-6)``,
refine=3) in bfloat16 on U2's system cut to 6,000 rows; each beside
its float32 hierarchy's six counts. ``--first`` as for ``--b17``. The
full sizes (331,776 unknowns; 85,623 rows on about 2 GB of bfloat16
dense windows) are chip-sized jobs this script is not meant for.
"""

import sys

import torch
import jax
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.relaxation import ilu0 as ref_ilu
from amgcl_tpu.solver.bicgstab import BiCGStab as RefBiCGStab

import amgcl_tpu_torch as T

U1_NNZ_PER_ROW = 2634905 / 85623


def a9_pair(label, A, rhs, extra):
    """(JAX bundle, port bundle) of phase-11 path ``label``."""
    import numpy as np
    from amgcl_tpu.models import runtime as ref_rt
    from amgcl_tpu.models.block_solver import make_block_solver
    from amgcl_tpu.models.cpr import CPR
    from amgcl_tpu.models.deflated import deflated_solver
    from amgcl_tpu.models.schur import SchurPressureCorrection
    from amgcl_tpu.solver.cg import CG
    from amgcl_tpu.solver.gmres import FGMRES
    import chip_smoke
    Ar = RefCSR(A.ptr, A.col, A.val, A.ncols)
    port = chip_smoke.a9_make(label, A, extra, device="cpu")
    cg = CG(maxiter=100, tol=1e-6)
    if label == "MX1":
        ref = ref_make_solver(Ar, RefParams(), cg, solver_dtype=jnp.float64)
    elif label in ("DF1", "RB1"):
        ref = ref_make_solver(Ar, RefParams(), cg, refine=3,
                              refine_dtype="df32" if label == "DF1"
                              else "float64")
    elif label == "DL1":
        # the JAX package's deflated_solver takes no refine: its deflated
        # preconditioner goes to make_solver with refine=3
        ref = ref_make_solver(Ar, deflated_solver(
            Ar, extra, RefParams(), cg).inner.precond, cg, refine=3)
    elif label in ("NS1", "DM1", "AP1"):
        cfg = {"NS1": {"precond.class": "nested", "precond.solver.type": "cg",
                       "precond.solver.maxiter": 4,
                       "precond.solver.tol": 1e-2,
                       "precond.precond.class": "amg",
                       "solver.type": "fgmres", "solver.tol": 1e-6,
                       "solver.maxiter": 100},
               "DM1": {"precond.class": "dummy", "solver.type": "cg",
                       "solver.maxiter": 1000, "solver.tol": 1e-6},
               "AP1": {"precond.class": "relaxation",
                       "precond.relax.type": "ilu0",
                       "solver.type": "bicgstab", "solver.maxiter": 500,
                       "solver.tol": 1e-6}}[label]
        # likewise for the JAX package's make_solver_from_config
        inner = ref_rt.make_solver_from_config(Ar, cfg)
        ref = ref_make_solver(Ar, inner.precond, inner.solver, refine=3)
    elif label == "SC1":
        ref = ref_make_solver(Ar, SchurPressureCorrection(Ar, extra,
                                                          adjust_p=2),
                              FGMRES(maxiter=500, tol=1e-6), refine=3)
    elif label == "CP1":
        ref = ref_make_solver(Ar, CPR(Ar), RefBiCGStab(maxiter=200,
                                                       tol=1e-6), refine=3)
    else:
        ref = make_block_solver(Ar, 3, RefParams(),
                                RefBiCGStab(maxiter=200, tol=1e-6))
    return ref, port


def a9():
    """The phase-11 lines (module docstring)."""
    import numpy as np
    import chip_smoke
    problems = {
        "poisson": lambda: T.poisson3d(32) + (
            chip_smoke.a9_deflation_vectors(32),),
        "fe": lambda: T.fe_like_problem(
            12000, nnz_target=int(U1_NNZ_PER_ROW * 12000)) + (None,),
        "stokes": lambda: (lambda A, pm: (A, np.ones(A.nrows), pm))(
            *T.stokes_like(128)),
        "reservoir": lambda: T.reservoir_like(24, 3) + (None,),
        "block_scalar": lambda: (lambda A, b: (A.unblock(), b, None))(
            *T.poisson3d_block(16, 3)),
    }
    for label, (system, config, refine) in chip_smoke.A9_PATHS.items():
        if label == "RB1h":
            continue
        A, rhs, extra = problems[system]()
        ref, port = a9_pair(label, A, rhs, extra)
        _, info_r = ref(rhs)
        _, info = port(rhs)
        print("%-5s %s, refine %d, %d rows: JAX %d iterations (resid "
              "%.2e), port %d (resid %.2e)" % (
                  label, config, refine, len(rhs), info_r.iters,
                  info_r.resid, info.iters, info.resid), flush=True)
    return 0


def a10_cases():
    """(label, call, A, rhs, {AMGParams field: (JAX value, port value)},
    JAX solver, port solver, refine, reorder) of the ``--a10`` paths
    (module docstring)."""
    import numpy as np
    from amgcl_tpu.solver.bicgstabl import BiCGStabL as RefBiCGStabL
    from amgcl_tpu.solver.cg import CG as RefCG
    from amgcl_tpu.solver.gmres import FGMRES as RefFGMRES
    from amgcl_tpu.solver.gmres import GMRES as RefGMRES
    from amgcl_tpu.solver.lgmres import LGMRES as RefLGMRES
    from amgcl_tpu.solver.richardson import Richardson as RefRichardson
    import chip_smoke
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    kw = dict(maxiter=100, tol=1e-6)
    u, u_rhs = T.fe_like_problem(12000,
                                 nnz_target=int(U1_NNZ_PER_ROW * 12000))
    up = cuthill_mckee(u)
    g, g_rhs = T.fe_like_problem(12000, nnz_target=6 * 12000)
    gp = cuthill_mckee(g)
    ro = np.random.RandomState(chip_smoke.RO1_SEED).permutation(u.nrows)
    p64, p64_rhs = T.poisson3d(64)
    b16, b16_rhs = T.poisson3d_block(16, 3)
    right = dict(precond_side="right")
    left = dict(precond_side="left")
    dwin = {"matrix_format": ("dwin", "dwin")}
    few = {"coarse_enough": (300, 300)}
    return [
        ("main", "poisson3d(64), CG, refine=3", p64, p64_rhs, {},
         RefCG(**kw), T.CG(**kw), 3, None),
        ("U1", "U1's system, 12,000 rows, BiCGStab right, refine=3", u,
         u_rhs, {}, RefBiCGStab(**kw, **right), T.BiCGStab(**kw, **right),
         3, None),
        ("U2", "the same in RCM order, left side", permute(u, up),
         u_rhs[up], {}, RefBiCGStab(**kw, **left),
         T.BiCGStab(**kw, **left), 3, None),
        ("K1", "U1's system, BiCGStab(2), refine=3", u, u_rhs, {},
         RefBiCGStabL(L=2, **kw), T.BiCGStabL(L=2, **kw), 3, None),
        ("D2", "U2's system and call on dense windows", permute(u, up),
         u_rhs[up], dwin, RefBiCGStab(**kw, **left),
         T.BiCGStab(**kw, **left), 3, None),
        ("G1", "G1's system, 12,000 rows, GMRES, refine=3", g, g_rhs, {},
         RefGMRES(**kw), T.GMRES(**kw), 3, None),
        ("G1r", "the same in RCM order, FGMRES", permute(g, gp),
         g_rhs[gp], {}, RefFGMRES(**kw), T.FGMRES(**kw), 3, None),
        ("LGMRES", "G1's system, LGMRES, refine=3", g, g_rhs, {},
         RefLGMRES(**kw), T.LGMRES(**kw), 3, None),
        ("Richardson", "G1's system, Richardson, refine=3", g, g_rhs, {},
         RefRichardson(**kw), T.Richardson(**kw), 3, None),
        ("B1", "poisson3d_block(16, 3), BiCGStab(maxiter=200)", b16,
         b16_rhs, few, RefBiCGStab(maxiter=200, tol=1e-6),
         T.BiCGStab(maxiter=200, tol=1e-6), 0, None),
        ("B1 refine=3", "the same, refine=3", b16, b16_rhs, few,
         RefBiCGStab(maxiter=200, tol=1e-6),
         T.BiCGStab(maxiter=200, tol=1e-6), 3, None),
        ("RO1", "U1's system, 12,000 rows, under RO1's permutation, "
         "reordered by RCM, U1's call", permute(u, ro), u_rhs[ro], {},
         RefBiCGStab(**kw, **right), T.BiCGStab(**kw, **right), 3, "rcm"),
    ]


def a10():
    """The device-setup lines (module docstring)."""
    import os
    for (label, call, A, rhs, fields, ref_solver, solver, refine,
         reorder) in a10_cases():
        Ar = RefCSR(A.ptr, A.col, A.val, A.ncols)
        os.environ["AMGCL_TPU_REORDER"] = reorder or "auto"
        ref_kw = {k: v[0] for k, v in fields.items()}
        counts = []
        for knob in ("0", "1"):
            os.environ["AMGCL_TPU_DEVICE_SETUP"] = knob
            ref = ref_make_solver(Ar, RefParams(dtype=jnp.float32,
                                                **ref_kw),
                                  ref_solver, refine=refine)
            counts.append((ref(rhs)[1], [h[0].nrows for h in
                                         ref.precond.host_levels]))
        os.environ.pop("AMGCL_TPU_DEVICE_SETUP")
        os.environ.pop("AMGCL_TPU_REORDER")
        port = T.make_solver(A, T.AMGParams(dtype=torch.float32, **{
            k: v[1] for k, v in fields.items()}), solver, refine=refine,
            device="cpu", device_setup=True, reorder=reorder or "auto")
        info = port(rhs)[1]
        rows = [h[0].nrows for h in port.precond.host_levels]
        print("%-11s %s: JAX host setup %d iterations, levels %s; device "
              "setup: JAX %d (resid %.2e), port %d (resid %.2e), levels "
              "%s / %s" % (label, call, counts[0][0].iters, counts[0][1],
                           counts[1][0].iters, counts[1][0].resid,
                           info.iters, info.resid, counts[1][1], rows),
              flush=True)
    return 0


def a10_full_cases():
    """{label: (system, JAX solver maker, make_solver keywords, reorder)}
    of the ``--a10-full`` paths (module docstring); the system is a
    chip_smoke.py problem name."""
    from amgcl_tpu.solver.bicgstabl import BiCGStabL as RefBiCGStabL
    from amgcl_tpu.solver.cg import CG as RefCG
    from amgcl_tpu.solver.gmres import FGMRES as RefFGMRES
    from amgcl_tpu.solver.gmres import GMRES as RefGMRES
    from amgcl_tpu.solver.idrs import IDRs as RefIDRs
    from amgcl_tpu.solver.lgmres import LGMRES as RefLGMRES
    from amgcl_tpu.solver.richardson import Richardson as RefRichardson
    kw = dict(maxiter=100, tol=1e-6)
    return {
        "main": ("poisson", lambda: RefCG(**kw), dict(refine=3), None),
        "DF1": ("poisson", lambda: RefCG(**kw),
                dict(refine=3, refine_dtype="df32"), None),
        "G2": ("poisson", lambda: RefGMRES(**kw), dict(refine=3), None),
        "S1": ("poisson", lambda: RefCG(**kw), None, None),
        "U1": ("fe", lambda: RefBiCGStab(precond_side="right", **kw),
               dict(refine=3), None),
        "U2": ("fe_rcm", lambda: RefBiCGStab(precond_side="left", **kw),
               dict(refine=3), None),
        "K1": ("fe", lambda: RefBiCGStabL(L=2, **kw), dict(refine=3), None),
        "RO1": ("fe_ro1", lambda: RefBiCGStab(precond_side="right", **kw),
                dict(refine=3), "rcm"),
        "G1": ("g1", lambda: RefGMRES(**kw), dict(refine=3), None),
        "G1r": ("g1_rcm", lambda: RefFGMRES(**kw), dict(refine=3), None),
        "LGMRES": ("g1", lambda: RefLGMRES(**kw), dict(refine=3), None),
        "IDRs": ("g1", lambda: RefIDRs(**kw), dict(refine=3), None),
        "Richardson": ("g1", lambda: RefRichardson(**kw), dict(refine=3),
                       None),
        "B1": ("block", lambda: RefBiCGStab(maxiter=200, tol=1e-6),
               dict(refine=0), None),
        "B1 refine=3": ("block", lambda: RefBiCGStab(maxiter=200, tol=1e-6),
                        dict(refine=3), None),
        "BK1": ("block_scalar", lambda: RefBiCGStab(maxiter=200, tol=1e-6),
                None, None),
    }


def a10_full_system(name):
    """(A, rhs) of an ``--a10-full`` system at full size."""
    import numpy as np
    import chip_smoke
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    if name == "poisson":
        return T.poisson3d(128)
    if name == "block":
        return T.poisson3d_block(48, 3)
    if name == "block_scalar":
        return chip_smoke.a9_problem("block_scalar")[:2]
    A, rhs = (chip_smoke.g1_problem() if name.startswith("g1")
              else T.fe_like_problem())
    if name.endswith("_rcm"):
        p = cuthill_mckee(A)
    elif name == "fe_ro1":
        p = np.random.RandomState(chip_smoke.RO1_SEED).permutation(A.nrows)
    else:
        return A, rhs
    return permute(A, p), rhs[p]


def a10_full(labels):
    """The JAX package's full-size counts under its device setup, and
    with ``--port`` the port's on the CPU (module docstring)."""
    import os
    import time
    from amgcl_tpu.models.block_solver import make_block_solver
    from amgcl_tpu.parallel.dist_stencil import DistStencilSolver
    from amgcl_tpu.parallel.mesh import make_mesh
    port, spread = "--port" in labels, "--spread" in labels
    labels = [a for a in labels if a not in ("--port", "--spread")]
    cases = a10_full_cases()
    systems = {}
    os.environ["AMGCL_TPU_DEVICE_SETUP"] = "1"
    for label in labels or list(cases):
        system, solver, make_kw, reorder = cases[label]
        os.environ["AMGCL_TPU_REORDER"] = reorder or "off"
        if system not in systems:
            systems.clear()
            systems[system] = a10_full_system(system)
        A, rhs = systems[system]
        Ar = RefCSR(A.ptr, A.col, A.val, A.ncols)
        t0 = time.perf_counter()
        if label == "S1":
            ref = DistStencilSolver(Ar, make_mesh(4),
                                    RefParams(dtype=jnp.float32), solver())
            rows = "sharded"
        elif label == "BK1":
            ref = make_block_solver(Ar, 3, RefParams(), solver())
            rows = [h[0].nrows for h in ref.inner.precond.host_levels]
        else:
            ref = ref_make_solver(Ar, RefParams(dtype=jnp.float32),
                                  solver(), **make_kw)
            rows = [h[0].nrows for h in ref.precond.host_levels]
        info = ref(rhs)[1]
        print("%-11s JAX, device setup, full size: %d iterations, resid "
              "%.3e, levels %s, %.1f s" % (label, info.iters, info.resid,
                                           rows, time.perf_counter() - t0),
              flush=True)
        if spread:
            print("%-11s JAX on six rhs: %s" % (label, [
                ref(b)[1].iters for b in perturbed(rhs)]), flush=True)
        del ref
        if port and label != "S1":
            print("%-11s port on the CPU, device setup: %s"
                  % (label, a10_full_port(label, A, rhs, spread)),
                  flush=True)
    return 0


def perturbed(rhs, k=6, eps=1e-6):
    """rhs, then k - 1 copies perturbed by ``eps`` relative (seed 0)."""
    import numpy as np
    rng = np.random.RandomState(0)
    return [rhs * (1 + (eps * rng.standard_normal(len(rhs)) if i else 0))
            for i in range(k)]


def a10_full_port(label, A, rhs, spread=False):
    """The port's count, reported residual and level rows for an
    ``--a10-full`` path, on the CPU with ``device_setup=True`` (and its
    counts on the six rhs of :func:`perturbed` with ``spread``)."""
    import chip_smoke
    kw = dict(maxiter=100, tol=1e-6)
    solver = {"U1": lambda: T.BiCGStab(precond_side="right", **kw),
              "RO1": lambda: T.BiCGStab(precond_side="right", **kw),
              "U2": lambda: T.BiCGStab(precond_side="left", **kw),
              "K1": lambda: T.BiCGStabL(L=2, **kw),
              "G1r": lambda: T.FGMRES(**kw),
              "main": lambda: T.CG(**kw), "DF1": lambda: T.CG(**kw),
              "B1": lambda: T.BiCGStab(maxiter=200, tol=1e-6),
              "B1 refine=3": lambda: T.BiCGStab(maxiter=200, tol=1e-6),
              "BK1": lambda: T.BiCGStab(maxiter=200, tol=1e-6)}.get(
                  label, lambda: getattr(T, {"G1": "GMRES", "G2": "GMRES"}
                                         .get(label, label))(**kw))()
    dev = dict(device="cpu", device_setup=True)
    if label == "BK1":
        solve = chip_smoke.a9_make("BK1", A, None, **dev)
        amg = solve.inner.precond
    else:
        refine = 0 if label == "B1" else 3
        solve = T.make_solver(
            A, T.AMGParams(dtype=torch.float32), solver, refine=refine,
            refine_dtype="df32" if label == "DF1" else "auto",
            reorder="rcm" if label == "RO1" else "off", **dev)
        amg = solve.precond
    info = solve(rhs)[1]
    six = "; on six rhs: %s" % [solve(b)[1].iters for b in perturbed(rhs)] \
        if spread else ""
    return "%d iterations, resid %.3e, levels %s%s" % (
        info.iters, info.resid, [h[0].nrows for h in amg.host_levels], six)


def a14_cases():
    """(label, system, JAX bundle maker, port bundle maker, rhs) of the
    bfloat16 hierarchies at reduced sizes (module docstring)."""
    from amgcl_tpu.solver.cg import CG as RefCG
    bf = dict(solver_dtype=jnp.float32)
    cases = []
    for n in (32, 48):
        A, rhs = T.poisson3d(n)
        cases.append((
            "BF1", "poisson3d(%d), CG(maxiter=100, tol=1e-6), refine=3" % n,
            A, rhs,
            lambda Ar: ref_make_solver(Ar, RefParams(dtype=jnp.bfloat16),
                                       RefCG(maxiter=100, tol=1e-6),
                                       refine=3, **bf),
            lambda A: T.make_solver(A, T.AMGParams(dtype=torch.bfloat16),
                                    T.CG(maxiter=100, tol=1e-6), refine=3,
                                    solver_dtype=torch.float32,
                                    device="cpu")))
    A, rhs = T.poisson3d(12)
    cases.append((
        "amg", "poisson3d(12), CG(maxiter=200, tol=1e-5)", A, rhs,
        lambda Ar: ref_make_solver(Ar, RefParams(dtype=jnp.bfloat16),
                                   RefCG(maxiter=200, tol=1e-5), **bf),
        lambda A: T.make_solver(A, T.AMGParams(dtype=torch.bfloat16),
                                T.CG(maxiter=200, tol=1e-5),
                                solver_dtype=torch.float32, device="cpu")))
    A, rhs = T.fe_like_problem(12000)
    cases.append((
        "BF2", "fe_like_problem(12000), BiCGStab(maxiter=200, tol=1e-6)",
        A, rhs,
        lambda Ar: ref_make_solver(Ar, RefParams(dtype=jnp.bfloat16),
                                   RefBiCGStab(maxiter=200, tol=1e-6), **bf),
        lambda A: T.make_solver(A, T.AMGParams(dtype=torch.bfloat16),
                                T.BiCGStab(maxiter=200, tol=1e-6),
                                solver_dtype=torch.float32, device="cpu")))
    # BF2's own call (left side, refine=3) on U1's system cut to 12,000
    # rows with U1's nonzeros a row
    A, rhs = T.fe_like_problem(12000, nnz_target=int(U1_NNZ_PER_ROW * 12000))
    kw = dict(maxiter=100, tol=1e-6, precond_side="left")
    cases.append((
        "BF2", "U1's system cut to 12,000 rows, BiCGStab(maxiter=100, "
        "tol=1e-6, precond_side='left'), refine=3", A, rhs,
        lambda Ar: ref_make_solver(Ar, RefParams(dtype=jnp.bfloat16),
                                   RefBiCGStab(**kw), refine=3, **bf),
        lambda A: T.make_solver(A, T.AMGParams(dtype=torch.bfloat16),
                                T.BiCGStab(**kw), refine=3,
                                solver_dtype=torch.float32, device="cpu")))
    return cases


def a14():
    """The bfloat16 lines (module docstring)."""
    for label, config, A, rhs, ref, port in a14_cases():
        _, info_r = ref(RefCSR(A.ptr, A.col, A.val, A.ncols))(rhs)
        _, info = port(A)(rhs)
        print("%-4s %s, bfloat16 hierarchy under float32: JAX %d iterations "
              "(resid %.2e), port %d (resid %.2e)" % (
                  label, config, info_r.iters, info_r.resid, info.iters,
                  info.resid), flush=True)
    return 0


def a14_sides():
    """The bfloat16 hierarchy under BiCGStab on fe_like_problem(12000)
    (the default nonzeros a row and U1's), right- and left-preconditioned,
    without and with refinement: both packages' counts on the system's
    rhs and on five rhs perturbed by 1e-6 relative (module docstring)."""
    import numpy as np
    for label, (A, rhs) in (
            ("fe_like_problem(12000)", T.fe_like_problem(12000)),
            ("U1's nonzeros a row", T.fe_like_problem(
                12000, nnz_target=int(U1_NNZ_PER_ROW * 12000)))):
        Ar = RefCSR(A.ptr, A.col, A.val, A.ncols)
        for side in ("right", "left"):
            for refine in (0, 3):
                kw = dict(maxiter=100, tol=1e-6, precond_side=side)
                ref = ref_make_solver(Ar, RefParams(dtype=jnp.bfloat16),
                                      RefBiCGStab(**kw), refine=refine,
                                      solver_dtype=jnp.float32)
                port = T.make_solver(A, T.AMGParams(dtype=torch.bfloat16),
                                     T.BiCGStab(**kw), refine=refine,
                                     solver_dtype=torch.float32,
                                     device="cpu")
                rng = np.random.RandomState(0)
                counts = []
                for k in range(6):
                    b = rhs * (1 + (1e-6 * rng.standard_normal(len(rhs))
                                    if k else 0))
                    counts.append((ref(b)[1].iters, port(b)[1].iters))
                print("%s, %s side, refine %d: JAX %s, port %s" % (
                    label, side, refine, [c[0] for c in counts],
                    [c[1] for c in counts]), flush=True)
    return 0


def b17_solve_shim():
    """Let the JAX package's ``jnp.linalg.solve`` take bfloat16 on the
    CPU, as the port does (module docstring)."""
    solve = jnp.linalg.solve
    if getattr(solve, "b17_shim", False):
        return

    def shim(a, b):
        if a.dtype == jnp.bfloat16:
            return solve(a.astype(jnp.float32),
                         b.astype(jnp.float32)).astype(jnp.bfloat16)
        return solve(a, b)
    shim.b17_shim = True
    jnp.linalg.solve = shim


#: history entries that ``--b17 --first`` prints
B17_HISTORY = 8


def b17_cases(full=False, refine=3):
    """(label, config, system maker, JAX bundle maker, port bundle maker)
    of phase 16's calls (module docstring), with ``refine`` restarts."""
    from amgcl_tpu.coarsening.ruge_stuben import RugeStuben as RefRS
    from amgcl_tpu.solver.bicgstabl import BiCGStabL as RefBiCGStabL
    from amgcl_tpu.solver.cg import CG as RefCG
    bf = torch.bfloat16
    kw = dict(maxiter=100, tol=1e-6, record_history=refine == 0)
    left = dict(kw, precond_side="left")
    if full:
        poisson = [("poisson3d(128)", lambda: T.poisson3d(128))]
        fe = ("fe_like_problem()", T.fe_like_problem)
    else:
        poisson = [("poisson3d(%d)" % n, lambda n=n: T.poisson3d(n))
                   for n in (32, 48)]
        fe = ("U1's system cut to 12,000 rows", lambda: T.fe_like_problem(
            12000, nnz_target=int(U1_NNZ_PER_ROW * 12000)))
    rf = dict(refine=refine)
    # the card's route at full size: the port's device setup (the
    # default on a CUDA device), here on the CPU
    cpu = dict(device="cpu", device_setup=True) if full else dict(device="cpu")
    cases = [("BFK1", name + ", CG(maxiter=100, tol=1e-6), refine=%d"
              % refine, make,
              lambda Ar: ref_make_solver(Ar, RefParams(dtype=jnp.bfloat16),
                                         RefCG(**kw), **rf),
              lambda A: T.make_solver(A, T.AMGParams(dtype=bf), T.CG(**kw),
                                      **cpu, **rf))
             for name, make in poisson]
    cases.append((
        "BFK2", fe[0] + ", BiCGStabL(L=2, maxiter=100, tol=1e-6), "
        "refine=%d" % refine, fe[1],
        lambda Ar: ref_make_solver(Ar, RefParams(dtype=jnp.bfloat16),
                                   RefBiCGStabL(L=2, **kw), **rf),
        lambda A: T.make_solver(A, T.AMGParams(dtype=bf),
                                T.BiCGStabL(L=2, **kw), **cpu, **rf)))
    cases.append((
        "BFG1", fe[0] + ", coarsening=RugeStuben(), BiCGStab(maxiter=100, "
        "tol=1e-6, precond_side='left'), refine=%d" % refine, fe[1],
        lambda Ar: ref_make_solver(
            Ar, RefParams(dtype=jnp.bfloat16, coarsening=RefRS()),
            RefBiCGStab(**left), **rf),
        lambda A: T.make_solver(
            A, T.AMGParams(dtype=bf, coarsening=T.RugeStuben()),
            T.BiCGStab(**left), **cpu, **rf)))
    return cases


def b19_cases(full=False, refine=3):
    """(label, config, system maker, JAX bundle maker, port bundle maker)
    of phase 17's calls (module docstring), with ``refine`` restarts, in
    bfloat16 and, labelled ``<label> float32``, with float32 hierarchies
    and loops."""
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    kw = dict(tol=1e-6, record_history=refine == 0)
    rf = dict(refine=refine)

    def u2():
        A, rhs = T.fe_like_problem(6000,
                                   nnz_target=int(U1_NNZ_PER_ROW * 6000))
        p = cuthill_mckee(A)
        return permute(A, p), rhs[p]
    systems = [
        ("BFB1", "poisson3d_block(16, 3), coarse_enough=300",
         lambda: T.poisson3d_block(16, 3), dict(coarse_enough=300),
         dict(maxiter=200)),
        ("BFB1", "poisson3d_block(24, 3)", lambda: T.poisson3d_block(24, 3),
         {}, dict(maxiter=200)),
        ("BFD2", "U2's system cut to 6,000 rows (RCM order), "
         "matrix_format='dwin'", u2, dict(matrix_format="dwin"),
         dict(maxiter=100, precond_side="left"))]
    cases = []
    for label, name, make, fields, skw in systems:
        for dt, rdt, tag in ((torch.bfloat16, jnp.bfloat16, ""),
                             (torch.float32, jnp.float32, " float32")):
            cases.append((
                label + tag, "%s, BiCGStab(%s, tol=1e-6), refine=%d, %s"
                % (name, ", ".join("%s=%r" % i for i in skw.items()), refine,
                   str(dt).split(".")[-1]), make,
                lambda Ar, f=fields, k=skw, d=rdt: ref_make_solver(
                    Ar, RefParams(dtype=d, **f), RefBiCGStab(**k, **kw),
                    **rf),
                lambda A, f=fields, k=skw, d=dt: T.make_solver(
                    A, T.AMGParams(dtype=d, **f), T.BiCGStab(**k, **kw),
                    device="cpu", **rf)))
    return cases


def b17(args, cases=b17_cases):
    """The phase-16 lines, or with ``cases=b19_cases`` phase 17's (module
    docstring)."""
    import time
    import numpy as np
    b17_solve_shim()
    full = "--full" in args
    refine = 0 if "--first" in args else 3
    labels = [a for a in args if a not in ("--full", "--first")]

    def true(A, rhs, x):
        x = np.asarray(x, dtype=np.float64) if not torch.is_tensor(x) \
            else x.double().numpy()
        return np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs)
    def head(info):
        h = info.history
        return [] if h is None else [float(v) for v in h[:B17_HISTORY]]
    for label, config, make, ref, port in cases(full, refine):
        if labels and label.split()[0] not in labels:
            continue
        A, rhs = make()
        Ar = RefCSR(A.ptr, A.col, A.val, A.ncols)
        t0 = time.perf_counter()
        rsolve = ref(Ar)
        if full:
            x, info = rsolve(rhs)
            print("%-4s %s: JAX %d iterations, resid %.3e, true %.3e, "
                  "levels %s, %.0f s%s" % (
                      label, config, info.iters, info.resid, true(A, rhs, x),
                      [h[0].nrows for h in rsolve.precond.host_levels],
                      time.perf_counter() - t0,
                      "; history %r" % head(info) if refine == 0 else ""),
                  flush=True)
            if refine == 0:
                # the port's first pass on the card's route, the
                # reference of chip_smoke.P16_FIRST
                t0 = time.perf_counter()
                psolve = port(A)
                x, info = psolve(rhs)
                print("     port on the CPU (device setup): %d iterations, "
                      "resid %.3e, true %.3e, health %s, levels %s, %.0f s;"
                      " history %r" % (
                          info.iters, info.resid, true(A, rhs, x),
                          info.health, [lv.A.shape[0] for lv in
                                        psolve.precond.hierarchy.levels],
                          time.perf_counter() - t0, head(info)), flush=True)
            continue
        psolve = port(A)
        got = {"JAX": [], "port": []}
        hist = {"JAX": [], "port": []}
        for b in perturbed(rhs, eps=2.0**-8 if refine == 0 else 1e-6):
            for who, solve in (("JAX", rsolve), ("port", psolve)):
                x, info = solve(b)
                got[who].append((info.iters, true(A, b, x)))
                hist[who].append(head(info))
        print("%-4s %s: JAX %s (true resid max %.2e), port %s (true resid "
              "max %.2e), port levels %s" % (
                  label, config, [c for c, _ in got["JAX"]],
                  max(r for _, r in got["JAX"]),
                  [c for c, _ in got["port"]],
                  max(r for _, r in got["port"]),
                  [h[0].nrows for h in psolve.precond.host_levels]),
              flush=True)
        def apart(a, *others):
            # entry by entry, the largest relative difference from a
            return ["%.1e" % max(abs(o[k] / a[k] - 1) for o in others)
                    for k in range(min(len(a), *map(len, others)))]
        if refine == 0:
            print("     history JAX %r\n     history port %r\n     port "
                  "against JAX by entry %s\n     spread by entry: JAX %s, "
                  "port %s" % (
                      hist["JAX"][0], hist["port"][0],
                      apart(hist["JAX"][0], hist["port"][0]),
                      apart(*hist["JAX"]), apart(*hist["port"])),
                  flush=True)
    return 0


def main(rows=12000):
    jax.config.update("jax_enable_x64", True)
    A, rhs = T.fe_like_problem(rows, nnz_target=int(U1_NNZ_PER_ROW * rows))
    A_ref = RefCSR(A.ptr, A.col, A.val, A.ncols)
    cases = [("ILU0", ref_ilu.ILU0(), T.ILU0()),
             ("ILUK(k=1)", ref_ilu.ILUK(k=1), T.ILUK(k=1)),
             ("ILUP(p=1)", ref_ilu.ILUP(), T.ILUP())]
    for name, ref_relax, relax in cases:
        for dt in ("float32", "float64"):
            _, info_r = ref_make_solver(
                A_ref, RefParams(dtype=getattr(jnp, dt), relax=ref_relax),
                RefBiCGStab(maxiter=100, tol=1e-6), refine=3)(rhs)
            solve = T.make_solver(
                A, T.AMGParams(dtype=getattr(torch, dt), relax=relax),
                T.BiCGStab(maxiter=100, tol=1e-6), refine=3, device="cpu")
            _, info = solve(rhs)
            print("%d rows %-9s %s: JAX %d iterations (resid %.2e), port %d "
                  "(resid %.2e)" % (rows, name, dt, info_r.iters,
                                    info_r.resid, info.iters, info.resid),
                  flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--a9"]:
        jax.config.update("jax_enable_x64", True)
        sys.exit(a9())
    if sys.argv[1:] == ["--a10"]:
        jax.config.update("jax_enable_x64", True)
        sys.exit(a10())
    if sys.argv[1:2] == ["--a10-full"]:
        jax.config.update("jax_enable_x64", True)
        sys.exit(a10_full(sys.argv[2:]))
    if sys.argv[1:] == ["--a14"]:
        jax.config.update("jax_enable_x64", True)
        sys.exit(a14())
    if sys.argv[1:] == ["--a14-sides"]:
        jax.config.update("jax_enable_x64", True)
        sys.exit(a14_sides())
    if sys.argv[1:2] == ["--b17"]:
        jax.config.update("jax_enable_x64", True)
        sys.exit(b17(sys.argv[2:]))
    if sys.argv[1:2] == ["--b19"] and "--full" not in sys.argv:
        jax.config.update("jax_enable_x64", True)
        sys.exit(b17(sys.argv[2:], b19_cases))
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
