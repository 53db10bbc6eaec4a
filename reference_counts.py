"""Iteration counts of the JAX package and of the port on the CPU at
reduced sizes: the ILU smoothers on a scaled-down U1 system, and the
compositions of chip_smoke.py's phase 11.

    JAX_PLATFORMS=cpu python reference_counts.py [ROWS]
    JAX_PLATFORMS=cpu python reference_counts.py --a9
    JAX_PLATFORMS=cpu python reference_counts.py --a14
    JAX_PLATFORMS=cpu python reference_counts.py --a14-sides

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
    if sys.argv[1:] == ["--a14"]:
        jax.config.update("jax_enable_x64", True)
        sys.exit(a14())
    if sys.argv[1:] == ["--a14-sides"]:
        jax.config.update("jax_enable_x64", True)
        sys.exit(a14_sides())
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
