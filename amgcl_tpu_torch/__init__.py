"""amgcl_tpu_torch — the PyTorch/CUDA port of amgcl_tpu.

Algebraic multigrid as the preconditioner of a Krylov solver: smoothed
aggregation (the default; with rigid-body near-nullspaces through
``SmoothedAggregation(nullspace=rigid_body_modes(coords))``), plain
aggregation, energy-minimizing SA, Ruge–Stüben and ``AsScalar`` for the
coarsening; SPAI-0 (the default), damped Jacobi, Chebyshev, SPAI-1,
multicolour Gauss–Seidel, ILU(0), ILUT, ILU(k), ILU(p) and ``AsBlock``
for the smoother, e.g. ``AMGParams(coarsening=RugeStuben(),
relax=Chebyshev())``; V- or W-cycles, with tensors on a CUDA device and the
hot sparse kernels written by hand for Hopper (``csrc/``). The JAX package
``amgcl_tpu`` is the reference it is held against; this package imports
nothing of it.

    from amgcl_tpu_torch import make_solver, AMGParams, CG, poisson3d
    A, rhs = poisson3d(64)
    solve = make_solver(A, AMGParams(), CG(tol=1e-6), refine=3)
    x, info = solve(rhs)           # device=None: CUDA, else an error

Unstructured systems take the windowed-ELL path, e.g. the poisson3Db
profile with BiCGStab::

    from amgcl_tpu_torch import BiCGStab, fe_like_problem
    A, rhs = fe_like_problem()
    solve = make_solver(A, AMGParams(), BiCGStab(maxiter=100, tol=1e-6),
                        refine=3)

Block-valued systems (several unknowns per node, e.g. elasticity or
coupled multiphysics) come as a BCSR: a ``CSR`` whose values are
``(nnz, b, b)`` blocks, or a scalar matrix with b×b block structure
through ``CSR.to_block(b)``. They coarsen by pointwise aggregation,
smooth with block SPAI-0, and run on block windowed-ELL operators
(square blocks of 2, 3 or 4 on the card)::

    from amgcl_tpu_torch import poisson3d_block
    A, rhs = poisson3d_block(48, 3)          # 110,592 3x3 block rows
    solve = make_solver(A, AMGParams(), BiCGStab(maxiter=200, tol=1e-6))
    x, info = solve(rhs)                     # rhs, x: 331,776 unknowns

BiCGStab(L) (amgcl's ``solver.type=bicgstabl``) takes the place of
BiCGStab in any of these calls, e.g. ``BiCGStabL(L=2, maxiter=100,
tol=1e-6)``, and so do ``GMRES``, ``FGMRES``, ``LGMRES``, ``IDRs``,
``Richardson`` and ``PreOnly``. A low-degree unstructured system (five
nearest neighbours, K = 16 slots a row) under GMRES runs its products
through the gather kernel (``csrc/gather.cu``)::

    from amgcl_tpu_torch import GMRES
    A, rhs = fe_like_problem(85623, nnz_target=6 * 85623)
    solve = make_solver(A, AMGParams(), GMRES(maxiter=100, tol=1e-6),
                        refine=3)
    x, info = solve(rhs)

Any solver takes ``record_history=True``; ``info.history`` then lists
the relative residual of each iteration of the initial solve. The dense-window format, which the JAX package offers for
the TPU's slow gathers, is available by name for banded (e.g.
Cuthill-McKee ordered) systems: ``AMGParams(matrix_format="dwin")`` or
``to_device(A, "dwin")``. It stores each 64-row tile's column window
densely (gigabytes at 85,623 rows), so ``auto`` never picks it::

    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    A, rhs = fe_like_problem()
    perm = cuthill_mckee(A)
    solve = make_solver(permute(A, perm),
                        AMGParams(matrix_format="dwin"),
                        BiCGStab(maxiter=100, tol=1e-6,
                                 precond_side="left"), refine=3)
    x, info = solve(rhs[perm])

A stencil system also solves over a mesh of shards, its hierarchy built
shard by shard over z-slabs, with the fused V-cycle legs in their framed
mode. One process drives every shard, and shards may share a card::

    from amgcl_tpu_torch import DistStencilSolver, make_mesh
    A, rhs = poisson3d(128)
    s = DistStencilSolver(A, make_mesh(4), AMGParams(),
                          CG(maxiter=100, tol=1e-6))
    x, info = s(rhs)                 # four z-slab shards on one card

``make_solver`` takes a prebuilt preconditioner in place of
``AMGParams``, a Krylov dtype of its own (``solver_dtype=torch.float64``
over a float32 hierarchy), a Krylov ``matrix_format`` and
``refine_dtype="df32"`` (compensated float32 refinement on a DIA
operator). Components are also chosen by name, as amgcl's runtime
configuration does, from a dict with dotted keys, a nested dict or a
JSON file::

    from amgcl_tpu_torch import make_solver_from_config
    solve = make_solver_from_config(A, {
        "precond.class": "nested", "precond.solver.type": "cg",
        "precond.solver.maxiter": 4, "precond.precond.class": "amg",
        "solver.type": "fgmres", "solver.tol": 1e-6}, refine=3)

``precond.class`` is ``amg``, ``relaxation`` (a smoother alone),
``dummy``, ``nested``, ``schur`` or ``cpr``. The coupled-system
preconditioners take the matrix and their split::

    from amgcl_tpu_torch import (CPR, FGMRES, SchurPressureCorrection,
                                 reservoir_like, stokes_like)
    A, pmask = stokes_like(512)                  # velocity, then pressure
    solve = make_solver(A, SchurPressureCorrection(A, pmask, adjust_p=2),
                        FGMRES(maxiter=500, tol=1e-6), refine=3)
    A, rhs = reservoir_like(96, 3)               # 3x3 cell blocks
    solve = make_solver(A, CPR(A), BiCGStab(maxiter=200, tol=1e-6),
                        refine=3)

A time-dependent loop whose matrix keeps its pattern refreshes the
bundle instead of building it again (``deflated_solver``,
``make_block_solver``, ``AsPreconditioner`` and ``DummyPreconditioner``
complete the set)::

    A, rhs = poisson3d(128)
    solve = make_solver(A, AMGParams(), CG(tol=1e-6), refine=3)
    x, _ = solve(rhs)
    for step in range(1, 4):
        solve.rebuild(CSR(A.ptr, A.col, A.val * (1 + 0.05 * step), A.ncols))
        x, info = solve(rhs, x0=x)
"""

from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.coarsening import (Aggregation, AsScalar, RugeStuben,
                                        SmoothedAggrEMin,
                                        SmoothedAggregation,
                                        rigid_body_modes)
from amgcl_tpu_torch.models import (AMG, CPR, CPRDRS, AMGParams,
                                    AsPreconditioner, DummyPreconditioner,
                                    NestedPreconditioner,
                                    SchurPressureCorrection, deflated_solver,
                                    make_block_solver, make_solver,
                                    make_solver_from_config,
                                    precond_from_config)
from amgcl_tpu_torch.ops.unstructured import fe_like_problem
from amgcl_tpu_torch.parallel import (DistStencilSolver, dist_stencil_build,
                                      make_mesh)
from amgcl_tpu_torch.relaxation import (ILU0, ILUK, ILUP, ILUT, AsBlock,
                                        Chebyshev, DampedJacobi, GaussSeidel,
                                        Spai0, Spai1)
from amgcl_tpu_torch.solver import (CG, FGMRES, GMRES, IDRs, LGMRES,
                                    BiCGStab, BiCGStabL, PreOnly, Richardson)
from amgcl_tpu_torch.utils.sample_problem import (poisson3d, poisson3d_block,
                                                  q1_elasticity2d,
                                                  reservoir_like, stokes_like)

__all__ = ["CSR", "AMG", "AMGParams", "make_solver", "BiCGStab",
           "BiCGStabL", "CG", "DistStencilSolver", "FGMRES", "GMRES", "IDRs",
           "LGMRES", "PreOnly", "Richardson", "dist_stencil_build",
           "fe_like_problem", "make_mesh", "poisson3d", "poisson3d_block",
           "q1_elasticity2d", "Aggregation", "AsScalar", "RugeStuben",
           "SmoothedAggrEMin", "SmoothedAggregation", "rigid_body_modes",
           "AsBlock", "Chebyshev", "DampedJacobi", "GaussSeidel", "ILU0",
           "ILUK", "ILUP", "ILUT", "Spai0", "Spai1", "make_block_solver",
           "deflated_solver", "AsPreconditioner", "DummyPreconditioner",
           "NestedPreconditioner", "SchurPressureCorrection", "CPR",
           "CPRDRS", "make_solver_from_config", "precond_from_config",
           "reservoir_like", "stokes_like"]
