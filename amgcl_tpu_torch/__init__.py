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
"""

from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.coarsening import (Aggregation, AsScalar, RugeStuben,
                                        SmoothedAggrEMin,
                                        SmoothedAggregation,
                                        rigid_body_modes)
from amgcl_tpu_torch.models.amg import AMG, AMGParams
from amgcl_tpu_torch.models.make_solver import make_solver
from amgcl_tpu_torch.ops.unstructured import fe_like_problem
from amgcl_tpu_torch.parallel import (DistStencilSolver, dist_stencil_build,
                                      make_mesh)
from amgcl_tpu_torch.relaxation import (ILU0, ILUK, ILUP, ILUT, AsBlock,
                                        Chebyshev, DampedJacobi, GaussSeidel,
                                        Spai0, Spai1)
from amgcl_tpu_torch.solver import (CG, FGMRES, GMRES, IDRs, LGMRES,
                                    BiCGStab, BiCGStabL, PreOnly, Richardson)
from amgcl_tpu_torch.utils.sample_problem import (poisson3d, poisson3d_block,
                                                  q1_elasticity2d)

__all__ = ["CSR", "AMG", "AMGParams", "make_solver", "BiCGStab",
           "BiCGStabL", "CG", "DistStencilSolver", "FGMRES", "GMRES", "IDRs",
           "LGMRES", "PreOnly", "Richardson", "dist_stencil_build",
           "fe_like_problem", "make_mesh", "poisson3d", "poisson3d_block",
           "q1_elasticity2d", "Aggregation", "AsScalar", "RugeStuben",
           "SmoothedAggrEMin", "SmoothedAggregation", "rigid_body_modes",
           "AsBlock", "Chebyshev", "DampedJacobi", "GaussSeidel", "ILU0",
           "ILUK", "ILUP", "ILUT", "Spai0", "Spai1"]
