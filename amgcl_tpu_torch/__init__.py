"""amgcl_tpu_torch — the PyTorch/CUDA port of amgcl_tpu.

Algebraic multigrid (smoothed aggregation, SPAI-0, V-cycle) as the
preconditioner of a Krylov solver, with tensors on a CUDA device and the
hot sparse kernels written by hand for Hopper (``csrc/``). The JAX package
``amgcl_tpu`` is the reference it is held against; this package imports
nothing of it.

    from amgcl_tpu_torch import make_solver, AMGParams, CG, poisson3d
    A, rhs = poisson3d(64)
    solve = make_solver(A, AMGParams(), CG(tol=1e-6), refine=3)
    x, info = solve(rhs)           # device=None: CUDA, else an error
"""

from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.models.amg import AMG, AMGParams
from amgcl_tpu_torch.models.make_solver import make_solver
from amgcl_tpu_torch.solver.cg import CG
from amgcl_tpu_torch.utils.sample_problem import poisson3d

__all__ = ["CSR", "AMG", "AMGParams", "make_solver", "CG", "poisson3d"]
