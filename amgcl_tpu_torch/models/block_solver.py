"""``make_block_solver``: solve a scalar system with a block-valued
engine — the matrix is viewed as BCSR and rhs and x keep their scalar
layout (counterpart of ``amgcl_tpu/models/block_solver.py``; reference:
amgcl/make_block_solver.hpp:28-77, adapter::block_matrix)."""

from __future__ import annotations

from typing import Any

from amgcl_tpu_torch.models.make_solver import make_solver
from amgcl_tpu_torch.ops.csr import CSR


class make_block_solver:
    """``make_block_solver(A, b, AMGParams(), solver)`` over the b×b BCSR
    view of the scalar ``A``; further keywords go to ``make_solver``."""

    def __init__(self, A, block_size: int, precond: Any = None,
                 solver: Any = None, **kw):
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        if A.is_block:
            raise ValueError("matrix is already blocked")
        if A.nrows % block_size:
            raise ValueError(
                "matrix size %d is not a multiple of block_size %d"
                % (A.nrows, block_size))
        self.inner = make_solver(A.to_block(block_size), precond, solver,
                                 **kw)

    def __call__(self, rhs, x0=None):
        return self.inner(rhs, x0)

    def __repr__(self):
        return "make_block_solver\n%r" % self.inner
