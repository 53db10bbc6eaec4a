"""Deterministic test fixtures: the 3-D Poisson problem, scalar and
block-valued.

Counterpart of ``amgcl_tpu/utils/sample_problem.py::poisson3d``, itself
modelled on the reference's tests/sample_problem.hpp:11-84.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amgcl_tpu_torch.ops.csr import CSR


def poisson3d(n: int, anisotropy: float = 1.0, dtype=np.float64):
    """7-point finite-difference Laplacian on an n×n×n grid.

    Returns ``(A: CSR, rhs: np.ndarray)`` with Dirichlet boundaries folded
    into the operator; ``anisotropy`` scales the z-direction coupling."""
    h2i = float(n - 1) ** 2 if n > 1 else 1.0
    ex = np.ones(n)
    T = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1], format="csr")
    I = sp.identity(n, format="csr")
    Axy = sp.kron(I, sp.kron(I, T)) + sp.kron(I, sp.kron(T, I))
    Az = sp.kron(T, sp.kron(I, I))
    A = (Axy + anisotropy * Az) * h2i
    A = sp.csr_matrix(A.astype(dtype))
    A.sort_indices()
    return CSR.from_scipy(A), np.ones(n ** 3, dtype=dtype)


def poisson3d_block(n: int, b: int, dtype=np.float64):
    """Block-valued variant (``amgcl_tpu/utils/sample_problem.py::
    poisson3d_block``): the scalar Poisson matrix kron the b×b identity,
    its components coupled by 0.01 off the block diagonal, as a b×b BCSR
    over n³ block rows. Returns ``(A: CSR, rhs)`` with ``rhs`` all ones
    over the n³·b unknowns."""
    A, _ = poisson3d(n, dtype=dtype)
    S = sp.kron(A.to_scipy(), sp.identity(b), format="csr")
    C = sp.kron(sp.identity(n ** 3), 0.01 * (np.ones((b, b)) - np.eye(b)),
                format="csr")
    return CSR.from_scipy(sp.csr_matrix(S + C)).to_block(b), \
        np.ones(n ** 3 * b, dtype=dtype)
