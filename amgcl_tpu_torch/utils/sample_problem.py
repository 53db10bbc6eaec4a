"""Deterministic test fixture: the 3-D Poisson problem.

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
