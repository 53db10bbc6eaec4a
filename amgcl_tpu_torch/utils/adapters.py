"""Problem adapters (counterpart of ``amgcl_tpu/utils/adapters.py``, the
reordering part; reference: amgcl/adapter/reorder.hpp,
amgcl/reorder/cuthill_mckee.hpp). Host scipy only."""

from __future__ import annotations

import numpy as np
from scipy.sparse.csgraph import reverse_cuthill_mckee

from amgcl_tpu_torch.ops.csr import CSR


def cuthill_mckee(A: CSR) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (bandwidth reduction), which
    narrows the windows of the windowed-ELL format on unstructured
    meshes. Returns perm such that B = A[perm][:, perm]."""
    return np.asarray(reverse_cuthill_mckee(A.to_scipy(),
                                            symmetric_mode=True))


def permute(A: CSR, perm: np.ndarray) -> CSR:
    """B = P A Pᵀ with B[i, j] = A[perm[i], perm[j]]."""
    m = A.to_scipy()[perm][:, perm].tocsr()
    m.sort_indices()
    return CSR.from_scipy(m)
