"""Problem adapters (counterpart of ``amgcl_tpu/utils/adapters.py``
without its complex adapters; reference: amgcl/adapter/reorder.hpp,
amgcl/reorder/cuthill_mckee.hpp, amgcl/adapter/scaled_problem.hpp):
reordering and symmetric scaling, on the host with scipy."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
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


def _take(v, idx):
    """v[idx] for a host array or a tensor (indexed on its device)."""
    if torch.is_tensor(v):
        return v[torch.as_tensor(np.ascontiguousarray(idx), device=v.device)]
    return np.asarray(v)[idx]


class Reordered:
    """Wrap a solver factory so that callers never see the permutation
    (reference: adapter::reorder; amgcl_tpu/utils/adapters.py:35-55):
    ``solver_factory(P A Pᵀ)`` is built, rhs and x0 are permuted in and
    x is permuted back out (a tensor stays a tensor)."""

    def __init__(self, A, solver_factory, perm=None):
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        self.perm = cuthill_mckee(A) if perm is None else np.asarray(perm)
        self.iperm = np.empty_like(self.perm)
        self.iperm[self.perm] = np.arange(len(self.perm))
        self.solve = solver_factory(permute(A, self.perm))

    def __call__(self, rhs, x0=None):
        rhs = _take(rhs, self.perm)
        if x0 is not None:
            x0 = _take(x0, self.perm)
        x, info = self.solve(rhs, x0)
        return _take(x, self.iperm), info


class Scaled:
    """Symmetric diagonal scaling: solve (D^-1/2 A D^-1/2) y = D^-1/2 b and
    return x = D^-1/2 y (reference: adapter::scaled_problem;
    amgcl_tpu/utils/adapters.py:58-76)."""

    def __init__(self, A, solver_factory):
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        d = np.abs(A.diagonal().astype(np.float64))
        self.s = 1.0 / np.sqrt(np.where(d > 0, d, 1.0))
        S = sp.diags(self.s)
        ms = (S @ A.to_scipy() @ S).tocsr()
        ms.sort_indices()
        self.solve = solver_factory(CSR.from_scipy(ms))

    def _scale(self, v, fn):
        if torch.is_tensor(v):
            return fn(v, torch.as_tensor(self.s, device=v.device)
                      .to(v.dtype))
        return fn(np.asarray(v), self.s)

    def __call__(self, rhs, x0=None):
        rhs = self._scale(rhs, lambda v, s: v * s)
        if x0 is not None:
            x0 = self._scale(x0, lambda v, s: v / s)
        y, info = self.solve(rhs, x0)
        return self._scale(y, lambda v, s: v * s), info
