"""Deflated solver: user-supplied deflation vectors around any
preconditioner and solver (counterpart of
``amgcl_tpu/models/deflated.py``; reference:
amgcl/deflated_solver.hpp:41-276, params {nvec, vec}).

The A-DEF2 deflated preconditioner ``M_defl r = P(r − A Q r) + Q r`` with
``Q = Z E⁻¹ Zᵀ``, ``E = Zᵀ A Z`` factorized once on the host. Z, AZ and
E⁻¹ are dense tensors on the device and their small products are
``torch.matmul``, as the JAX package computes them outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from amgcl_tpu_torch.models.amg import apply_columns
from amgcl_tpu_torch.models.make_solver import make_solver
from amgcl_tpu_torch.ops.csr import CSR


class DeflatedHierarchy:
    """A base hierarchy wrapped in the deflation projector."""

    def __init__(self, base, Z, AZ, Einv):
        self.base = base
        self.Z = Z         # (n, k)
        self.AZ = AZ       # (n, k)
        self.Einv = Einv   # (k, k)

    def apply(self, r):
        if r.dim() == 2:
            return apply_columns(self.apply, r)
        w = self.Einv @ (self.Z.T @ r)
        z = self.base.apply(r - self.AZ @ w)
        return z + self.Z @ w

    @property
    def system_matrix(self):
        return self.base.system_matrix


class _DeflatedPrecond:
    def __init__(self, hierarchy, dtype, device):
        self.hierarchy = hierarchy
        self.dtype = dtype
        self.device = device

    def __repr__(self):
        return "deflated(%d vectors)" % self.hierarchy.Z.shape[1]


class deflated_solver:
    """``deflated_solver(A, Z, precond, solver)``, with ``make_solver``'s
    calling surface; ``vec`` is (n,) or (n, k). A caller's prebuilt
    preconditioner is wrapped, never changed."""

    def __init__(self, A, vec, precond: Any = None, solver: Any = None,
                 solver_dtype=None, matrix_format: str = "auto", **kw):
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        Z = np.asarray(vec, dtype=np.float64)
        if Z.ndim == 1:
            Z = Z[:, None]
        self.inner = make_solver(A, precond, solver, solver_dtype,
                                 matrix_format, **kw)
        dtype, device = self.inner.precond_dtype, self.inner.device
        AZ = np.stack([A.spmv(Z[:, k]) for k in range(Z.shape[1])], axis=1)
        Einv = np.linalg.pinv(Z.T @ AZ)

        def put(a):
            return torch.as_tensor(a, device=device).to(dtype)

        # the inner make_solver gets a fresh holder for the deflated view
        self.inner.precond = _DeflatedPrecond(
            DeflatedHierarchy(self.inner.precond.hierarchy, put(Z), put(AZ),
                              put(Einv)), dtype, device)

    def __call__(self, rhs, x0=None):
        return self.inner(rhs, x0)

    def __repr__(self):
        return "deflated_solver(nvec=%d)\n%r" % (
            self.inner.precond.hierarchy.Z.shape[1], self.inner)
