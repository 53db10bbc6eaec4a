"""Galerkin coarse operator Ac = R A P (counterpart of the host route of
``amgcl_tpu/coarsening/galerkin.py``; reference:
amgcl/coarsening/detail/galerkin.hpp:53)."""

from __future__ import annotations

from amgcl_tpu_torch.ops.csr import CSR


def galerkin(A: CSR, P: CSR, R: CSR) -> CSR:
    return R @ (A @ P)
