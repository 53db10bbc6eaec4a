"""Galerkin coarse operator Ac = R A P, and its scaled form for plain
aggregation (counterpart of the host route of
``amgcl_tpu/coarsening/galerkin.py``; reference:
amgcl/coarsening/detail/galerkin.hpp:53, scaled_galerkin.hpp)."""

from __future__ import annotations

from amgcl_tpu_torch.ops.csr import CSR


def galerkin(A: CSR, P: CSR, R: CSR) -> CSR:
    return R @ (A @ P)


def scaled_galerkin(A: CSR, P: CSR, R: CSR, scale: float) -> CSR:
    Ac = galerkin(A, P, R)
    return CSR(Ac.ptr, Ac.col, Ac.val * Ac.val.dtype.type(scale), Ac.ncols)
