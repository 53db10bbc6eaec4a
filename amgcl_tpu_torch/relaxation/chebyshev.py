"""Chebyshev polynomial smoother (reference:
amgcl/relaxation/chebyshev.hpp:55-253: degree 5, lower bound 1/30 of the
spectral radius; counterpart of ``amgcl_tpu/relaxation/chebyshev.py``).
One application is the classic σ = θ/δ two-term recurrence, unrolled
``degree`` times: ``degree − 1`` residuals through the level operator's
kernel (SpMVs with ``scale=True``) and vector updates."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops.csr import CSR, spectral_radius
from amgcl_tpu_torch.relaxation.base import state_bytes


class ChebyshevState:
    def __init__(self, dinv, degree, theta, delta, scale):
        self.dinv = dinv          # (n,) D⁻¹, or None when scale is False
        self.degree = int(degree)
        self.theta = float(theta)
        self.delta = float(delta)
        self.scale = bool(scale)

    def apply(self, A, f):
        """z ≈ A⁻¹ f by ``degree`` Chebyshev steps from z = 0."""
        fs = self.dinv * f if self.scale else f
        sigma = self.theta / self.delta
        rho = 1.0 / sigma
        d = fs / self.theta
        z = d
        for _ in range(self.degree - 1):
            r = fs - self.dinv * dev.spmv(A, z) if self.scale \
                else dev.residual(fs, A, z)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / self.delta) * r
            z = z + d
            rho = rho_new
        return z

    def apply_pre(self, A, f, x):
        return x + self.apply(A, dev.residual(f, A, x))

    apply_post = apply_pre

    def bytes(self) -> int:
        return state_bytes(self.dinv)


@dataclass
class Chebyshev:
    degree: int = 5
    lower: float = 1.0 / 30.0
    power_iters: int = 0
    scale: bool = False

    def build(self, A: CSR, dtype, device) -> ChebyshevState:
        rho = spectral_radius(A, self.power_iters, scale=self.scale)
        a, b = rho * self.lower, rho
        dinv = None
        if self.scale:
            S = A.unblock() if A.is_block else A
            dinv = torch.as_tensor(S.diagonal(invert=True),
                                   device=device).to(dtype)
        return ChebyshevState(dinv, self.degree, (a + b) / 2.0,
                              (b - a) / 2.0, self.scale)
