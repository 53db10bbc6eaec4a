"""Preconditioned conjugate gradients (counterpart of
``amgcl_tpu/solver/cg.py``; reference: amgcl/solver/cg.hpp:140-207).

The recurrences are the JAX package's, written as a Python loop: every
vector operation is enqueued on the device, and each iteration fetches
its three scalars (residual norm, ρ, ⟨q, p⟩) in one host sync for the
convergence check and the health guards.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.telemetry import health as H
from amgcl_tpu_torch.telemetry.history import HistoryMixin


@dataclass
class CG(HistoryMixin):
    maxiter: int = 100
    tol: float = 1e-8
    abstol: float = 0.0
    guard: bool = True      # in-loop health guards (telemetry/health.py)

    def solve(self, A, precond, rhs, x0=None, abstol=None):
        """Returns ``(x, iters, relative_residual, health_state)``.
        ``precond`` maps a residual r to an approximate solution of
        A z = r. ``abstol`` overrides the field (iterative refinement stops
        correction solves exactly at the global target)."""
        x = torch.zeros_like(rhs) if x0 is None else x0
        # fused residual + <r,r>: one operator pass
        r, rr0 = fv.residual_dot(rhs, A, x)
        norm_rhs, res = torch.stack(
            [dev.norm(rhs), torch.sqrt(torch.abs(rr0))]).tolist()
        # if ||rhs|| == 0 the solution is x = 0 (reference cg.hpp:144-149)
        norm_scale = norm_rhs if norm_rhs > 0 else 1.0
        eps = max(self.tol * norm_scale,
                  self.abstol if abstol is None else abstol)
        tiny = torch.finfo(rhs.dtype).tiny
        hs = self._guard_init(res / norm_scale)
        p = torch.zeros_like(r)
        rho_prev = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
        zero = torch.zeros_like(rho_prev)
        it = 0
        while it < self.maxiter and res > eps and self._guard_go(hs):
            s = precond(r)
            rho = dev.inner_product(r, s)
            beta = torch.where(rho_prev == 0, zero, rho / rho_prev)
            p_n = dev.axpby(1.0, s, beta, p)
            q, qp = dev.spmv_dot(A, p_n)
            # guarded: the safe division only protects a candidate the
            # breakdown trip below discards anyway
            alpha = rho / (torch.where(qp == 0, torch.ones_like(qp), qp)
                           if self.guard else qp)
            # fused tail: x += alpha p, r -= alpha q and <r,r> in one pass
            x_n, r_n, rr = fv.xr_update(alpha, p_n, q, x, r)
            res_n, rho_h, qp_h = torch.stack(
                [torch.sqrt(torch.abs(rr)), rho, qp]).tolist()
            # rho: residual orthogonal to the preconditioned residual;
            # qp ≈ 0: singular direction; qp < 0: not positive definite
            # (informational — CG may still proceed)
            ok = self._guard_step(
                hs, it, res_n / norm_scale,
                ((H.BREAKDOWN_RHO, H.bad_denom(rho_h, tiny)),
                 (H.BREAKDOWN_ALPHA, H.bad_denom(qp_h, tiny)),
                 (H.INDEFINITE, qp_h < 0, False)))
            x, r, p, rho_prev, res = self._guard_commit(
                ok, (x_n, r_n, p_n, rho, res_n), (x, r, p, rho_prev, res))
            it += int(ok)
        if norm_rhs == 0:
            x = torch.zeros_like(x)
        return x, it, res / norm_scale, (hs if self.guard else None)
