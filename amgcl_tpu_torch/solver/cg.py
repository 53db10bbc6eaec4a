"""Preconditioned conjugate gradients (counterpart of
``amgcl_tpu/solver/cg.py``; reference: amgcl/solver/cg.hpp:140-207).

The recurrences are the JAX package's, written as a Python loop: every
vector operation is enqueued on the device, and each iteration fetches
its three scalars (residual norm, ρ, ⟨q, p⟩) in one host sync for the
convergence check and the health guards. A stacked (n, B) rhs runs the
same recurrences on the block, one host sync an iteration for the B
columns (``solver/stacked.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.solver import stacked as S
from amgcl_tpu_torch.telemetry import health as H
from amgcl_tpu_torch.telemetry.history import HistoryMixin


@dataclass
class CG(HistoryMixin):
    maxiter: int = 100
    tol: float = 1e-8
    abstol: float = 0.0
    ns_search: bool = False  # keep iterating on a zero rhs to find
    #                          null-space vectors (cg.hpp:90-94,163-168)
    verbose: bool = False   # print residual every 5 iterations (cg.hpp:199)
    record_history: bool = False  # per-iteration relative residuals
    guard: bool = True      # in-loop health guards (telemetry/health.py)

    def solve(self, A, precond, rhs, x0=None, abstol=None):
        """Returns ``(x, iters, relative_residual, health_state)``, with
        the residual history appended when ``record_history``.
        ``precond`` maps a residual r to an approximate solution of
        A z = r. ``abstol`` overrides the field (iterative refinement stops
        correction solves exactly at the global target). A stacked
        (n, B) rhs returns x (n, B) with per-column lists of iterations
        and residuals and a :class:`StackedHealth`."""
        if rhs.dim() == 2:
            return self._solve_stacked(A, precond, rhs, x0, abstol)
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
        # ns_search drives the iterates into the null space, where the
        # breakdown denominators legitimately vanish: guards off there but
        # the NaN check
        guard_trips = self.guard and not self.ns_search
        hs = self._guard_init(res / norm_scale)
        hist = self._hist_init()
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
                           if guard_trips else qp)
            # fused tail: x += alpha p, r -= alpha q and <r,r> in one pass
            x_n, r_n, rr = fv.xr_update(alpha, p_n, q, x, r)
            res_n, rho_h, qp_h = torch.stack(
                [torch.sqrt(torch.abs(rr)), rho, qp]).tolist()
            # rho: residual orthogonal to the preconditioned residual;
            # qp ≈ 0: singular direction; qp < 0: not positive definite
            # (informational — CG may still proceed)
            if guard_trips:
                ok = self._guard_step(
                    hs, it, res_n / norm_scale,
                    ((H.BREAKDOWN_RHO, H.bad_denom(rho_h, tiny)),
                     (H.BREAKDOWN_ALPHA, H.bad_denom(qp_h, tiny)),
                     (H.INDEFINITE, qp_h < 0, False)))
            elif self.guard:
                # a NaN residual is still a failure under ns_search
                ok = math.isfinite(res_n)
                hs.trip(it, H.NAN, not ok)
            else:
                ok = True
            x, r, p, rho_prev, res = self._guard_commit(
                ok, (x_n, r_n, p_n, rho, res_n), (x, r, p, rho_prev, res))
            self._hist_put(hist, it, res_n / norm_scale, keep=ok)
            if self.verbose and (it + 1) % 5 == 0:
                print("iter %d: resid %.6e" % (it + 1, res / norm_scale))
            it += int(ok)
        if norm_rhs == 0 and not self.ns_search:
            # with ns_search the iterates from a nonzero x0 approach a
            # null-space vector instead (reference cg.hpp:163-168)
            x = torch.zeros_like(x)
        return self._hist_result(x, it, res / norm_scale, hs, hist)

    def _solve_stacked(self, A, precond, rhs, x0, abstol):
        """The 1-D recurrences on a (n, B) block, columns frozen once
        their own loop condition fails."""
        rhs, x = S.entry(rhs, x0)
        r, rr0 = fv.residual_dot(rhs, A, x)
        norm_rhs, res = S.fetch(torch.sqrt(torch.abs(fv.col_dots(rhs, rhs))),
                                torch.sqrt(torch.abs(rr0)))
        ab = self.abstol if abstol is None else abstol
        cols = S.Columns(self, norm_rhs, res,
                         [max(self.tol * (v if v > 0 else 1.0), ab)
                          for v in norm_rhs])
        tiny = torch.finfo(rhs.dtype).tiny
        guard_trips = self.guard and not self.ns_search
        p = torch.zeros_like(r)
        rho_prev = torch.zeros_like(rr0)
        zero = torch.zeros_like(rho_prev)
        while True:
            act = cols.actives()
            if not any(act):
                break
            s = precond(r)
            rho = fv.col_dots(r, s)
            beta = torch.where(rho_prev == 0, zero, rho / rho_prev)
            p_n = dev.axpby(1.0, s, beta, p)
            q, _, qp, _ = dev.spmv_dots(A, p_n)
            alpha = rho / (torch.where(qp == 0, torch.ones_like(qp), qp)
                           if guard_trips else qp)
            x_n, r_n, rr = fv.xr_update(alpha, p_n, q, x, r)
            res_n, rho_h, qp_h = S.fetch(torch.sqrt(torch.abs(rr)), rho, qp)
            oks = []
            for b in range(cols.B):
                if not act[b]:
                    oks.append(False)
                    continue
                it, sc, hs = cols.its[b], cols.scale[b], cols.hs[b]
                if guard_trips:
                    ok = self._guard_step(
                        hs, it, res_n[b] / sc,
                        ((H.BREAKDOWN_RHO, H.bad_denom(rho_h[b], tiny)),
                         (H.BREAKDOWN_ALPHA, H.bad_denom(qp_h[b], tiny)),
                         (H.INDEFINITE, qp_h[b] < 0, False)))
                elif self.guard:
                    ok = math.isfinite(res_n[b])
                    hs.trip(it, H.NAN, not ok)
                else:
                    ok = True
                self._hist_put(cols.hist[b], it, res_n[b] / sc, keep=ok)
                if ok:
                    cols.res[b] = res_n[b]
                    cols.its[b] += 1
                    if self.verbose and cols.its[b] % 5 == 0:
                        print("rhs %d iter %d: resid %.6e"
                              % (b, cols.its[b], res_n[b] / sc))
                oks.append(ok)
            m = cols.mask(oks, r)
            x, r, p, rho_prev = S.commit(m, (x_n, r_n, p_n, rho),
                                         (x, r, p, rho_prev))
        if not self.ns_search:
            x = torch.where(cols.mask([v > 0 for v in norm_rhs], x), x,
                        torch.zeros_like(x))
        return cols.result(x)
