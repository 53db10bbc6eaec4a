"""Damped Richardson iteration x += ω M(f − A x) (counterpart of
``amgcl_tpu/solver/richardson.py``; reference: amgcl/solver/richardson.hpp,
default damping 1.0).

Host control flow: each iteration is one preconditioner application and
one fused residual + ⟨r, r⟩ pass, and fetches the residual norm in one
host sync. A stationary iteration has no breakdown denominators, so the
guards watch for NaN, stagnation and divergence only. A stacked (n, B)
rhs runs the iteration on the block, one host sync an iteration for the
B columns (``solver/stacked.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.solver import stacked as S
from amgcl_tpu_torch.telemetry.history import HistoryMixin


@dataclass
class Richardson(HistoryMixin):
    maxiter: int = 100
    tol: float = 1e-8
    damping: float = 1.0
    record_history: bool = False  # per-iteration relative residuals
    guard: bool = True      # in-loop health guards (telemetry/health.py)

    def solve(self, A, precond, rhs, x0=None):
        """Returns ``(x, iters, relative_residual, health_state)``, with
        the residual history appended when ``record_history``. A stacked
        (n, B) rhs returns per-column lists, as :meth:`CG.solve` does."""
        if rhs.dim() == 2:
            return self._solve_stacked(A, precond, rhs, x0)
        x = torch.zeros_like(rhs) if x0 is None else x0
        r, rr0 = fv.residual_dot(rhs, A, x)
        norm_rhs, res = torch.stack(
            [dev.norm(rhs), torch.sqrt(torch.abs(rr0))]).tolist()
        scale = norm_rhs if norm_rhs > 0 else 1.0
        eps = self.tol * scale
        hs = self._guard_init(res / scale)
        hist = self._hist_init()
        it = 0
        while it < self.maxiter and res > eps and self._guard_go(hs):
            x_n = x + self.damping * precond(r)
            # fused residual + <r,r>: after the preconditioner the whole
            # iteration is one operator pass
            r_n, rr = fv.residual_dot(rhs, A, x_n)
            res_n = float(torch.sqrt(torch.abs(rr)))
            ok = self._guard_step(hs, it, res_n / scale)
            x, r, res = self._guard_commit(ok, (x_n, r_n, res_n), (x, r, res))
            self._hist_put(hist, it, res_n / scale, keep=ok)
            it += int(ok)
        return self._hist_result(x, it, res / scale, hs, hist)

    def _solve_stacked(self, A, precond, rhs, x0):
        rhs, x = S.entry(rhs, x0)
        r, rr0 = fv.residual_dot(rhs, A, x)
        norm_rhs, res = S.fetch(torch.sqrt(torch.abs(fv.col_dots(rhs, rhs))),
                                torch.sqrt(torch.abs(rr0)))
        cols = S.Columns(self, norm_rhs, res)
        while True:
            act = cols.actives()
            if not any(act):
                break
            x_n = x + self.damping * precond(r)
            r_n, rr = fv.residual_dot(rhs, A, x_n)
            (res_n,) = S.fetch(torch.sqrt(torch.abs(rr)))
            oks = []
            for b in range(cols.B):
                ok = act[b] and self._guard_step(
                    cols.hs[b], cols.its[b], res_n[b] / cols.scale[b])
                if act[b]:
                    self._hist_put(cols.hist[b], cols.its[b],
                                   res_n[b] / cols.scale[b], keep=ok)
                if ok:
                    cols.res[b] = res_n[b]
                    cols.its[b] += 1
                oks.append(ok)
            x, r = S.commit(cols.mask(oks, rr), (x_n, r_n), (x, r))
        return cols.result(x)
