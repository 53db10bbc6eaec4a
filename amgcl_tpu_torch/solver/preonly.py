"""Apply the preconditioner exactly once, for nesting a preconditioner
inside another solver (counterpart of ``amgcl_tpu/solver/preonly.py``;
reference: amgcl/solver/preonly.hpp).

The solve reports one iteration and the true relative residual of the
result, fetched in one host sync; the guard trips only on a non-finite
residual. A stacked (n, B) rhs applies the preconditioner to the block and
fetches the B residuals in one sync.
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
class PreOnly(HistoryMixin):
    maxiter: int = 1   # unused; the runtime config may set it, as for
    #                    the JAX package's
    tol: float = 0.0   # iterative refinement's target (make_solver)
    record_history: bool = False
    guard: bool = True      # NaN detection only (no loop to guard)

    def solve(self, A, precond, rhs, x0=None):
        """Returns ``(x, 1, relative_residual, health_state)``, with the
        one-entry history appended when ``record_history``; ``x0`` is
        ignored. A stacked (n, B) rhs returns per-column lists, as
        :meth:`CG.solve` does."""
        if rhs.dim() == 2:
            rhs = S.block(rhs)
            x = precond(rhs)
            r = dev.residual(rhs, A, x)
            nr, nb = S.fetch(torch.sqrt(torch.abs(fv.col_dots(r, r))),
                             torch.sqrt(torch.abs(fv.col_dots(rhs, rhs))))
            cols = S.Columns(self, nb, nr)
            for b in range(cols.B):
                rel = nr[b] / cols.scale[b]
                cols.its[b] = 1
                self._hist_put(cols.hist[b], 0, rel)
                cols.hs[b].trip(0, H.NAN, not math.isfinite(rel))
            return cols.result(x)
        x = precond(rhs)
        r = dev.residual(rhs, A, x)
        nr, nb = torch.stack([dev.norm(r), dev.norm(rhs)]).tolist()
        rel = nr / (nb if nb > 0 else 1.0)
        hist = self._hist_init()
        self._hist_put(hist, 0, rel)
        hs = self._guard_init(rel)
        hs.trip(0, H.NAN, not math.isfinite(rel))
        return self._hist_result(x, 1, rel, hs, hist)
