"""LGMRES: restarted GMRES augmented with error-correction directions
from earlier restart cycles, which damps the restart stalling of plain
GMRES(m) (counterpart of ``amgcl_tpu/solver/lgmres.py``; reference:
amgcl/solver/lgmres.hpp, defaults M = 30, K = 3).

Reuses the Arnoldi/Givens cycle of :mod:`amgcl_tpu_torch.solver.gmres`:
the first M − K expansion directions are Krylov basis vectors, the last
ones the stored corrections (the cycle's ``direction`` hook), newest
first and kept normalised; the accumulated directions Z hold whatever
each step expanded with, so the least-squares update applies uniformly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.solver import stacked as S
from amgcl_tpu_torch.solver.gmres import (_arnoldi_cycle, _restarted_stacked,
                                          _Run)
from amgcl_tpu_torch.telemetry.history import HistoryMixin


@dataclass
class LGMRES(HistoryMixin):
    """``pside`` selects the preconditioning side (the JAX package's
    default, left, or right). With ``pside='right'`` the Arnoldi
    directions live in the unpreconditioned space and the preconditioner
    is applied once to the assembled correction of each cycle
    (lgmres.hpp:384-389), with true residuals tracked."""
    M: int = 30
    K: int = 3
    maxiter: int = 100
    tol: float = 1e-8
    pside: str = "left"
    record_history: bool = False  # per-iteration relative residuals
    guard: bool = True      # in-loop health guards (telemetry/health.py)

    def solve(self, A, precond, rhs, x0=None):
        """Returns ``(x, iters, relative_residual, health_state)``, with
        the residual history appended when ``record_history``. A stacked
        (n, B) rhs returns per-column lists, as :meth:`CG.solve` does."""
        if self.pside not in ("left", "right"):
            raise ValueError("pside must be 'left' or 'right', got %r"
                             % (self.pside,))
        m, K = int(self.M), int(self.K)
        if not 0 <= K < m:
            raise ValueError("need 0 <= K < M, got K=%r, M=%r"
                             % (self.K, self.M))
        mk = m - K
        left = self.pside == "left"
        if rhs.dim() == 2:
            rhs, x = S.entry(rhs, x0)
        else:
            x = torch.zeros_like(rhs) if x0 is None else x0
        if left:
            def apply_op(v):
                return precond(dev.spmv(A, v)), v

            def presid(x):
                return precond(dev.residual(rhs, A, x))
        else:
            # w = A (M z); the stored directions are the z themselves, M
            # lands on the assembled correction
            def apply_op(v):
                return dev.spmv(A, precond(v)), v

            def presid(x):
                return dev.residual(rhs, A, x)

        if rhs.dim() == 2:
            return _restarted_stacked(self, apply_op, presid, rhs, x, m, K,
                                      None if left else precond)
        aug = []                # stored corrections, newest first

        def direction(j, V):
            return V[j] if j < mk else aug[j - mk]

        norm_rhs = dev.norm(presid(torch.zeros_like(rhs)))
        r = presid(x)
        beta = dev.norm(r)
        run = _Run(self, rhs.dtype)
        while run.it < self.maxiter and (
                run.scale is None or (run.res > run.eps and run.go())):
            if run.scale is not None:
                r = presid(x)
                beta = dev.norm(r)
            dx, steps, run.res = _arnoldi_cycle(
                run, apply_op, r, beta, m, direction=direction,
                n_steps=mk + len(aug),
                pending=norm_rhs if run.scale is None else None)
            # the augmentation stores the correction of the Arnoldi space
            # on both sides, normalised (lgmres.hpp:363-371)
            nrm = dev.norm(dx)
            aug.insert(0, dx / torch.where(nrm == 0, torch.ones_like(nrm),
                                           nrm))
            del aug[K:]
            x = x + (dx if left else precond(dx))
            run.it += steps
        if run.scale is None:           # maxiter <= 0: no cycle ran
            run.resolve(*torch.stack([norm_rhs, beta]).tolist())
        return self._hist_result(x, run.it, run.res / run.scale, run.hs,
                                 run.hist)
