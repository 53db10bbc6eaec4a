"""History and guard plumbing shared by the Krylov solvers (counterpart of
``amgcl_tpu/telemetry/history.py::HistoryMixin``).

The JAX package writes each iteration's relative residual into a
preallocated buffer carried through its device loop, at the iteration's
slot; slots never written stay NaN, and ``make_solver`` slices the buffer
by the recorded count. The port's loops already fetch each iteration's
residual to the host for the convergence test, so the history is a host
list with the same slot semantics (:meth:`_hist_put` at an index, NaN
where nothing was written) and costs no device work.
"""

from __future__ import annotations

import math

from amgcl_tpu_torch.telemetry import health as _health


class HistoryMixin:
    """Numerical-health guard hooks and per-iteration history for a solver
    with ``guard`` and ``record_history`` fields."""

    guard = True
    record_history = False

    def _hist_init(self):
        """An empty history when recording, else None."""
        return [] if self.record_history else None

    def _hist_put(self, hist, idx, value, keep=True):
        """hist[idx] = value when recording and ``keep``; slots skipped
        on the way stay NaN."""
        if hist is None or not keep:
            return
        if len(hist) <= idx:
            hist.extend([math.nan] * (idx + 1 - len(hist)))
        hist[idx] = float(value)

    def _hist_result(self, x, iters, resid, hs, hist):
        """The uniform solver return: ``(x, iters, resid, health)`` —
        health None with guards off — with the history list appended when
        recording (``make_solver`` slices it by the initial solve's
        count)."""
        out = (x, iters, resid, hs if self.guard else None)
        return out + (hist,) if self.record_history else out

    def _guard_init(self, res0: float) -> _health.HealthState:
        return _health.HealthState(prev_res=res0, best_res=res0)

    def _guard_step(self, hs, it, res, trips=()) -> bool:
        """Guard update with candidate residual ``res``; returns the
        commit mask (always True with guards off)."""
        if not self.guard:
            return True
        return _health.step(hs, it, res, trips)

    def _guard_go(self, hs) -> bool:
        """Loop continuation term: False once a fatal guard tripped."""
        return not self.guard or _health.keep_going(hs)

    @staticmethod
    def _guard_commit(ok, new, old):
        """``new`` if the step is committed, else ``old`` — the fatal-trip
        freeze."""
        return new if ok else old
