"""Guard plumbing shared by the Krylov solvers (counterpart of the guard
methods of ``amgcl_tpu/telemetry/history.py::HistoryMixin``; per-iteration
residual history recording comes with the other solvers)."""

from __future__ import annotations

from amgcl_tpu_torch.telemetry import health as _health


class HistoryMixin:
    """Numerical-health guard hooks for a solver with a ``guard`` field."""

    guard = True

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
