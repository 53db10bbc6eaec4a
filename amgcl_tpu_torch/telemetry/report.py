"""SolveReport — the convergence record of one solve (counterpart of a
subset of ``amgcl_tpu/telemetry/report.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional


@dataclass
class SolveReport:
    """``resid`` is the final relative residual. Unpacks like the
    reference's pair: ``iters, error = info``. ``history`` (a solver with
    ``record_history=True``) lists the relative residual of each
    iteration: ``len(history) == iters`` for a plain solve, and under
    iterative refinement it covers the initial solve only while
    ``iters`` also counts the correction solves. A stacked (n, B) solve
    reports the batch maxima of ``iters`` and ``resid``, the JAX
    package's health dict with a decode a column (``health["per_rhs"]``),
    the slowest column's history, and in ``extra["per_rhs"]`` each
    column's iterations, residual and history."""

    iters: int
    resid: float
    wall_time_s: Optional[float] = None
    hierarchy: Optional[Dict[str, Any]] = None
    #: names of the guard flags that tripped (telemetry/health.py);
    #: empty for a clean guarded solve, None with guards off
    health: Optional[List[str]] = None
    #: per-iteration relative residuals, or None
    history: Optional[List[float]] = None
    #: the solver's name where one entry point serves several, and its
    #: own details (a sharded solve: the shard and device counts)
    solver: Optional[str] = None
    extra: Optional[Dict[str, Any]] = None
    #: right-hand sides solved a second (a stacked solve, a service batch)
    solves_per_sec: Optional[float] = None
    #: a service request's spans (serve/service.py)
    serve: Optional[Dict[str, Any]] = None

    def __iter__(self):
        yield self.iters
        yield self.resid

    def __str__(self):
        lines = ["Iterations: %d" % self.iters,
                 "Error:      %.6e" % self.resid]
        if self.wall_time_s is not None:
            lines.append("Wall time:  %.4f s" % self.wall_time_s)
        if self.health:
            lines.append("Health:     %s" % ", ".join(self.health))
        return "\n".join(lines)
