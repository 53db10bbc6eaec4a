"""SolveReport — the convergence record of one solve (counterpart of a
subset of ``amgcl_tpu/telemetry/report.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional


@dataclass
class SolveReport:
    """``resid`` is the final relative residual. Unpacks like the
    reference's pair: ``iters, error = info``."""

    iters: int
    resid: float
    wall_time_s: Optional[float] = None
    hierarchy: Optional[Dict[str, Any]] = None
    #: names of the guard flags that tripped (telemetry/health.py);
    #: empty for a clean guarded solve, None with guards off
    health: Optional[List[str]] = None

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
