"""Percentiles, rollups and Prometheus exposition (the parts of
``amgcl_tpu/telemetry/metrics.py`` the serving path uses)."""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterable, List, Optional


def percentile(values: List[float], p: float) -> Optional[float]:
    """Linear-interpolated percentile of an (unsorted) list; None when
    nothing finite is in it."""
    vals = sorted(v for v in values if v is not None
                  and isinstance(v, (int, float)) and math.isfinite(v))
    if not vals:
        return None
    if len(vals) == 1:
        return float(vals[0])
    k = (len(vals) - 1) * (p / 100.0)
    lo = int(math.floor(k))
    hi = min(lo + 1, len(vals) - 1)
    return float(vals[lo] + (vals[hi] - vals[lo]) * (k - lo))


def rollup(values: Iterable[Any]) -> Optional[Dict[str, Any]]:
    """{count, min, p50, p90, p99, max, mean, last} of the finite numeric
    values; None when nothing numeric survives."""
    vals = [float(v) for v in values
            if isinstance(v, (int, float)) and not isinstance(v, bool)
            and math.isfinite(v)]
    if not vals:
        return None
    return {
        "count": len(vals),
        "min": min(vals),
        "p50": round(percentile(vals, 50), 6),
        "p90": round(percentile(vals, 90), 6),
        "p99": round(percentile(vals, 99), 6),
        "max": max(vals),
        "mean": round(sum(vals) / len(vals), 6),
        "last": vals[-1],
    }


def prom_name(prefix: str, name: str) -> str:
    """The Prometheus metric name: prefix join, sanitized to
    [a-zA-Z0-9_]."""
    return "%s_%s" % (prefix, re.sub(r"[^a-zA-Z0-9_]", "_", name))


def prometheus_text(rollups: Dict[str, Dict[str, Any]],
                    prefix: str = "amgcl_torch") -> str:
    """Prometheus exposition of a rollup table: summary-style gauges with
    ``quantile`` labels plus ``_count``/``_min``/``_max``."""
    lines = []
    for name in sorted(rollups):
        r = rollups[name]
        metric = prom_name(prefix, name)
        lines.append("# TYPE %s summary" % metric)
        for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            if r.get(key) is not None:
                lines.append('%s{quantile="%s"} %s' % (metric, q, r[key]))
        lines.append("%s_count %d" % (metric, r["count"]))
        lines.append("%s_min %s" % (metric, r["min"]))
        lines.append("%s_max %s" % (metric, r["max"]))
    return "\n".join(lines) + ("\n" if lines else "")
