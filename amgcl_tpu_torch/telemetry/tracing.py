"""Per-request span recorder of the serving path (counterpart of
:class:`RequestSpans` in ``amgcl_tpu/telemetry/tracing.py``; the JAX
package's named scopes and host annotations have no counterpart here).

The service worker records each request's queue wait and each batch's
padding, capture, device solve and sync intervals; the export is a
Chrome/Perfetto trace-event track.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


class RequestSpans:
    """Bounded thread-safe recorder of per-request serve phases.

    ``add(request_id, phases)`` takes ``[(phase, start_s, end_s), ...]``
    in ``time.perf_counter()`` seconds; the export renders one
    ``reqNNNNN/phase`` complete event per span. Past ``max_events`` spans
    further ones are dropped (the count is carried in the export), so a
    long-running service does not grow without bound."""

    def __init__(self, max_events: int = 100_000):
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        #: (path, start_s, end_s)
        self.events: List[Tuple[str, float, float]] = []
        self.dropped = 0
        self._t0 = time.perf_counter()

    def add(self, request_id: int,
            phases: Sequence[Tuple[str, float, float]],
            label: str = "req") -> None:
        """``label`` prefixes the span path: per-request spans ride
        ``req<id>/...``, the phases a batch shares (pad, compile, solve,
        sync) ride ``batch<id>/...`` once."""
        with self._lock:
            if len(self.events) + len(phases) > self.max_events:
                self.dropped += len(phases)
                return
            for name, start, end in phases:
                self.events.append(
                    ("%s%05d/%s" % (label, int(request_id), name),
                     float(start), float(end)))

    def to_chrome_trace(self, tid: int = 0,
                        tid_name: Optional[str] = None, pid: int = 0,
                        epoch: Optional[float] = None) -> Dict:
        """Chrome/Perfetto trace-event dict of the recorded spans, times
        relative to ``epoch`` (default: the recorder's creation)."""
        t0 = self._t0 if epoch is None else epoch
        with self._lock:
            spans = list(self.events)
            dropped = self.dropped
        events = []
        if tid_name:
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tid_name}})
        for path, start, end in spans:
            events.append({
                "name": path.rsplit("/", 1)[-1], "cat": "amgcl/serve",
                "ph": "X", "ts": round((start - t0) * 1e6, 3),
                "dur": round((end - start) * 1e6, 3),
                "pid": pid, "tid": tid, "args": {"path": path}})
        if dropped:
            last_end = spans[-1][2] if spans else t0
            events.append({
                "name": "spans_dropped", "cat": "amgcl/serve",
                "ph": "i", "s": "g",
                "ts": round((last_end - t0) * 1e6, 3),
                "pid": pid, "tid": tid,
                "args": {"dropped": dropped, "cap": self.max_events}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}
