"""Named scopes of the set-up and the solve, and the per-request span
recorder of the serving path (counterpart of
``amgcl_tpu/telemetry/tracing.py``).

``phase(name)`` and ``annotate(name)`` mark a span ``amgcl/<name>`` with
``torch.profiler.record_function``: a ``torch.profiler`` capture then
groups the host ops and the device kernels launched inside it under the
name (the JAX package's ``jax.named_scope`` and ``TraceAnnotation``; one
torch API serves both, since torch code is not traced).

``setup_scope(prof, name)`` opens a scope of the hierarchy build on a
:class:`~amgcl_tpu_torch.utils.profiler.Profiler` and publishes the
profiler thread-locally, so that :func:`setup_substage` attaches nested
stages (the device MIS, the Galerkin plans, the native passes) from code
that never sees the AMG object: ``AMG.setup_profile`` reads the whole
tree.

:class:`RequestSpans` records each request's queue wait and each batch's
padding, capture, device solve and sync intervals in the service worker;
the export is a Chrome/Perfetto trace-event track.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "amgcl/"


def annotate(name: str):
    """Host-side span ``amgcl/<name>`` for work outside a traced region
    (set-up stages, host packing, dispatch)."""
    import torch
    return torch.profiler.record_function(PREFIX + name)


def phase(name: str):
    """Span ``amgcl/<name>`` around device code (a V-cycle's stages): a
    ``torch.profiler`` capture files the kernels launched inside under
    it."""
    return annotate(name)


#: the profiler the build running on this thread records into, and the
#: name of its open set-up scope
_setup_tls = threading.local()


@contextmanager
def setup_scope(prof, name: str):
    """A scope ``name`` of the set-up on ``prof`` (a
    :class:`~amgcl_tpu_torch.utils.profiler.Profiler`; None records
    nothing but the span) and a span ``amgcl/setup/<name>``. While it is
    open, :func:`setup_substage` nests under it."""
    prev = getattr(_setup_tls, "scope", None)
    _setup_tls.scope = (prof, name)
    try:
        with annotate("setup/" + name):
            if prof is None:
                yield
            else:
                with prof.scope(name):
                    yield
    finally:
        _setup_tls.scope = prev


@contextmanager
def setup_substage(name: str):
    """A stage nested in the open :func:`setup_scope` of this thread,
    ``<scope>/<name>`` in the profile; outside a build only the span."""
    cur = getattr(_setup_tls, "scope", None)
    with annotate("setup/" + (cur[1] + "/" if cur else "") + name):
        if cur is None or cur[0] is None:
            yield
        else:
            with cur[0].scope(name):
                yield


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
