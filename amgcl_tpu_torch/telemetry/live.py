"""Live metrics registry and scrape endpoint of the serving path
(counterpart of ``amgcl_tpu/telemetry/live.py``; its gauges of the
distributed solve, the operator X-ray, the memory observatory, the farm
and the load generator belong to later slices).

* :data:`METRICS` — the declared metric table. The registry accepts a
  name only from it (an unknown name raises), so every live metric is a
  row here.
* :class:`LiveRegistry` — thread-safe counters (optionally labelled),
  gauges and bounded histograms (the last N observations, summarized with
  the interpolated percentiles of ``telemetry/metrics.py``); an update is
  a dict write under one lock.
* :class:`MetricsServer` — a daemon ``http.server`` thread serving
  ``/metrics`` (Prometheus text) and ``/healthz`` (JSON) on 127.0.0.1;
  port 0 binds an ephemeral port (the bound one is ``.port``).

A :class:`~amgcl_tpu_torch.serve.SolverService` starts a server when
given ``metrics_port``.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

from amgcl_tpu_torch.telemetry import metrics as _metrics

#: the declared metric table: name -> (kind, help), kind one of
#: "counter", "gauge" and "histogram"
METRICS: Dict[str, Tuple[str, str]] = {
    "serve_queue_depth": (
        "gauge", "requests waiting in the serve queue right now"),
    "serve_inflight": (
        "gauge", "requests inside the current device batch"),
    "serve_requests_total": (
        "counter", "requests completed by the service"),
    "serve_batches_total": (
        "counter", "device batches dispatched"),
    "serve_timeouts_total": (
        "counter", "requests expired in the queue before dispatch"),
    "serve_unhealthy_total": (
        "counter", "requests whose health guards tripped or whose batch "
                   "dispatch raised"),
    "serve_health_flags_total": (
        "counter", "guard-flag trips by flag name (label: flag)"),
    "serve_padded_slots_total": (
        "counter", "zero-padded bucket columns dispatched (wasted)"),
    "serve_bucket_solves_total": (
        "counter", "requests retired by bucket size (label: bucket)"),
    "serve_slo_trips_total": (
        "counter", "SLO watchdog threshold trips"),
    "serve_batch_fill": (
        "histogram", "live columns / padded bucket B per batch"),
    "serve_latency_ms": (
        "histogram", "end-to-end per-request latency (submit->result)"),
    "serve_queue_ms": (
        "histogram", "per-request queue wait before batch assembly"),
    "serve_solve_ms": (
        "histogram", "per-batch device solve wall (capture excluded)"),
    "serve_graph_captures": (
        "gauge", "CUDA graphs captured for the service's buckets"),
    "serve_graph_capture_s": (
        "gauge", "cumulative CUDA graph capture seconds of the buckets"),
    "recovery_retries_total": (
        "counter", "request retries scheduled (re-dispatch with backoff)"),
    "recoveries_total": (
        "counter", "retried requests that subsequently succeeded"),
    "serve_worker_deaths_total": (
        "counter", "dispatch-worker threads that died on an unexpected "
                   "exception (futures failed, never stranded)"),
    "serve_worker_restarts_total": (
        "counter", "dispatch workers restarted by the supervisor"),
}

#: the declared label keys: metric name -> allowed label keys
METRIC_LABELS: Dict[str, Tuple[str, ...]] = {
    "serve_health_flags_total": ("flag",),
    "serve_bucket_solves_total": ("bucket",),
}

PREFIX = "amgcl_torch"


def _prom_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, str(v).replace('"', "'"))
                             for k, v in labels)


class LiveRegistry:
    """Thread-safe in-process metrics, validated against a declared table
    (:data:`METRICS` by default): an unknown name or label key raises
    KeyError, a kind mismatch TypeError."""

    def __init__(self, spec: Optional[Dict[str, Tuple[str, str]]] = None,
                 hist_cap: int = 2048,
                 labels_spec: Optional[Dict[str, Tuple[str, ...]]] = None):
        self.spec = dict(METRICS if spec is None else spec)
        self.labels_spec = dict(METRIC_LABELS if labels_spec is None
                                else labels_spec)
        self.hist_cap = int(hist_cap)
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = {}
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._hists: Dict[str, deque] = {}

    def _check(self, name: str, kind: str, labels=()) -> None:
        row = self.spec.get(name)
        if row is None:
            raise KeyError("undeclared live metric %r — add it to "
                           "telemetry/live.py METRICS" % name)
        if row[0] != kind:
            raise TypeError("metric %r is declared %r, not %r"
                            % (name, row[0], kind))
        for k in labels:
            if k not in self.labels_spec.get(name, ()):
                raise KeyError("label %r is not declared for metric %r — "
                               "add it to telemetry/live.py METRIC_LABELS"
                               % (k, name))

    def inc(self, name: str, by: float = 1, **labels) -> None:
        self._check(name, "counter", labels)
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + by

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self._check(name, "gauge", labels)
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name: str, value: float) -> None:
        self._check(name, "histogram")
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = deque(maxlen=self.hist_cap)
            h.append(float(value))

    def get(self, name: str, **labels) -> Optional[float]:
        """Current value: counter or gauge (with exact labels); the last
        observation of a histogram. None when never touched."""
        kind = self.spec.get(name, (None,))[0]
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            if kind == "counter":
                return self._counters.get(key)
            if kind == "gauge":
                return self._gauges.get(key)
            if kind == "histogram":
                h = self._hists.get(name)
                return h[-1] if h else None
        return None

    def snapshot(self) -> Dict[str, Any]:
        """JSON-clean copy: counters and gauges (labels in the key) and
        histogram rollups, each with ``window`` = the histogram capacity
        (the percentiles cover at most that many recent observations)."""
        with self._lock:
            counters = {name + _prom_labels(labels): v
                        for (name, labels), v in self._counters.items()}
            gauges = {name + _prom_labels(labels): v
                      for (name, labels), v in self._gauges.items()}
            hists = {name: list(h) for name, h in self._hists.items()}
        return {"counters": counters, "gauges": gauges,
                "histograms": {name: dict(_metrics.rollup(vals),
                                          window=self.hist_cap)
                               for name, vals in hists.items() if vals}}

    def prometheus(self, prefix: str = PREFIX) -> str:
        """Prometheus exposition text of everything live: counters and
        gauges as typed lines, histograms as summary quantiles."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = {name: list(h) for name, h in self._hists.items()}
        lines = []
        seen = set()
        for kind, rows in (("counter", counters), ("gauge", gauges)):
            for (name, labels), v in rows:
                metric = _metrics.prom_name(prefix, name)
                if metric not in seen:
                    seen.add(metric)
                    lines.append("# HELP %s %s" % (metric, self.spec[name][1]))
                    lines.append("# TYPE %s %s" % (metric, kind))
                lines.append("%s%s %s" % (metric, _prom_labels(labels), v))
        rollups = {name: r for name, r in
                   ((name, _metrics.rollup(vals))
                    for name, vals in sorted(hists.items()))
                   if r is not None}
        for name in rollups:
            lines.append("# HELP %s %s (rolling window: last %d "
                         "observations)" % (_metrics.prom_name(prefix, name),
                                            self.spec[name][1],
                                            self.hist_cap))
        text = "\n".join(lines) + ("\n" if lines else "")
        if rollups:
            text += _metrics.prometheus_text(rollups, prefix=prefix)
        return text


class MetricsServer:
    """Daemon HTTP thread serving ``/metrics`` (Prometheus text) and
    ``/healthz`` (JSON) on 127.0.0.1. ``metrics_cb`` returns the
    exposition text, ``health_cb`` a JSON-able dict; both run on the
    scrape thread and must not touch the device. Port 0 binds an
    ephemeral port, read back from ``.port``."""

    def __init__(self, port: int, metrics_cb: Callable[[], str],
                 health_cb: Optional[Callable[[], Dict[str, Any]]] = None,
                 host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path == "/metrics":
                        body = server.metrics_cb().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif path == "/healthz":
                        body = json.dumps(server.health_cb()
                                          if server.health_cb
                                          else {"ok": True}).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:      # noqa: BLE001 — a scrape must
                    self.send_error(500, repr(e)[:120])   # not crash the
                    return                                # server
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.metrics_cb = metrics_cb
        self.health_cb = health_cb
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="amgcl-metrics")
        self._thread.start()

    @property
    def url(self) -> str:
        return "http://%s:%d/metrics" % (self.host, self.port)

    def close(self, timeout: float = 5.0) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout)
