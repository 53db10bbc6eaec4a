"""The resident solve loop: a bounded request queue, one worker thread,
stacked solves by bucket, and one CUDA graph a bucket (counterpart of
``amgcl_tpu/serve/service.py``).

:class:`SolverService` serves one ``make_solver`` bundle:

* **buckets** — requests accumulate up to the batch size B or the flush
  deadline (``flush_ms``), whichever comes first; a partial batch is
  padded with zero columns (which converge at once) up to the smallest
  power of two ≥ its size, capped at B, so a shape has O(log B) buckets.
* **the resident program** — each (n, B, dtype) bucket's per-column
  preconditioner apply is captured once as a CUDA graph and replayed at
  every preconditioner call of the stacked Krylov loop
  (:class:`~amgcl_tpu_torch.serve.batched.StackedPrecond`, shared with
  the bundle's own stacked calls). The JAX package keeps one compiled
  program per bucket with a donated iterate buffer; the graph's static
  input and output buffers take that buffer's place. The Krylov step
  itself runs eagerly, with one host sync an iteration for the bucket.
* **per-request spans** — ``queue_ms``, ``pad_ms``, ``compile_ms`` (the
  capture of a cold bucket), ``solve_ms`` and ``sync_ms``, which sum to
  ``latency_ms``, in each request's ``SolveReport.serve``; the batch's
  shared phases and each request's queue wait in a
  :class:`~amgcl_tpu_torch.telemetry.tracing.RequestSpans` track.
* **live metrics** — a :class:`~amgcl_tpu_torch.telemetry.live.
  LiveRegistry`, scrapeable at ``/metrics`` and ``/healthz`` when the
  service is given ``metrics_port`` (0: an ephemeral port on
  127.0.0.1).
* **SLO watchdog** — rolling-window p99 latency, timeout rate and
  unhealthy rate against their thresholds after every batch; a trip
  emits an ``slo`` event with the serving findings.
* **padding-waste ledger** — the zero columns' work, booked through
  ``telemetry.ledger.krylov_iteration_model(effective_batch=...)``.
* **supervisor** — an unexpected exception in the worker fails every
  in-flight and queued future with
  :class:`~amgcl_tpu_torch.faults.WorkerDiedError` and restarts the
  worker (at most ``worker_restart_max`` times); with ``retry_max`` > 0
  a failed batch is bisected to isolate a poison request and the
  survivors are retried with exponential backoff and seeded jitter.

The JAX package's environment knobs are keywords here, with its
defaults: ``batch`` (``AMGCL_TPU_SERVE_BATCH``, 8, or the bundle's
``batch``), ``queue_max`` (1024), ``flush_ms`` (50), ``timeout_s`` (30),
``metrics_port`` (off), ``slo_p99_ms`` (0, off), ``slo_timeout_rate``
(0.01), ``slo_unhealthy_rate`` (0.05), ``slo_window`` (256),
``retry_max`` (0), ``retry_backoff_ms`` (50), ``retry_jitter`` (0.1) and
``worker_restart_max`` (2). The fault-injection seams, the memory watch
and the flight recorder of the JAX service are ROADMAP A.13, and
``release_device``/``readmit`` (the farm's eviction) A.11b.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from amgcl_tpu_torch import faults as _faults
from amgcl_tpu_torch.serve.batched import decode_batched_health
from amgcl_tpu_torch.telemetry import health as _health
from amgcl_tpu_torch.telemetry import ledger as _ledger
from amgcl_tpu_torch.telemetry import metrics as _metrics
from amgcl_tpu_torch.telemetry import sink as _sink
from amgcl_tpu_torch.telemetry.live import LiveRegistry, MetricsServer
from amgcl_tpu_torch.telemetry.report import SolveReport
from amgcl_tpu_torch.telemetry.tracing import RequestSpans


class _Request:
    __slots__ = ("rhs", "x0", "future", "t_submit", "timeout_s", "rid",
                 "attempts", "started")

    def __init__(self, rhs, timeout_s, x0=None, rid=0):
        self.rhs = rhs
        self.x0 = x0
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.timeout_s = timeout_s
        self.rid = rid
        #: failed dispatch attempts so far (the retry ladder)
        self.attempts = 0
        #: set_running_or_notify_cancel() may be called once only
        self.started = False


_SENTINEL = object()


class SolverService:
    """Solve-as-a-service over one :class:`~amgcl_tpu_torch.models.
    make_solver.make_solver` bundle (built with ``refine=0``)::

        svc = SolverService(make_solver(A, ...), batch=8)
        fut = svc.submit(rhs)              # a concurrent.futures.Future
        x, report = fut.result()           # x: a tensor on the device
        svc.close()                        # or use it as a context manager

    :meth:`solve_batch` is the synchronous stacked entry (no queue, no
    thread): one stacked solve, per-column reports."""

    def __init__(self, solver, batch: Optional[int] = None,
                 queue_max: int = 1024, flush_ms: float = 50.0,
                 timeout_s: float = 30.0,
                 metrics_port: Optional[int] = None,
                 slo_p99_ms: float = 0.0, slo_timeout_rate: float = 0.01,
                 slo_unhealthy_rate: float = 0.05, slo_window: int = 256,
                 retry_max: int = 0, retry_backoff_ms: float = 50.0,
                 retry_jitter: float = 0.1, worker_restart_max: int = 2):
        if not hasattr(solver, "solve_stacked"):
            raise TypeError("SolverService needs a make_solver bundle "
                            "(got %r)" % type(solver).__name__)
        if getattr(solver, "refine", 0):
            raise ValueError(
                "stacked solves do not support iterative refinement; "
                "build the service bundle with refine=0")
        self.solver = solver
        self.batch = int(batch or getattr(solver, "batch", None) or 8)
        self.flush_s = float(flush_ms) / 1e3
        self.timeout_s = float(timeout_s)
        self.queue: "queue.Queue" = queue.Queue(maxsize=int(queue_max))
        self._lat: List[float] = []
        self._n_requests = 0
        self._n_batches = 0
        self._n_padded = 0
        self._n_timeouts = 0
        self._n_unhealthy = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._rid = itertools.count(1)
        self.live = LiveRegistry()
        self.spans = RequestSpans()
        # a negative port means off; 0 binds an ephemeral port
        self.metrics_port = None if (metrics_port is not None
                                     and metrics_port < 0) else metrics_port
        self.metrics_server: Optional[MetricsServer] = None
        self.slo = {"p99_ms": float(slo_p99_ms),
                    "timeout_rate": float(slo_timeout_rate),
                    "unhealthy_rate": float(slo_unhealthy_rate)}
        self.slo_window = int(slo_window)
        #: the rolling window the watchdog evaluates, one dict a request
        self._win: deque = deque(maxlen=max(self.slo_window, 8))
        self._slo_trips = 0
        self._slo_active: set = set()
        self._last_slo: Optional[Dict[str, Any]] = None
        self._waste = {"flops": 0, "bytes": 0, "padded_col_iters": 0}
        self._bucket_models: Dict[int, Dict[str, Any]] = {}
        self.retry_max = max(int(retry_max), 0)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.retry_jitter = float(retry_jitter)
        self._restart_max = int(worker_restart_max)
        self._n_retries = 0
        self._n_recovered = 0
        self._n_worker_deaths = 0
        self._worker_restarts = 0
        #: requests popped off the queue but not yet resolved: what the
        #: supervisor fails if the worker dies mid-batch
        self._inflight_reqs: List[_Request] = []

    # -- sizing ---------------------------------------------------------------

    @property
    def n(self) -> int:
        return self.solver.n

    @property
    def lowering(self) -> str:
        """The stacked lowering of this service's buckets
        (``serve/batched.py``: per-column-graph on the card)."""
        return self.solver.stacked_precond().lowering

    def _bucket(self, k: int) -> int:
        """Smallest power-of-two bucket >= k, capped at the batch size."""
        b = 1
        while b < k and b < self.batch:
            b <<= 1
        return min(b, self.batch)

    # -- synchronous stacked entry -------------------------------------------

    def solve_batch(self, rhs, x0=None):
        """One stacked solve of an (n, B) ``rhs`` (a 1-D rhs is B = 1)
        through the buckets' graphs. Returns ``(x, report)``, x (n, B) on
        the device, ``report.extra['per_rhs']`` the per-column iterations
        and residuals, ``report.solves_per_sec`` the batch rate."""
        rhs = torch.as_tensor(rhs)
        if rhs.dim() == 1:
            rhs = rhs[:, None]
        rhs = self.solver._block(rhs, "rhs")
        if x0 is None:
            x0 = torch.zeros_like(rhs)
        else:
            x0 = torch.as_tensor(x0)
            x0 = self.solver._block(x0[:, None] if x0.dim() == 1 else x0,
                                    "x0", rhs.shape[1])
        x, iters, resid, hstate, timing = self._dispatch(rhs, x0)
        return x, self._batch_report(iters, resid, hstate, timing["wall_s"])

    def release_device(self):
        raise NotImplementedError(
            "release_device (the farm's eviction) is not ported yet "
            "(ROADMAP A.11b)")

    def readmit(self):
        raise NotImplementedError(
            "readmit (the farm's readmission) is not ported yet "
            "(ROADMAP A.11b)")

    def _dispatch(self, rhs, x0):
        """One stacked solve of device blocks; returns ``(x, iters,
        resid, health, timing)``, ``timing`` the span boundaries: ``t0``
        (dispatch start), ``t_solved`` (the device finished),
        ``t_fetched`` (stats on the host) and ``compile_s`` (the bucket
        captures inside this dispatch, > 0 exactly on a cold bucket)."""
        try:
            x, iters, resid, hs, _, tm = self.solver.solve_stacked(rhs, x0)
        except Exception as e:
            if not _faults.is_resource_exhausted(e):
                raise
            raise _faults.AllocationError(
                "device allocation failed in the serve dispatch: the "
                "hierarchy holds %s bytes — shrink the batch bucket (%s)"
                % (getattr(self.solver.precond.hierarchy, "bytes",
                           lambda: "?")(), str(e)[:200])) from e
        t0, t_solved = tm["t0"], tm["t_solved"]
        iters = np.asarray(iters)
        resid = np.asarray(resid)
        t_fetched = time.perf_counter()
        timing = {"t0": t0, "t_solved": t_solved, "t_fetched": t_fetched,
                  "compile_s": min(max(tm["capture_s"], 0.0),
                                   max(t_solved - t0, 0.0)),
                  "wall_s": t_fetched - t0}
        return x, iters, resid, hs, timing

    def _batch_report(self, iters, resid, hstate, wall):
        B = len(iters)
        health = None if hstate is None else decode_batched_health(
            hstate.flags, hstate.first_it)
        return SolveReport(
            int(np.max(iters)), float(np.max(resid)), wall_time_s=wall,
            solver=type(self.solver.solver).__name__, health=health,
            solves_per_sec=round(B / wall, 3) if wall > 0 else None,
            extra={"batch": B, "lowering": self.lowering,
                   "per_rhs": {"iters": [int(v) for v in iters],
                               "resid": [float(v) for v in resid]}})

    # -- async queue ----------------------------------------------------------

    def start(self) -> "SolverService":
        if not self._closed and self._thread is not None and (
                self.metrics_port is None
                or self.metrics_server is not None):
            return self
        with self._lock:
            if self._closed:
                raise RuntimeError("SolverService is closed")
            if self.metrics_server is None and self.metrics_port is not None:
                # bound before the worker starts: a bind failure raises
                # out of the first start() with nothing leaked
                self.live.set_gauge("serve_queue_depth", self.queue.qsize())
                self.live.set_gauge("serve_inflight", 0)
                self.metrics_server = MetricsServer(
                    self.metrics_port, self.live.prometheus,
                    self._health_json)
            if self._thread is None:
                self._stop = False
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True,
                                                name="amgcl-serve")
                self._thread.start()
        return self

    @property
    def metrics_url(self) -> Optional[str]:
        return self.metrics_server.url if self.metrics_server else None

    def _health_json(self) -> Dict[str, Any]:
        """/healthz payload: liveness and the lifetime counters."""
        alive = self._thread is not None and self._thread.is_alive()
        with self._lock:
            return {"ok": bool(alive or (self._thread is None
                                         and not self._stop)),
                    "requests": self._n_requests,
                    "batches": self._n_batches,
                    "timeouts": self._n_timeouts,
                    "unhealthy": self._n_unhealthy,
                    "queue_depth": self.queue.qsize(),
                    "slo_trips": self._slo_trips}

    def submit(self, rhs, timeout_s: Optional[float] = None,
               x0=None, block: bool = False) -> Future:
        """Enqueue one rhs (and optionally its initial guess ``x0``);
        returns a Future resolving to ``(x, report)``. A full queue
        raises ``queue.Full`` at once (backpressure), or with
        ``block=True`` waits for room up to the request timeout."""
        rhs = torch.as_tensor(rhs)
        if tuple(rhs.shape) != (self.n,):
            raise ValueError("rhs has shape %s but the system has %d "
                             "unknowns" % (tuple(rhs.shape), self.n))
        if x0 is not None:
            x0 = torch.as_tensor(x0)
            if tuple(x0.shape) != (self.n,):
                raise ValueError("x0 has shape %s but the system has %d "
                                 "unknowns" % (tuple(x0.shape), self.n))
        self.start()
        timeout = timeout_s if timeout_s is not None else self.timeout_s
        req = _Request(rhs, timeout, x0=x0, rid=next(self._rid))
        self.queue.put(req, block=block, timeout=timeout if block else None)
        with self._lock:
            gone = self._thread is None
        if self._closed:
            # raced close(): once the worker is gone nothing drains the
            # queue, so fail what is stranded on it (this request too)
            if gone:
                self._fail_stragglers()
            if req.future.done() and req.future.exception() is not None:
                raise RuntimeError("SolverService is closed")
        elif gone:
            # raced a worker death the supervisor did not restart
            try:
                self.start()
            except RuntimeError:
                self._fail_stragglers()
        self.live.set_gauge("serve_queue_depth", self.queue.qsize())
        return req.future

    def _loop(self):
        """The worker: the dispatch loop under a supervisor."""
        try:
            self._loop_inner()
        except Exception as e:           # noqa: BLE001 — supervisor
            self._worker_died(e)

    def _loop_inner(self):
        while True:
            try:
                first = self.queue.get(timeout=0.1)
            except queue.Empty:
                if self._stop:
                    return
                continue
            if first is _SENTINEL:
                return
            self._inflight_reqs = [first]
            batch = [first]
            deadline = time.monotonic() + self.flush_s
            while len(batch) < self.batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    got = self.queue.get(timeout=left)
                except queue.Empty:
                    break
                if got is _SENTINEL:
                    with self._lock:
                        self._stop = True
                    break
                batch.append(got)
                self._inflight_reqs = batch
            try:
                self._run_batch(batch)
            except Exception as e:       # noqa: BLE001 — a failed batch
                self._handle_batch_failure(batch, e)   # fails its requests
            # cleared on the normal path only: if the failure handler
            # raised, the supervisor must still see (and fail) the batch
            self._inflight_reqs = []
            if self._stop and self.queue.empty():
                return

    def _handle_batch_failure(self, batch, e):
        """A batch dispatch raised. With retries off (the default) fail
        its futures; with ``retry_max`` > 0 bisect a multi-request batch
        (each half dispatched on its own, isolating a poison request in
        O(log B) dispatches) and re-queue a single request with backoff
        until its attempts run out."""
        if self.retry_max <= 0 or not batch:
            self._fail_batch(batch, e)
            return
        if len(batch) > 1:
            mid = len(batch) // 2
            for half in (batch[:mid], batch[mid:]):
                try:
                    self._run_batch(half)
                except Exception as e2:          # noqa: BLE001
                    self._handle_batch_failure(half, e2)
            return
        req = batch[0]
        req.attempts += 1
        if req.attempts <= self.retry_max and not req.future.done() \
                and not self._closed:
            delay = _faults.backoff_s(req.attempts, key=req.rid,
                                      base_ms=self.retry_backoff_ms,
                                      jitter=self.retry_jitter)
            self.live.inc("recovery_retries_total")
            with self._lock:
                self._n_retries += 1
            if _sink.sink_attached():
                _sink.emit(event="serve_retry", request_id=req.rid,
                           attempt=req.attempts, backoff_s=round(delay, 4),
                           error=repr(e)[:200])
            timer = threading.Timer(delay, self._requeue, args=(req,))
            timer.daemon = True
            timer.start()
            return
        self._fail_batch(batch, e)

    def _requeue(self, req):
        """Backoff-timer callback: put the retried request back (starting
        a worker first); any failure to re-enter fails its future."""
        try:
            if self._closed:
                raise RuntimeError("SolverService closed before the retry "
                                   "of request %d" % req.rid)
            self.start()
            self.queue.put(req, block=False)
        except Exception as e:               # noqa: BLE001
            if not req.future.done():
                req.future.set_exception(e)

    def _fail_batch(self, batch, e):
        """Terminal batch failure: book it (unhealthy counts, the SLO
        window), then fail the futures, so a caller who saw its future
        fail reads stats that include it."""
        pending = [req for req in batch if not req.future.done()]
        if not pending:
            traceback.print_exc()
            return
        self.live.set_gauge("serve_inflight", 0)
        self.live.set_gauge("serve_queue_depth", self.queue.qsize())
        self.live.inc("serve_unhealthy_total", len(pending))
        with self._lock:
            self._n_unhealthy += len(pending)
            self._win.extend({"timeout": False, "unhealthy": True,
                              "error": True} for _ in pending)
        for req in pending:
            if not req.future.done():
                req.future.set_exception(e)
        self._check_slo()

    def _worker_died(self, exc):
        """Supervisor tail, on the dying worker: fail every in-flight and
        queued future with WorkerDiedError, publish the death and restart
        a worker unless the service is closed or the restart budget is
        spent."""
        if isinstance(exc, _faults.WorkerDiedError):
            err = exc
        else:
            err = _faults.WorkerDiedError("serve dispatch worker died: %r"
                                          % (exc,))
            err.__cause__ = exc
        # _thread is cleared before the drain: a submit racing past
        # start() lands before the drain (failed here) or after it, and
        # then sees no worker and revives one
        with self._lock:
            self._n_worker_deaths += 1
            self._thread = None
            closed = self._closed
            restarts = self._worker_restarts
        inflight, self._inflight_reqs = self._inflight_reqs, []
        for req in inflight:
            if not req.future.done():
                req.future.set_exception(err)
        while True:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                break
            if item is not _SENTINEL and not item.future.done():
                item.future.set_exception(err)
        self.live.inc("serve_worker_deaths_total")
        self.live.set_gauge("serve_inflight", 0)
        self.live.set_gauge("serve_queue_depth", self.queue.qsize())
        if not isinstance(exc, _faults.WorkerDiedError):
            traceback.print_exception(type(exc), exc, exc.__traceback__)
        if _sink.sink_attached():
            _sink.emit(event="serve_worker_death", error=repr(exc)[:200],
                       failed=len(inflight), restarts=restarts)
        if not closed and restarts < self._restart_max:
            with self._lock:
                self._worker_restarts += 1
            self.live.inc("serve_worker_restarts_total")
            try:
                self.start()
            except Exception:                    # noqa: BLE001
                traceback.print_exc()

    def _fail_timeouts(self, timed_out, t_start):
        """Queue-expired requests: book them, then fail their futures."""
        self.live.inc("serve_timeouts_total", len(timed_out))
        with self._lock:
            self._n_timeouts += len(timed_out)
            self._win.extend({"timeout": True, "unhealthy": False}
                             for _ in timed_out)
        for req in timed_out:
            if not req.future.done():
                req.future.set_exception(TimeoutError(
                    "request waited %.2fs in the serve queue (timeout "
                    "%.2fs)" % (t_start - req.t_submit, req.timeout_s)))

    def _run_batch(self, batch):
        t_start = time.perf_counter()
        live = []
        timed_out: List[_Request] = []
        for req in batch:
            if t_start - req.t_submit > req.timeout_s:
                timed_out.append(req)
            elif req.started or req.future.set_running_or_notify_cancel():
                req.started = True
                live.append(req)
        if timed_out:
            self._fail_timeouts(timed_out, t_start)
        self.live.set_gauge("serve_queue_depth", self.queue.qsize())
        if not live:
            if timed_out:
                self._check_slo()
            return
        self.live.set_gauge("serve_inflight", len(live))
        bucket = self._bucket(len(live))
        fill = len(live) / bucket
        pad = bucket - len(live)
        dev, dtype = self.solver.device, self.solver.solver_dtype
        # zero columns converge at once (a zero rhs is short-circuited by
        # every solver): cheap fill that keeps the buckets to O(log B)
        zero = torch.zeros(self.n, dtype=dtype, device=dev)
        rhs = torch.stack([r.rhs.to(device=dev, dtype=dtype) for r in live]
                          + [zero] * pad).T
        x0 = torch.stack([zero if r.x0 is None
                          else r.x0.to(device=dev, dtype=dtype)
                          for r in live] + [zero] * pad).T
        x, iters, resid, hstate, timing = self._dispatch(rhs, x0)
        per_health = None
        if hstate is not None:
            flags, first = hstate.flags, hstate.first_it
            per_health = [_health.decode(int(flags[b]), first[b])
                          for b in range(len(live))]
        t_done = time.perf_counter()
        wall = timing["wall_s"]
        pad_ms = (timing["t0"] - t_start) * 1e3
        compile_ms = timing["compile_s"] * 1e3
        solve_ms = max((timing["t_solved"] - timing["t0"]) * 1e3
                       - compile_ms, 0.0)
        sync_ms = (t_done - timing["t_solved"]) * 1e3
        lowering = self.lowering
        lats: List[float] = []
        win_rows: List[Dict[str, Any]] = []
        req_events: List[Dict[str, Any]] = []
        resolved = []          # futures resolve last, after the stats
        n_unhealthy = 0
        for i, req in enumerate(live):
            lat = t_done - req.t_submit
            lats.append(lat)
            queue_ms = (t_start - req.t_submit) * 1e3
            serve = {"request_id": req.rid,
                     "queue_ms": round(queue_ms, 3),
                     "pad_ms": round(pad_ms, 3),
                     "compile_ms": round(compile_ms, 3),
                     "solve_ms": round(solve_ms, 3),
                     "sync_ms": round(sync_ms, 3),
                     "bucket_B": bucket,
                     "batch_fill": round(fill, 4),
                     "latency_ms": round(lat * 1e3, 3),
                     "lowering": lowering}
            healthy = per_health[i]["ok"] if per_health else True
            if not healthy:
                n_unhealthy += 1
                for flag in per_health[i]["flags"]:
                    self.live.inc("serve_health_flags_total", flag=flag)
            rep = SolveReport(
                int(iters[i]), float(resid[i]), wall_time_s=wall,
                solver=type(self.solver.solver).__name__,
                health=per_health[i] if per_health else None, serve=serve,
                extra={"batch": bucket, "batch_index": i,
                       "latency_s": round(lat, 6)})
            resolved.append((req, x[:, i], rep))
            self.spans.add(req.rid, [("queue", req.t_submit, t_start)])
            self.live.observe("serve_latency_ms", lat * 1e3)
            self.live.observe("serve_queue_ms", queue_ms)
            win_rows.append({"lat_ms": lat * 1e3, "queue_ms": queue_ms,
                             "pad_ms": pad_ms, "compile_ms": compile_ms,
                             "solve_ms": solve_ms, "sync_ms": sync_ms,
                             "fill": fill, "timeout": False,
                             "unhealthy": not healthy})
            if _sink.sink_attached():
                req_events.append(dict(event="serve_request",
                                       iters=int(iters[i]),
                                       resid=float(resid[i]),
                                       healthy=healthy, **serve))
        # the phases the batch shares, once a batch
        phases = [("pad", t_start, timing["t0"])]
        if timing["compile_s"] > 0:
            phases.append(("compile", timing["t0"],
                           timing["t0"] + timing["compile_s"]))
        phases += [("solve", timing["t0"] + timing["compile_s"],
                    timing["t_solved"]), ("sync", timing["t_solved"], t_done)]
        self.spans.add(self._n_batches + 1, phases, label="batch")
        self.live.inc("serve_requests_total", len(live))
        self.live.inc("serve_batches_total")
        if pad:
            self.live.inc("serve_padded_slots_total", pad)
        if n_unhealthy:
            self.live.inc("serve_unhealthy_total", n_unhealthy)
        self.live.inc("serve_bucket_solves_total", len(live),
                      bucket=str(bucket))
        self.live.observe("serve_batch_fill", fill)
        self.live.observe("serve_solve_ms", solve_ms)
        self.live.set_gauge("serve_inflight", 0)
        pre = self.solver.stacked_precond()
        self.live.set_gauge("serve_graph_captures",
                            sum(pre.captures.values()))
        self.live.set_gauge("serve_graph_capture_s", pre.capture_total_s)
        recovered = sum(1 for req in live if req.attempts)
        if recovered:
            self.live.inc("recoveries_total", recovered)
            with self._lock:
                self._n_recovered += recovered
        self._account_padding(bucket, len(live), int(np.max(iters)))
        with self._lock:
            self._lat.extend(lats)
            if len(self._lat) > 4096:
                del self._lat[:len(self._lat) - 4096]
            self._n_requests += len(live)
            self._n_batches += 1
            self._n_padded += pad
            self._n_unhealthy += n_unhealthy
            self._win.extend(win_rows)
            t_now = time.perf_counter()
            if self._t_first is None:
                self._t_first = t_now - wall
            self._t_last = t_now
        summary = self._check_slo()
        for req, xcol, rep in resolved:
            req.future.set_result((xcol, rep))
        for ev in req_events:
            _sink.emit(**ev)
        self._emit_batch(len(live), bucket, fill, wall, iters, resid,
                         summary,
                         {"queue": round(sum(t_start - r.t_submit
                                             for r in live)
                                         * 1e3 / len(live), 3),
                          "pad": round(pad_ms, 3),
                          "compile": round(compile_ms, 3),
                          "solve": round(solve_ms, 3),
                          "sync": round(sync_ms, 3)})

    def _account_padding(self, bucket, n_live, iters_max):
        """Book the zero-padded columns' device work (the iteration
        model's padding waste × the batch's iteration count). Best
        effort: a model failure never fails a batch."""
        if bucket <= n_live:
            return
        try:
            model = self._bucket_models.get(bucket)
            if model is None:
                model = self._bucket_models[bucket] = \
                    _ledger.krylov_iteration_model(
                        type(self.solver.solver).__name__,
                        self.solver.A_dev, batch=bucket, effective_batch=0)
            frac = (bucket - n_live) / bucket
            with self._lock:
                self._waste["flops"] += int(
                    model["padding_waste_flops"] * frac * iters_max)
                self._waste["bytes"] += int(
                    model["padding_waste_bytes"] * frac * iters_max)
                self._waste["padded_col_iters"] += \
                    (bucket - n_live) * iters_max
        except Exception:                       # noqa: BLE001
            pass

    # -- SLO watchdog ---------------------------------------------------------

    def slo_summary(self) -> Dict[str, Any]:
        """The rolling window the watchdog evaluates: latency
        percentiles, timeout and unhealthy rates, mean spans and fill,
        the thresholds, and the trips."""
        with self._lock:
            rows = list(self._win)
        lat = [r["lat_ms"] for r in rows if r.get("lat_ms") is not None]
        n = len(rows)

        def mean(key):
            vals = [r[key] for r in rows if r.get(key) is not None]
            return round(sum(vals) / len(vals), 3) if vals else None

        out: Dict[str, Any] = {
            "window": n,
            "p50_ms": round(_metrics.percentile(lat, 50), 3) if lat
            else None,
            "p99_ms": round(_metrics.percentile(lat, 99), 3) if lat
            else None,
            "timeout_rate": round(sum(1 for r in rows if r.get("timeout"))
                                  / n, 4) if n else 0,
            "unhealthy_rate": round(sum(1 for r in rows
                                        if r.get("unhealthy")) / n, 4)
            if n else 0,
            "batch_fill": mean("fill"),
            "bucket": self.batch,
            "spans_ms": {k: mean(k + "_ms") for k in
                         ("queue", "pad", "compile", "solve", "sync")},
            "slo": dict(self.slo, window=self.slo_window),
        }
        trips = []
        if self.slo["p99_ms"] and out["p99_ms"] is not None \
                and out["p99_ms"] > self.slo["p99_ms"]:
            trips.append("p99")
        if out["timeout_rate"] > self.slo["timeout_rate"]:
            trips.append("timeout_rate")
        if out["unhealthy_rate"] > self.slo["unhealthy_rate"]:
            trips.append("unhealthy_rate")
        out["trips"] = trips
        return out

    def _check_slo(self):
        """Evaluate the window against the thresholds, edge-triggered: a
        trip kind fires once (an ``slo`` event with the serving findings,
        a counter) when it enters the tripped state and re-arms when the
        window clears. Returns the window summary."""
        summary = self.slo_summary()
        if not summary["window"]:
            return summary
        trips = summary["trips"]
        self._last_slo = summary
        new = [t for t in trips if t not in self._slo_active]
        self._slo_active = set(trips)
        if not new:
            return summary
        self.live.inc("serve_slo_trips_total", len(new))
        with self._lock:
            self._slo_trips += len(new)
        if _sink.sink_attached():
            _sink.emit(event="slo", new_trips=new,
                       findings=_health.serve_findings(summary), **summary)
        return summary

    def to_chrome_trace(self, tid: int = 0, tid_name: Optional[str] = None,
                        epoch: Optional[float] = None) -> Dict[str, Any]:
        """The request span track as Chrome/Perfetto trace-event JSON."""
        return self.spans.to_chrome_trace(tid=tid, tid_name=tid_name,
                                          epoch=epoch)

    def _emit_batch(self, n_live, bucket, fill, wall, iters, resid,
                    slo_summary, spans_ms):
        if not _sink.sink_attached():
            return
        _sink.emit(event="serve", requests=n_live, bucket=bucket,
                   batch_fill=round(fill, 4), wall_s=round(wall, 6),
                   solves_per_sec=round(n_live / wall, 3) if wall > 0
                   else None,
                   iters_max=int(np.max(iters)),
                   resid_max=float(np.max(resid)), lowering=self.lowering,
                   spans_ms=spans_ms, totals=self.stats(_summary=slo_summary))

    # -- stats / lifecycle ----------------------------------------------------

    def stats(self, _summary: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
        """Service-lifetime rollup: request and batch counts, solves a
        second over the busy window, latency percentiles, timeouts and
        unhealthy counts, the window's mean spans and fill, the padding
        waste, the SLO state, the buckets' graphs (captures, capture
        seconds and replays by bucket size), the recovery counters and
        the scrape port."""
        with self._lock:
            lat = list(self._lat)
            out: Dict[str, Any] = {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "padded_slots": self._n_padded,
                "batch_bucket": self.batch,
                "timeouts": self._n_timeouts,
                "unhealthy": self._n_unhealthy,
                "slo_trips": self._slo_trips,
            }
            span = (self._t_last - self._t_first) \
                if self._t_first is not None and self._t_last else None
            waste = dict(self._waste)
        if span and span > 0:
            out["solves_per_sec"] = round(out["requests"] / span, 3)
        if lat:
            out["latency_s"] = {
                "p50": round(_metrics.percentile(lat, 50), 6),
                "p99": round(_metrics.percentile(lat, 99), 6),
                "max": round(max(lat), 6)}
        summary = _summary if _summary is not None else self.slo_summary()
        out["lowering"] = self.lowering
        out["spans_ms"] = summary["spans_ms"]
        if summary["batch_fill"] is not None:
            out["batch_fill"] = summary["batch_fill"]
        if any(waste.values()):
            out["padding_waste"] = waste
        if self._last_slo is not None:
            out["slo"] = {"trips": summary.get("trips", []),
                          "p99_ms": summary.get("p99_ms"),
                          "timeout_rate": summary.get("timeout_rate"),
                          "unhealthy_rate": summary.get("unhealthy_rate"),
                          "targets": dict(self.slo, window=self.slo_window)}
        pre = self.solver.stacked_precond()
        out["graphs"] = {"captures": dict(pre.captures),
                         "capture_s": {b: round(s, 6) for b, s in
                                       pre.capture_s.items()},
                         "replays": dict(pre.replays)}
        with self._lock:
            rec = {"retries": self._n_retries,
                   "recovered": self._n_recovered,
                   "worker_deaths": self._n_worker_deaths,
                   "worker_restarts": self._worker_restarts}
        if any(rec.values()):
            out["recovery"] = rec
        if self.metrics_server is not None:
            out["metrics_port"] = self.metrics_server.port
        out["histogram_window"] = self.live.hist_cap
        return out

    def _fail_stragglers(self):
        """Fail every request still on a queue no worker will drain."""
        while True:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                return
            if item is not _SENTINEL and not item.future.done():
                item.future.set_exception(
                    RuntimeError("SolverService is closed"))

    def close(self, timeout: float = 10.0):
        """Drain the queue, stop the worker and the /metrics server, emit
        a final ``serve`` event. Terminal: a later submit() raises. If
        the join exceeds ``timeout`` the worker keeps draining and the
        teardown is left to a later close()."""
        with self._lock:
            self._closed = True
            self._stop = True
            thread = self._thread
        if thread is not None:
            try:
                self.queue.put(_SENTINEL, block=False)
            except queue.Full:
                pass
            thread.join(timeout)
            if thread.is_alive():
                return
        with self._lock:
            self._thread = None
        self._fail_stragglers()
        if _sink.sink_attached():
            _sink.emit(event="serve", final=True, **self.stats())
        with self._lock:
            server, self.metrics_server = self.metrics_server, None
        if server is not None:
            server.close()

    def __enter__(self) -> "SolverService":
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False
