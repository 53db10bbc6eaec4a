"""Storm: a seeded, deterministic open-loop traffic generator for the
serving stack (counterpart of ``amgcl_tpu/serve/storm.py``).

A closed-loop harness submits, waits and submits again, so its arrivals
slow down exactly when the server does, and its p99 forgets every request
it would have sent while blocked (coordinated omission). Storm draws the
arrivals up front from a seeded process (:func:`build_schedule`),
timestamps each request at its scheduled arrival and measures latency
from there, so queueing under overload is charged to the request whether
or not the generator managed to submit on time.

Three arrival phases compose into a schedule:

* :func:`poisson_phase` — homogeneous Poisson arrivals at a fixed rate
  (exponential gaps from a seeded ``random.Random``).
* :func:`burst_phase` — Poisson background plus periodic trains of
  ``burst_len`` arrivals 1 ms apart every ``burst_every_s`` (a flash
  crowd).
* :func:`ramp_phase` — a linearly ramping rate by time rescaling: unit
  exponential partial sums ``S`` inverted through the cumulative
  intensity ``Λ(t) = r0·t + (r1−r0)·t²/(2D)``, so one seed gives the
  same arrivals for any pair of rates.

:func:`run_storm` drives a :class:`~amgcl_tpu_torch.serve.farm.
SolverFarm`, a :class:`~amgcl_tpu_torch.serve.service.SolverService` or
any object with non-blocking submits, classifies outcomes (ok, shed,
timeout, unhealthy, error), copies the serve spans off each report, and
scrapes the target's /metrics into a gauge series meanwhile.
:func:`run_ladder` runs Poisson rungs of rising offered rate on one warm
target, the input of ``telemetry/load.py``'s curve and knee.

Concurrency: a storm run has one lock, ``_StormRun._lock``, over the
sample rows and the gauge series; the futures' done callbacks, the
scraper thread and the generator loop all go through it, so the lock
order is empty. Nothing sleeps or blocks while holding it.
"""

from __future__ import annotations

import math
import queue as _queue
import random
import re
import threading
import time
import urllib.request
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence

from amgcl_tpu_torch.faults import FaultError, LoadShedError
from amgcl_tpu_torch.telemetry import load as _load
from amgcl_tpu_torch.telemetry import sink as _sink

#: the declared lock order: a storm has one lock (``_StormRun._lock``),
#: so there is nothing to rank. The target's own locks are never held
#: across it: submits happen outside it, and done callbacks run after
#: the target has released its locks.
LOCK_ORDER = ()

#: fields read outside the lock on purpose
UNGUARDED_OK = {
    "_stop": ("threading.Event — its set()/is_set() pair is the "
              "scraper thread's stop signal; Events are internally "
              "synchronized"),
    "_thread": ("written once by start() before the scraper thread "
                "exists and read by stop() after set(); never raced"),
    "url": "immutable after construction",
    "every_s": "immutable after construction",
}

_ms = 1e3


# ---------------------------------------------------------------------------
# arrival schedules
# ---------------------------------------------------------------------------

def poisson_phase(rate_rps: float, duration_s: float) -> Dict[str, Any]:
    """Homogeneous Poisson arrivals at ``rate_rps`` for ``duration_s``."""
    return {"kind": "poisson", "rate_rps": float(rate_rps),
            "duration_s": float(duration_s)}


def burst_phase(rate_rps: float, duration_s: float,
                burst_every_s: float = 1.0,
                burst_len: int = 8) -> Dict[str, Any]:
    """Poisson background at ``rate_rps`` plus a deterministic train of
    ``burst_len`` arrivals 1 ms apart every ``burst_every_s``."""
    return {"kind": "burst", "rate_rps": float(rate_rps),
            "duration_s": float(duration_s),
            "burst_every_s": float(burst_every_s),
            "burst_len": int(burst_len)}


def ramp_phase(rate0_rps: float, rate1_rps: float,
               duration_s: float) -> Dict[str, Any]:
    """Rate ramping linearly from ``rate0_rps`` to ``rate1_rps``."""
    return {"kind": "ramp", "rate_rps": float(rate0_rps),
            "rate1_rps": float(rate1_rps),
            "duration_s": float(duration_s)}


def _phase_times(phase: Dict[str, Any], rng: random.Random
                 ) -> List[float]:
    """Arrival instants in ``[0, duration)`` for one phase spec."""
    kind = phase["kind"]
    dur = phase["duration_s"]
    out: List[float] = []
    if kind in ("poisson", "burst"):
        rate = phase["rate_rps"]
        t = 0.0
        while rate > 0:
            t += rng.expovariate(rate)
            if t >= dur:
                break
            out.append(t)
        if kind == "burst":
            every = phase["burst_every_s"]
            k = 1
            while k * every < dur:
                base = k * every
                for j in range(phase["burst_len"]):
                    tj = base + j * 1e-3
                    if tj < dur:
                        out.append(tj)
                k += 1
            out.sort()
    elif kind == "ramp":
        r0, r1 = phase["rate_rps"], phase["rate1_rps"]
        # time-rescaling: S_k = sum of unit exponentials; invert the
        # cumulative intensity L(t) = r0*t + (r1-r0)*t^2/(2D). For a
        # linear ramp that is a quadratic in t with the positive root
        # t = (-r0 + sqrt(r0^2 + 4*a*S)) / (2*a), a = (r1-r0)/(2D).
        a = (r1 - r0) / (2.0 * dur)
        s = 0.0
        while True:
            s += rng.expovariate(1.0)
            if abs(a) < 1e-12:
                t = s / r0 if r0 > 0 else float("inf")
            else:
                disc = r0 * r0 + 4.0 * a * s
                if disc < 0:        # decreasing ramp exhausted: the
                    break           # total intensity L(D) is finite
                t = (-r0 + math.sqrt(disc)) / (2.0 * a)
            if not (t < dur):
                break
            out.append(t)
    else:
        raise ValueError("unknown phase kind %r" % (kind,))
    return out


def _phase_rate_at(phase: Dict[str, Any], t: float) -> float:
    if phase["kind"] == "ramp":
        frac = t / phase["duration_s"] if phase["duration_s"] else 0.0
        return round(phase["rate_rps"] + frac * (
            phase["rate1_rps"] - phase["rate_rps"]), 3)
    return phase["rate_rps"]


def build_schedule(phases: Sequence[Dict[str, Any]],
                   tenants: Sequence[str] = ("t0",),
                   seed: int = 0) -> List[Dict[str, Any]]:
    """The full deterministic arrival schedule: phases back-to-back,
    tenants drawn uniformly from ``tenants`` with the same seeded
    generator, one row per request::

        {"rid", "t_s", "tenant", "phase", "rate_rps"}

    The same ``(phases, tenants, seed)`` give the same schedule, row
    for row."""
    rng = random.Random(seed)
    rows: List[Dict[str, Any]] = []
    offset = 0.0
    for phase in phases:
        for t in _phase_times(phase, rng):
            rows.append({
                "t_s": round(offset + t, 6),
                "tenant": tenants[rng.randrange(len(tenants))],
                "phase": phase["kind"],
                "rate_rps": _phase_rate_at(phase, t),
            })
        offset += phase["duration_s"]
    rows.sort(key=lambda r: r["t_s"])
    for i, r in enumerate(rows):
        r["rid"] = i
    return rows


def schedule_duration_s(phases: Sequence[Dict[str, Any]]) -> float:
    return sum(p["duration_s"] for p in phases)


# ---------------------------------------------------------------------------
# /metrics scraping (concurrent gauge time-series)
# ---------------------------------------------------------------------------

_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{[^}]*\})?\s+([0-9eE.+-]+)\s*$")

#: exposition-name suffix -> gauge-series column; label variants
#: (per-tenant queue depths) SUM into one column
_SCRAPE_COLS = (
    ("queue_depth", "queue_depth"),
    ("_inflight", "inflight"),
    ("requests_total", "requests_total"),
)


def parse_prometheus_gauges(text: str) -> Dict[str, float]:
    """The storm-relevant columns out of one Prometheus exposition:
    queue depth (summed across tenants), inflight, lifetime request
    count. Tolerant of anything else in the page."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if not m:
            continue
        name, val = m.group(1), m.group(2)
        for suffix, col in _SCRAPE_COLS:
            if name.endswith(suffix):
                try:
                    out[col] = out.get(col, 0.0) + float(val)
                except ValueError:
                    pass
                break
    return out


class _Scraper:
    """Polls ``url`` every ``every_s`` on its own thread, appending
    ``{"t_s", <gauge columns>}`` rows (storm-epoch seconds) under the
    storm lock."""

    def __init__(self, url: str, every_s: float, t0: float,
                 lock: threading.Lock, rows: List[Dict[str, Any]]):
        self.url = url
        self.every_s = every_s
        self._t0 = t0
        self._lock = lock
        self._rows = rows
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: failed scrapes (guarded by the storm lock) — best-effort,
        #: but counted: a gauge series with gaps says so
        self.errors = 0
        self.last_error: Optional[str] = None

    def start(self) -> "_Scraper":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="amgcl-storm-scrape")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                with urllib.request.urlopen(self.url, timeout=2.0) as r:
                    text = r.read().decode("utf-8", "replace")
                row = dict(parse_prometheus_gauges(text),
                           t_s=round(time.perf_counter() - self._t0, 4))
            except Exception as exc:  # noqa: BLE001 — a failed scrape
                with self._lock:      # never fails the storm, but it
                    self.errors += 1  # is COUNTED: a gauge series with
                    #                   gaps says so in the record
                    self.last_error = repr(exc)[:120]
            else:
                with self._lock:
                    self._rows.append(row)
            self._stop.wait(self.every_s)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# the open-loop run
# ---------------------------------------------------------------------------

@contextmanager
def armed_fault_plan(plan: Optional[str]):
    """A fault plan armed for the duration of a storm. The fault
    injection seams are not ported yet (ROADMAP A.13): only ``None`` (no
    plan) is accepted."""
    if plan:
        raise NotImplementedError(
            "fault plans need the fault-injection seams, which are not "
            "ported yet (ROADMAP A.13)")
    yield


def _classify_exc(exc: BaseException) -> str:
    if isinstance(exc, (_queue.Full, LoadShedError)):
        return "shed"
    if isinstance(exc, TimeoutError) \
            or "Timeout" in type(exc).__name__:
        return "timeout"
    if isinstance(exc, FaultError):
        return "error"
    return "error"


class _StormRun:
    """One storm execution: the generator loop, the done-callback fan-
    in, and the scraper all share ``self._lock`` (the module's single
    lock) over ``samples`` and ``gauges``."""

    def __init__(self, target, schedule: List[Dict[str, Any]],
                 rhs_for: Callable[[str, int], Any],
                 drain_timeout_s: float = 30.0,
                 scrape_every_s: float = 0.25,
                 label: str = "storm"):
        self.target = target
        self.schedule = schedule
        self.rhs_for = rhs_for
        self.drain_timeout_s = drain_timeout_s
        self.scrape_every_s = scrape_every_s
        self.label = label
        self._lock = threading.Lock()
        self.samples: List[Dict[str, Any]] = []
        self.gauges: List[Dict[str, Any]] = []

    # -- submit adapter ------------------------------------------------
    def _submit(self, tenant: str, rhs):
        t = self.target
        if hasattr(t, "tenants"):               # SolverFarm
            return t.submit(tenant, rhs, block=False)
        if hasattr(t, "solver"):                # SolverService
            return t.submit(rhs, block=False)
        return t.submit(tenant, rhs)            # duck-typed stub

    def _live(self):
        return getattr(self.target, "live", None)

    # -- completion fan-in --------------------------------------------
    def _on_done(self, fut, sample: Dict[str, Any], t0: float):
        t_done = time.perf_counter() - t0
        outcome = "ok"
        lat_ms = round((t_done - sample["t_sched_s"]) * _ms, 3)
        spans: Optional[Dict[str, Any]] = None
        try:
            _x, rep = fut.result()
        except Exception as exc:          # noqa: BLE001 — classified
            outcome = _classify_exc(exc)
        else:
            health = getattr(rep, "health", None)
            if isinstance(health, dict) and not health.get("ok", True):
                outcome = "unhealthy"
            serve = getattr(rep, "serve", None)
            if isinstance(serve, dict):
                spans = {k: serve.get("%s_ms" % k)
                         for k in _load.SPAN_KEYS}
        with self._lock:
            sample["outcome"] = outcome
            sample["t_done_s"] = round(t_done, 6)
            sample["latency_ms"] = lat_ms
            if spans is not None:
                sample["spans_ms"] = spans

    # -- the open-loop generator loop ---------------------------------
    def run(self) -> Dict[str, Any]:
        live = self._live()
        t0 = time.perf_counter()
        scraper = None
        url = getattr(self.target, "metrics_url", None)
        if url and self.scrape_every_s > 0:
            scraper = _Scraper(url, self.scrape_every_s, t0,
                               self._lock, self.gauges).start()
        n_shed = 0
        try:
            for arr in self.schedule:
                delay = arr["t_s"] - (time.perf_counter() - t0)
                if delay > 0:
                    time.sleep(delay)
                t_submit = time.perf_counter() - t0
                sample = {
                    "rid": arr["rid"], "tenant": arr["tenant"],
                    "phase": arr["phase"],
                    "rate_rps": arr["rate_rps"],
                    "t_sched_s": arr["t_s"],
                    "t_submit_s": round(t_submit, 6),
                    "lag_ms": round((t_submit - arr["t_s"]) * _ms, 3),
                    "outcome": None,
                }
                with self._lock:
                    self.samples.append(sample)
                if live is not None:
                    live.inc("storm_submitted_total")
                    live.observe("storm_sched_lag_ms",
                                 sample["lag_ms"])
                try:
                    rhs = self.rhs_for(arr["tenant"], arr["rid"])
                    fut = self._submit(arr["tenant"], rhs)
                except Exception as exc:    # noqa: BLE001 — classified
                    outcome = _classify_exc(exc)
                    now = time.perf_counter() - t0
                    with self._lock:
                        sample["outcome"] = outcome
                        sample["t_done_s"] = round(now, 6)
                        # a shed IS an answer (an immediate typed
                        # reject) — its latency is the reject latency,
                        # still measured from the scheduled arrival
                        sample["latency_ms"] = round(
                            (now - sample["t_sched_s"]) * _ms, 3)
                    if outcome == "shed":
                        n_shed += 1
                        if live is not None:
                            live.inc("storm_shed_total")
                else:
                    fut.add_done_callback(
                        lambda f, s=sample: self._on_done(f, s, t0))
            # drain: wait (bounded) for in-flight completions
            deadline = time.perf_counter() + self.drain_timeout_s
            while time.perf_counter() < deadline:
                with self._lock:
                    pending = any(s["outcome"] is None
                                  for s in self.samples)
                if not pending:
                    break
                time.sleep(0.02)
        finally:
            if scraper is not None:
                scraper.stop()
        with self._lock:
            samples = [dict(s) for s in self.samples]
            gauges = [dict(g) for g in self.gauges]
        dur = self.schedule[-1]["t_s"] if self.schedule else None
        summary = _load.summarize_samples(samples, duration_s=dur)
        return {"label": self.label, "summary": summary,
                "samples": samples, "gauges": gauges}


def run_storm(target, schedule: List[Dict[str, Any]],
              rhs_for: Callable[[str, int], Any],
              drain_timeout_s: float = 30.0,
              scrape_every_s: float = 0.25,
              label: str = "storm",
              fault_plan: Optional[str] = None,
              emit_event: bool = True) -> Dict[str, Any]:
    """Run one open-loop storm of ``schedule`` against ``target``.

    ``target`` is a :class:`SolverFarm` (submits routed per-tenant), a
    :class:`SolverService` (tenant ignored), or any stub exposing
    ``submit(tenant, rhs) -> Future``; submits are NON-blocking — a
    full queue or an active load-shed is recorded as outcome ``shed``,
    never waited out (waiting is exactly the closed-loop bug this
    harness exists to avoid). ``rhs_for(tenant, rid)`` supplies each
    request's right-hand side. ``fault_plan`` must be None (the fault
    plans are ROADMAP A.13). Returns ``{"label", "summary", "samples",
    "gauges"}`` and emits one ``storm`` event when a telemetry sink is
    attached."""
    run = _StormRun(target, schedule, rhs_for,
                    drain_timeout_s=drain_timeout_s,
                    scrape_every_s=scrape_every_s, label=label)
    with armed_fault_plan(fault_plan):
        out = run.run()
    if emit_event and _sink.sink_attached():
        summ = out["summary"]
        _sink.emit(event="storm", label=label,
                       requests=summ.get("requests"),
                       offered_rps=summ.get("offered_rps"),
                       achieved_rps=summ.get("achieved_rps"),
                       goodput_rps=summ.get("goodput_rps"),
                       p99_ms=(summ.get("latency_ms") or {}).get("p99"),
                       shed_rate=summ.get("shed_rate"),
                       timeout_rate=summ.get("timeout_rate"),
                       outcomes=summ.get("outcomes"))
    return out


def run_ladder(target, rates: Sequence[float], duration_s: float,
               rhs_for: Callable[[str, int], Any],
               tenants: Sequence[str] = ("t0",), seed: int = 0,
               drain_timeout_s: float = 30.0,
               scrape_every_s: float = 0.25,
               fault_plan: Optional[str] = None,
               emit_events: bool = True) -> List[Dict[str, Any]]:
    """The offered-load ladder: sequential Poisson rungs of
    ``duration_s`` each at the given rates on the SAME warm target (so
    compile caches persist across rungs and the curve measures load,
    not warmup). Rung ``i`` uses seed ``seed + i`` — deterministic but
    decorrelated. Returns ``load.ladder_curve``-ready rung dicts."""
    live = getattr(target, "live", None)
    rungs: List[Dict[str, Any]] = []
    for i, rate in enumerate(rates):
        sched = build_schedule([poisson_phase(rate, duration_s)],
                               tenants=tenants, seed=seed + i)
        if live is not None:
            live.set_gauge("storm_offered_rps", float(rate))
        res = run_storm(target, sched, rhs_for,
                        drain_timeout_s=drain_timeout_s,
                        scrape_every_s=scrape_every_s,
                        label="rung%d@%.3grps" % (i, rate),
                        fault_plan=fault_plan, emit_event=emit_events)
        rungs.append({"offered_rps": float(rate),
                      "summary": res["summary"],
                      "samples": res["samples"],
                      "gauges": res["gauges"]})
    return rungs
