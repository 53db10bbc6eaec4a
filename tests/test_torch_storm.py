"""The open-loop load generator and the saturation analytics
(``amgcl_tpu_torch/serve/storm.py``, ``telemetry/load.py``) against the
JAX package's ``amgcl_tpu/serve/storm.py`` and ``telemetry/load.py``.

Parity: the arrival schedules of every phase kind for several seeds equal
row for row (both draw from ``random.Random``), every analytics function
equal on the same sample rows, and the Prometheus scrape parser equal on
the same page. The JAX tests' protocol cases (tests/test_storm.py) follow,
ported, on a pure-python queueing stub (one worker, a fixed service time,
a bounded queue), and one storm drives the port's farm on the CPU. The
JAX file's gate, history and fault-plan cases have no counterpart yet
(the port's benchmark, ROADMAP A.13).
"""

import concurrent.futures as _cf
import contextlib
import json
import queue
import threading
import time
import types

import numpy as np
import pytest
import torch

from amgcl_tpu_torch import faults
from amgcl_tpu_torch.serve import storm as S
from amgcl_tpu_torch.telemetry import load as L
from amgcl_tpu_torch.telemetry import sink


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS, OpenMP and torch thread while this module runs: its
    small problems gain nothing from threads, and the test suite's
    parallel workers would oversubscribe the cores. The card's machine
    has no threadpoolctl; there torch's own limit is set alone."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1) if threadpool_limits \
                else contextlib.nullcontext():
            yield
    finally:
        torch.set_num_threads(threads)


PHASES = [S.poisson_phase(40.0, 1.0),
          S.burst_phase(5.0, 1.0, burst_every_s=0.25, burst_len=6),
          S.ramp_phase(10.0, 80.0, 1.0)]


def _ref_phase(R, p):
    if p["kind"] == "poisson":
        return R.poisson_phase(p["rate_rps"], p["duration_s"])
    if p["kind"] == "burst":
        return R.burst_phase(p["rate_rps"], p["duration_s"],
                             burst_every_s=p["burst_every_s"],
                             burst_len=p["burst_len"])
    return R.ramp_phase(p["rate_rps"], p["rate1_rps"], p["duration_s"])


# ===========================================================================
# parity with the JAX package
# ===========================================================================

@pytest.mark.parametrize("seed", [0, 7, 19, 2026])
def test_schedules_match_jax(seed):
    """Every phase kind alone and composed (a decreasing ramp included),
    for one and two tenants: the same arrivals, tenants, rates and rids
    as the JAX package's schedule, and the same phase specs."""
    from amgcl_tpu.serve import storm as R
    mixes = [[p] for p in PHASES] + [PHASES,
                                     [S.ramp_phase(100.0, 10.0, 2.0)],
                                     [S.poisson_phase(0.0, 1.0)]]
    for phases in mixes:
        ref_phases = [_ref_phase(R, p) for p in phases]
        assert ref_phases == phases
        for tenants in (("t0",), ("t-main", "t-u1")):
            mine = S.build_schedule(phases, tenants=tenants, seed=seed)
            assert mine == R.build_schedule(ref_phases, tenants=tenants,
                                            seed=seed)
        assert S.schedule_duration_s(phases) == \
            R.schedule_duration_s(ref_phases)


def _sample(rid, t, outcome, lat=None, tenant="t0", phase="poisson",
            spans=None):
    s = {"rid": rid, "tenant": tenant, "phase": phase, "rate_rps": 10.0,
         "t_sched_s": t, "t_submit_s": t, "lag_ms": 0.1, "outcome": outcome}
    if lat is not None:
        s["latency_ms"] = lat
        s["t_done_s"] = t + lat / 1e3
    if spans is not None:
        s["spans_ms"] = spans
    return s


def _random_rungs(seed):
    """Seeded sample rows of three rungs: every outcome, spans, lags,
    gauges, one pending row."""
    rng = np.random.default_rng(seed)
    outcomes = ["ok"] * 6 + ["shed", "timeout", "unhealthy", "error"]
    rungs = []
    for i, rate in enumerate((40.0, 10.0, 80.0)):
        n = int(rng.integers(8, 30))
        samples = []
        for k in range(n):
            t = float(np.round(rng.uniform(0, n / rate), 6))
            out = str(rng.choice(outcomes))
            spans = {key: float(np.round(rng.uniform(0, 5), 3))
                     for key in L.SPAN_KEYS}
            s = _sample(k, t, out, lat=float(np.round(rng.uniform(
                1, 50 * (i + 1)), 3)), tenant="t%d" % (k % 2),
                spans=spans if out == "ok" else None)
            s["lag_ms"] = float(np.round(rng.uniform(0, 3), 3))
            samples.append(s)
        samples.append(_sample(n, 0.5, None))
        gauges = [{"t_s": 0.1 * j, "queue_depth": float(rng.integers(0, 9)),
                   "inflight": float(rng.integers(0, 4))}
                  for j in range(4)]
        rungs.append({"offered_rps": rate, "samples": samples,
                      "gauges": gauges,
                      "summary": L.summarize_samples(samples,
                                                     duration_s=n / rate)})
    return rungs


@pytest.mark.parametrize("seed", [1, 5, 23])
def test_load_analytics_match_jax(seed):
    """summarize_samples, ladder_curve, detect_knee (each criterion),
    phase_attribution, gauge_rollup, storm_timeline_trace and
    build_record give the JAX package's results on the same rows."""
    from amgcl_tpu.telemetry import load as RL
    rungs = _random_rungs(seed)
    for r in rungs:
        for dur in (None, 0.7):
            assert L.summarize_samples(r["samples"], duration_s=dur) == \
                RL.summarize_samples(r["samples"], duration_s=dur)
    curve = L.ladder_curve(rungs)
    assert curve == RL.ladder_curve(rungs)
    for kw in ({}, {"slo_p99_ms": 30.0}, {"goodput_floor": 0.99},
               {"queue_depth_limit": 4.0}):
        assert L.detect_knee(curve, **kw) == RL.detect_knee(curve, **kw)
    assert L.phase_attribution(curve) == RL.phase_attribution(curve)
    gauges = [g for r in rungs for g in r["gauges"]]
    assert L.gauge_rollup(gauges) == RL.gauge_rollup(gauges)
    for r in rungs:
        assert L.storm_timeline_trace(r["samples"], r["gauges"], pid=3) == \
            RL.storm_timeline_trace(r["samples"], r["gauges"], pid=3)
    for kw in ({}, {"slo_p99_ms": 40.0, "profile": {"x": 1}}):
        assert L.build_record(rungs, **kw) == RL.build_record(rungs, **kw)
    assert L.STORM_SCHEMA == RL.STORM_SCHEMA
    assert L.SPAN_KEYS == RL.SPAN_KEYS


PROM_PAGE = """\
# HELP amgcl_torch_farm_tenant_queue_depth per-tenant backlog
# TYPE amgcl_torch_farm_tenant_queue_depth gauge
amgcl_torch_farm_tenant_queue_depth{tenant="a"} 3
amgcl_torch_farm_tenant_queue_depth{tenant="b"} 4.5
amgcl_torch_serve_inflight 2
amgcl_torch_serve_requests_total 120
amgcl_torch_farm_tenant_requests_total{tenant="a"} 7
amgcl_torch_serve_batch_fill 0.75
not a metric line
amgcl_torch_bad_value{x="1"} zz
"""


def test_parse_prometheus_gauges_matches_jax():
    from amgcl_tpu.serve import storm as R
    for page in (PROM_PAGE, PROM_PAGE.replace("amgcl_torch", "amgcl_tpu"),
                 ""):
        assert S.parse_prometheus_gauges(page) == \
            R.parse_prometheus_gauges(page)
    out = S.parse_prometheus_gauges(PROM_PAGE)
    assert out == {"queue_depth": 7.5, "inflight": 2.0,
                   "requests_total": 127.0}


# ===========================================================================
# arrival schedules (tests/test_storm.py:53-110)
# ===========================================================================

def test_schedule_deterministic_and_ordered():
    a = S.build_schedule(PHASES, tenants=("t0", "t1"), seed=7)
    assert a == S.build_schedule(PHASES, tenants=("t0", "t1"), seed=7)
    assert a != S.build_schedule(PHASES, tenants=("t0", "t1"), seed=8)
    ts = [r["t_s"] for r in a]
    assert ts == sorted(ts)
    assert [r["rid"] for r in a] == list(range(len(a)))
    assert {r["tenant"] for r in a} == {"t0", "t1"}
    assert {r["phase"] for r in a} == {"poisson", "burst", "ramp"}
    assert 0.0 <= ts[0] and ts[-1] < S.schedule_duration_s(PHASES) == 3.0


def test_poisson_phase_mean_rate():
    rows = S.build_schedule([S.poisson_phase(200.0, 2.0)], seed=3)
    assert 300 <= len(rows) <= 500
    assert all(0.0 <= r["t_s"] < 2.0 for r in rows)
    assert all(r["rate_rps"] == 200.0 for r in rows)


def test_ramp_phase_density_and_rate_annotation():
    rows = S.build_schedule([S.ramp_phase(10.0, 100.0, 2.0)], seed=11)
    lo = [r for r in rows if r["t_s"] < 1.0]
    hi = [r for r in rows if r["t_s"] >= 1.0]
    assert len(hi) > 1.5 * len(lo)
    rates = [r["rate_rps"] for r in rows]
    assert rates == sorted(rates)
    assert rates[0] < 50.0 < rates[-1] <= 100.0
    down = S.build_schedule([S.ramp_phase(100.0, 10.0, 2.0)], seed=11)
    assert down and all(0.0 <= r["t_s"] < 2.0 for r in down)


def test_burst_phase_trains_are_deterministic():
    phase = S.burst_phase(5.0, 2.0, burst_every_s=0.5, burst_len=6)
    ts = {r["t_s"] for r in S.build_schedule([phase], seed=1)}
    for k in (1, 2, 3):
        for j in range(6):
            assert round(k * 0.5 + j * 1e-3, 6) in ts
    assert len(ts) >= 18


# ===========================================================================
# the sample accounting (tests/test_storm.py:113-265)
# ===========================================================================

def test_summarize_goodput_excludes_bad_outcomes():
    spans = {"queue": 2.0, "pad": 0.5, "compile": 0.0, "solve": 6.0,
             "sync": 1.5}
    samples = ([_sample(i, i * 0.1, "ok", lat=10.0 + i, spans=spans)
                for i in range(6)]
               + [_sample(6, 0.6, "shed", lat=0.2),
                  _sample(7, 0.7, "timeout", lat=500.0),
                  _sample(8, 0.8, "unhealthy", lat=20.0),
                  _sample(9, 0.9, "error", lat=20.0)])
    out = L.summarize_samples(samples, duration_s=1.0)
    assert out["requests"] == 10 and out["outcomes"]["ok"] == 6
    assert out["offered_rps"] == 10.0
    assert out["shed_rate"] == 0.1 and out["timeout_rate"] == 0.1
    assert out["unhealthy_rate"] == 0.1 and out["error_rate"] == 0.1
    assert out["bad_frac"] == 0.4
    assert 0 < out["goodput_frac"] <= 0.6
    assert out["latency_ms"]["count"] == 6
    assert out["latency_ms"]["max"] == 15.0
    assert out["spans_ms"]["solve"] == 6.0
    assert abs(sum(out["span_share"].values()) - 1.0) < 1e-6
    assert out["span_share"]["solve"] == 0.6


def test_detect_knee_all_three_reasons_and_clean():
    def row(i, rate, p99, gf, qd=None):
        return {"rung": i, "offered_rps": rate, "p99_ms": p99,
                "goodput_frac": gf, "goodput_rps": rate * gf,
                "queue_depth_max": qd}
    clean = [row(0, 10, 5.0, 1.0), row(1, 20, 6.0, 0.99),
             row(2, 40, 8.0, 0.97)]
    k = L.detect_knee(clean, slo_p99_ms=50.0)
    assert not k["saturated"] and k["reason"] is None
    assert k["knee_offered_rps"] is None
    assert k["max_sustainable_rps"] == 40 * 0.97
    k = L.detect_knee(clean[:2] + [row(2, 40, 80.0, 0.97)],
                      slo_p99_ms=50.0)
    assert k["reason"] == "p99_slo_breach" and k["knee_p99_ms"] == 80.0
    assert k["max_sustainable_rps"] == 20 * 0.99
    k = L.detect_knee(clean[:2] + [row(2, 40, 8.0, 0.5)])
    assert k["reason"] == "goodput_collapse" and k["knee_rung"] == 2
    k = L.detect_knee([row(0, 10, 5.0, 1.0, qd=2),
                       row(1, 20, 6.0, 0.99, qd=900)],
                      queue_depth_limit=100.0)
    assert k["reason"] == "queue_divergence"
    assert k["knee_offered_rps"] == 20 and k["max_sustainable_rps"] == 10.0


def test_build_record_schema_and_reference():
    spans = {"queue": 1.0, "pad": 0.2, "compile": 0.0, "solve": 4.0,
             "sync": 0.8}

    def rung(rate, n_ok, n_shed):
        samples = [_sample(i, i / rate, "ok", lat=8.0, spans=spans)
                   for i in range(n_ok)]
        samples += [_sample(n_ok + j, (n_ok + j) / rate, "shed", lat=0.1)
                    for j in range(n_shed)]
        return {"offered_rps": rate,
                "summary": L.summarize_samples(
                    samples, duration_s=(n_ok + n_shed) / rate),
                "gauges": [{"t_s": 0.1, "queue_depth": 3.0}]}

    rec = L.build_record([rung(40.0, 8, 8), rung(10.0, 10, 0)],
                         slo_p99_ms=100.0)
    assert rec["schema"] == L.STORM_SCHEMA == 1
    assert len(rec["curve"]) == 2
    assert rec["reference"]["offered_rps"] == 10.0
    assert rec["reference"]["p99_ms"] == 8.0
    assert rec["goodput"]["requests"] == 26 and rec["goodput"]["ok"] == 18
    assert rec["goodput"]["outcomes"]["shed"] == 8
    assert rec["knee"]["saturated"]
    assert rec["knee"]["reason"] == "goodput_collapse"
    assert rec["attribution"][0]["shares"]["solve"] > 0
    assert rec["gauges"]["rows"] == 2
    json.dumps(rec)


def test_storm_timeline_trace_shape():
    samples = [_sample(0, 0.1, "ok", lat=12.0, tenant="a"),
               _sample(1, 0.2, "shed", lat=0.1, tenant="b")]
    tr = L.storm_timeline_trace(samples, [{"t_s": 0.15, "queue_depth": 4.0}])
    evs = tr["traceEvents"]
    assert {"M", "X", "i", "C"} <= {e["ph"] for e in evs}
    x = [e for e in evs if e["ph"] == "X"][0]
    assert x["ts"] == pytest.approx(0.1 * 1e6)
    assert x["dur"] == pytest.approx(12.0 * 1e3)
    assert {e["args"]["name"] for e in evs if e["ph"] == "M"} == \
        {"storm/a", "storm/b"}
    assert [e for e in evs if e["ph"] == "C"][0]["args"] == \
        {"queue_depth": 4.0}


def test_scraper_counts_errors_instead_of_swallowing():
    lock = threading.Lock()
    rows = []
    sc = S._Scraper("http://127.0.0.1:9/metrics", 0.02, time.perf_counter(),
                    lock, rows).start()
    time.sleep(0.15)
    sc.stop()
    assert sc.errors > 0 and sc.last_error
    assert rows == []


# ===========================================================================
# open-loop runs on a stub (tests/test_storm.py:287-437)
# ===========================================================================

class _StubTarget:
    """One worker, a fixed service time, a bounded queue: an M/D/1/K
    system on which the protocol's properties are exact."""

    def __init__(self, service_s=0.008, qmax=16, healthy=True):
        self.service_s = service_s
        self.healthy = healthy
        self._q = queue.Queue(maxsize=qmax)
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def submit(self, tenant, rhs):
        fut = _cf.Future()
        self._q.put_nowait((fut, rhs))     # queue.Full -> shed
        return fut

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, rhs = item
            time.sleep(self.service_s)
            rep = types.SimpleNamespace(
                health={"ok": self.healthy,
                        "flags": [] if self.healthy else ["stub"]},
                serve={"queue_ms": 1.0, "pad_ms": 0.1, "compile_ms": 0.0,
                       "solve_ms": self.service_s * 1e3, "sync_ms": 0.2,
                       "latency_ms": self.service_s * 1e3 + 1.3})
            fut.set_result((rhs, rep))

    def close(self):
        self._q.put(None)
        self._t.join(timeout=5.0)


def test_open_loop_vs_closed_loop_p99_diverge_under_overload():
    """Closed loop on an overloaded target keeps each latency near the
    service time (coordinated omission); the open-loop storm charges the
    queueing from the scheduled arrival, and its p99 is at least 3x."""
    tgt = _StubTarget(service_s=0.008, qmax=16)
    try:
        closed = []
        for _ in range(30):
            t0 = time.perf_counter()
            tgt.submit("t0", b"x").result(timeout=10)
            closed.append((time.perf_counter() - t0) * 1e3)
        closed.sort()
        closed_p99 = closed[int(0.99 * (len(closed) - 1))]
        sched = S.build_schedule([S.poisson_phase(300.0, 1.0)], seed=5)
        res = S.run_storm(tgt, sched, lambda tenant, rid: b"x",
                          drain_timeout_s=10.0, scrape_every_s=0.0,
                          emit_event=False)
    finally:
        tgt.close()
    summ = res["summary"]
    assert summ["outcomes"].get("pending", 0) == 0
    assert summ["outcomes"]["ok"] > 20
    assert summ["shed_rate"] > 0.2
    assert summ["latency_ms"]["p99"] > 3 * closed_p99
    assert summ["goodput_rps"] < 0.75 * summ["offered_rps"]


def test_run_storm_outcomes_spans_and_event(tmp_path):
    out = tmp_path / "storm.jsonl"
    sink.set_default_sink(sink.JsonlSink(str(out)))
    tgt = _StubTarget(service_s=0.002, qmax=64)
    try:
        sched = S.build_schedule([S.poisson_phase(50.0, 0.5)],
                                 tenants=("a", "b"), seed=2)
        res = S.run_storm(tgt, sched, lambda tenant, rid: b"x",
                          drain_timeout_s=10.0, scrape_every_s=0.0,
                          label="gentle")
    finally:
        tgt.close()
        sink.set_default_sink(sink.NullSink())
    summ = res["summary"]
    assert summ["outcomes"] == {"ok": summ["requests"]}
    assert summ["goodput_frac"] > 0.5
    ok_rows = [s for s in res["samples"] if s["outcome"] == "ok"]
    assert all(s["spans_ms"]["solve"] == 2.0 for s in ok_rows)
    assert all(s["latency_ms"] >= 0 for s in ok_rows)
    ev = [json.loads(ln) for ln in open(out)]
    ev = [r for r in ev if r.get("event") == "storm"]
    assert len(ev) == 1 and ev[0]["label"] == "gentle"
    assert ev[0]["requests"] == summ["requests"]
    assert ev[0]["p99_ms"] == summ["latency_ms"]["p99"]
    assert ev[0]["shed_rate"] == 0.0


def test_unhealthy_solves_excluded_from_goodput():
    tgt = _StubTarget(service_s=0.001, qmax=64, healthy=False)
    try:
        sched = S.build_schedule([S.poisson_phase(40.0, 0.4)], seed=4)
        res = S.run_storm(tgt, sched, lambda tenant, rid: b"x",
                          drain_timeout_s=10.0, scrape_every_s=0.0,
                          emit_event=False)
    finally:
        tgt.close()
    summ = res["summary"]
    assert summ["outcomes"] == {"unhealthy": summ["requests"]}
    assert summ["unhealthy_rate"] == 1.0 and summ["goodput_rps"] == 0.0
    assert "latency_ms" not in summ


def test_classify_exc_taxonomy():
    class RequestTimeout(Exception):
        pass
    assert S._classify_exc(queue.Full()) == "shed"
    assert S._classify_exc(faults.LoadShedError("t0")) == "shed"
    assert S._classify_exc(TimeoutError()) == "timeout"
    assert S._classify_exc(RequestTimeout()) == "timeout"
    assert S._classify_exc(faults.WorkerDiedError("x")) == "error"
    assert S._classify_exc(ValueError("boom")) == "error"


def test_ladder_to_knee_on_stub():
    tgt = _StubTarget(service_s=0.008, qmax=16)
    try:
        rungs = S.run_ladder(tgt, (20.0, 60.0, 400.0), 0.8,
                             lambda tenant, rid: b"x", seed=9,
                             drain_timeout_s=10.0, scrape_every_s=0.0,
                             emit_events=False)
    finally:
        tgt.close()
    rec = L.build_record(rungs)
    assert [r["offered_rps"] for r in rec["curve"]] == [20.0, 60.0, 400.0]
    assert rec["knee"]["saturated"]
    assert rec["knee"]["knee_offered_rps"] == 400.0
    assert rec["knee"]["max_sustainable_rps"] < 130.0
    assert rec["reference"]["offered_rps"] == 20.0


def test_fault_plans_wait_for_the_injection_seams():
    """Only no plan is accepted: the fault plans need the injection
    seams (ROADMAP A.13)."""
    with S.armed_fault_plan(None):
        pass
    with pytest.raises(NotImplementedError, match="A.13"):
        with S.armed_fault_plan("serve.worker:1"):
            pass
    with pytest.raises(NotImplementedError, match="A.13"):
        S.run_storm(object(), [], lambda t, r: None, fault_plan="x")


# ===========================================================================
# a storm through the port's farm on the CPU
# ===========================================================================

def test_storm_drives_the_farm_and_scrapes_tenant_labels(monkeypatch):
    """Two tenants behind one farm: every answer ok, each within the
    tolerance, and the scraper reads the farm's /metrics over loopback
    with tenant labels and no scrape error; the ladder's knee computes."""
    import amgcl_tpu_torch as T
    from amgcl_tpu_torch.serve import SolverFarm
    A6, _ = T.poisson3d(6)
    A7, _ = T.poisson3d(7)
    farm = SolverFarm(batch=4, flush_ms=2, metrics_port=0)
    rng = np.random.default_rng(19)
    rhs = {"a": rng.standard_normal(A6.nrows),
           "b": rng.standard_normal(A7.nrows)}
    scrapers = []

    class Counted(S._Scraper):
        def start(self):
            scrapers.append(self)
            return super().start()

    monkeypatch.setattr(S, "_Scraper", Counted)
    try:
        for name, A in (("a", A6), ("b", A7)):
            farm.register(name, A, solver=T.CG(maxiter=80, tol=1e-7),
                          precond=T.AMGParams(dtype=torch.float64,
                                              coarse_enough=50),
                          device="cpu")
        farm.start()
        sched = S.build_schedule([S.poisson_phase(20.0, 0.4),
                                  S.burst_phase(5.0, 0.4,
                                                burst_every_s=0.2,
                                                burst_len=3)],
                                 tenants=("a", "b"), seed=19)
        res = S.run_storm(farm, sched, lambda t, rid: rhs[t],
                          drain_timeout_s=60.0, scrape_every_s=0.05,
                          emit_event=False)
        rungs = S.run_ladder(farm, (5.0, 15.0), 0.25,
                             lambda t, rid: rhs[t], tenants=("a", "b"),
                             seed=3, drain_timeout_s=60.0,
                             scrape_every_s=0.0, emit_events=False)
        text = urllib_get(farm.metrics_url)
    finally:
        farm.close()
    summ = res["summary"]
    assert summ["outcomes"] == {"ok": len(sched)}
    assert res["gauges"] and any("requests_total" in g
                                 for g in res["gauges"])
    assert len(scrapers) == 1 and scrapers[0].errors == 0
    assert 'tenant="a"' in text and 'tenant="b"' in text
    assert summ["spans_ms"]["solve"] is not None
    knee = L.detect_knee(L.ladder_curve(rungs))
    assert knee["max_sustainable_rps"] is not None or knee["saturated"]
    assert farm.live.get("storm_submitted_total") == \
        len(sched) + sum(r["summary"]["requests"] for r in rungs)


def urllib_get(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()
