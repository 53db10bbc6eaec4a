"""Saturation observability: load-curve analytics over open-loop storm
samples (``serve/storm.py``; counterpart of
``amgcl_tpu/telemetry/load.py``).

The storm generator records one sample row a request, timestamped at its
*scheduled* arrival (the open-loop contract: latency includes every
millisecond of queueing that a closed-loop harness hides by not
submitting while blocked, "coordinated omission"). This module turns the
rows into the saturation story:

* :func:`summarize_samples` — one rung's accounting: outcome counts,
  offered, achieved and goodput rates (sheds, timeouts, unhealthy and
  errors are not goodput), open-loop latency percentiles, scheduler-lag
  percentiles and the mean serve spans with their shares.
* :func:`ladder_curve` — latency against offered load over a ladder.
* :func:`detect_knee` — the first rung whose p99 breaches the SLO, whose
  goodput falls below the offered rate, or whose queue depth diverges;
  ``max_sustainable_rps`` is the best goodput below it.
* :func:`phase_attribution` — queue, pad, compile, solve and sync shares
  against offered load.
* :func:`gauge_rollup` — rollups of the scraped /metrics gauges.
* :func:`storm_timeline_trace` — a Chrome/Perfetto trace: one event a
  request from its scheduled arrival, instants for sheds and timeouts,
  counter tracks from the gauges.
* :func:`build_record` — the schema-versioned record body (curve, knee,
  goodput, attribution, the p99 at the reference load).

A sample row::

    {"rid", "tenant", "phase", "rate_rps",      # schedule identity
     "t_sched_s",                # scheduled arrival, storm-epoch seconds
     "t_submit_s", "lag_ms",     # actual submit and scheduler lag
     "outcome",                  # ok|shed|timeout|unhealthy|error
     "t_done_s", "latency_ms",   # completion; latency = done - scheduled
     "spans_ms": {queue,pad,compile,solve,sync}}   # ok rows only
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from amgcl_tpu_torch.telemetry import metrics as _metrics

#: the record's schema version (bumped on breaking field changes)
STORM_SCHEMA = 1

#: the serve phases a request's spans carry
SPAN_KEYS = ("queue", "pad", "compile", "solve", "sync")

#: outcomes excluded from goodput: a shed, timed-out, unhealthy or
#: errored request consumed capacity without serving anyone
BAD_OUTCOMES = ("shed", "timeout", "unhealthy", "error")


def _pct(vals: List[float], p: float) -> Optional[float]:
    v = _metrics.percentile(vals, p)
    return round(v, 3) if v is not None else None


def summarize_samples(samples: List[Dict[str, Any]],
                      duration_s: Optional[float] = None
                      ) -> Dict[str, Any]:
    """One storm (or ladder-rung) summary from open-loop sample rows.

    ``offered_rps`` counts every SCHEDULED arrival over the schedule
    span (``duration_s`` overrides the span when the caller knows the
    configured phase length); ``achieved_rps`` counts completions of
    any outcome over the completion wall; ``goodput_rps`` counts only
    ``ok`` completions. Latency percentiles cover ok rows and are
    measured from the scheduled arrival — the open-loop contract."""
    n = len(samples)
    outcomes: Dict[str, int] = {}
    for s in samples:
        key = s.get("outcome") or "pending"
        outcomes[key] = outcomes.get(key, 0) + 1
    ok = [s for s in samples if s.get("outcome") == "ok"]
    lat = [s["latency_ms"] for s in ok
           if s.get("latency_ms") is not None]
    lag = [s["lag_ms"] for s in samples if s.get("lag_ms") is not None]
    sched = [s.get("t_sched_s") for s in samples
             if s.get("t_sched_s") is not None]
    dur = duration_s
    if dur is None and len(sched) > 1:
        dur = max(sched) - min(sched)
    done = [s.get("t_done_s") for s in samples
            if s.get("t_done_s") is not None]
    wall = (max(done) - min(sched)) if done and sched else None
    if wall is not None and dur:
        # the rate window never shrinks below the schedule span: an
        # underloaded rung whose few requests all finish early is
        # serving at the OFFERED rate, not at 1/completion-spread —
        # only drain time past the span stretches the window
        wall = max(wall, dur)
    completed = sum(v for k, v in outcomes.items()
                    if k not in ("pending", "shed"))
    out: Dict[str, Any] = {
        "requests": n,
        "outcomes": outcomes,
        "duration_s": round(dur, 4) if dur else None,
        "wall_s": round(wall, 4) if wall else None,
        "offered_rps": round(n / dur, 3) if dur else None,
        "achieved_rps": round(completed / wall, 3) if wall else None,
        "goodput_rps": round(len(ok) / wall, 3) if wall else None,
    }
    if out["offered_rps"] and out["goodput_rps"] is not None:
        out["goodput_frac"] = round(
            out["goodput_rps"] / out["offered_rps"], 4)
    bad = sum(outcomes.get(k, 0) for k in BAD_OUTCOMES)
    out["bad_frac"] = round(bad / n, 4) if n else 0.0
    for k in BAD_OUTCOMES:
        out["%s_rate" % k] = round(outcomes.get(k, 0) / n, 4) \
            if n else 0.0
    if lat:
        out["latency_ms"] = {
            "p50": _pct(lat, 50), "p90": _pct(lat, 90),
            "p99": _pct(lat, 99), "max": round(max(lat), 3),
            "count": len(lat)}
    if lag:
        out["sched_lag_ms"] = {"p50": _pct(lag, 50),
                               "p99": _pct(lag, 99),
                               "max": round(max(lag), 3)}
    spans: Dict[str, List[float]] = {k: [] for k in SPAN_KEYS}
    for s in ok:
        sp = s.get("spans_ms") or {}
        for k in SPAN_KEYS:
            v = sp.get(k)
            if isinstance(v, (int, float)) and math.isfinite(v):
                spans[k].append(float(v))
    means = {k: round(sum(v) / len(v), 3) if v else None
             for k, v in spans.items()}
    out["spans_ms"] = means
    total = sum(v for v in means.values() if v)
    if total > 0:
        out["span_share"] = {k: round((v or 0.0) / total, 4)
                             for k, v in means.items()}
    return out


def ladder_curve(rungs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The latency-vs-offered-load curve: one row per ladder rung.

    ``rungs``: ``[{"offered_rps": <target rate>, "summary":
    summarize_samples(...), "gauges": [scrape rows]}, ...]`` (what
    ``serve.storm.run_ladder`` returns). Rows keep both the target
    offered rate (the rung's Poisson rate) and the measured one."""
    curve = []
    for i, rung in enumerate(rungs):
        summ = rung.get("summary") or {}
        lat = summ.get("latency_ms") or {}
        depth = [g.get("queue_depth") for g in (rung.get("gauges") or [])
                 if isinstance(g.get("queue_depth"), (int, float))]
        row = {
            "rung": i,
            "offered_rps": rung.get("offered_rps"),
            "measured_offered_rps": summ.get("offered_rps"),
            "achieved_rps": summ.get("achieved_rps"),
            "goodput_rps": summ.get("goodput_rps"),
            "goodput_frac": summ.get("goodput_frac"),
            "p50_ms": lat.get("p50"), "p99_ms": lat.get("p99"),
            "max_ms": lat.get("max"),
            "shed_rate": summ.get("shed_rate"),
            "timeout_rate": summ.get("timeout_rate"),
            "unhealthy_rate": summ.get("unhealthy_rate"),
            "queue_depth_max": max(depth) if depth else None,
            "span_share": summ.get("span_share"),
        }
        curve.append(row)
    return curve


def detect_knee(curve: List[Dict[str, Any]],
                slo_p99_ms: Optional[float] = None,
                goodput_floor: float = 0.85,
                queue_depth_limit: Optional[float] = None
                ) -> Dict[str, Any]:
    """The saturation knee of a ladder curve: the FIRST rung (in
    offered-rate order) where

    * p99 latency breaches ``slo_p99_ms`` (when an SLO is set), or
    * goodput collapses below ``goodput_floor`` of the offered rate
      (the server is no longer keeping up — completions lag arrivals
      or requests are shed/timed out), or
    * the scraped queue depth exceeds ``queue_depth_limit`` (queue
      divergence — by Little's law an open-loop queue past saturation
      grows without bound; the scrape series catches it even while
      early percentiles still look fine).

    ``max_sustainable_rps`` is the best goodput of any rung below the
    knee (the whole curve when no knee is found): the headline of a
    ladder."""
    rows = sorted([r for r in curve if r.get("offered_rps")],
                  key=lambda r: r["offered_rps"])
    knee = None
    reason = None
    for r in rows:
        if slo_p99_ms and r.get("p99_ms") is not None \
                and r["p99_ms"] > slo_p99_ms:
            knee, reason = r, "p99_slo_breach"
            break
        gf = r.get("goodput_frac")
        if gf is not None and gf < goodput_floor:
            knee, reason = r, "goodput_collapse"
            break
        qd = r.get("queue_depth_max")
        if queue_depth_limit and qd is not None \
                and qd > queue_depth_limit:
            knee, reason = r, "queue_divergence"
            break
    below = rows if knee is None \
        else [r for r in rows if r["offered_rps"] < knee["offered_rps"]]
    good = [r["goodput_rps"] for r in below
            if r.get("goodput_rps") is not None]
    return {
        "saturated": knee is not None,
        "reason": reason,
        "knee_offered_rps": knee["offered_rps"] if knee else None,
        "knee_rung": knee["rung"] if knee else None,
        "knee_p99_ms": knee.get("p99_ms") if knee else None,
        "max_sustainable_rps": round(max(good), 3) if good else None,
        "goodput_floor": goodput_floor,
        "slo_p99_ms": slo_p99_ms,
    }


def phase_attribution(curve: List[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
    """Per-phase serve-span share as a function of offered load — the
    request spans under traffic: a queue share that grows with the
    offered rate while solve share shrinks is the saturation signature
    (the device is busy; requests pay in line, not in compute)."""
    out = []
    for r in curve:
        share = r.get("span_share")
        if share:
            out.append({"offered_rps": r.get("offered_rps"),
                        "shares": share})
    return out


def gauge_rollup(series: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Rollups per scraped gauge across the storm's /metrics scrape
    time-series (rows ``{"t_s": .., <gauge>: value, ..}``)."""
    keys = set()
    for row in series:
        keys.update(k for k, v in row.items()
                    if k != "t_s" and isinstance(v, (int, float)))
    out: Dict[str, Any] = {"rows": len(series)}
    for k in sorted(keys):
        r = _metrics.rollup(row.get(k) for row in series)
        if r is not None:
            out[k] = r
    return out


def storm_timeline_trace(samples: List[Dict[str, Any]],
                         gauges: Optional[List[Dict[str, Any]]] = None,
                         pid: int = 0) -> Dict[str, Any]:
    """Chrome/Perfetto trace of a storm: per-tenant tracks of complete
    events spanning SCHEDULED arrival -> completion (so queueing is
    visible as event length), instant markers for sheds/timeouts, and
    counter tracks for every scraped gauge. Same trace-event shape as
    ``RequestSpans.to_chrome_trace`` — concatenate ``traceEvents`` to
    merge tracks."""
    events: List[Dict[str, Any]] = []
    tenants = sorted({s.get("tenant") or "t0" for s in samples})
    tid_of = {t: i + 1 for i, t in enumerate(tenants)}
    for t, tid in tid_of.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": "storm/%s" % t}})
    for s in samples:
        tid = tid_of.get(s.get("tenant") or "t0", 0)
        ts = round(float(s.get("t_sched_s") or 0.0) * 1e6, 3)
        outcome = s.get("outcome")
        if outcome == "ok" and s.get("latency_ms") is not None:
            events.append({
                "name": s.get("phase") or "req",
                "cat": "amgcl/storm", "ph": "X", "ts": ts,
                "dur": round(float(s["latency_ms"]) * 1e3, 3),
                "pid": pid, "tid": tid,
                "args": {"rid": s.get("rid"),
                         "rate_rps": s.get("rate_rps"),
                         "lag_ms": s.get("lag_ms")}})
        elif outcome:
            events.append({
                "name": outcome, "cat": "amgcl/storm", "ph": "i",
                "s": "t", "ts": ts, "pid": pid, "tid": tid,
                "args": {"rid": s.get("rid")}})
    for row in gauges or []:
        ts = round(float(row.get("t_s") or 0.0) * 1e6, 3)
        for k, v in row.items():
            if k == "t_s" or not isinstance(v, (int, float)):
                continue
            events.append({"name": "storm/%s" % k, "ph": "C",
                           "ts": ts, "pid": pid, "args": {k: v}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def build_record(rungs: List[Dict[str, Any]],
                 slo_p99_ms: Optional[float] = None,
                 goodput_floor: float = 0.85,
                 queue_depth_limit: Optional[float] = None,
                 profile: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """The schema-versioned record body of an offered-load ladder:
    curve, knee, aggregate goodput accounting, per-phase attribution,
    the reference-load row (the lowest offered rate) and the optional
    mixed-phase storm's summary (``profile``)."""
    curve = ladder_curve(rungs)
    knee = detect_knee(curve, slo_p99_ms=slo_p99_ms,
                       goodput_floor=goodput_floor,
                       queue_depth_limit=queue_depth_limit)
    total = sum((r.get("summary") or {}).get("requests", 0)
                for r in rungs)
    outcomes: Dict[str, int] = {}
    for r in rungs:
        for k, v in ((r.get("summary") or {}).get("outcomes")
                     or {}).items():
            outcomes[k] = outcomes.get(k, 0) + v
    good = outcomes.get("ok", 0)
    ref = None
    rows = [r for r in curve if r.get("offered_rps")]
    if rows:
        lo = min(rows, key=lambda r: r["offered_rps"])
        ref = {"offered_rps": lo["offered_rps"],
               "p50_ms": lo.get("p50_ms"), "p99_ms": lo.get("p99_ms"),
               "goodput_frac": lo.get("goodput_frac")}
    rec: Dict[str, Any] = {
        "schema": STORM_SCHEMA,
        "curve": curve,
        "knee": knee,
        "reference": ref,
        "goodput": {
            "requests": total,
            "ok": good,
            "outcomes": outcomes,
            "good_frac": round(good / total, 4) if total else None,
        },
        "attribution": phase_attribution(curve),
        "gauges": gauge_rollup([g for r in rungs
                                for g in (r.get("gauges") or [])]),
    }
    if profile is not None:
        rec["profile"] = profile
    return rec
