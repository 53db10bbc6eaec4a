"""In-loop numerical-health guards (counterpart of the guard part of
``amgcl_tpu/telemetry/health.py``, as far as CG uses it).

The JAX package carries a compact guard state through its device-side
``while_loop``. The port's Krylov loops are Python loops that already
fetch the iteration's scalars once per step (the convergence check), so
the guard state lives on the host as Python numbers and costs no extra
device work: NaN/Inf residuals, Krylov breakdown denominators, loss of
positive definiteness, stagnation and divergence, recorded as a bitmask
plus the first iteration each flag tripped. A fatal trip freezes the
iterate at the last committed step and ends the loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np

NAN = 1                      # non-finite residual
BREAKDOWN_RHO = 2            # <rhat, r> / shadow-space projection ≈ 0
BREAKDOWN_OMEGA = 4          # minimal-residual step length ≈ 0
BREAKDOWN_ALPHA = 8          # search-direction denominator ≈ 0
BREAKDOWN_HESSENBERG = 16    # Arnoldi h[j+1,j] ≈ 0 before convergence
INDEFINITE = 32              # p·Ap ≤ 0 under CG (operator not SPD)
STAGNATION = 64              # reduction below threshold over a window
DIVERGENCE = 128             # residual grew K consecutive iterations

FLAG_BITS = (NAN, BREAKDOWN_RHO, BREAKDOWN_OMEGA, BREAKDOWN_ALPHA,
             BREAKDOWN_HESSENBERG, INDEFINITE, STAGNATION, DIVERGENCE)
N_FLAGS = len(FLAG_BITS)
FLAG_NAMES = {
    NAN: "nan", BREAKDOWN_RHO: "breakdown_rho",
    BREAKDOWN_OMEGA: "breakdown_omega", BREAKDOWN_ALPHA: "breakdown_alpha",
    BREAKDOWN_HESSENBERG: "breakdown_hessenberg", INDEFINITE: "indefinite",
    STAGNATION: "stagnation", DIVERGENCE: "divergence"}
BREAKDOWN_MASK = (BREAKDOWN_RHO | BREAKDOWN_OMEGA | BREAKDOWN_ALPHA
                  | BREAKDOWN_HESSENBERG)
#: flags that end the loop: NaN, breakdowns, and divergence (the JAX
#: package's default, AMGCL_TPU_DIVERGENCE_BREAK=1)
FATAL_MASK = NAN | BREAKDOWN_MASK | DIVERGENCE
_IDX = {bit: i for i, bit in enumerate(FLAG_BITS)}

# the JAX package's default thresholds (health.py module docstring)
STAG_RTOL = 0.99     # an iteration with res > 0.99·prev counts as stalled
STAG_WINDOW = 10     # consecutive stalled iterations before STAGNATION
DIV_RTOL = 10.0      # diverging only when res also exceeds 10·best
DIV_WINDOW = 5       # consecutive diverging iterations before DIVERGENCE


@dataclass
class HealthState:
    """Guard state of one solve: a bitmask, per-flag first-trip
    iterations and the stagnation/divergence window counters."""
    prev_res: float
    best_res: float
    flags: int = 0
    first_it: List[int] = field(
        default_factory=lambda: [-1] * len(FLAG_BITS))
    stag: int = 0
    div: int = 0

    def trip(self, it: int, bit: int, cond: bool) -> None:
        if cond:
            self.flags |= bit
            if self.first_it[_IDX[bit]] < 0:
                self.first_it[_IDX[bit]] = int(it)

    def names(self) -> List[str]:
        return [FLAG_NAMES[b] for b in FLAG_BITS if self.flags & b]


def bad_denom(v: float, tiny: float) -> bool:
    """A denominator that signals breakdown: non-finite, exactly zero, or
    at most ``tiny`` (the smallest normal number of the working dtype)."""
    return not math.isfinite(v) or abs(v) <= tiny


def step(hs: HealthState, it: int, res: float, trips=()) -> bool:
    """One guard update at iteration ``it`` with candidate residual norm
    ``res``. ``trips`` holds ``(bit, cond)`` or ``(bit, cond, fatal)``
    tuples (``fatal`` defaults True). Returns the commit mask: False on a
    fatal trip, in which case the solver keeps its previous state.
    Stagnation/divergence counters advance only on committed steps."""
    fatal = not math.isfinite(res)
    hs.trip(it, NAN, fatal)
    for t in trips:
        bit, cond = t[0], bool(t[1])
        hs.trip(it, bit, cond)
        if cond and (t[2] if len(t) > 2 else True):
            fatal = True
    ok = not fatal
    if ok:
        stalled = res > STAG_RTOL * hs.prev_res
        grew = res > hs.prev_res and res > DIV_RTOL * hs.best_res
        hs.stag = hs.stag + 1 if stalled else 0
        hs.div = hs.div + 1 if grew else 0
        hs.prev_res = res
        hs.best_res = min(res, hs.best_res)
    hs.trip(it, STAGNATION, hs.stag >= STAG_WINDOW)
    hs.trip(it, DIVERGENCE, hs.div >= DIV_WINDOW)
    return ok


def keep_going(hs: HealthState) -> bool:
    """Loop continuation term: False once a fatal flag tripped."""
    return (hs.flags & FATAL_MASK) == 0


# -- stacked (n, B) solves -----------------------------------------------------


class StackedHealth:
    """The guard states of a stacked solve, one :class:`HealthState` a
    column (the JAX package's ``HealthState`` with a leading batch axis):
    ``flags`` is the (B,) bitmask array and ``first_it`` the
    (B, N_FLAGS) first-trip iterations, as numpy int arrays."""

    def __init__(self, columns):
        self.columns = list(columns)

    @property
    def flags(self):
        return np.array([hs.flags for hs in self.columns], np.int64)

    @property
    def first_it(self):
        return np.array([hs.first_it for hs in self.columns],
                        np.int64).reshape(len(self.columns), N_FLAGS)


def _trip_first(first, bit, cond, it):
    """Record, in the (B, N_FLAGS) array ``first``, iteration ``it`` as
    the first trip of ``bit`` for each column where ``cond`` (B,) holds
    and none is recorded yet; returns ``first``."""
    col = first[:, _IDX[bit]]
    col[np.asarray(cond, bool) & (col < 0)] = int(it)
    return first


def decode(flags, first_it=None):
    """A guard state's bitmask and first-trip iterations as the JAX
    package's ``SolveReport.health`` dict (amgcl_tpu/telemetry/health.py
    ``decode``): tripped names, per-flag first trips, the headline
    booleans and the earliest breakdown."""
    flags = int(flags)
    fi = [int(v) for v in first_it] if first_it is not None \
        else [-1] * N_FLAGS
    names = [FLAG_NAMES[b] for b in FLAG_BITS if flags & b]
    first = {FLAG_NAMES[b]: fi[_IDX[b]] for b in FLAG_BITS
             if flags & b and fi[_IDX[b]] >= 0}
    bk_bits = [b for b in FLAG_BITS if (b & BREAKDOWN_MASK) and (flags & b)]
    bk = None
    if bk_bits:
        bk = min(bk_bits, key=lambda b: fi[_IDX[b]] if fi[_IDX[b]] >= 0
                 else 1 << 30)
    out = {
        "ok": flags == 0,
        "flags": names,
        "first_trip": first,
        "nan": bool(flags & NAN),
        "diverged": bool(flags & DIVERGENCE),
        "stagnated": bool(flags & STAGNATION),
        "indefinite": bool(flags & INDEFINITE),
        "breakdown": FLAG_NAMES[bk] if bk else None,
    }
    if bk and fi[_IDX[bk]] >= 0:
        out["breakdown_iteration"] = fi[_IDX[bk]]
    return out


def _finding(sev, code, message, suggestion=None):
    f = {"severity": sev, "code": code, "message": message}
    if suggestion:
        f["suggestion"] = suggestion
    return f


def serve_findings(serve):
    """Serving findings from a :meth:`SolverService.slo_summary` window
    (amgcl_tpu/telemetry/health.py:362): which thresholds tripped, the
    span that dominates the latency, and padding waste; each a dict
    ``{severity, code, message, suggestion}``."""
    out = []
    trips = serve.get("trips") or []
    slo = serve.get("slo") or {}
    spans = serve.get("spans_ms") or {}
    window = serve.get("window")
    if "p99" in trips:
        parts = {k: spans.get(k) or 0.0
                 for k in ("queue", "pad", "compile", "solve", "sync")}
        total = sum(parts.values()) or 1.0
        dom = max(parts, key=parts.get)
        msg = ("serving p99 latency %.1f ms exceeds the %.1f ms SLO over "
               "the last %s request(s) — dominated by %s_ms (%.0f%% of the "
               "span breakdown)"
               % (serve.get("p99_ms", float("nan")),
                  slo.get("p99_ms", float("nan")), window, dom,
                  100.0 * parts[dom] / total))
        sug = {
            "queue": "raise the batch bucket B or shorten the flush "
                     "deadline (flush_ms) so requests spend less time "
                     "queued",
            "pad": "host packing dominates — submit contiguous tensors of "
                   "the solver dtype to avoid per-request conversions",
            "compile": "cold bucket captures dominate — warm every (n, B) "
                       "bucket at startup (one dummy request per bucket)",
            "solve": "the device solve itself dominates — batching cannot "
                     "help; cut iterations (stronger preconditioner)",
            "sync": "result fetch/decode dominates — keep results on the "
                    "device or batch the host round trips",
        }[dom]
        out.append(_finding("critical", "slo_p99", msg, sug))
    if "timeout_rate" in trips:
        out.append(_finding(
            "critical", "slo_timeout_rate",
            "%.1f%% of the last %s request(s) timed out in the serve "
            "queue (SLO %.1f%%)"
            % (100 * serve.get("timeout_rate", 0), window,
               100 * slo.get("timeout_rate", 0)),
            "the service is overloaded: raise timeout_s only if callers "
            "tolerate the latency — otherwise add capacity or shed load"))
    if "unhealthy_rate" in trips:
        out.append(_finding(
            "critical", "slo_unhealthy_rate",
            "%.1f%% of the last %s request(s) finished with tripped "
            "health guards (SLO %.1f%%)"
            % (100 * serve.get("unhealthy_rate", 0), window,
               100 * slo.get("unhealthy_rate", 0)),
            "inspect the per-request health decodes (SolveReport.health) "
            "— a systematic breakdown is an operator or preconditioner "
            "problem, not a serving problem"))
    fill = serve.get("batch_fill")
    if fill is not None and fill < 0.5:
        out.append(_finding(
            "warning", "serve_padding_waste",
            "mean batch_fill %.2f < 0.5 — over half the padded bucket "
            "columns are zero padding, wasted device work the ledger books "
            "as padding_waste bytes/FLOPs" % fill,
            "shrink the bucket (batch B) toward the real arrival rate, or "
            "raise the flush deadline so batches fill before dispatch"))
    return out
