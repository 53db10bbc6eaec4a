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
