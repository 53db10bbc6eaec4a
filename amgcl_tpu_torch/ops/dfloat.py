"""Double-float (two-float32) arithmetic for the refinement's outer
residual (counterpart of ``amgcl_tpu/ops/dfloat.py``).

Mixed-precision iterative refinement needs r = b − A x evaluated more
accurately than float32: the float32 evaluation floors around
eps32·‖A‖·‖x‖/‖b‖. ``refine_dtype="df32"`` evaluates it with
error-free transformations in float32 instead of a float64 operator:

- ``two_sum(a, b)`` -> (s, e) with a + b = s + e exactly (Knuth);
- ``two_prod(a, b)`` -> (p, e) with a·b = p + e exactly (Dekker
  splitting, no fused multiply-add assumed);
- operators and vectors carry (hi, lo) float32 pairs, value = hi + lo;
- ``dia_residual_df`` accumulates b − Σ_d a_d ∘ shift(x) row by row with
  every product's and every sum's rounding error folded back.

The transforms hold only if every float32 operation rounds once, so each
is a separate eager torch operation: no ``addcmul``, no fused or
compiled body, which could contract a product and a sum into one
rounding. ``make_solver`` checks the result once on the device against a
host float64 residual. The JAX package has no Pallas kernel here (its
``dia_residual_df`` is jitted jnp), so neither does the port.
"""

from __future__ import annotations

import numpy as np
import torch

_SPLITTER = 4097.0        # 2^12 + 1 for float32 Dekker splitting


def two_sum(a, b):
    """(s, e): a + b = s + e exactly (branch-free Knuth two-sum)."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _split(a):
    """Dekker split: a = hi + lo with hi carrying the top 12 mantissa
    bits, so products of halves are exact in float32."""
    c = a * _SPLITTER
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """(p, e): a·b = p + e exactly (Dekker; no fma assumption)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_decompose(a64):
    """float64 array -> (hi, lo) float32 pair with hi + lo == a64 (to
    float64 round-off)."""
    hi = np.asarray(a64, np.float32)
    lo = np.asarray(np.asarray(a64, np.float64)
                    - hi.astype(np.float64), np.float32)
    return hi, lo


def df_add_vec(x_hi, x_lo, d):
    """(x_hi, x_lo) + d (a float32 correction) -> new (hi, lo) pair."""
    s, e = two_sum(x_hi, d)
    lo = x_lo + e
    # renormalize so hi stays the leading part
    return two_sum(s, lo)


def dia_residual_df(offsets, data_hi, data_lo, b_hi, b_lo, x_hi, x_lo):
    """r ≈ b − A x in compensated float32 for DIA storage (``offsets``
    host ints, ``data_*`` (ndiag, n)); a float32 vector accurate to
    about |r| + eps32²·Σ|a||x|."""
    n, m = data_hi.shape[1], x_hi.shape[0]
    offsets = tuple(int(o) for o in offsets)
    lo_off = min(offsets + (0,))
    base = -lo_off if lo_off < 0 else 0
    hi_off = max(max(offsets + (0,)) + n - m, 0)
    xh = torch.nn.functional.pad(x_hi, (base, hi_off))
    xl = torch.nn.functional.pad(x_lo, (base, hi_off))
    s = b_hi
    comp = b_lo                       # running error and low-order folds
    for k, d in enumerate(offsets):
        seg_h = xh[base + d:base + d + n]
        seg_l = xl[base + d:base + d + n]
        p, pe = two_prod(data_hi[k], seg_h)
        s, se = two_sum(s, -p)
        # product error, sum error and the cross terms (small: plain
        # float32 is enough for them)
        comp = comp - pe + se - data_hi[k] * seg_l - data_lo[k] * seg_h
    return s + comp
