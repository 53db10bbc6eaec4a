"""Diagonal-scaling smoother state (counterpart of
``amgcl_tpu/relaxation/base.py``)."""

from __future__ import annotations

from amgcl_tpu_torch.ops import device as dev


class ScaledResidualSmoother:
    """State for smoothers of the form x += scale ∘ (f − A x) with a
    per-unknown scale (damped Jacobi, SPAI-0)."""

    def __init__(self, scale):
        self.scale = scale            # (n,) tensor

    def apply_pre(self, A, f, x):
        # one fused kernel pass where the format has one
        got = dev.scaled_correction(A, self.scale, f, x)
        if got is not None:
            return got
        return x + self.scale * dev.residual(f, A, x)

    apply_post = apply_pre

    def apply(self, A, f):
        """One application from a zero initial guess
        (reference: relaxation/spai0.hpp:96-103)."""
        return self.scale * f
