"""Diagonal-scaling smoother state (counterpart of
``amgcl_tpu/relaxation/base.py``)."""

from __future__ import annotations

import torch

from amgcl_tpu_torch.ops import device as dev


def setup_device(device):
    """Where a smoother's set-up runs its large sparse products and
    gathers: the CUDA device its state is built for, else None (numpy and
    scipy on the host)."""
    device = torch.device(device)
    return device if device.type == "cuda" else None


def state_bytes(*parts) -> int:
    """Device bytes of a smoother state's parts: tensors and device
    matrices (anything with ``bytes()``); None counts 0."""
    total = 0
    for p in parts:
        if torch.is_tensor(p):
            total += p.numel() * p.element_size()
        elif p is not None:
            total += p.bytes()
    return total


class ScaledResidualSmoother:
    """State for smoothers of the form x += scale ∘ (f − A x), with a
    per-unknown scale (damped Jacobi, SPAI-0) or a per-node b×b block
    (block SPAI-0)."""

    def __init__(self, scale):
        self.scale = scale            # (n,) or (n_pt, b, b) tensor

    def _mul(self, r):
        if self.scale.dim() == 1:
            return self.scale * r
        b = self.scale.shape[-1]
        return torch.einsum("nij,nj->ni", self.scale,
                            r.reshape(-1, b)).reshape(r.shape)

    def apply_pre(self, A, f, x):
        # one fused kernel pass where the format has one
        got = dev.scaled_correction(A, self.scale, f, x)
        if got is not None:
            return got
        return x + self._mul(dev.residual(f, A, x))

    apply_post = apply_pre

    def bytes(self) -> int:
        return state_bytes(self.scale)

    def apply(self, A, f):
        """One application from a zero initial guess
        (reference: relaxation/spai0.hpp:96-103)."""
        return self._mul(f)
