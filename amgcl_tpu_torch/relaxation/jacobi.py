"""Damped Jacobi: x += ω D⁻¹ (f − A x) (reference:
amgcl/relaxation/damped_jacobi.hpp, damping 0.72; counterpart of
``amgcl_tpu/relaxation/jacobi.py``). A block matrix takes its inverted
b×b diagonal blocks, so the block correction kernel applies it."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.relaxation.base import ScaledResidualSmoother


@dataclass
class DampedJacobi:
    damping: float = 0.72

    def build(self, A: CSR, dtype, device) -> ScaledResidualSmoother:
        # contiguous: the block correction kernel reads blocks row-major
        w = np.ascontiguousarray(self.damping * A.diagonal(invert=True))
        return ScaledResidualSmoother(
            torch.as_tensor(w, device=device).to(dtype))
