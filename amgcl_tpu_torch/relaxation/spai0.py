"""SPAI-0: sparse approximate inverse restricted to a diagonal,
m_i = a_ii / Σ_j a_ij² (reference: amgcl/relaxation/spai0.hpp:49-117;
counterpart of ``amgcl_tpu/relaxation/spai0.py``, scalar path)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.relaxation.base import ScaledResidualSmoother


@dataclass
class Spai0:
    def build(self, A: CSR, dtype, device) -> ScaledResidualSmoother:
        sq = (np.abs(A.val) ** 2).astype(np.float64)
        denom = np.bincount(A.expanded_rows(), weights=sq,
                            minlength=A.nrows)
        m = A.diagonal() / np.where(denom != 0, denom, 1.0)
        return ScaledResidualSmoother(
            torch.as_tensor(m, device=device).to(dtype))
