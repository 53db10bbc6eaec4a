"""``as_block``: a scalar smoother on the unblocked view of a block
matrix (reference: amgcl/relaxation/as_block.hpp; counterpart of
``amgcl_tpu/relaxation/as_block.py``). Vectors are flat either way, so
the scalar state applies to the block level operator as it stands."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.relaxation.spai0 import Spai0


@dataclass
class AsBlock:
    base: Any = field(default_factory=Spai0)

    def build(self, A: CSR, dtype, device):
        return self.base.build(A.unblock() if A.is_block else A, dtype,
                               device)
