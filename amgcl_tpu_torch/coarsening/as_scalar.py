"""``as_scalar<Base>``: a scalar coarsening's transfers built on the
unblocked copy of a block matrix and blocked again (reference:
amgcl/coarsening/as_scalar.hpp:46-119; counterpart of
``amgcl_tpu/coarsening/as_scalar.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

from amgcl_tpu_torch.coarsening.smoothed_aggregation import \
    SmoothedAggregation
from amgcl_tpu_torch.ops.csr import CSR


@dataclass
class AsScalar:
    base: Any = field(default_factory=SmoothedAggregation)

    def transfer_operators(self, A: CSR, ctx: dict):
        bs = A.block_size[0] if A.is_block else 1
        scalar = A.unblock() if A.is_block else A
        base = self.base
        if bs > 1 and hasattr(base, "block_size") \
                and base.block_size != bs:
            # aggregate whole block nodes, so that the scalar coarse
            # space tiles back into bs×bs blocks (a copy: the wrapped
            # policy stays as it is)
            base = replace(base, block_size=bs)
        P, R = base.transfer_operators(scalar, ctx)
        if bs > 1:
            if P.ncols % bs:
                raise ValueError(
                    "scalar coarse space (%d cols) does not tile into %dx%d "
                    "blocks" % (P.ncols, bs, bs))
            P = P.to_block(bs)
            R = R.to_block(bs)
        return P, R

    def coarse_operator(self, A: CSR, P, R, ctx: dict) -> CSR:
        return self.base.coarse_operator(A, P, R, ctx)
