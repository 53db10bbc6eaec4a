"""Plain (unsmoothed) aggregation with a scaled Galerkin product
(reference: amgcl/coarsening/aggregation.hpp:71-160; counterpart of
``amgcl_tpu/coarsening/aggregation.py``). Piecewise-constant
interpolation underestimates corrections, so the coarse operator is
multiplied by 1/over_interp (1.5 by default).

On a detected grid the transfers are T itself, applied matrix-free
(``TentativeP``/``TentativeR``), and the coarse operator is the parity
collapse of A on diagonals (``ops/stencil.py``); elsewhere P and R are
stored and the product is scipy's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from amgcl_tpu_torch.coarsening.aggregates import (plain_aggregates,
                                                   pointwise_aggregates)
from amgcl_tpu_torch.coarsening.galerkin import scaled_galerkin
from amgcl_tpu_torch.coarsening.stall import CoarseningStall
from amgcl_tpu_torch.coarsening.tentative import tentative_prolongation
from amgcl_tpu_torch.ops.csr import CSR


@dataclass
class Aggregation:
    eps_strong: float = 0.08
    over_interp: float = 1.5
    block_size: int = 1
    nullspace: Optional[np.ndarray] = None
    aggregator: Any = None        # ``(A, eps) -> (agg, n_agg)``
    stencil_setup: bool = True    # grid transfers on detected stencils
    setup_dtype: Any = None

    def transfer_operators(self, A: CSR, ctx: dict):
        """``ctx`` carries per-build state (eps_strong decay, the coarse
        nullspace); the policy object is never mutated."""
        eps_strong = ctx.get("eps_strong", self.eps_strong)
        nullspace = ctx.get("nullspace", self.nullspace)
        setup_dtype = ctx.get("setup_dtype", self.setup_dtype)
        setup_device = ctx.get("setup_device")
        if A.is_block and nullspace is not None:
            raise NotImplementedError(
                "near-nullspace with block value types is not supported; "
                "unblock the matrix first (reference: coarsening::as_scalar)")
        scalar = A.unblock() if A.is_block else A
        bs = A.block_size[0] if A.is_block else self.block_size
        ctx["eps_strong"] = eps_strong * 0.5
        if (self.stencil_setup and bs == 1 and not A.is_block
                and nullspace is None and self.aggregator is None):
            from amgcl_tpu_torch.ops.structured import detect_grid_csr
            grid = detect_grid_csr(scalar)
            if grid is not None:
                from amgcl_tpu_torch.ops.stencil import \
                    stencil_plain_transfer_operators
                got = stencil_plain_transfer_operators(scalar, grid,
                                                       eps_strong,
                                                       setup_dtype)
                if got is not None:
                    return got
        if bs > 1:
            agg, n_agg = pointwise_aggregates(A, eps_strong, bs,
                                              setup_device)
            n_pt = A.nrows if A.is_block else A.nrows // bs
        elif self.aggregator is not None:
            agg, n_agg = self.aggregator(scalar, eps_strong)
            n_pt = scalar.nrows
        else:
            agg, n_agg = plain_aggregates(scalar, eps_strong, setup_device)
            n_pt = scalar.nrows
        if n_agg == 0:
            raise CoarseningStall("empty coarse level (all rows isolated)")
        P, Bc = tentative_prolongation(n_pt, agg, n_agg, nullspace, bs)
        R = P.transpose()
        if A.is_block and not P.is_block:
            P = P.to_block(bs)
            R = R.to_block(bs)
        ctx["nullspace"] = Bc
        return P, R

    def coarse_operator(self, A: CSR, P, R, ctx: dict) -> CSR:
        from amgcl_tpu_torch.ops.stencil import (StencilTransfer,
                                                 stencil_coarse_operator)
        if isinstance(P, StencilTransfer):
            return stencil_coarse_operator(A, P, 1.0 / self.over_interp,
                                           ctx.get("setup_device"))
        return scaled_galerkin(A, P, R, 1.0 / self.over_interp,
                               ctx.get("setup_device"))
