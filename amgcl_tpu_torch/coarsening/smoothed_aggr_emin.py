"""Energy-minimizing smoothed aggregation (reference:
amgcl/coarsening/smoothed_aggr_emin.hpp:55-180; counterpart of
``amgcl_tpu/coarsening/smoothed_aggr_emin.py``).

Each coarse basis column j takes the damping ω_j that minimizes its
energy along the D⁻¹A direction: P_j = P_tent_j − ω_j K_j with
K = D_f⁻¹ A_f P_tent and ω_j = (K_jᵀ A_f P_tent_j) / (K_jᵀ A_f K_j),
clipped to [0, 2], for all columns at once with two products and
column sums. P and R are stored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from amgcl_tpu_torch.coarsening.aggregates import (plain_aggregates,
                                                   pointwise_aggregates)
from amgcl_tpu_torch.coarsening.galerkin import galerkin
from amgcl_tpu_torch.coarsening.smoothed_aggregation import _filtered
from amgcl_tpu_torch.coarsening.stall import CoarseningStall
from amgcl_tpu_torch.coarsening.tentative import tentative_prolongation
from amgcl_tpu_torch.ops.csr import CSR


@dataclass
class SmoothedAggrEMin:
    eps_strong: float = 0.08
    block_size: int = 1
    nullspace: Optional[np.ndarray] = None

    def transfer_operators(self, A: CSR, ctx: dict):
        eps_strong = ctx.get("eps_strong", self.eps_strong)
        nullspace = ctx.get("nullspace", self.nullspace)
        if A.is_block and nullspace is not None:
            raise NotImplementedError(
                "near-nullspace with block value types is not supported")
        scalar = A.unblock() if A.is_block else A
        bs = A.block_size[0] if A.is_block else self.block_size
        ctx["eps_strong"] = eps_strong * 0.5
        if bs > 1:
            agg, n_agg = pointwise_aggregates(A, eps_strong, bs,
                                              ctx.get("setup_device"))
            n_pt = A.nrows if A.is_block else A.nrows // bs
        else:
            agg, n_agg = plain_aggregates(scalar, eps_strong,
                                          ctx.get("setup_device"))
            n_pt = scalar.nrows
        if n_agg == 0:
            raise CoarseningStall("empty coarse level (all rows isolated)")
        P_tent, Bc = tentative_prolongation(n_pt, agg, n_agg, nullspace, bs)
        Pt = (P_tent.unblock() if P_tent.is_block else P_tent).to_scipy()
        Af, Dfi = _filtered(scalar, eps_strong)
        Afs = Af.to_scipy()
        AP = (Afs @ Pt).tocsr()
        K = AP.multiply(Dfi[:, None]).tocsr()          # D⁻¹ A P
        AK = (Afs @ K).tocsr()
        num = np.asarray(K.multiply(AP).sum(axis=0)).ravel()
        den = np.asarray(K.multiply(AK).sum(axis=0)).ravel()
        omega = np.clip(num / np.where(den != 0, den, 1.0), 0.0, 2.0)
        P = (Pt - K.multiply(omega[None, :])).tocsr()
        P.eliminate_zeros()
        P.sort_indices()
        Pc = CSR.from_scipy(P)
        R = Pc.transpose()
        if A.is_block:
            Pc = Pc.to_block(bs)
            R = R.to_block(bs)
        ctx["nullspace"] = Bc
        return Pc, R

    def coarse_operator(self, A: CSR, P, R, ctx: dict) -> CSR:
        return galerkin(A, P, R, ctx.get("setup_device"))
