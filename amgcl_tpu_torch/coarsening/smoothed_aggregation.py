"""Smoothed aggregation coarsening (Vaněk SA), host route.

Counterpart of ``amgcl_tpu/coarsening/smoothed_aggregation.py`` on the
route its CPU backend takes. P = (I − ω D_f⁻¹ A_f) · P_tent, where A_f
is the strength-filtered matrix (weak off-diagonal entries lumped onto the
diagonal) and ω = relax · 4/3 / ρ(D_f⁻¹ A_f) with ρ the Gershgorin bound
(reference: amgcl/coarsening/smoothed_aggregation.hpp:55-243).
``eps_strong`` is halved per level as in the reference.

Stencil levels (at most 13 diagonals on a detected grid) build their
transfers on diagonals (ops/stencil.py); other levels take the CSR route:
strength filter → grid-aligned (or MIS) aggregates → tentative P and its
smoothing → explicit Galerkin product. Either way the device applies the
transfers matrix-free through an implicit spec (ops/structured.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from amgcl_tpu_torch.ops.csr import CSR, spectral_radius
from amgcl_tpu_torch.coarsening.aggregates import plain_aggregates
from amgcl_tpu_torch.coarsening.tentative import tentative_prolongation
from amgcl_tpu_torch.coarsening.galerkin import galerkin
from amgcl_tpu_torch.coarsening.stall import CoarseningStall


@dataclass
class SmoothedAggregation:
    """Policy object: ``transfer_operators`` / ``coarse_operator``."""
    eps_strong: float = 0.08
    relax: float = 1.0

    def transfer_operators(self, A: CSR, ctx: dict):
        """``ctx`` carries per-build state across levels (eps_strong
        decay, the stencil setup dtype, the next level's grid dims); the
        policy object itself is never mutated."""
        eps_strong = ctx.get("eps_strong", self.eps_strong)
        ctx["eps_strong"] = eps_strong * 0.5
        from amgcl_tpu_torch.ops.structured import detect_grid_csr
        grid = detect_grid_csr(A)
        if grid is not None:
            from amgcl_tpu_torch.ops.stencil import \
                stencil_transfer_operators
            got = stencil_transfer_operators(
                A, grid, eps_strong, self.relax, ctx.get("setup_dtype"))
            if got is not None:
                return got
        # filtered matrix: needed for P-smoothing below AND (computed
        # first) for the strength-aware grid aggregation decision
        Af, Df_inv = _filtered(A, eps_strong)
        if grid is not None:
            from amgcl_tpu_torch.ops.structured import (grid_aggregates,
                                                        strength_blocks)
            # semicoarsen: aggregate only along strong axes; no strong
            # axis means the grid path would stall -> MIS
            gblocks = strength_blocks(Af, grid)
            if gblocks is None:
                grid = None
        if grid is not None:
            agg, n_agg, coarse_dims, blocks = grid_aggregates(grid, gblocks)
            ctx["next_grid"] = coarse_dims
        else:
            agg, n_agg = plain_aggregates(A, eps_strong)
        if n_agg == 0:
            raise CoarseningStall("empty coarse level (all rows isolated)")

        rho = spectral_radius(Af)
        omega = self.relax * (4.0 / 3.0) / max(rho, 1e-30)
        P_tent = tentative_prolongation(A.nrows, agg, n_agg)
        P = _p_smooth(P_tent, Af.scale_rows(Df_inv), omega)
        R = P.transpose()
        # the device applies P/R matrix-free through this spec
        M = CSR(Af.ptr, Af.col,
                Af.val * (omega * Df_inv[Af.expanded_rows()]), Af.ncols)
        spec = {"M": M}
        if grid is not None:
            spec.update(fine=grid, block=blocks, coarse=coarse_dims)
        else:
            spec.update(agg=agg, n_agg=n_agg)
        P._implicit_spec = spec
        R._implicit_spec = spec
        return P, R

    def coarse_operator(self, A: CSR, P, R, ctx: dict) -> CSR:
        from amgcl_tpu_torch.ops.stencil import (StencilTransfer,
                                                 stencil_coarse_operator)
        if isinstance(P, StencilTransfer):
            return stencil_coarse_operator(A, P)
        Ac = galerkin(A, P, R)
        g = ctx.pop("next_grid", None)
        if g is not None:
            # detect_grid_csr validates prod(dims) == nrows on read
            Ac._grid_dims = tuple(g)
        return Ac


def _filtered(A: CSR, eps_strong: float):
    """(A_f, D_f⁻¹): strength-filtered matrix and its inverted diagonal.
    Weak off-diagonal entries are removed and added to the diagonal."""
    d = np.abs(A.diagonal())
    rows = A.expanded_rows()
    strong = (np.abs(A.val) ** 2 > eps_strong ** 2 * d[rows] * d[A.col]) \
        | (rows == A.col)
    weak = ~strong
    removed_sum = np.bincount(
        rows[weak], weights=A.val[weak], minlength=A.nrows
    ).astype(A.val.dtype)
    Af = A.filter_rows(strong)
    dia_mask = Af.expanded_rows() == Af.col
    Af.val = Af.val.copy()
    Af.val[dia_mask] += removed_sum[Af.col[dia_mask]]
    return Af, Af.diagonal(invert=True)


def _p_smooth(Pt: CSR, DA: CSR, omega: float) -> CSR:
    """P = Pt − ω · DA @ Pt without forming I explicitly."""
    M = DA @ Pt
    M.val = M.val * (-omega)
    return Pt + M
