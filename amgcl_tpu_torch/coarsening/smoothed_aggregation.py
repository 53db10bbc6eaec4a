"""Smoothed aggregation coarsening (Vaněk SA), host route.

Counterpart of ``amgcl_tpu/coarsening/smoothed_aggregation.py`` on the
route its CPU backend takes. P = (I − ω D_f⁻¹ A_f) · P_tent, where A_f
is the strength-filtered matrix (weak off-diagonal entries lumped onto the
diagonal) and ω = relax · 4/3 / ρ(D_f⁻¹ A_f), ρ the Gershgorin bound or
``power_iters`` power iterations
(reference: amgcl/coarsening/smoothed_aggregation.hpp:55-243).
``eps_strong`` is halved per level as in the reference.

Stencil levels (at most 13 diagonals on a detected grid) build their
transfers on diagonals (ops/stencil.py); other scalar levels take the CSR
route: strength filter → grid-aligned (or greedy) aggregates →
tentative P and its smoothing → explicit Galerkin product. Either way the
device applies the transfers matrix-free through an implicit spec
(ops/structured.py), unless ``implicit_transfers`` is off or a
near-nullspace is given: then P and R are stored. A block matrix (BCSR)
filters and smooths in scalars, aggregates its pointwise matrix, and
returns P and R as BCSR: the device stores them as block operators.
``nullspace`` (with :func:`~amgcl_tpu_torch.coarsening.rigid_body_modes.
rigid_body_modes`) orthonormalizes the near-nullspace over each
aggregate (``coarsening/tentative.py``). A build whose setup runs on
the device (``ctx["setup_device"]``) aggregates with the device MIS and,
on a scalar level without a nullspace, smooths P through a segment-sum
plan (``ops/segment_spgemm.py``, amgcl_tpu/coarsening/
smoothed_aggregation.py:120-133) whose pattern keeps the identity's and
A_f's entries where their values cancel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from amgcl_tpu_torch.ops.csr import CSR, spectral_radius
from amgcl_tpu_torch.coarsening.aggregates import (plain_aggregates,
                                                   pointwise_aggregates)
from amgcl_tpu_torch.coarsening.tentative import tentative_prolongation
from amgcl_tpu_torch.coarsening.galerkin import galerkin
from amgcl_tpu_torch.coarsening.stall import CoarseningStall
from amgcl_tpu_torch.ops.segment_spgemm import SmoothPlan


@dataclass
class SmoothedAggregation:
    """Policy object: ``transfer_operators`` / ``coarse_operator``."""
    eps_strong: float = 0.08
    relax: float = 1.0
    power_iters: int = 0          # 0: the Gershgorin bound
    block_size: int = 1           # pointwise aggregation of a scalar matrix
    nullspace: Optional[np.ndarray] = None   # (n_scalar, nvec)
    #: an aggregation in place of the greedy pass:
    #: ``(scalar_csr, eps) -> (agg, n_agg)``
    aggregator: Any = None
    structured: bool = True       # detect grids, aggregate along them
    implicit_transfers: bool = True   # apply P and R matrix-free
    stencil_setup: bool = True    # build grid levels on diagonals
    setup_dtype: Any = None       # dtype of the stencil setup algebra

    def transfer_operators(self, A: CSR, ctx: dict):
        """``ctx`` carries per-build state across levels (eps_strong
        decay, the coarse nullspace, the stencil setup dtype, the next
        level's grid dims); the policy object itself is never mutated."""
        eps_strong = ctx.get("eps_strong", self.eps_strong)
        nullspace = ctx.get("nullspace", self.nullspace)
        setup_dtype = ctx.get("setup_dtype", self.setup_dtype)
        setup_device = ctx.get("setup_device")
        if A.is_block and nullspace is not None:
            raise NotImplementedError(
                "near-nullspace with block value types is not supported; "
                "use a scalar matrix (as the reference does via "
                "coarsening::as_scalar): the smoothed P has n_agg*nvec "
                "columns, which do not tile into the block structure")
        scalar = A.unblock() if A.is_block else A
        bs = A.block_size[0] if A.is_block else self.block_size
        ctx["eps_strong"] = eps_strong * 0.5
        plain_scalar = (bs == 1 and not A.is_block and nullspace is None
                        and self.aggregator is None)
        if (self.stencil_setup and self.structured
                and self.implicit_transfers and plain_scalar):
            from amgcl_tpu_torch.ops.structured import detect_grid_csr
            grid = detect_grid_csr(scalar)
            if grid is not None:
                from amgcl_tpu_torch.ops.stencil import \
                    stencil_transfer_operators
                got = stencil_transfer_operators(
                    scalar, grid, eps_strong, self.relax, self.power_iters,
                    setup_dtype)
                if got is not None:
                    return got
        # the filtered matrix smooths P below and, computed first, decides
        # the strength-aware grid aggregation
        Af, Df_inv = _filtered(scalar, eps_strong)
        grid = None
        if self.structured and plain_scalar:
            from amgcl_tpu_torch.ops.structured import (detect_grid_csr,
                                                        strength_blocks)
            grid = detect_grid_csr(scalar)
            if grid is not None:
                # semicoarsen: aggregate only along strong axes; no
                # strong axis means the grid route would stall
                gblocks = strength_blocks(Af, grid)
                if gblocks is None:
                    grid = None
        if grid is not None:
            from amgcl_tpu_torch.ops.structured import grid_aggregates
            agg, n_agg, coarse_dims, blocks = grid_aggregates(grid, gblocks)
            n_pt = scalar.nrows
            ctx["next_grid"] = coarse_dims
        elif bs > 1:
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

        rho = spectral_radius(Af, self.power_iters, scale=True)
        omega = self.relax * (4.0 / 3.0) / max(rho, 1e-30)
        if setup_device is not None and nullspace is None and bs == 1 \
                and not A.is_block:
            # the tentative P is a selection over ``agg``: the smoothing
            # product is one segment pass over A_f keyed by
            # (row, agg[col])
            from amgcl_tpu_torch.telemetry.tracing import setup_substage
            with setup_substage("transfer_smooth"):
                P = SmoothPlan(Af, agg, n_agg).prolongation(
                    Af, Df_inv, omega, setup_device)
            Bc = None
        else:
            P_tent, Bc = tentative_prolongation(n_pt, agg, n_agg,
                                                nullspace, bs)
            Pt = P_tent.unblock() if P_tent.is_block else P_tent
            P = _p_smooth(Pt, Af.scale_rows(Df_inv), omega)
        R = P.transpose()
        if A.is_block:
            P = P.to_block(bs)
            R = R.to_block(bs)
        elif self.implicit_transfers and bs == 1 and nullspace is None:
            # the device applies P and R matrix-free through this spec
            M = CSR(Af.ptr, Af.col,
                    Af.val * (omega * Df_inv[Af.expanded_rows()]), Af.ncols)
            spec = {"M": M}
            if grid is not None:
                spec.update(fine=grid, block=blocks, coarse=coarse_dims)
            else:
                spec.update(agg=agg, n_agg=n_agg)
            P._implicit_spec = spec
            R._implicit_spec = spec
        ctx["nullspace"] = Bc
        return P, R

    def coarse_operator(self, A: CSR, P, R, ctx: dict) -> CSR:
        from amgcl_tpu_torch.ops.stencil import (StencilTransfer,
                                                 stencil_coarse_operator)
        if isinstance(P, StencilTransfer):
            return stencil_coarse_operator(A, P,
                                           device=ctx.get("setup_device"))
        Ac = galerkin(A, P, R, ctx.get("setup_device"))
        g = ctx.pop("next_grid", None)
        if g is not None:
            # detect_grid_csr validates prod(dims) == nrows on read
            Ac._grid_dims = tuple(g)
        return Ac


def _filtered(A: CSR, eps_strong: float):
    """(A_f, D_f⁻¹): strength-filtered matrix and its inverted diagonal.
    Weak off-diagonal entries are removed and added to the diagonal: in
    the native library for float64 and float32 values, else in numpy."""
    if A.dtype in (np.float64, np.float32):
        from amgcl_tpu_torch.native import native_filtered
        got = native_filtered(A, eps_strong)
        if got is not None:
            return CSR(got[0], got[1], got[2], A.ncols), got[3]
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
