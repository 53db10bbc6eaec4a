"""CPR — constrained pressure residual preconditioner for reservoir-type
block systems (counterpart of ``amgcl_tpu/models/cpr.py``; reference:
amgcl/preconditioner/cpr.hpp:45-561, the DRS variant
amgcl/preconditioner/cpr_drs.hpp).

Two-stage apply on a cell-block system (pressure is unknown 0 of each
b-sized cell block):

  1. pressure stage: restrict the residual with per-cell decoupling
     weights (quasi-IMPES: first row of each diagonal block's inverse;
     DRS: dynamic row-sum weights), solve the extracted pressure matrix
     App with AMG, prolong the correction into the pressure slots;
  2. global stage: one application of a global smoother (block SPAI-0 by
     default) on the full system.

The full system moves to the device as block ELL, whose product is a
plain gather in both packages (the JAX one is XLA, not Pallas); the
pressure AMG runs through the level kernels.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from amgcl_tpu_torch.models.amg import (AMG, AMGParams, apply_columns,
                                        check_dtype)
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.relaxation.spai0 import Spai0
from amgcl_tpu_torch.utils.devices import resolve_device


class CPRHierarchy:
    def __init__(self, A_full, W, p_hier, smoother, block, np_cells=None):
        self.A_full = A_full
        self.W = W               # (np_cells, b) decoupling weights
        self.p_hier = p_hier
        self.smoother = smoother
        self.block = int(block)
        # the pressure stage covers the leading np_cells cells only
        # (params.active_rows, cpr.hpp:194: trailing rows, e.g. appended
        # well equations, see only the global stage)
        self.np_cells = None if np_cells is None else int(np_cells)

    def apply(self, r):
        if r.dim() == 2:
            return apply_columns(self.apply, r)
        b = self.block
        rb = r.reshape(-1, b)
        npc = rb.shape[0] if self.np_cells is None else self.np_cells
        rp = torch.einsum("nb,nb->n", self.W, rb[:npc])
        # the pressure hierarchy may hold another dtype than the system
        dp = self.p_hier.apply(rp.to(self.p_hier.system_matrix.dtype))
        x = torch.zeros_like(rb)
        x[:npc, 0] = dp
        x = x.reshape(r.shape)
        # global smoothing of the remaining residual
        s = self.smoother.apply(self.A_full, dev.residual(r, self.A_full, x))
        return x + s

    @property
    def system_matrix(self):
        return self.A_full


def _pressure_matrix(A: CSR, W: np.ndarray, np_cells=None) -> CSR:
    """App_ij = w_i · A_ij[:, 0] over the block pattern, restricted to the
    leading ``np_cells`` cells when active_rows limits the pressure
    system (cpr.hpp:194-253: columns beyond N are skipped)."""
    if np_cells is None or np_cells == A.nrows:
        app = np.einsum("eb,eb->e", W[A.expanded_rows()], A.val[:, :, 0])
        return CSR(A.ptr.copy(), A.col.copy(), app, A.ncols)
    rows = A.expanded_rows()
    sel = (rows < np_cells) & (A.col < np_cells)
    r = rows[sel]
    c = A.col[sel]
    app = np.einsum("eb,eb->e", W[r], A.val[sel][:, :, 0])
    ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(r, minlength=np_cells))])
    return CSR(ptr.astype(np.int64), c.astype(np.int32), app, np_cells)


class CPR:
    """make_solver-compatible preconditioner; ``A`` is a block CSR (or a
    scalar CSR plus ``block_size``). ``active_rows`` (scalar rows, a
    multiple of the block size) limits the pressure stage to the leading
    sub-block — the reference's params.active_rows for systems with
    trailing non-reservoir equations (cpr.hpp:85-106). ``device`` and
    ``device_setup`` as for :class:`AMG` (the pressure hierarchy)."""

    weighting = "quasi_impes"

    def __init__(self, A, block_size: Optional[int] = None,
                 pressure_prm: Optional[AMGParams] = None,
                 relax: Any = None, dtype=torch.float32,
                 active_rows: int = 0, device=None, device_setup=None,
                 **wkw):
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        if not A.is_block:
            if not block_size or block_size < 2:
                raise ValueError("CPR needs a block system (block_size >= 2)")
            A = A.to_block(block_size)
        self.A_host = A
        self.dtype = check_dtype(dtype)
        self.device = resolve_device(device)
        b = A.block_size[0]
        if active_rows:
            if active_rows % b:
                raise ValueError(
                    "active_rows=%d is not a multiple of the block size %d"
                    % (active_rows, b))
            np_cells = active_rows // b
            if not 0 < np_cells <= A.nrows:
                raise ValueError("active_rows out of range")
        else:
            np_cells = A.nrows
        self.np_cells = np_cells
        self._wkw = dict(wkw)
        self._relax = relax or Spai0()
        W = self._weights(A, np_cells=np_cells, **wkw)
        pprm = pressure_prm or AMGParams(dtype=dtype)
        self.p_amg = AMG(_pressure_matrix(A, W, np_cells), pprm,
                         self.device, device_setup)
        self.hierarchy = CPRHierarchy(
            dev.to_device(A, "ell", dtype, self.device),
            torch.as_tensor(W, device=self.device).to(dtype),
            self.p_amg.hierarchy, self._relax.build(A, dtype, self.device),
            b, None if np_cells == A.nrows else np_cells)

    def partial_update(self, A, update_transfer_ops: bool = True):
        """Time-dependent resimulation fast path (reference:
        cpr.hpp:159-186 ``partial_update``): the matrix values changed,
        the structure did not. The global-stage smoother is always
        rebuilt; ``update_transfer_ops`` also refreshes the decoupling
        weights and the pressure hierarchy (through ``AMG.rebuild``)."""
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        if not A.is_block:
            b0 = self.A_host.block_size[0]
            if A.nrows % b0 or A.ncols % b0:
                raise ValueError(
                    "partial_update: scalar matrix shape %s is not a "
                    "multiple of the original block size %d, so it cannot "
                    "be re-blocked to match" % (A.shape, b0))
            A = A.to_block(b0)
        if (A.shape != self.A_host.shape
                or A.block_size != self.A_host.block_size
                or not np.array_equal(A.ptr, self.A_host.ptr)
                or not np.array_equal(A.col, self.A_host.col)):
            raise ValueError(
                "partial_update requires the same structure "
                "(dimensions, block size and sparsity pattern)")
        h = self.hierarchy
        A_dev = dev.to_device(A, "ell", self.dtype, self.device)
        smoother = self._relax.build(A, self.dtype, self.device)
        p_hier = h.p_hier
        W_dev = h.W
        if update_transfer_ops:
            W = self._weights(A, np_cells=self.np_cells, **self._wkw)
            W_dev = torch.as_tensor(W, device=self.device).to(self.dtype)
            # last fallible step: the in-place p_amg rebuild
            self.p_amg.rebuild(_pressure_matrix(A, W, self.np_cells))
            p_hier = self.p_amg.hierarchy
        self.A_host = A
        self.hierarchy = CPRHierarchy(
            A_dev, W_dev, p_hier, smoother, A.block_size[0], h.np_cells)

    # make_solver.rebuild's seam: CPR's structure-reusing refresh is its
    # rebuild (reference: make_solver owning amg::rebuild)
    rebuild = partial_update

    @staticmethod
    def _weights(A: CSR, np_cells=None, **kw) -> np.ndarray:
        """Quasi-IMPES: first row of each diagonal block's inverse,
        restricted to the active cells before inverting — trailing
        (inactive) well or constraint blocks may be singular, and the
        reference never forms weights for them (cpr.hpp:194)."""
        dia = A.diagonal()
        if np_cells is not None:
            dia = dia[:np_cells]
        return np.linalg.inv(dia)[:, 0, :]

    def __repr__(self):
        return "cpr(%s)\n[ P ]\n%r" % (self.weighting, self.p_amg)


class CPRDRS(CPR):
    """CPR with dynamic row-sum weights (reference: cpr_drs.hpp:240-320):
    the pressure equation is a delta-weighted sum of the cell's
    equations. Per cell, equation i > 0 contributes (delta=1) unless
    either test fails:

    - **diagonal dominance** (``eps_dd``): its own-cell pressure coupling
      a_dia[i] falls below eps_dd × the sum of its off-cell pressure
      couplings;
    - **pressure sum** (``eps_ps``): the pressure equation's total
      coupling to unknown i falls below eps_ps × |a_dia[0]|.

    User ``weights`` (length active scalar rows) scale every delta,
    including the pressure equation's own."""

    weighting = "drs"

    @staticmethod
    def _weights(A: CSR, eps_dd: float = 0.2, eps_ps: float = 0.02,
                 weights=None, np_cells=None, **kw) -> np.ndarray:
        b = A.block_size[0]
        n = A.nrows if np_cells is None else int(np_cells)
        rows = A.expanded_rows()
        sel = slice(None) if n == A.nrows else (rows < n) & (A.col < n)
        r = rows[sel]
        c = A.col[sel]
        V = A.val[sel]
        dia = r == c
        # a_dia[i]: signed own-cell pressure coupling of equation i;
        # a_off[i]: sum |off-cell pressure couplings| of equation i;
        # a_top[c]: the pressure equation's total |coupling| to unknown c
        # (cpr_drs.hpp:248-290)
        a_dia = np.zeros((n, b))
        a_dia[r[dia]] = V[dia][:, :, 0].real
        a_off = np.zeros((n, b))
        np.add.at(a_off, r[~dia], np.abs(V[~dia][:, :, 0]))
        a_top = np.zeros((n, b))
        np.add.at(a_top, r, np.abs(V[:, 0, :]))
        delta = np.ones((n, b))
        if weights is not None:
            w = np.asarray(weights, dtype=np.float64).ravel()
            if w.size != n * b:
                raise ValueError(
                    "weights must have one entry per active scalar row "
                    "(%d); got %d" % (n * b, w.size))
            delta = delta * w.reshape(n, b)
        drop = np.zeros((n, b), dtype=bool)
        drop[:, 1:] |= a_dia[:, 1:] < eps_dd * a_off[:, 1:]
        drop[:, 1:] |= a_top[:, 1:] < eps_ps * np.abs(a_dia[:, :1])
        delta[drop] = 0.0
        return delta
