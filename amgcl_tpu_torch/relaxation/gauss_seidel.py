"""Multicolour Gauss–Seidel (counterpart of
``amgcl_tpu/relaxation/gauss_seidel.py``).

The reference orders Gauss–Seidel by level scheduling over dependency
levels (amgcl/relaxation/gauss_seidel.hpp:57-395), which serializes on
the longest chain. Here rows are split into independent colour classes
on the host (iterated Luby MIS rounds over the adjacency graph) and a
sweep updates one colour at a time: row i of colour c takes
x_i + dinv_i (f − A x)_i, a scaled-residual correction with the colour's
pre-scaled mask as w, so each colour is one pass of the level operator's
correction kernel. The masks are (ncolors, n): the fused V-cycle legs,
which take one scale vector, decline them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from amgcl_tpu_torch.coarsening.aggregates import _luby_mis, _priority
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.relaxation.base import state_bytes


def greedy_coloring(m: sp.csr_matrix, max_colors: int = 64) -> np.ndarray:
    """Distance-1 colouring by iterated Luby MIS rounds: colour c is an
    MIS of the nodes still uncoloured (at most max degree + 1 colours)."""
    n = m.shape[0]
    adj = (m + m.T).tocsr()
    adj.setdiag(0)
    adj.eliminate_zeros()
    adj = (adj != 0).astype(np.int8)
    prio = _priority(n)
    color = np.full(n, -1, dtype=np.int64)
    for c in range(max_colors):
        und = color < 0
        if not und.any():
            break
        color[_luby_mis(adj, und, prio)] = c
    if (color < 0).any():
        raise RuntimeError("coloring failed within %d colors" % max_colors)
    return color


class MulticolorGS:
    """masks: (ncolors, n) pre-scaled colour masks, dinv_i on colour c's
    rows and 0 elsewhere."""

    def __init__(self, masks):
        self.masks = masks

    def _sweep(self, A, f, x, order):
        for c in order:
            w = self.masks[c]
            got = dev.scaled_correction(A, w, f, x)
            x = got if got is not None \
                else x + w * dev.residual(f, A, x)
        return x

    def apply_pre(self, A, f, x):
        return self._sweep(A, f, x, range(self.masks.shape[0]))

    def apply_post(self, A, f, x):
        return self._sweep(A, f, x, range(self.masks.shape[0] - 1, -1, -1))

    def apply(self, A, f):
        return self.apply_pre(A, f, torch.zeros_like(f))

    def bytes(self) -> int:
        return state_bytes(self.masks)


@dataclass
class GaussSeidel:
    serial: bool = False   # the reference's parameter; the sweep is the same

    def build(self, A: CSR, dtype, device) -> MulticolorGS:
        S = A.unblock() if A.is_block else A
        color = greedy_coloring(S.to_scipy())
        masks = np.zeros((int(color.max()) + 1, S.nrows))
        masks[color, np.arange(S.nrows)] = S.diagonal(invert=True)
        return MulticolorGS(torch.as_tensor(masks, device=device).to(dtype))
