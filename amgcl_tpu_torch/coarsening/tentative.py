"""Tentative prolongation from aggregates (counterpart of
``amgcl_tpu/coarsening/tentative.py`` without a near-nullspace):
piecewise constant over aggregates (reference:
amgcl/coarsening/tentative_prolongation.hpp:61-233). A block system's
identity blocks are this P over its scalar unknowns, with unknown
``i·b + c`` aggregated into ``agg[i]·b + c``."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amgcl_tpu_torch.ops.csr import CSR


def tentative_prolongation(n: int, agg: np.ndarray, n_agg: int) -> CSR:
    """P with one unit entry per aggregated row (``agg[i] == -1`` rows
    are excluded)."""
    rows = np.flatnonzero(agg >= 0)
    P = sp.csr_matrix((np.ones(len(rows)), (rows, agg[rows])),
                      shape=(n, n_agg))
    P.sort_indices()
    return CSR.from_scipy(P)
