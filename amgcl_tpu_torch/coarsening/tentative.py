"""Tentative prolongation from aggregates, with an optional
near-nullspace (counterpart of ``amgcl_tpu/coarsening/tentative.py``;
reference: amgcl/coarsening/tentative_prolongation.hpp:61-233, QR at
amgcl/detail/qr.hpp:114-268).

Without a nullspace P is piecewise constant over aggregates (identity
blocks for block systems, unknown ``i·b + c`` aggregated into
``agg[i]·b + c``). With one, each aggregate's rows of the nullspace are
orthonormalized by a QR (one batched numpy QR over the aggregates padded
to the largest, the sign fixed so that diag(R) ≥ 0), Q fills P and the R
factors become the coarse level's nullspace.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amgcl_tpu_torch.coarsening.stall import CoarseningStall
from amgcl_tpu_torch.ops.csr import CSR


def tentative_prolongation(n: int, agg: np.ndarray, n_agg: int,
                           nullspace=None, block_size: int = 1):
    """(P, coarse nullspace or None). ``agg``: the aggregate of each node
    (block units), -1 for none; ``nullspace``: (n·block_size, nvec)
    near-nullspace vectors, giving P nvec columns an aggregate and the
    coarse level a (n_agg·nvec, nvec) nullspace."""
    if nullspace is None:
        rows = np.flatnonzero(agg >= 0)
        if block_size == 1:
            P = sp.csr_matrix((np.ones(len(rows)), (rows, agg[rows])),
                              shape=(n, n_agg))
            P.sort_indices()
            return CSR.from_scipy(P), None
        b = block_size
        srows = (rows[:, None] * b + np.arange(b)).ravel()
        scols = (agg[rows][:, None] * b + np.arange(b)).ravel()
        P = sp.csr_matrix((np.ones(len(srows)), (srows, scols)),
                          shape=(n * b, n_agg * b))
        P.sort_indices()
        return CSR.from_scipy(P).to_block(b), None

    B = np.asarray(nullspace, dtype=np.float64)
    nvec = B.shape[1]
    ns = n * block_size
    if B.shape[0] != ns:
        raise ValueError("nullspace has %d rows; the level has %d unknowns"
                         % (B.shape[0], ns))
    sagg = np.repeat(agg, block_size)
    order = np.argsort(sagg, kind="stable")
    order = order[sagg[order] >= 0]
    gagg = sagg[order]
    counts = np.bincount(gagg, minlength=n_agg)
    if n_agg and int(counts.min()) < nvec:
        # a rank-deficient QR: close the hierarchy at the level before,
        # as the JAX package does
        raise CoarseningStall(
            "aggregate of size %d is smaller than the nullspace dimension "
            "%d; coarsen more aggressively (larger eps_strong) or reduce "
            "the nullspace" % (int(counts.min()), nvec))
    maxsz = int(counts.max()) if n_agg else 0
    pos_in_agg = np.arange(len(order)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    batch = np.zeros((n_agg, maxsz, nvec))
    batch[gagg, pos_in_agg] = B[order]
    Q, R = np.linalg.qr(batch)
    sgn = np.sign(np.einsum("aii->ai", R))
    sgn = np.where(sgn == 0, 1.0, sgn)
    Q = Q * sgn[:, None, :]
    R = R * sgn[:, :, None]
    prow = np.repeat(order, nvec)
    pcol = (gagg[:, None] * nvec + np.arange(nvec)).ravel()
    P = sp.csr_matrix((Q[gagg, pos_in_agg].ravel(), (prow, pcol)),
                      shape=(ns, n_agg * nvec))
    P.eliminate_zeros()
    P.sort_indices()
    return CSR.from_scipy(P), R.reshape(n_agg * nvec, nvec)
