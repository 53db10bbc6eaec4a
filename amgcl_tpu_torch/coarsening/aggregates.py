"""Aggregates over the strength graph (counterpart of the host path of
``amgcl_tpu/coarsening/aggregates.py``).

The JAX package's host route aggregates with a greedy distance-2 pass —
the reference's own algorithm (amgcl/coarsening/plain_aggregates.hpp:
63-213), run there by the native setup library
(``csrc/setup_kernels.cpp::aggregate_d2``). This is the same pass in
numpy: the scan over candidate roots is sequential, and each root's
claims are vectorized over its neighbourhood.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amgcl_tpu_torch.ops.csr import CSR

_UNSET = -3


def strength_graph(A: CSR, eps_strong: float) -> sp.csr_matrix:
    """Symmetric strong-connection graph: (i, j) is strong iff
    ``|a_ij|² > eps² · |a_ii · a_jj|`` (plain_aggregates.hpp:122-136),
    diagonal removed, symmetrized."""
    d = np.abs(A.diagonal())
    rows = A.expanded_rows()
    strong = (np.abs(A.val) ** 2 > eps_strong ** 2 * d[rows] * d[A.col]) \
        & (rows != A.col)
    # copies: eliminate_zeros() compacts in place and must not alias A
    S = sp.csr_matrix((strong.astype(np.int8), A.col.copy(), A.ptr.copy()),
                      shape=A.shape)
    S.eliminate_zeros()
    S = ((S + S.T) > 0).astype(np.int8)
    S.sort_indices()
    return S


def greedy_aggregates(S: sp.csr_matrix):
    """Greedy distance-2 aggregation over the strength graph S.

    Rows are scanned in order; an unclaimed row with a strong neighbour
    becomes a root, its unassigned strong neighbours join it, and their
    unassigned strong neighbours are claimed tentatively (a tentative
    claim keeps a row from becoming a root; rows still unassigned at the
    end join their claimant). Returns ``(agg, n_agg)``; ``agg[i] == -1``
    flags isolated rows."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    deg = np.diff(indptr)
    agg = np.where(deg > 0, _UNSET, -1).astype(np.int64)
    owner = np.full(n, _UNSET, dtype=np.int64)
    count = 0
    for i in range(n):
        if agg[i] != _UNSET or owner[i] != _UNSET:
            continue
        agg[i] = count
        nbr = indices[indptr[i]:indptr[i + 1]]
        new = nbr[agg[nbr] == _UNSET]
        agg[new] = count
        if len(new):
            # strong neighbours of the rows just finalized
            starts, lens = indptr[new], deg[new]
            offs = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens,
                                                     lens)
            cc = indices[np.repeat(starts, lens) + offs]
            cc = cc[(agg[cc] == _UNSET) & (owner[cc] == _UNSET)]
            owner[cc] = count
        count += 1
    # leftover tentatives join their claimant
    agg = np.where(agg == _UNSET, np.where(owner == _UNSET, -1, owner), agg)
    return agg, count


def plain_aggregates(A: CSR, eps_strong: float = 0.08):
    """Aggregates over the scalar strength graph of A (reference default
    eps_strong = 0.08)."""
    return greedy_aggregates(strength_graph(A, eps_strong))
