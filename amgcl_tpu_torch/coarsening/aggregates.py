"""Aggregates over the strength graph (counterpart of
``amgcl_tpu/coarsening/aggregates.py``).

A build whose setup runs on the device aggregates with the distance-2
MIS rounds of :mod:`~amgcl_tpu_torch.coarsening.device_mis`, as the JAX
package does on an accelerator; a host build takes the greedy pass
below.

The host route aggregates with a greedy distance-2 pass — the
reference's own algorithm (amgcl/coarsening/plain_aggregates.hpp:
63-213) — in the native set-up library
(``csrc/setup_kernels.cpp::aggregate_d2``, through
:func:`amgcl_tpu_torch.native.native_aggregates`), as the JAX package's
does. :func:`greedy_aggregates` is the same pass in numpy, for a machine
without ``g++``: the scan over candidate roots is sequential, and each
root's claims are vectorized over its neighbourhood.

The distance-2 maximal-independent-set formulation of the JAX package's
numpy route (:func:`mis_aggregates`, reference:
amgcl/mpi/coarsening/pmis.hpp:49-1131) is here too: its Luby rounds
colour the graph for multicolour Gauss–Seidel and split C/F points for
Ruge–Stüben's PMIS.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amgcl_tpu_torch.ops.csr import CSR, pointwise_matrix

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


def _priority(n: int) -> np.ndarray:
    """A unique pseudo-random priority per node (a seeded permutation of
    1..n): small integers, exact in float64, so that a row maximum
    identifies its argmax."""
    return (np.random.RandomState(7919).permutation(n) + 1).astype(
        np.float64)


def _row_max(indptr: np.ndarray, indices: np.ndarray,
             score: np.ndarray) -> np.ndarray:
    """Per-row max of score[col] over a CSR pattern (0 on empty rows)."""
    n = len(indptr) - 1
    out = np.zeros(n, dtype=score.dtype)
    nonempty = indptr[:-1] < indptr[1:]
    if nonempty.any():
        out[nonempty] = np.maximum.reduceat(score[indices],
                                            indptr[:-1][nonempty])
    return out


def _luby_mis(S2: sp.csr_matrix, active: np.ndarray, prio: np.ndarray,
              max_rounds: int = 1000) -> np.ndarray:
    """Maximal independent set of S2 over the ``active`` nodes: Luby
    rounds in which an undecided node whose priority beats every
    undecided neighbour's joins, and its neighbourhood leaves the pool."""
    und = active.copy()
    in_set = np.zeros(S2.shape[0], dtype=bool)
    indptr, indices = S2.indptr, S2.indices
    for _ in range(max_rounds):
        if not und.any():
            break
        nbr_max = _row_max(indptr, indices, np.where(und, prio, 0.0))
        winners = und & (prio > nbr_max)
        in_set |= winners
        covered = _row_max(indptr, indices,
                           winners.astype(np.float64)) > 0
        und &= ~(winners | covered)
    return in_set


def mis_aggregates(S: sp.csr_matrix, max_rounds: int = 1000):
    """Aggregates from a distance-2 MIS over the strength graph S: roots
    are an MIS of S + S² (no two within distance 2), their strong
    neighbours join them, and the rest join their highest-priority
    assigned neighbour (two sweeps); an active node left over becomes an
    aggregate of its own. Returns ``(agg, n_agg)``, ``agg[i] == -1`` for
    isolated rows."""
    n = S.shape[0]
    prio = _priority(n)
    active = np.diff(S.indptr) > 0
    S2 = ((S + S @ S) > 0).astype(np.int8)
    S2.setdiag(0)
    S2.eliminate_zeros()
    roots = _luby_mis(S2, active, prio, max_rounds)
    root_of = np.full(n, -1, dtype=np.int64)
    root_of[roots] = np.flatnonzero(roots)
    rows_all = np.repeat(np.arange(n), np.diff(S.indptr))

    # distance 1: the adjacent root (unique: roots are S2-independent)
    p_root = np.where(roots, prio, 0.0)
    nbr_root_max = _row_max(S.indptr, S.indices, p_root)
    d1 = active & ~roots & (nbr_root_max > 0)
    sc = p_root[S.indices]
    match = d1[rows_all] & (sc > 0) & (sc == nbr_root_max[rows_all])
    root_of[rows_all[match]] = S.indices[match]

    # distance 2: the highest-priority assigned neighbour's aggregate
    assigned = root_of >= 0
    for _ in range(2):
        todo = active & ~assigned
        if not todo.any():
            break
        p_asgn = np.where(assigned, prio, 0.0)
        nbr_max = _row_max(S.indptr, S.indices, p_asgn)
        join = todo & (nbr_max > 0)
        sc = p_asgn[S.indices]
        match = join[rows_all] & (sc > 0) & (sc == nbr_max[rows_all])
        root_of[rows_all[match]] = root_of[S.indices[match]]
        assigned = root_of >= 0

    left = active & (root_of < 0)
    root_of[left] = np.flatnonzero(left)
    roots = roots | left
    root_nodes = np.flatnonzero(roots)
    agg_id = np.full(n, -1, dtype=np.int64)
    agg_id[root_nodes] = np.arange(len(root_nodes))
    agg = np.full(n, -1, dtype=np.int64)
    agg[root_of >= 0] = agg_id[root_of[root_of >= 0]]
    return agg, len(root_nodes)


def plain_aggregates(A: CSR, eps_strong: float = 0.08, device=None):
    """Aggregates over the scalar strength graph of A (reference default
    eps_strong = 0.08): the distance-2 MIS rounds of
    :mod:`~amgcl_tpu_torch.coarsening.device_mis` on ``device`` when the
    build's setup runs there (the JAX package's default on an
    accelerator, amgcl_tpu/coarsening/aggregates.py:160-182), else the
    greedy pass on the host (``device=None``): native, or numpy without
    the library."""
    if device is not None:
        from amgcl_tpu_torch.coarsening.device_mis import \
            aggregates_on_device
        return aggregates_on_device(A, eps_strong, device)
    from amgcl_tpu_torch.native import native_aggregates
    got = native_aggregates(A, eps_strong)
    if got is not None:
        return got
    return greedy_aggregates(strength_graph(A, eps_strong))


def pointwise_aggregates(A: CSR, eps_strong: float = 0.08,
                         block_size: int = 1, device=None):
    """Aggregates of a block system over its pointwise matrix, one value
    per block (amgcl/coarsening/pointwise_aggregates.hpp:54-197;
    counterpart of ``amgcl_tpu/coarsening/aggregates.py::
    pointwise_aggregates``): a BCSR, or a scalar matrix with
    ``block_size``² blocks. ``agg`` indexes block rows; ``device`` as
    :func:`plain_aggregates`."""
    if block_size == 1 and not A.is_block:
        return plain_aggregates(A, eps_strong, device)
    b = A.block_size[0] if A.is_block else block_size
    return plain_aggregates(pointwise_matrix(A, b), eps_strong, device)
