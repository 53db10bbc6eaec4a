"""Distance-2 MIS aggregation on the device.

Counterpart of ``amgcl_tpu/coarsening/device_mis.py`` (reference:
amgcl/mpi/coarsening/pmis.hpp:49-1131, reformulated). The whole
algorithm is max-plus propagation over the strength graph: a node's
aggregate is named by its root's (unique) priority, and every step —
root election, distance-1 capture, distance-2 capture — is one or two
row maxima over an ELL adjacency. Priorities and keys are int32, so
the max-plus algebra is exact, and a fixed number of rounds runs the
same way on every device. The JAX package pads the operands to
power-of-two shape buckets to bound its jit signatures; padded rows
never win or capture, so the port packs the graph at its own size and
gets the same aggregates.
"""

from __future__ import annotations

import numpy as np
import torch

from amgcl_tpu_torch.ops.csr import CSR


def _ell_row_max(cols, valid, x):
    """max_k x[cols[:, k]] over the valid slots of each row (0 on a row
    without one)."""
    g = x[cols]
    return torch.where(valid, g, torch.zeros((), dtype=g.dtype,
                                             device=g.device)).amax(dim=1)


def device_aggregates(cols, valid, prio, rounds: int = 40):
    """Distance-2 MIS aggregation of the ELL adjacency ``cols``/``valid``
    (n, K) of a symmetric strength graph, with unique positive int32
    priorities ``prio`` (n,), all on their device. Returns (key,
    assigned): ``key[i]`` is the root priority of i's aggregate, 0 for an
    isolated row."""
    prio = prio.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=prio.device)
    und = valid.any(dim=1)
    key = torch.zeros_like(prio)
    for _ in range(rounds):
        p_und = torch.where(und, prio, zero)
        # the closed two-hop maximum of undecided priorities equals a
        # node's own priority exactly when it wins (its priority comes
        # back through its neighbours)
        m1 = _ell_row_max(cols, valid, p_und)
        m2 = torch.maximum(
            _ell_row_max(cols, valid, torch.maximum(m1, p_und)), m1)
        winners = und & (prio >= m2)
        key = torch.where(winners, prio, key)
        # distance 1: the best adjacent new root
        w1 = _ell_row_max(cols, valid, torch.where(winners, prio, zero))
        d1 = und & ~winners & (w1 > 0)
        key = torch.where(d1, w1, key)
        # distance 2: the key of the captured neighbour of highest
        # priority (unique priorities make it unique)
        cap = winners | d1
        kcap = torch.where(cap, key, zero)
        pcap = torch.where(cap, prio, zero)
        best_p = _ell_row_max(cols, valid, pcap)
        pg = pcap[cols]
        kg = kcap[cols]
        hit = valid & (pg > 0) & (pg == best_p[:, None])
        k2 = torch.where(hit, kg, zero).amax(dim=1)
        d2 = und & ~cap & (best_p > 0)
        key = torch.where(d2, k2, key)
        und = und & ~(winners | d1 | d2)
    # leftovers (pathological fragments) become their own roots
    key = torch.where(und, prio, key)
    return key, key > 0


def strength_ell(S):
    """(cols, valid) int32/bool (n, K) ELL arrays of the scipy CSR
    adjacency ``S``, K its widest row (at least 1)."""
    n = S.shape[0]
    nnz_row = np.diff(S.indptr)
    K = max(int(nnz_row.max()) if n else 1, 1)
    cols = np.zeros((n, K), dtype=np.int32)
    valid = np.zeros((n, K), dtype=bool)
    rows = np.repeat(np.arange(n), nnz_row)
    pos = np.arange(S.nnz) - S.indptr[rows]
    cols[rows, pos] = S.indices
    valid[rows, pos] = True
    return cols, valid


def aggregates_on_device(A: CSR, eps_strong: float = 0.08, device="cpu",
                         rounds: int = 40):
    """Host strength graph → MIS on ``device`` → ``(agg, n_agg)`` in the
    host convention (−1 for isolated rows). Real rows keep exactly the
    host ``_priority(n)`` values."""
    from amgcl_tpu_torch.coarsening.aggregates import (_priority,
                                                       strength_graph)
    from amgcl_tpu_torch.telemetry.tracing import setup_substage
    with setup_substage("strength_graph"):
        S = strength_graph(A, eps_strong)
    n = S.shape[0]
    with setup_substage("mis_pack"):
        cols, valid = strength_ell(S)
        prio = _priority(n).astype(np.int32)
    with setup_substage("device_mis"):
        key, _ = device_aggregates(
            torch.as_tensor(cols, dtype=torch.int64, device=device),
            torch.as_tensor(valid, device=device),
            torch.as_tensor(prio, device=device), rounds)
        key = key.cpu().numpy()
    agg = np.full(n, -1, dtype=np.int64)
    live = key > 0
    uniq, inv = np.unique(key[live], return_inverse=True)
    agg[live] = inv
    return agg, len(uniq)
