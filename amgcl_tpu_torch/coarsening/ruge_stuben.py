"""Classic (Ruge-Stüben) coarsening: C/F splitting + direct interpolation
(counterpart of ``amgcl_tpu/coarsening/ruge_stuben.py``).

The reference implements the sequential RS pass with dynamic measures
(amgcl/coarsening/ruge_stuben.hpp:53-446, defaults eps_strong=0.25,
do_trunc=true, eps_trunc=0.2). Two splittings are provided:

- ``splitting='classic'`` (default): the reference's sequential
  dynamic-measure pass (cfsplit, ruge_stuben.hpp:316-446: pick
  max-lambda point as C, its dependents become F, lambdas resync) with
  the reference's exact direct interpolation incl. its truncation
  compensation (ruge_stuben.hpp:120-248). The split runs in the native
  set-up library (``rs_cfsplit``), as the JAX package's does, else as
  the same lazy-heap pass in Python, which gives the same split.
- ``splitting='pmis'``: De Sterck & Yang's parallel modified
  independent set — the same deterministic-priority MIS machinery as
  the aggregation path — with sign-split direct interpolation. The
  vectorizable choice, used where the split itself must be
  data-parallel.

Scalar values only, like the reference (ruge_stuben.hpp:445 static-asserts
non-block values). P and R are stored.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from amgcl_tpu_torch.coarsening.aggregates import _priority
from amgcl_tpu_torch.coarsening.galerkin import galerkin
from amgcl_tpu_torch.coarsening.stall import CoarseningStall
from amgcl_tpu_torch.ops.csr import CSR


def _strength_rs(A: CSR, eps: float):
    """Directed RS strength: i strongly depends on j when
    -a_ij >= eps * max_k(-a_ik); returns boolean mask per entry."""
    rows = A.expanded_rows()
    off = rows != A.col
    neg = np.where(off, -A.val.real, 0.0)
    rowmax = np.zeros(A.nrows)
    np.maximum.at(rowmax, rows, neg)
    strong = off & (neg >= eps * np.where(rowmax > 0, rowmax, np.inf)[rows])
    return strong, rows


def cf_splitting_pmis(A: CSR, strong: np.ndarray, rows: np.ndarray):
    """PMIS C/F split over the symmetrized strength graph. Returns bool
    is_coarse. F points with no strong C neighbor are promoted to C."""
    n = A.nrows
    # NB: copy col/ptr — scipy mutates them in place (eliminate_zeros)
    Ssym = sp.csr_matrix(
        (strong.astype(np.float64), A.col.copy(), A.ptr.copy()),
        shape=(n, n))
    Ssym.eliminate_zeros()
    Ssym = ((Ssym + Ssym.T) > 0).astype(np.float64)
    # measure: number of points that strongly depend on i (column count of
    # the directed strength graph) + deterministic jitter
    Sdir = sp.csr_matrix(
        (strong.astype(np.float64), A.col.copy(), A.ptr.copy()),
        shape=(n, n))
    lam = np.asarray(Sdir.sum(axis=0)).ravel()
    prio = lam * n + _priority(n)          # unique measures

    state = np.zeros(n, dtype=np.int8)     # 0 undecided, 1 C, 2 F
    isolated = np.asarray(Ssym.sum(axis=1)).ravel() == 0
    state[isolated] = 1                    # isolated rows become coarse
    for _ in range(1000):
        und = state == 0
        if not und.any():
            break
        p_und = np.where(und, prio, 0.0)
        nbr_max = Ssym.multiply(p_und[None, :]).max(axis=1).toarray().ravel()
        new_c = und & (prio > nbr_max)
        state[new_c] = 1
        nbr_c = np.asarray(
            Ssym @ (state == 1).astype(np.float64)).ravel() > 0
        state[(state == 0) & nbr_c] = 2
    # every F point must interpolate from at least one strong C neighbor
    is_c = state == 1
    c_nbr = np.zeros(n, dtype=bool)
    np.logical_or.at(c_nbr, rows[strong & is_c[A.col]], True)
    orphan = (state == 2) & ~c_nbr
    is_c |= orphan
    return is_c


def cf_splitting_classic(A: CSR, strong: np.ndarray, rows: np.ndarray):
    """The reference's sequential dynamic-measure split
    (ruge_stuben.hpp:316-446): repeatedly promote the undecided point
    with the largest lambda (number of points strongly depending on it,
    F-dependents counted twice) to C, demote its undecided dependents to
    F, and resync lambdas. Ties break by heap order rather than the
    C++ bucket arrangement: the smaller index first, in the native pass
    and the Python one alike."""
    import heapq

    n = A.nrows
    col = A.col
    ptr = A.ptr
    Sdir = sp.csr_matrix((strong.astype(np.int8), col.copy(), ptr.copy()),
                         shape=(n, n))
    Sdir.eliminate_zeros()
    ST = Sdir.T.tocsr()                     # dependents of each point
    stp, stc = ST.indptr, ST.indices

    cf = np.zeros(n, dtype=np.int8)         # 0 U, 1 C, 2 F
    # connect(): rows with no negative off-diagonal start as F
    has_strong = np.zeros(n, dtype=bool)
    np.logical_or.at(has_strong, rows, strong)
    cf[~has_strong] = 2

    from amgcl_tpu_torch.native import native_rs_cfsplit
    got = native_rs_cfsplit(ptr, col, strong, stp, stc, cf)
    if got is not None:
        return got == 1

    # the lazy-heap pass without the library;
    # lambda_i = sum over dependents (U -> 1, decided -> 2)
    dep_count = np.diff(stp)
    dep_f = np.asarray(
        ST @ (cf != 0).astype(np.int64)).ravel()
    lam = (dep_count + dep_f).astype(np.int64)

    heap = [(-lam[i], i) for i in range(n) if cf[i] == 0]
    heapq.heapify(heap)
    while heap:
        nl, i = heapq.heappop(heap)
        if cf[i] != 0 or -nl != lam[i]:
            continue                         # decided or stale entry
        if lam[i] == 0:
            cf[cf == 0] = 1                  # remaining U become C
            break
        cf[i] = 1
        for c in stc[stp[i]:stp[i + 1]]:
            if cf[c] != 0:
                continue
            cf[c] = 2
            # increase lambdas of the new F's strong neighbours
            for j in range(ptr[c], ptr[c + 1]):
                if not strong[j]:
                    continue
                ac = col[j]
                if cf[ac] == 0 and lam[ac] + 1 < n:
                    lam[ac] += 1
                    heapq.heappush(heap, (-lam[ac], ac))
        # decrease lambdas of the new C's strong neighbours
        for j in range(ptr[i], ptr[i + 1]):
            if not strong[j]:
                continue
            c = col[j]
            if cf[c] == 0 and lam[c] > 0:
                lam[c] -= 1
                heapq.heappush(heap, (-lam[c], c))
    return cf == 1


def _interp_classic(A: CSR, strong, rows, is_c, cidx, nc,
                    do_trunc, eps_trunc):
    """The reference's direct interpolation, vectorized
    (ruge_stuben.hpp:134-248): sign-split alpha/beta with truncation
    folded in via the cf_neg/cf_pos compensation factors and the
    Amin/Amax thresholds, plus the lone-positive-row dia correction."""
    n = A.nrows
    col = A.col
    val = A.val.real
    dia = A.diagonal().real
    eps = np.finfo(np.float64).eps
    off = rows != col
    scn = strong & is_c[col]

    a_num = _rowsum(n, rows, val, off & (val < 0))
    b_num = _rowsum(n, rows, val, off & (val > 0))
    a_den = _rowsum(n, rows, val, scn & (val < 0))
    b_den = _rowsum(n, rows, val, scn & (val > 0))

    if do_trunc:
        amin = np.zeros(n)
        amax = np.zeros(n)
        np.minimum.at(amin, rows[scn], val[scn])
        np.maximum.at(amax, rows[scn], val[scn])
        amin *= eps_trunc
        amax *= eps_trunc
        keep = scn & ((val < amin[rows]) | (val > amax[rows]))
        d_neg = _rowsum(n, rows, val, scn & (val < 0) & (val > amin[rows]))
        d_pos = _rowsum(n, rows, val, scn & (val > 0) & (val < amax[rows]))
        den_n = np.abs(a_den - d_neg)
        den_p = np.abs(b_den - d_pos)
        cf_neg = np.where(den_n > eps,
                          np.abs(a_den) / np.maximum(den_n, eps), 1.0)
        cf_pos = np.where(den_p > eps,
                          np.abs(b_den) / np.maximum(den_p, eps), 1.0)
    else:
        keep = scn.copy()
        cf_neg = np.ones(n)
        cf_pos = np.ones(n)

    # a row with positive couplings but no positive strong-C neighbour
    # lumps them onto the diagonal
    dia_eff = dia + np.where((b_num > 0) & (np.abs(b_den) < eps),
                             b_num, 0.0)
    denom_a = np.abs(dia_eff) * np.abs(a_den)
    denom_b = np.abs(dia_eff) * np.abs(b_den)
    alpha = np.where(np.abs(a_den) > eps,
                     -cf_neg * np.abs(a_num)
                     / np.where(denom_a > 0, denom_a, 1.0), 0.0)
    beta = np.where(np.abs(b_den) > eps,
                    -cf_pos * np.abs(b_num)
                    / np.where(denom_b > 0, denom_b, 1.0), 0.0)

    w = np.where(val < 0, alpha[rows], beta[rows]) * val
    return _assemble_P(n, nc, rows, col, w, keep, is_c, cidx)


def _assemble_P(n, nc, rows, col, w, keep, is_c, cidx):
    """P assembly shared by both interpolation variants: identity rows at
    C points, kept weights at F points."""
    fkeep = keep & ~is_c[rows]
    prow = np.concatenate([np.flatnonzero(is_c), rows[fkeep]])
    pcol = np.concatenate([cidx[is_c], cidx[col[fkeep]]])
    pval = np.concatenate([np.ones(nc), w[fkeep]])
    P = sp.csr_matrix((pval, (prow, pcol)), shape=(n, nc))
    P.sum_duplicates()
    P.sort_indices()
    return CSR.from_scipy(P)


def _rowsum(n, rows, v, mask):
    out = np.zeros(n)
    np.add.at(out, rows[mask], v[mask])
    return out


@dataclass
class RugeStuben:
    eps_strong: float = 0.25
    do_trunc: bool = True
    eps_trunc: float = 0.2
    splitting: str = "classic"    # 'classic' | 'pmis' (see module doc)

    def transfer_operators(self, A: CSR, ctx: dict):
        # RS keeps no state across levels
        if A.is_block:
            raise NotImplementedError(
                "ruge_stuben supports scalar value types only (as in the "
                "reference, ruge_stuben.hpp:445)")
        n = A.nrows
        strong, rows = _strength_rs(A, self.eps_strong)
        if self.splitting == "classic":
            is_c = cf_splitting_classic(A, strong, rows)
            cidx = np.cumsum(is_c) - 1
            nc = int(is_c.sum())
            if nc == 0:
                raise CoarseningStall("empty coarse level in RS splitting")
            Pc = _interp_classic(A, strong, rows, is_c, cidx, nc,
                                 self.do_trunc, self.eps_trunc)
            return Pc, Pc.transpose()
        if self.splitting != "pmis":
            raise ValueError("splitting must be 'pmis' or 'classic'")
        is_c = cf_splitting_pmis(A, strong, rows)
        cidx = np.cumsum(is_c) - 1          # C-point -> coarse index
        nc = int(is_c.sum())
        if nc == 0:
            raise CoarseningStall("empty coarse level in RS splitting")

        dia = A.diagonal()
        # direct interpolation with sign split:
        # w_ij = -(a_ij/a_ii) * (sum_N a^∓) / (sum_C a^∓)
        scn = strong & is_c[A.col]          # strong C-neighbor entries
        val = A.val.real
        neg = np.where(rows != A.col, np.minimum(val, 0.0), 0.0)
        pos = np.where(rows != A.col, np.maximum(val, 0.0), 0.0)

        everywhere = np.ones_like(strong)
        sum_all_neg = _rowsum(n, rows, neg, everywhere)
        sum_all_pos = _rowsum(n, rows, pos, everywhere)
        sum_c_neg = _rowsum(n, rows, neg, scn)
        sum_c_pos = _rowsum(n, rows, pos, scn)
        alpha = sum_all_neg / np.where(sum_c_neg != 0, sum_c_neg, 1.0)
        beta = sum_all_pos / np.where(sum_c_pos != 0, sum_c_pos, 1.0)

        w = np.where(val < 0, alpha[rows], beta[rows]) * \
            (-val / np.where(dia[rows] != 0, dia[rows], 1.0))
        keep = scn.copy()

        if self.do_trunc:
            absw = np.where(keep, np.abs(w), 0.0)
            wmax = np.zeros(n)
            np.maximum.at(wmax, rows, absw)
            trunc = keep & (absw < self.eps_trunc * wmax[rows])
            keep &= ~trunc
            # rescale kept weights to preserve the row sums
            tot = np.zeros(n)
            np.add.at(tot, rows, np.where(scn, w, 0.0))
            kept = np.zeros(n)
            np.add.at(kept, rows, np.where(keep, w, 0.0))
            w = w * (tot / np.where(kept != 0, kept, 1.0))[rows]

        Pc = _assemble_P(n, nc, rows, A.col, w, keep, is_c, cidx)
        return Pc, Pc.transpose()

    def coarse_operator(self, A: CSR, P: CSR, R: CSR, ctx: dict) -> CSR:
        return galerkin(A, P, R, ctx.get("setup_device"))
