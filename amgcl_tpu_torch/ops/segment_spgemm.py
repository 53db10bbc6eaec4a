"""Setup algebra as segment sums against cached plans: Galerkin triple
products and prolongation smoothing.

Counterpart of ``amgcl_tpu/ops/segment_spgemm.py``. The setup products
have more structure than a general SpGEMM:

* a tentative prolongation of aggregation type is a *selection* matrix
  (at most one unit entry a fine row), so ``R A P`` is one segment sum
  over A's entries keyed by ``(agg[row], agg[col])``;
* smoothed aggregation's ``P = (I − ω D⁻¹ A_f) T`` is a segment sum over
  A_f's entries keyed by ``(row, agg[col])``, plus the identity;
* the general products (smoothed ``A P``, ``R (A P)``) have a sparsity
  that does not depend on the values, so one host symbolic pass gives a
  *plan* (gather indices and output segments) and the numeric product is
  ``segment_sum(a[ia] * b[ib])``.

The index arrays are built on the host, once a level, and the plan is
cached on the transfer operator, so ``AMG.rebuild`` with new values runs
only the numeric passes. The numeric pass runs on ``device`` (a
``torch.device``, the build's own when its setup is on the device): the
gather and multiply in torch, and the segment sum as
``torch.segment_reduce`` over the entries sorted by segment at plan time
(stably, so each segment keeps entry order) — a sum that runs each
segment in order, the same on every run, with no atomics. With
``device=None`` the host pass is ``np.bincount`` in float64, as the JAX
package's ``_host_segment``; on float64 values both routes add in the
same order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from amgcl_tpu_torch.ops.csr import CSR

#: largest multiply list a general SpGEMM plan may hold (three int32
#: index arrays of this length); past it the level keeps scipy's product
#: and opts out of the numeric-rebuild fast path
PLAN_MAX_FLOPS = 32_000_000


def _host_segment(vals, seg, n_out, dtype):
    """bincount segment sum in float64 (the host numeric pass)."""
    return np.bincount(seg, weights=vals, minlength=n_out).astype(dtype)


def _unique_keys(key: np.ndarray):
    """(uniq, seg, segs): ``np.unique(key, return_inverse=True)`` from one
    stable sort, whose order also lists the entries segment by segment
    (a :class:`_Segments`)."""
    order = np.argsort(key, kind="stable")
    ks = key[order]
    new = np.empty(len(ks), dtype=bool)
    new[:1] = True
    np.not_equal(ks[1:], ks[:-1], out=new[1:])
    uniq = ks[new]
    seg = np.empty(len(key), dtype=np.int32)
    seg[order] = np.cumsum(new) - 1
    return uniq, seg, _Segments(order, np.diff(
        np.append(np.flatnonzero(new), len(ks))))


def _pattern_tag(A: CSR):
    """Cheap identity of a sparsity pattern: (shape, nnz, a strided
    column checksum). ``AMG.rebuild`` compares the fine pattern in full;
    a level's plan only has to catch a matrix from another build."""
    col = A.col
    s = int(col[:: max(1, len(col) // 64)].sum()) if len(col) else 0
    return (A.nrows, A.ncols, A.nnz, s)


class _Segments:
    """The plan's output segments in sorted form: ``order`` lists the
    entries segment by segment (stably), ``lengths`` counts each
    segment's entries. Device copies are cached per device."""

    def __init__(self, order: np.ndarray, lengths: np.ndarray):
        self.order = order
        self.lengths = lengths.astype(np.int64)
        self._dev = {}

    def device_arrays(self, device, *index_arrays):
        """``(lengths, *[a[order] for a in index_arrays])`` on
        ``device``, built once."""
        key = str(device)
        got = self._dev.get(key)
        if got is None:
            got = (torch.as_tensor(self.lengths, device=device),) + tuple(
                torch.as_tensor(np.ascontiguousarray(a[self.order]),
                                dtype=torch.int64, device=device)
                for a in index_arrays)
            self._dev[key] = got
        return got

    def release_device(self):
        """Drop the device copies (a released hierarchy's plans keep
        their host arrays; the next numeric pass copies them again)."""
        self._dev = {}

    def device_sum(self, v_sorted, lengths):
        """Sum of each segment of ``v_sorted`` (the entries in segment
        order), in entry order: a two-dimensional operand keeps
        segment_reduce on its one-thread-a-segment loop."""
        return torch.segment_reduce(v_sorted[:, None], "sum",
                                    lengths=lengths, axis=0,
                                    unsafe=True)[:, 0]


def _values_tensor(vals, device, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(vals), device=device,
                           dtype=dtype)


class TripleProductPlan:
    """``Ac = R A P`` for a selection P: one segment sum over A's
    entries keyed by ``(agg[row], agg[col])``."""

    def __init__(self, A: CSR, agg_rows: np.ndarray, agg_cols: np.ndarray,
                 n_agg_rows: int, n_agg_cols: int):
        rows = A.expanded_rows()
        ri = agg_rows[rows]
        ci = agg_cols[A.col]
        keep = (ri >= 0) & (ci >= 0)
        self.take = np.flatnonzero(keep).astype(np.int32)
        key = ri[keep].astype(np.int64) * n_agg_cols + ci[keep]
        uniq, self.seg, self._segs = _unique_keys(key)
        self.nnz_c = len(uniq)
        crow = (uniq // n_agg_cols).astype(np.int64)
        self.ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(crow, minlength=n_agg_rows))]
        ).astype(np.int64)
        self.col = (uniq % n_agg_cols).astype(np.int32)
        self.ncols = int(n_agg_cols)
        self.tag = _pattern_tag(A)
        self.flops = int(len(self.take))

    def coarse_values(self, avals: np.ndarray, scale: float = 1.0,
                      device=None) -> np.ndarray:
        dt = avals.dtype
        if device is not None:
            lengths, take = self._segs.device_arrays(device, self.take)
            a = _values_tensor(avals, device)
            v = a[take] * torch.tensor(scale, dtype=a.dtype, device=device)
            return self._segs.device_sum(v, lengths).cpu().numpy()
        v = avals[self.take]
        if scale != 1.0:
            v = v * scale
        return _host_segment(v, self.seg, self.nnz_c, dt)

    def coarse_csr(self, A: CSR, scale: float = 1.0, device=None) -> CSR:
        assert _pattern_tag(A) == self.tag, \
            "Galerkin plan was built for a different sparsity pattern"
        return CSR(self.ptr, self.col,
                   self.coarse_values(A.val, scale, device), self.ncols)


class SpGEMMPlan:
    """Numeric ``C = A @ B`` against a host-computed multiply list:
    ``C.val = segment_sum(A.val[ia] * B.val[ib])`` with a fixed output
    sparsity. :meth:`build` returns None past the flop guard."""

    def __init__(self, ia, ib, seg, segs, ptr, col, ncols, tag_a, tag_b):
        self.ia, self.ib, self.seg = ia, ib, seg
        self.ptr, self.col, self.ncols = ptr, col, ncols
        self.nnz_c = len(col)
        self.tag_a, self.tag_b = tag_a, tag_b
        self.flops = int(len(ia))
        self._segs = segs

    @classmethod
    def build(cls, A: CSR, B: CSR,
              max_flops: Optional[int] = None) -> Optional["SpGEMMPlan"]:
        cnt = B.row_nnz()[A.col]
        nflop = int(cnt.sum())
        if nflop > (PLAN_MAX_FLOPS if max_flops is None else max_flops):
            return None
        idt = np.int32 if max(A.nnz, B.nnz, nflop) < 2**31 else np.int64
        ia = np.repeat(np.arange(A.nnz, dtype=idt), cnt)
        start = np.cumsum(cnt) - cnt
        pos = np.arange(nflop, dtype=np.int64) - np.repeat(start, cnt)
        ib = (np.repeat(B.ptr[A.col], cnt) + pos).astype(idt)
        out_row = A.expanded_rows()[ia].astype(np.int64)
        key = out_row * B.ncols + B.col[ib]
        uniq, seg, segs = _unique_keys(key)
        crow = (uniq // B.ncols).astype(np.int64)
        ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(crow, minlength=A.nrows))]
        ).astype(np.int64)
        return cls(ia, ib, seg, segs, ptr,
                   (uniq % B.ncols).astype(np.int32), B.ncols,
                   _pattern_tag(A), _pattern_tag(B))

    def values(self, avals, bvals, device=None) -> np.ndarray:
        dt = np.result_type(avals.dtype, bvals.dtype)
        if device is not None:
            lengths, ia, ib = self._segs.device_arrays(device, self.ia,
                                                       self.ib)
            prod = _values_tensor(avals, device)[ia] \
                * _values_tensor(bvals, device)[ib]
            return self._segs.device_sum(prod, lengths).cpu().numpy()
        prod = avals[self.ia] * bvals[self.ib]
        return _host_segment(prod, self.seg, self.nnz_c, dt)


class SmoothPlan:
    """``P = (I − ω D_f⁻¹ A_f) T`` for a selection T over ``agg``: the
    smoothing product as one segment sum over A_f's entries keyed by
    ``(row, agg[col])``, plus the identity's entries. The pattern is the
    union of the two, kept where the values cancel (scipy's product
    would drop an exact zero)."""

    def __init__(self, Af: CSR, agg: np.ndarray, n_agg: int):
        rows = Af.expanded_rows()
        keep = agg[Af.col] >= 0
        self.take = np.flatnonzero(keep).astype(np.int32)
        self.rows_kept = rows[keep].astype(np.int32)
        iden = np.flatnonzero(agg >= 0)
        key_i = iden.astype(np.int64) * n_agg + agg[iden]
        key_a = rows[keep].astype(np.int64) * n_agg + agg[Af.col[keep]]
        uniq, self.seg, self._segs = _unique_keys(
            np.concatenate([key_i, key_a]))
        self.n_iden = len(iden)
        self.nnz_p = len(uniq)
        prow = (uniq // n_agg).astype(np.int64)
        self.ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(prow, minlength=Af.nrows))]
        ).astype(np.int64)
        self.col = (uniq % n_agg).astype(np.int32)
        self.n_agg = int(n_agg)
        self.tag = _pattern_tag(Af)
        self.flops = int(len(self.take)) + self.n_iden

    def prolongation(self, Af: CSR, dinv: np.ndarray, omega: float,
                     device=None) -> CSR:
        assert _pattern_tag(Af) == self.tag, \
            "smoothing plan was built for a different strength pattern"
        dt = Af.val.dtype
        if device is not None:
            # entry j of the concatenation: the identity's 1 for
            # j < n_iden, else −ω·dinv[row]·a_f of entry j − n_iden
            src = np.concatenate([np.full(self.n_iden, -1, np.int64),
                                  np.arange(len(self.take))])
            lengths, src_s = self._segs.device_arrays(device, src)
            af = _values_tensor(Af.val, device)
            dinv_rows = _values_tensor(dinv[self.rows_kept], device,
                                       af.dtype)
            take = torch.as_tensor(self.take, dtype=torch.int64,
                                   device=device)
            contrib = -omega * dinv_rows * af[take]
            v = torch.cat([torch.ones(1, dtype=contrib.dtype,
                                      device=device), contrib])
            vals = self._segs.device_sum(v[src_s + 1], lengths)
            vals = vals.cpu().numpy()
        else:
            contrib = -omega * dinv[self.rows_kept] * Af.val[self.take]
            v = np.concatenate([np.ones(self.n_iden, dtype=contrib.dtype),
                                contrib])
            vals = _host_segment(v, self.seg, self.nnz_p, dt)
        return CSR(self.ptr, self.col, vals, self.n_agg)


class _PlanTooLarge(Exception):
    pass


class GalerkinPlan:
    """A level's coarse-operator plan: the one-pass selection triple
    product, or the general two-stage ``R (A P)`` (both stages numeric
    segment sums; P's and R's values are captured here — the rebuild
    contract freezes the transfer operators)."""

    def __init__(self, A: CSR, P: CSR, R: CSR):
        agg = selection_aggregates(P)
        if agg is not None:
            self.kind = "selection"
            self.triple = TripleProductPlan(A, agg, agg, P.ncols, P.ncols)
            self.flops = self.triple.flops
            self.plan_ap = self.plan_r = None
        else:
            self.kind = "general"
            self.triple = None
            self.plan_ap = SpGEMMPlan.build(A, P)
            if self.plan_ap is None:
                raise _PlanTooLarge()
            ap_pattern = CSR(self.plan_ap.ptr, self.plan_ap.col,
                             np.empty(self.plan_ap.nnz_c, np.float64),
                             self.plan_ap.ncols)
            self.plan_r = SpGEMMPlan.build(R, ap_pattern)
            if self.plan_r is None:
                raise _PlanTooLarge()
            self._pvals = P.val
            self._rvals = R.val
            self.flops = self.plan_ap.flops + self.plan_r.flops
        self.tag = _pattern_tag(A)

    def segments(self):
        """The plan's :class:`_Segments`, whose device copies it caches."""
        if self.kind == "selection":
            return [self.triple._segs]
        return [self.plan_ap._segs, self.plan_r._segs]

    def coarse(self, A: CSR, scale: float = 1.0, device=None) -> CSR:
        assert _pattern_tag(A) == self.tag, \
            "Galerkin plan was built for a different sparsity pattern"
        if self.kind == "selection":
            return self.triple.coarse_csr(A, scale, device)
        y = self.plan_ap.values(A.val, self._pvals, device)
        vals = self.plan_r.values(self._rvals, y, device)
        if scale != 1.0:
            vals = vals * vals.dtype.type(scale)
        return CSR(self.plan_r.ptr, self.plan_r.col, vals,
                   self.plan_r.ncols)


def selection_aggregates(P: CSR) -> Optional[np.ndarray]:
    """P's aggregate vector (−1 on rows without an entry) when P is a
    selection matrix — at most one unit entry a row, a tentative
    prolongation without a nullspace — else None."""
    if P.is_block or P.nnz == 0:
        return None
    nnz_row = P.row_nnz()
    if nnz_row.max() > 1 or not np.all(P.val == 1.0):
        return None
    agg = np.full(P.nrows, -1, dtype=np.int64)
    agg[nnz_row == 1] = P.col[np.cumsum(nnz_row)[nnz_row == 1] - 1]
    return agg


def cached_plan(P, A: CSR) -> Optional[GalerkinPlan]:
    plan = getattr(P, "_seg_plan", None)
    if plan is not None and plan.tag == _pattern_tag(A):
        return plan
    return None


def ensure_plan(A: CSR, P, R, force: bool = False,
                device=None) -> Optional[GalerkinPlan]:
    """Build (and cache on P) the level's Galerkin plan, or return None
    where the level opts out: block values, a P that is not a selection
    on a host build (``device=None``) unless ``force``, or a plan past
    the flop guard (remembered on P, so that it is not built again).
    ``force`` is the rebuild's entry: the symbolic pass is paid once, so
    that every later rebuild is a numeric pass."""
    if A.is_block or getattr(P, "is_block", False):
        return None
    plan = cached_plan(P, A)
    if plan is not None:
        return plan
    if getattr(P, "_seg_plan_oversize", None) == _pattern_tag(A):
        return None
    selection = selection_aggregates(P) is not None
    if not (force or selection or device is not None):
        return None          # a first host build: scipy's product
    try:
        plan = GalerkinPlan(A, P, R)
    except _PlanTooLarge:
        P._seg_plan_oversize = _pattern_tag(A)
        return None
    P._seg_plan = plan
    return plan
