"""Galerkin coarse operator Ac = R A P, and its scaled form for plain
aggregation (counterpart of ``amgcl_tpu/coarsening/galerkin.py``;
reference: amgcl/coarsening/detail/galerkin.hpp:53, scaled_galerkin.hpp).

Two routes:

* the plan route, where it applies: a segment-sum plan
  (:mod:`~amgcl_tpu_torch.ops.segment_spgemm`) cached on P — a selection
  P is one segment pass over A's entries, a smoothed P two planned
  numeric products — with its numeric pass on ``device`` when the
  build's setup runs there, else on the host;
* scipy's two products: block values, a level past the plan's flop
  guard, and a P that is not a selection on a host build.
"""

from __future__ import annotations

from amgcl_tpu_torch.ops import segment_spgemm as seg
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.telemetry.tracing import setup_substage


def galerkin(A: CSR, P: CSR, R: CSR, device=None) -> CSR:
    plan = seg.ensure_plan(A, P, R, device=device)
    if plan is not None:
        with setup_substage("galerkin_numeric"):
            return plan.coarse(A, device=device)
    return R @ (A @ P)


def scaled_galerkin(A: CSR, P: CSR, R: CSR, scale: float,
                    device=None) -> CSR:
    plan = seg.ensure_plan(A, P, R, device=device)
    if plan is not None:
        with setup_substage("galerkin_numeric"):
            return plan.coarse(A, scale, device)
    Ac = R @ (A @ P)
    return CSR(Ac.ptr, Ac.col, Ac.val * Ac.val.dtype.type(scale), Ac.ncols)
