"""Coarsening policies: ``transfer_operators(A, ctx) -> (P, R)`` and
``coarse_operator(A, P, R, ctx) -> Ac`` (reference:
amgcl/coarsening/smoothed_aggregation.hpp:130-242 for the contract)."""

from amgcl_tpu_torch.coarsening.aggregates import (mis_aggregates,
                                                   plain_aggregates,
                                                   pointwise_aggregates,
                                                   strength_graph)
from amgcl_tpu_torch.coarsening.aggregation import Aggregation
from amgcl_tpu_torch.coarsening.as_scalar import AsScalar
from amgcl_tpu_torch.coarsening.rigid_body_modes import rigid_body_modes
from amgcl_tpu_torch.coarsening.ruge_stuben import RugeStuben
from amgcl_tpu_torch.coarsening.smoothed_aggr_emin import SmoothedAggrEMin
from amgcl_tpu_torch.coarsening.smoothed_aggregation import \
    SmoothedAggregation

__all__ = ["Aggregation", "AsScalar", "RugeStuben", "SmoothedAggrEMin",
           "SmoothedAggregation", "mis_aggregates", "plain_aggregates",
           "pointwise_aggregates", "rigid_body_modes", "strength_graph"]
