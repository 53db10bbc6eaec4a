"""Serving: stacked (n, B) solves through every Krylov solver, block CG,
the bucket's CUDA graph, and the resident :class:`SolverService`
(counterpart of the first half of ``amgcl_tpu/serve/``; the operator
registry, the solver farm and the load generator are ROADMAP A.11b)."""

from amgcl_tpu_torch.serve.batched import (GRAPH, PER_COLUMN, UNCAPTURED,
                                           BlockCG, StackedPrecond,
                                           decode_batched_health,
                                           lowering_kind, stacked_solve)
from amgcl_tpu_torch.serve.service import SolverService

__all__ = ["BlockCG", "GRAPH", "PER_COLUMN", "SolverService",
           "StackedPrecond", "UNCAPTURED", "decode_batched_health",
           "lowering_kind", "stacked_solve"]
