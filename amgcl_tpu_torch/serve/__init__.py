"""Serving: stacked (n, B) solves through every Krylov solver, block CG,
the bucket's CUDA graph, the resident :class:`SolverService`, the
operator registry, the multi-tenant :class:`SolverFarm` and the open-loop
load generator (counterpart of ``amgcl_tpu/serve/``)."""

from amgcl_tpu_torch.serve.batched import (GRAPH, PER_COLUMN, UNCAPTURED,
                                           BlockCG, StackedPrecond,
                                           decode_batched_health,
                                           lowering_kind, stacked_solve)
from amgcl_tpu_torch.serve.farm import SolverFarm
from amgcl_tpu_torch.serve.registry import (OperatorRegistry, RegistryEntry,
                                            sparsity_fingerprint,
                                            stable_config_key)
from amgcl_tpu_torch.serve.service import SolverService
from amgcl_tpu_torch.serve.storm import (build_schedule, burst_phase,
                                         poisson_phase, ramp_phase,
                                         run_ladder, run_storm,
                                         schedule_duration_s)

__all__ = ["BlockCG", "GRAPH", "OperatorRegistry", "PER_COLUMN",
           "RegistryEntry", "SolverFarm", "SolverService", "StackedPrecond",
           "UNCAPTURED", "build_schedule", "burst_phase",
           "decode_batched_health", "lowering_kind", "poisson_phase",
           "ramp_phase", "run_ladder", "run_storm", "schedule_duration_s",
           "sparsity_fingerprint", "stable_config_key", "stacked_solve"]
