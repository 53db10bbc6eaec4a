"""Top-level compositions: the AMG hierarchy, make_solver bundles, the
runtime configuration layer, and single-level, nested, deflated and
coupled-physics (Schur, CPR) preconditioners."""

from amgcl_tpu_torch.models.amg import AMG, AMGParams
from amgcl_tpu_torch.models.block_solver import make_block_solver
from amgcl_tpu_torch.models.cpr import CPR, CPRDRS
from amgcl_tpu_torch.models.deflated import deflated_solver
from amgcl_tpu_torch.models.make_solver import make_solver
from amgcl_tpu_torch.models.preconditioner import (AsPreconditioner,
                                                   DummyPreconditioner,
                                                   NestedPreconditioner)
from amgcl_tpu_torch.models.runtime import (make_solver_from_config,
                                            precond_from_config)
from amgcl_tpu_torch.models.schur import SchurPressureCorrection

__all__ = ["AMG", "AMGParams", "make_solver", "make_block_solver",
           "deflated_solver", "AsPreconditioner", "DummyPreconditioner",
           "NestedPreconditioner", "SchurPressureCorrection", "CPR",
           "CPRDRS", "make_solver_from_config", "precond_from_config"]
