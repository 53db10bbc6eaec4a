"""Krylov solvers and the coarse direct solver: CG, BiCGStab, BiCGStab(L),
GMRES, FGMRES, LGMRES, IDR(s), Richardson and PreOnly."""

from amgcl_tpu_torch.solver.bicgstab import BiCGStab
from amgcl_tpu_torch.solver.bicgstabl import BiCGStabL
from amgcl_tpu_torch.solver.cg import CG
from amgcl_tpu_torch.solver.gmres import FGMRES, GMRES
from amgcl_tpu_torch.solver.idrs import IDRs
from amgcl_tpu_torch.solver.lgmres import LGMRES
from amgcl_tpu_torch.solver.preonly import PreOnly
from amgcl_tpu_torch.solver.richardson import Richardson

__all__ = ["BiCGStab", "BiCGStabL", "CG", "FGMRES", "GMRES", "IDRs",
           "LGMRES", "PreOnly", "Richardson"]
