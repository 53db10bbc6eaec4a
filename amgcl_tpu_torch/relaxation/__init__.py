"""Smoothers (relaxation): each policy's ``build(A, dtype, device)``
makes a device state with ``apply``, ``apply_pre``, ``apply_post`` and
``bytes`` (reference contract: amgcl/relaxation/spai0.hpp:49-117)."""

from amgcl_tpu_torch.relaxation.as_block import AsBlock
from amgcl_tpu_torch.relaxation.chebyshev import Chebyshev
from amgcl_tpu_torch.relaxation.gauss_seidel import GaussSeidel
from amgcl_tpu_torch.relaxation.ilu0 import ILU0, ILUK, ILUP, ILUT
from amgcl_tpu_torch.relaxation.jacobi import DampedJacobi
from amgcl_tpu_torch.relaxation.spai0 import Spai0
from amgcl_tpu_torch.relaxation.spai1 import Spai1

__all__ = ["AsBlock", "Chebyshev", "DampedJacobi", "GaussSeidel", "ILU0",
           "ILUK", "ILUP", "ILUT", "Spai0", "Spai1"]
