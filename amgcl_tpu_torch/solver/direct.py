"""Dense direct solve for the coarsest AMG level (counterpart of the host
path of ``amgcl_tpu/solver/direct.py``).

The reference factorizes the coarse matrix with a skyline LU
(amgcl/solver/skyline_lu.hpp:80-311); for a level of a few thousand rows
the inverse is computed once on the host in float64 and every coarse
solve is one matrix-vector product on the device."""

from __future__ import annotations

import warnings

import numpy as np
import scipy.linalg
import torch

from amgcl_tpu_torch.ops.csr import CSR


class DenseDirectSolver:
    """Coarse direct solve as y = A⁻¹ f with the inverse precomputed."""

    def __init__(self, inv):
        self.inv = inv

    def solve(self, f):
        return torch.matmul(self.inv, f)

    @classmethod
    def build(cls, A: CSR, dtype, device) -> "DenseDirectSolver":
        # a block level is inverted over its scalar unknowns
        dense = A.to_dense().astype(np.float64)
        try:
            inv = scipy.linalg.inv(dense)
            if not np.all(np.isfinite(inv)):
                raise np.linalg.LinAlgError
        except (np.linalg.LinAlgError, scipy.linalg.LinAlgError):
            # operators singular up to constants (pure Neumann coarse
            # levels): least-squares solve, announced
            inv = np.linalg.pinv(dense)
            warnings.warn(
                "singular coarse operator: coarse solve uses the "
                "pseudo-inverse (least-squares solve)", RuntimeWarning,
                stacklevel=2)
        return cls(torch.as_tensor(inv, device=device).to(dtype))
