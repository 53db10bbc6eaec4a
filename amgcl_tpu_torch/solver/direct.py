"""Dense direct solve for the coarsest AMG level (counterpart of
``amgcl_tpu/solver/direct.py``).

The reference factorizes the coarse matrix with a skyline LU
(amgcl/solver/skyline_lu.hpp:80-311); for a level of a few thousand rows
the inverse is computed once and every coarse solve is one matrix-vector
product on the device. By default the inverse is computed on the host in
float64. With ``device_inv`` (the JAX package's
``AMGCL_TPU_DEVICE_INV``, its default on a TPU only) a float32 or
bfloat16 level is inverted on the device in float32 and polished by two
Newton–Schulz steps, and the result is kept only when ‖AX − I‖_F/√n is
below 1e-3; otherwise the host float64 inverse is taken (with a warning
when the residual was under 1e-2, near the gate)."""

from __future__ import annotations

import math
import warnings

import numpy as np
import scipy.linalg
import torch

from amgcl_tpu_torch.ops.csr import CSR

#: ‖AX − I‖_F/√n below which the device inverse is kept, and below which
#: a rejection is announced
DEVICE_INV_ACCEPT = 1e-3
DEVICE_INV_WARN = 1e-2


class DenseDirectSolver:
    """Coarse direct solve as y = A⁻¹ f with the inverse precomputed.
    ``device_rnorm`` is the device inverse's ‖AX − I‖_F/√n where one was
    computed (kept or not), else None."""

    def __init__(self, inv, device_rnorm=None):
        self.inv = inv
        self.device_rnorm = device_rnorm

    def solve(self, f):
        return torch.matmul(self.inv, f)

    @classmethod
    def build(cls, A: CSR, dtype, device,
              device_inv: bool = False) -> "DenseDirectSolver":
        # a block level is inverted over its scalar unknowns
        dense = A.to_dense().astype(np.float64)
        rnorm = None
        if device_inv and dense.shape[0] \
                and torch.empty((), dtype=dtype).element_size() <= 4:
            X, rnorm = device_inverse(
                torch.as_tensor(dense, dtype=torch.float32, device=device))
            if device_inv_accepted(rnorm):
                return cls(X.to(dtype), rnorm)
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
        return cls(torch.as_tensor(inv, device=device).to(dtype), rnorm)


def device_inverse(Ad):
    """(X, ‖Ad X − I‖_F / √n): the float32 inverse of ``Ad`` on its
    device, after two Newton–Schulz steps X ← X (2I − Ad X)
    (amgcl_tpu/solver/direct.py:104-115). ``rnorm`` is a float."""
    n = Ad.shape[0]
    eye = torch.eye(n, dtype=Ad.dtype, device=Ad.device)
    # inv_ex does not raise on a singular Ad: the gate rejects its X
    X, _ = torch.linalg.inv_ex(Ad)
    for _ in range(2):
        X = X @ (2.0 * eye - Ad @ X)
    rnorm = torch.linalg.norm(Ad @ X - eye) / math.sqrt(max(n, 1))
    return X, float(rnorm)


def device_inv_accepted(rnorm: float) -> bool:
    """The device inverse's gate: keep it below DEVICE_INV_ACCEPT; warn
    when a rejection was under DEVICE_INV_WARN."""
    if math.isfinite(rnorm) and rnorm < DEVICE_INV_ACCEPT:
        return True
    if math.isfinite(rnorm) and rnorm < DEVICE_INV_WARN:
        warnings.warn(
            "device f32 coarse inverse rejected near the gate "
            "(||AX-I||_F/sqrt(n) = %.2e); using host f64 path" % rnorm,
            RuntimeWarning, stacklevel=3)
    return False
