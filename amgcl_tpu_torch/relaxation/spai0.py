"""SPAI-0: sparse approximate inverse restricted to a diagonal,
m_i = a_ii / Σ_j a_ij² (reference: amgcl/relaxation/spai0.hpp:49-117;
counterpart of ``amgcl_tpu/relaxation/spai0.py``). For block values the
row-wise least squares over block-diagonal M gives
M_i · (Σ_j a_ij a_ijᵀ) = a_iiᵀ, one b×b block per node."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.relaxation.base import ScaledResidualSmoother


def _block_scale(A: CSR) -> np.ndarray:
    br = A.block_size[0]
    G = np.zeros((A.nrows, br, br))
    np.add.at(G, A.expanded_rows(), np.einsum("nij,nkj->nik", A.val, A.val))
    # an all-zero block row gets the identity as G and a zero block as M,
    # as the scalar path's zero denominator gives m = 0
    zero_row = np.einsum("nii->n", G) == 0
    G[zero_row] = np.eye(br)
    Gt = np.swapaxes(G, 1, 2)
    dia = A.diagonal()
    try:
        M = np.linalg.solve(Gt, dia)           # Gᵀ Mᵀ = a_ii
    except np.linalg.LinAlgError:
        M = np.einsum("nij,njk->nik", np.linalg.pinv(Gt), dia)
    # contiguous: the block correction kernel reads S row-major
    M = np.ascontiguousarray(np.swapaxes(M, 1, 2))
    M[zero_row] = 0.0
    return M


@dataclass
class Spai0:
    def build(self, A: CSR, dtype, device) -> ScaledResidualSmoother:
        from amgcl_tpu_torch.native import native_spai0_diag
        if A.is_block:
            m = _block_scale(A)
        elif (m := native_spai0_diag(A)) is None:
            sq = (np.abs(A.val) ** 2).astype(np.float64)
            denom = np.bincount(A.expanded_rows(), weights=sq,
                                minlength=A.nrows)
            m = A.diagonal() / np.where(denom != 0, denom, 1.0)
        return ScaledResidualSmoother(
            torch.as_tensor(m, device=device).to(dtype))
