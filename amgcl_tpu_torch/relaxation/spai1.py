"""SPAI-1: sparse approximate inverse with the sparsity pattern of A
(reference: amgcl/relaxation/spai1.hpp:54; counterpart of
``amgcl_tpu/relaxation/spai1.py``).

Row i minimizes ``‖e_i − m_i A[J_i, :]‖`` over its pattern J_i; the normal
equations are ``(A Aᵀ)[J_i, J_i] m_iᵀ = Aᵀ[J_i, i]``. All rows are solved
at once: the Gram matrix A·Aᵀ is formed once, each row's block gathered
into a padded (n, K, K) batch and solved in one batched call (for a
hierarchy on a CUDA device, on that device, in blocks of rows). M moves
to the device in the format ``to_device("auto")`` picks, so its product
runs through that format's kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.relaxation.base import setup_device, state_bytes


def gather_sparse_entries(m: sp.csr_matrix, rows: np.ndarray,
                          cols: np.ndarray) -> np.ndarray:
    """m[rows[k], cols[k]] for every k (0 where absent): one searchsorted
    over the sorted CSR's global key row·ncols + col."""
    m = m.tocsr()
    m.sort_indices()
    ncols = m.shape[1]
    m_rows = np.repeat(np.arange(m.shape[0], dtype=np.int64),
                       np.diff(m.indptr))
    key_m = m_rows * ncols + m.indices
    key_q = rows.astype(np.int64) * ncols + cols.astype(np.int64)
    if not len(key_m):
        return np.zeros(len(rows))
    pos = np.searchsorted(key_m, key_q)
    pos_c = np.minimum(pos, len(key_m) - 1)
    valid = (pos < len(key_m)) & (key_m[pos_c] == key_q)
    return np.where(valid, m.data[pos_c], 0.0)


def padded_pattern(indptr, indices):
    """(Jp, valid, rows, pos, K): row patterns padded to the widest row;
    padded slots hold index 0 and are masked before the solve."""
    n = len(indptr) - 1
    nnz_row = np.diff(indptr)
    K = int(nnz_row.max()) if n else 1
    rows = np.repeat(np.arange(n), nnz_row)
    pos = np.arange(int(indptr[-1])) - np.asarray(indptr)[rows]
    Jp = np.zeros((n, K), dtype=np.int64)
    valid = np.zeros((n, K), dtype=bool)
    Jp[rows, pos] = indices
    valid[rows, pos] = True
    return Jp, valid, rows, pos, K


def pattern_normal_solve(Jp, valid, B, c, on=None):
    """The batched least-squares core: G[i] = B[Jp_i, Jp_i] with padded
    slots as identity rows and a zero right side, a 1e-12 ridge, one
    batched solve. ``c`` is the (n, K) right side aligned with Jp. ``on``
    None: numpy on the host; a torch device: the gather and the solves
    there, in blocks of rows."""
    n, K = Jp.shape
    if on is None:
        qi = np.repeat(Jp, K, axis=1).ravel()
        qj = np.tile(Jp, (1, K)).ravel()
        G = gather_sparse_entries(B, qi, qj).reshape(n, K, K)
        pad = ~valid
        eye = np.eye(K)[None, :, :]
        G = np.where(pad[:, :, None] | pad[:, None, :], eye, G)
        c = np.where(pad, 0.0, c)
        G = G + 1e-12 * eye
        return np.linalg.solve(G, c[..., None])[..., 0]
    B = B.tocsr()
    B.sort_indices()
    ncols = B.shape[1]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=on)
    key_m = t(np.repeat(np.arange(B.shape[0], dtype=np.int64),
                        np.diff(B.indptr)) * ncols + B.indices)
    data = t(B.data.astype(np.float64))
    eye = torch.eye(K, dtype=torch.float64, device=on)
    out = np.empty((n, K))
    step = max(1, (1 << 26) // (K * K))      # about 0.5 GiB of keys a block
    for lo in range(0, n, step):
        J = t(Jp[lo:lo + step])
        q = (J[:, :, None] * ncols + J[:, None, :]).reshape(-1)
        pos = torch.searchsorted(key_m, q).clamp_(max=len(key_m) - 1)
        G = torch.where(key_m[pos] == q, data[pos],
                        torch.zeros((), dtype=torch.float64, device=on))
        pad = ~t(valid[lo:lo + step])
        G = torch.where(pad[:, :, None] | pad[:, None, :], eye,
                        G.reshape(-1, K, K)) + 1e-12 * eye
        rhs = torch.where(pad, 0.0, t(c[lo:lo + step]))
        out[lo:lo + step] = torch.linalg.solve(
            G, rhs[..., None])[..., 0].cpu().numpy()
    return out


class Spai1State:
    """M with A's pattern as a device matrix."""

    def __init__(self, M):
        self.M = M

    def apply(self, A, f):
        return dev.spmv(self.M, f)

    def apply_pre(self, A, f, x):
        return x + dev.spmv(self.M, dev.residual(f, A, x))

    apply_post = apply_pre

    def bytes(self) -> int:
        return state_bytes(self.M)


@dataclass
class Spai1:
    def build_host(self, A: CSR, on=None) -> CSR:
        """M as a host CSR over scalar unknowns; the Gram gathers and
        solves on ``on`` (a torch device) or on the host (None)."""
        S = A.unblock() if A.is_block else A
        m = S.to_scipy().astype(np.float64)
        m.sort_indices()
        n = m.shape[0]
        J, valid, rows, pos, K = padded_pattern(m.indptr, m.indices)
        B = (m @ m.T).tocsr()
        # right side: c[i, k] = A[J_ik, i] = Aᵀ[i, J_ik]
        c = gather_sparse_entries(m.T.tocsr(), np.repeat(np.arange(n), K),
                                  J.ravel()).reshape(n, K)
        mvals = pattern_normal_solve(J, valid, B, c, on)
        return CSR(m.indptr.copy(), m.indices.copy(), mvals[rows, pos], n)

    def build(self, A: CSR, dtype, device) -> Spai1State:
        return Spai1State(dev.to_device(
            self.build_host(A, setup_device(device)), "auto", dtype,
            device))
