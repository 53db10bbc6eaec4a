"""Host-side CSR build format and setup-phase matrix algebra.

Counterpart of ``amgcl_tpu/ops/csr.py`` (the reference's *builtin*
backend matrix, amgcl/backend/builtin.hpp:55-909), scalar values only.
Everything here runs on the host in numpy, with scipy.sparse for the
products; the device never sees this class — hierarchies are converted to
device formats by :mod:`amgcl_tpu_torch.ops.device`.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class CSR:
    """Compressed sparse row matrix with scalar values.

    Attributes:
      ptr: (n+1,) int64 row pointers.
      col: (nnz,) int32 column indices.
      val: (nnz,) values.
      ncols: number of columns.
    """

    def __init__(self, ptr, col, val, ncols=None):
        self.ptr = np.asarray(ptr, dtype=np.int64)
        self.col = np.asarray(col, dtype=np.int32)
        self.val = np.asarray(val)
        if self.val.ndim != 1:
            raise ValueError("CSR holds scalar values only, got val of "
                             "shape %r" % (self.val.shape,))
        self.ncols = int(ncols) if ncols is not None else (
            int(self.col.max()) + 1 if len(self.col) else 0)

    @property
    def nrows(self) -> int:
        return len(self.ptr) - 1

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz(self) -> int:
        return len(self.col)

    @property
    def dtype(self):
        return self.val.dtype

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.ptr)

    def expanded_rows(self) -> np.ndarray:
        """Row index per nonzero (cached — instances are treated as
        immutable once built)."""
        r = getattr(self, "_rows_cache", None)
        if r is None or len(r) != self.nnz:
            r = np.repeat(np.arange(self.nrows), self.row_nnz())
            self._rows_cache = r
        return r

    def copy(self) -> "CSR":
        return CSR(self.ptr.copy(), self.col.copy(), self.val.copy(),
                   self.ncols)

    def __repr__(self):
        return (f"CSR({self.nrows}x{self.ncols}, nnz={self.nnz}, "
                f"dtype={self.dtype})")

    # -- conversions --------------------------------------------------------

    @classmethod
    def from_scipy(cls, m) -> "CSR":
        m = sp.csr_matrix(m)
        m.sort_indices()
        return cls(m.indptr, m.indices, m.data, m.shape[1])

    def to_scipy(self):
        return sp.csr_matrix(
            (self.val, self.col, self.ptr), shape=(self.nrows, self.ncols))

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    # -- setup-phase algebra (builtin.hpp:333-909) --------------------------

    def transpose(self) -> "CSR":
        m = self.to_scipy().T.tocsr()
        m.sort_indices()
        return CSR(m.indptr, m.indices, m.data, self.nrows)

    def __matmul__(self, other: "CSR") -> "CSR":
        """SpGEMM through scipy (builtin.hpp:378-397)."""
        return CSR.from_scipy(self.to_scipy() @ other.to_scipy())

    def __add__(self, other: "CSR") -> "CSR":
        return CSR.from_scipy(self.to_scipy() + other.to_scipy())

    def diagonal(self, invert: bool = False) -> np.ndarray:
        """(Optionally inverted) diagonal (builtin.hpp:751-773)."""
        d = np.zeros(self.nrows, dtype=self.dtype)
        rows = self.expanded_rows()
        mask = rows == self.col
        d[rows[mask]] = self.val[mask]
        if invert:
            with np.errstate(divide="ignore"):
                d = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)
        return d

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Host reference SpMV (setup and tests only)."""
        return self.to_scipy() @ x

    def scale_rows(self, d: np.ndarray) -> "CSR":
        """Left-multiply by a diagonal."""
        out = self.copy()
        out.val = self.val * d[self.expanded_rows()]
        return out

    def filter_rows(self, keep_mask_per_entry: np.ndarray) -> "CSR":
        """Drop entries where the mask is False."""
        keep = np.asarray(keep_mask_per_entry, dtype=bool)
        new_rows = self.expanded_rows()[keep]
        counts = np.bincount(new_rows, minlength=self.nrows)
        ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return CSR(ptr, self.col[keep], self.val[keep], self.ncols)


def spectral_radius(A: CSR) -> float:
    """Gershgorin bound on the spectral radius of D⁻¹A:
    max_i Σ_j |a_ij| / |a_ii| (builtin.hpp:775-820)."""
    dia = A.diagonal()
    inv_dia = np.where(dia != 0, 1.0 / np.where(dia != 0, dia, 1), 1.0)
    s = np.abs(A.to_scipy()).sum(axis=1)
    absrow = np.asarray(s).ravel()
    return float(np.max(np.abs(inv_dia) * absrow))
