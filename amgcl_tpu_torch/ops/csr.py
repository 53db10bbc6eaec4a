"""Host-side CSR build format and setup-phase matrix algebra.

Counterpart of ``amgcl_tpu/ops/csr.py`` (the reference's *builtin*
backend matrix, amgcl/backend/builtin.hpp:55-909). Everything here runs
on the host in numpy, the products in the native set-up library
(:mod:`amgcl_tpu_torch.native`) or scipy.sparse; the device
never sees this class — hierarchies are converted to device formats by
:mod:`amgcl_tpu_torch.ops.device`.

Block (BCSR) values are a trailing ``(br, bc)`` on ``val``, the
reference's ``static_matrix`` value type
(amgcl/value_type/static_matrix.hpp:43-342) without a class of its own.
Block sums, and block products without the native library, go through
the scalar matrix (``unblock`` → scipy → ``to_block``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class CSR:
    """Compressed sparse row matrix with scalar or block values.

    Attributes:
      ptr: (n+1,) int64 row pointers.
      col: (nnz,) int32 column indices (block columns for block values).
      val: (nnz,) scalar values, or (nnz, br, bc) block values.
      ncols: number of (block) columns.
    """

    def __init__(self, ptr, col, val, ncols=None):
        self.ptr = np.asarray(ptr, dtype=np.int64)
        self.col = np.asarray(col, dtype=np.int32)
        self.val = np.asarray(val)
        if self.val.ndim not in (1, 3):
            raise ValueError("CSR values are (nnz,) scalars or (nnz, br, "
                             "bc) blocks, got shape %r" % (self.val.shape,))
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
    def block_size(self):
        """(br, bc) for block values, (1, 1) for scalar."""
        if self.val.ndim == 3:
            return (self.val.shape[1], self.val.shape[2])
        return (1, 1)

    @property
    def is_block(self) -> bool:
        return self.val.ndim == 3

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
        b = self.block_size
        blk = f", block={b[0]}x{b[1]}" if self.is_block else ""
        return (f"CSR({self.nrows}x{self.ncols}, nnz={self.nnz}, "
                f"dtype={self.dtype}{blk})")

    # -- conversions --------------------------------------------------------

    @classmethod
    def from_scipy(cls, m) -> "CSR":
        m = sp.csr_matrix(m)
        m.sort_indices()
        return cls(m.indptr, m.indices, m.data, m.shape[1])

    def to_scipy(self):
        """Scalar scipy CSR (block values are expanded)."""
        if self.is_block:
            return self.unblock().to_scipy()
        return sp.csr_matrix(
            (self.val, self.col, self.ptr), shape=(self.nrows, self.ncols))

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    # -- block <-> scalar views (amgcl/adapter/block_matrix.hpp:44,
    #    amgcl/coarsening/as_scalar.hpp:46) ---------------------------------

    def to_block(self, b: int) -> "CSR":
        """A scalar CSR with b×b block structure as a BCSR."""
        if self.is_block or self.nrows % b or self.ncols % b:
            raise ValueError("to_block(%d) needs a scalar matrix whose "
                             "shape divides by %d, got %r" % (b, b, self))
        m = sp.bsr_matrix(self.to_scipy(), blocksize=(b, b))
        m.sort_indices()
        return CSR(m.indptr, m.indices, m.data, self.ncols // b)

    def unblock(self) -> "CSR":
        """A BCSR expanded to a scalar CSR."""
        if not self.is_block:
            raise ValueError("unblock() needs block values, got %r" % self)
        br, bc = self.block_size
        m = sp.bsr_matrix((self.val, self.col, self.ptr),
                          shape=(self.nrows * br, self.ncols * bc)).tocsr()
        m.sort_indices()
        return CSR(m.indptr, m.indices, m.data, m.shape[1])

    # -- setup-phase algebra (builtin.hpp:333-909) --------------------------

    def transpose(self) -> "CSR":
        """Sparse transpose (builtin.hpp:346-376); block values are
        transposed one by one."""
        if self.is_block:
            rows = self.expanded_rows()
            order = np.lexsort((rows, self.col))
            counts = np.bincount(self.col, minlength=self.ncols)
            ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            return CSR(ptr, rows[order],
                       np.swapaxes(self.val[order], 1, 2).copy(), self.nrows)
        m = self.to_scipy().T.tocsr()
        m.sort_indices()
        return CSR(m.indptr, m.indices, m.data, self.nrows)

    def __matmul__(self, other: "CSR") -> "CSR":
        """SpGEMM (builtin.hpp:378-397): the native library's OpenMP hash
        product where it takes the operands (``native.native_spgemm``:
        float32 or float64, scalar or block values, at least two
        threads), else scipy's, block operands unblocked and the product
        blocked again by self's block rows unless both block sizes it
        would take are 1."""
        from amgcl_tpu_torch.native import native_spgemm
        got = native_spgemm(self, other)
        if got is not None:
            cval = got[2]
            want = np.result_type(self.val.dtype, other.val.dtype)
            if cval.dtype != want:
                cval = cval.astype(want)
            return CSR(got[0], got[1], cval, other.ncols)
        c = CSR.from_scipy(self.to_scipy() @ other.to_scipy())
        if (self.block_size[0], other.block_size[1]) != (1, 1):
            return c.to_block(self.block_size[0])
        return c

    def __add__(self, other: "CSR") -> "CSR":
        c = CSR.from_scipy(self.to_scipy() + other.to_scipy())
        return c.to_block(self.block_size[0]) if self.is_block else c

    def diagonal(self, invert: bool = False) -> np.ndarray:
        """(Optionally inverted) diagonal (builtin.hpp:751-773): (n,) for
        scalar values, (n, br, bc) blocks for block values, each inverted
        as a dense block with ``invert``."""
        rows = self.expanded_rows()
        mask = rows == self.col
        if self.is_block:
            d = np.zeros((self.nrows,) + self.block_size, dtype=self.dtype)
            d[rows[mask]] = self.val[mask]
            return np.linalg.inv(d) if invert else d
        d = np.zeros(self.nrows, dtype=self.dtype)
        d[rows[mask]] = self.val[mask]
        if invert:
            with np.errstate(divide="ignore"):
                d = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)
        return d

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Host reference SpMV over scalar unknowns (setup and tests
        only)."""
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


def pointwise_matrix(A: CSR, block_size: int) -> CSR:
    """One value per b×b block (builtin.hpp:560-661): the block's
    Frobenius norm, negated off the diagonal so that the strength test
    sees an M-matrix's sign pattern. ``A`` is a BCSR or a scalar matrix
    with b×b block structure."""
    B = A if A.is_block else A.to_block(block_size)
    norms = np.sqrt((B.val.astype(np.float64) ** 2).sum(axis=(1, 2)))
    sign = np.where(B.expanded_rows() == B.col, 1.0, -1.0)
    return CSR(B.ptr, B.col, norms * sign, B.ncols)


def spectral_radius(A: CSR, power_iters: int = 0,
                    scale: bool = True) -> float:
    """Spectral radius of D⁻¹A (``scale``) or of A (builtin.hpp:775-909).

    ``power_iters == 0`` gives the Gershgorin bound max_i Σ_j |a_ij| /
    |a_ii| (or the largest absolute row sum without ``scale``); otherwise
    ``power_iters`` power iterations from the reference's seeded start
    vector (builtin.hpp:852). Block values are unblocked first."""
    S = A.unblock() if A.is_block else A
    m = S.to_scipy()
    dia = S.diagonal()
    inv_dia = np.where(dia != 0, 1.0 / np.where(dia != 0, dia, 1), 1.0)
    if power_iters <= 0:
        absrow = np.asarray(np.abs(m).sum(axis=1)).ravel()
        if scale:
            return float(np.max(np.abs(inv_dia) * absrow))
        return float(np.max(absrow))
    b = np.random.RandomState(2345).rand(m.shape[0])
    b /= np.linalg.norm(b)
    radius = 1.0
    for _ in range(power_iters):
        b = inv_dia * (m @ b) if scale else m @ b
        nrm = np.linalg.norm(b)
        if nrm == 0:
            return 0.0
        radius = nrm
        b /= nrm
    return float(radius)
