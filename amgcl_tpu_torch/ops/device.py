"""Device formats and the backend primitive set.

Counterpart of ``amgcl_tpu/ops/device.py`` (the reference's backend
contract, amgcl/backend/interface.hpp:189-443): matrix types holding
tensors, plain tensors as vectors, and the primitives the solve phase is
written against. Formats:

* :class:`DiaMatrix` — diagonal storage; its products go through the
  DIA kernels of :mod:`amgcl_tpu_torch.ops.dia_kernels`.
* :class:`EllMatrix` — padded-row storage; a gather plus a row sum.
* :class:`DenseMatrix` — small dense operator; a matrix product.
"""

from __future__ import annotations

import numpy as np
import torch

from amgcl_tpu_torch.ops import dia_kernels as dk
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.utils.devices import resolve_device

#: ELL row widths are padded up to a multiple of this
_ELL_PAD = 4

#: auto-format thresholds (the accelerator values of the reference,
#: amgcl_tpu/ops/device.py:460-468, on every device): DIA up to this many
#: diagonals and this storage fill, under a 2 GiB data guard
MAX_DIAGS = 512
MAX_FILL = 16.0
DIA_MAX_BYTES = 2 << 30
DENSE_CUTOFF = 2048


class DiaMatrix:
    """Diagonal-format sparse matrix (possibly rectangular): ``data[k, i]``
    holds ``A[i, i + offsets[k]]``. ``offsets`` is a tuple of ints;
    ``offsets_t`` the same offsets as an int32 tensor on the data's
    device, the form the kernels take."""

    def __init__(self, offsets, data, shape):
        self.offsets = tuple(int(o) for o in offsets)
        self.data = data                       # (ndiag, nrows)
        self.shape = (int(shape[0]), int(shape[1]))
        self.offsets_t = torch.tensor(self.offsets, dtype=torch.int32,
                                      device=data.device)

    @property
    def dtype(self):
        return self.data.dtype

    def mv(self, x):
        return dk.dia_spmv(self.offsets_t, self.data, x)

    def bytes(self):
        return self.data.numel() * self.data.element_size()


class EllMatrix:
    """ELLPACK matrix: cols (n, K) int64, vals (n, K). Padding entries
    have col == 0 and val == 0."""

    def __init__(self, cols, vals, shape):
        self.cols = cols
        self.vals = vals
        self.shape = (int(shape[0]), int(shape[1]))

    @property
    def dtype(self):
        return self.vals.dtype

    def mv(self, x):
        return (self.vals * x[self.cols]).sum(dim=1)

    def bytes(self):
        return (self.cols.numel() * self.cols.element_size()
                + self.vals.numel() * self.vals.element_size())


class DenseMatrix:
    """Small dense operator (coarse levels)."""

    def __init__(self, a):
        self.a = a

    @property
    def shape(self):
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    def mv(self, x):
        return self.a @ x

    def bytes(self):
        return self.a.numel() * self.a.element_size()


# -- conversion -------------------------------------------------------------

def _np_dtype(dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def dia_offsets(A: CSR) -> np.ndarray:
    """Distinct diagonals of A (cached on the matrix)."""
    off = getattr(A, "_dia_offsets_cache", None)
    if off is None:
        d = A.col.astype(np.int64) - A.expanded_rows()
        # bincount over the [-(m-1), n-1] diagonal range beats
        # np.unique's sort on stencil matrices
        base = A.nrows - 1
        hits = np.bincount(d + base, minlength=base + A.ncols)
        off = np.flatnonzero(hits) - base
        A._dia_offsets_cache = off
    return off


def csr_to_ell(A: CSR, dtype=torch.float32, device="cpu") -> EllMatrix:
    """Pack a host CSR into ELL format on ``device``."""
    nnz_row = A.row_nnz()
    K = int(nnz_row.max()) if A.nrows and A.nnz else 1
    K = max(_ELL_PAD, -(-K // _ELL_PAD) * _ELL_PAD)
    n = A.nrows
    rows = A.expanded_rows()
    flat_idx = rows * K + (np.arange(A.nnz) - A.ptr[rows])
    cols = np.zeros(n * K, dtype=np.int64)
    cols[flat_idx] = A.col
    vals = np.zeros(n * K, dtype=A.val.dtype)
    vals[flat_idx] = A.val
    return EllMatrix(
        torch.as_tensor(cols.reshape(n, K), device=device),
        torch.as_tensor(vals.reshape(n, K), device=device).to(dtype),
        A.shape)


def csr_to_dia(A: CSR, dtype=torch.float32, device="cpu") -> DiaMatrix:
    """Pack a host CSR into DIA format on ``device``."""
    pre = getattr(A, "_dia_prepacked", None)
    if pre is not None:
        # stencil-setup levels are born in DIA layout (ops/stencil.py):
        # the move is a cast + transfer
        offs, data = pre
        return DiaMatrix(list(offs), torch.as_tensor(
            np.ascontiguousarray(data, _np_dtype(dtype)), device=device),
            A.shape)
    offsets = dia_offsets(A)
    rows = A.expanded_rows()
    d = A.col.astype(np.int64) - rows
    base = A.nrows - 1
    lut = np.zeros(base + A.ncols, dtype=np.int64)
    lut[offsets + base] = np.arange(len(offsets))
    flat = np.zeros(len(offsets) * A.nrows, dtype=_np_dtype(dtype))
    flat[lut[d + base] * A.nrows + rows] = A.val
    return DiaMatrix(offsets.tolist(), torch.as_tensor(
        flat.reshape(len(offsets), A.nrows), device=device), A.shape)


def dia_efficiency(A: CSR):
    """(ndiags, fill_ratio) of the DIA packing; fill = stored / nnz."""
    nd = len(dia_offsets(A))
    return nd, nd * A.nrows / max(A.nnz, 1)


def to_device(A, fmt: str = "auto", dtype=torch.float32, device=None):
    """Move a host matrix to ``device`` (None means CUDA) in a device
    format: ``fmt`` is 'auto' | 'dia' | 'ell' | 'dense'. Auto picks dense
    for small dense-ish matrices, DIA when the matrix is banded enough
    (at most MAX_DIAGS diagonals, fill at most MAX_FILL, data under
    DIA_MAX_BYTES), ELL otherwise."""
    from amgcl_tpu_torch.ops.stencil import HostDia
    device = resolve_device(device)
    if isinstance(A, HostDia):
        # stencil-setup smoother operators live in DIA layout already
        flat = A.flat_offsets()
        order = np.argsort(flat)
        return DiaMatrix(
            [flat[k] for k in order],
            torch.as_tensor(np.ascontiguousarray(
                A.data[order], _np_dtype(dtype)), device=device),
            A.shape)
    if fmt not in ("auto", "dia", "ell", "dense"):
        raise ValueError("unknown device format %r" % (fmt,))
    auto = fmt == "auto"
    if fmt == "dense" or (auto and max(A.shape) <= DENSE_CUTOFF
                          and A.nnz > 0.02 * A.shape[0] * A.shape[1]):
        return DenseMatrix(torch.as_tensor(A.to_dense(),
                                           device=device).to(dtype))
    if fmt == "dia":
        return csr_to_dia(A, dtype, device)
    if auto:
        nd, fill = dia_efficiency(A)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if nd <= MAX_DIAGS and fill <= MAX_FILL \
                and nd * A.nrows * itemsize < DIA_MAX_BYTES:
            return csr_to_dia(A, dtype, device)
    return csr_to_ell(A, dtype, device)


# -- backend primitives (reference: amgcl/backend/interface.hpp:253-443) ----

def spmv(A, x):
    """y = A x."""
    return A.mv(x)


def residual(f, A, x):
    """r = f − A x; one kernel pass for DIA operators."""
    if isinstance(A, DiaMatrix):
        return dk.dia_residual(A.offsets_t, A.data, f, x)
    return f - A.mv(x)


def scaled_correction(A, w, f, x):
    """x + w ∘ (f − A x) in one kernel pass for square DIA operators with a
    per-unknown scale, else None (the smoother composes)."""
    if isinstance(A, DiaMatrix) and w.dim() == 1 \
            and A.shape[0] == A.shape[1]:
        return dk.dia_scaled_correction(A.offsets_t, A.data, w, f, x)
    return None


def axpby(a, x, b, y):
    """a x + b y."""
    return a * x + b * y


def inner_product(x, y):
    """Real dot product as a 0-d tensor on the vectors' device."""
    return torch.dot(x, y)


def spmv_dots(A, x, w=None):
    """(y, ⟨y,y⟩, ⟨y,x⟩, ⟨y,w⟩) with y = A x; one kernel pass for square
    DIA operators (⟨y,w⟩ is None without w)."""
    if isinstance(A, DiaMatrix) and A.shape[0] == A.shape[1]:
        return dk.dia_spmv_dots(A.offsets_t, A.data, x, w)
    y = A.mv(x)
    return (y, inner_product(y, y), inner_product(y, x),
            None if w is None else inner_product(y, w))


def spmv_dot(A, p):
    """(q, ⟨q, p⟩) with q = A p — the CG hot pair."""
    q, _, qp, _ = spmv_dots(A, p)
    return q, qp


def norm(x):
    return torch.sqrt(torch.abs(inner_product(x, x)))


def clear(x):
    return torch.zeros_like(x)
