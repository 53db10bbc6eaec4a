"""Device formats and the backend primitive set.

Counterpart of ``amgcl_tpu/ops/device.py`` (the reference's backend
contract, amgcl/backend/interface.hpp:189-443): matrix types holding
tensors, plain tensors as vectors, and the primitives the solve phase is
written against. Formats:

* :class:`DiaMatrix` — diagonal storage; its products go through the
  DIA kernels of :mod:`amgcl_tpu_torch.ops.dia_kernels`.
* :class:`~amgcl_tpu_torch.ops.unstructured.WindowedEllMatrix` — padded
  rows binned into tiles with per-tile x windows, scalar or block values;
  its products go through the windowed-ELL kernels of
  :mod:`amgcl_tpu_torch.ops.well_kernels` and
  :mod:`amgcl_tpu_torch.ops.well_block_kernels`.
* :class:`~amgcl_tpu_torch.ops.densewin.DenseWindowMatrix` — dense
  (64, win) row-tile window blocks, named explicitly (``fmt="dwin"``) and
  never picked by ``auto``; its products go through the dense-window
  kernels of :mod:`amgcl_tpu_torch.ops.densewin_kernels`.
* :class:`EllMatrix` — padded-row storage, scalar or block values; a
  gather plus a row sum (the JAX package has no kernel for it either).
* :class:`DenseMatrix` — small dense operator; a matrix product.
"""

from __future__ import annotations

import numpy as np
import torch

from amgcl_tpu_torch.ops import densewin_kernels as dwk
from amgcl_tpu_torch.ops import dia_kernels as dk
from amgcl_tpu_torch.ops import well_block_kernels as wbk
from amgcl_tpu_torch.ops import well_kernels as wk
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.ops.densewin import (DenseWindowMatrix,
                                          csr_to_dense_window)
from amgcl_tpu_torch.ops.unstructured import (WindowedEllMatrix,
                                              csr_to_windowed_ell)
from amgcl_tpu_torch.telemetry.ledger import DWIN_MAX_BYTES
from amgcl_tpu_torch.utils.devices import (host_tensor, np_dtype,
                                           resolve_device)

#: ELL row widths are padded up to a multiple of this
_ELL_PAD = 4

#: auto-format thresholds (the accelerator values of the reference,
#: amgcl_tpu/ops/device.py:460-468, on every device): DIA up to this many
#: diagonals and this storage fill, under a 2 GiB data guard
MAX_DIAGS = 512
MAX_FILL = 16.0
DIA_MAX_BYTES = 2 << 30
DENSE_CUTOFF = 2048
#: widest windowed-ELL window that auto accepts, at 4 bytes a column (the
#: reference's auto budget, amgcl_tpu/ops/device.py:556)
WELL_MAX_WIN_BYTES = 4 << 20


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
    """ELLPACK matrix: cols (n, K) int64, vals (n, K), or (n, K, br, bc)
    for block values (``block`` = (br, bc); shape and cols in block
    units, x and y flat). Padding entries have col == 0 and val == 0."""

    def __init__(self, cols, vals, shape, block=(1, 1)):
        self.cols = cols
        self.vals = vals
        self.shape = (int(shape[0]), int(shape[1]))
        self.block = (int(block[0]), int(block[1]))

    @property
    def dtype(self):
        return self.vals.dtype

    def mv(self, x):
        if self.block == (1, 1):
            return (self.vals * x[self.cols]).sum(dim=1)
        xg = x.reshape(self.shape[1], self.block[1])[self.cols]
        return torch.einsum("nkij,nkj->ni", self.vals, xg).reshape(-1)

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

def dia_offsets(A: CSR) -> np.ndarray:
    """Distinct diagonals of A (cached on the matrix): the native mark
    pass, else a bincount over the diagonal range."""
    off = getattr(A, "_dia_offsets_cache", None)
    if off is None:
        from amgcl_tpu_torch.native import native_dia_offsets
        off = native_dia_offsets(A)
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
    """Pack a host CSR or BCSR into ELL format on ``device``: the native
    pack, with the cast to a float32 or float64 ``dtype`` fused in, else
    one flat numpy scatter."""
    nnz_row = A.row_nnz()
    K = int(nnz_row.max()) if A.nrows and A.nnz else 1
    K = max(_ELL_PAD, -(-K // _ELL_PAD) * _ELL_PAD)
    n = A.nrows
    if dtype in (torch.float32, torch.float64):
        from amgcl_tpu_torch.native import native_ell_pack
        got = native_ell_pack(A, K, np_dtype(dtype))
        if got is not None:
            return EllMatrix(
                torch.as_tensor(got[0], device=device).long(),
                torch.as_tensor(got[1], device=device), A.shape,
                A.block_size)
    rows = A.expanded_rows()
    flat_idx = rows * K + (np.arange(A.nnz) - A.ptr[rows])
    cols = np.zeros(n * K, dtype=np.int64)
    cols[flat_idx] = A.col
    blk = A.val.shape[1:]
    vals = np.zeros((n * K,) + blk, dtype=A.val.dtype)
    vals[flat_idx] = A.val
    return EllMatrix(
        torch.as_tensor(cols.reshape(n, K), device=device),
        host_tensor(vals.reshape((n, K) + blk), dtype, device),
        A.shape, A.block_size)


def csr_to_dia(A: CSR, dtype=torch.float32, device="cpu") -> DiaMatrix:
    """Pack a host CSR into DIA format on ``device``."""
    pre = getattr(A, "_dia_prepacked", None)
    if pre is not None:
        # stencil-setup levels are born in DIA layout (ops/stencil.py):
        # the move is a cast + transfer
        offs, data = pre
        return DiaMatrix(list(offs), host_tensor(data, dtype, device),
                         A.shape)
    offsets = dia_offsets(A)
    if dtype in (torch.float32, torch.float64):
        # the native scatter fuses the cast to the device dtype
        from amgcl_tpu_torch.native import native_dia_pack
        data = native_dia_pack(A, offsets, np_dtype(dtype))
        if data is not None:
            return DiaMatrix(offsets.tolist(),
                             torch.as_tensor(data, device=device), A.shape)
    rows = A.expanded_rows()
    d = A.col.astype(np.int64) - rows
    base = A.nrows - 1
    lut = np.zeros(base + A.ncols, dtype=np.int64)
    lut[offsets + base] = np.arange(len(offsets))
    flat = np.zeros(len(offsets) * A.nrows, dtype=np_dtype(dtype))
    flat[lut[d + base] * A.nrows + rows] = A.val
    return DiaMatrix(offsets.tolist(), host_tensor(
        flat.reshape(len(offsets), A.nrows), dtype, device), A.shape)


def csr_to_dia_remainder(A: CSR, hi: DiaMatrix) -> DiaMatrix:
    """float32 DIA matrix of the rounding remainders A − f32(A), laid out
    along ``hi``'s offsets on ``hi``'s device: the low half of the
    double-float operator pair of the df32 refinement residual
    (``ops/dfloat.py``; amgcl_tpu/ops/device.py:310)."""
    assert not A.is_block
    offs = np.asarray(hi.offsets, np.int64)
    order = np.argsort(offs)
    rows = A.expanded_rows()
    d = A.col.astype(np.int64) - rows
    idx_sorted = np.clip(np.searchsorted(offs[order], d), 0, len(offs) - 1)
    k = order[idx_sorted]
    if not np.array_equal(offs[k], d):
        raise ValueError(
            "system matrix has entries outside the device operator's "
            "diagonal set — cannot build the df32 low operator")
    val64 = np.asarray(A.val, np.float64)
    lo_val = (val64 - val64.astype(np.float32).astype(np.float64)) \
        .astype(np.float32)
    data = np.zeros((len(offs), A.nrows), np.float32)
    data[k, rows] = lo_val
    return DiaMatrix(hi.offsets, torch.as_tensor(data, device=hi.data.device),
                     A.shape)


def dia_efficiency(A: CSR):
    """(ndiags, fill_ratio) of the DIA packing; fill = stored / nnz."""
    nd = len(dia_offsets(A))
    return nd, nd * A.nrows / max(A.nnz, 1)


def to_device(A, fmt: str = "auto", dtype=torch.float32, device=None,
              budget=None):
    """Move a host matrix to ``device`` (None means CUDA) in a device
    format: ``fmt`` is 'auto' | 'dia' | 'well' | 'dwin' | 'ell' | 'dense'.
    'dwin' (dense window) raises ValueError where the JAX package's
    does: when :func:`~amgcl_tpu_torch.ops.densewin.csr_to_dense_window`
    declines, drawing on ``budget`` (a hierarchy's shared
    :class:`~amgcl_tpu_torch.telemetry.ledger.DeviceMemoryBudget`) when
    one is given. Auto
    picks dense for small dense-ish matrices; otherwise it tries DIA (at
    most MAX_DIAGS diagonals, fill at most MAX_FILL, data under
    DIA_MAX_BYTES) and windowed ELL (widest window within
    WELL_MAX_WIN_BYTES) in the order of their predicted SpMV bytes
    (:func:`ranked_formats`, the JAX package's ledger-ranked choice), and
    takes ELL where both decline. The JAX package's dense-window format,
    which it tries only on a TPU, is never picked here. A block matrix
    (BCSR) is never made dense or DIA by auto (amgcl_tpu/ops/device.py:
    472, 510): windowed ELL, else ELL."""
    from amgcl_tpu_torch.ops.stencil import HostDia
    device = resolve_device(device)
    if isinstance(A, HostDia):
        # stencil-setup smoother operators live in DIA layout already
        flat = A.flat_offsets()
        order = np.argsort(flat)
        return DiaMatrix([flat[k] for k in order],
                         host_tensor(A.data[order], dtype, device), A.shape)
    if fmt not in ("auto", "dia", "well", "dwin", "ell", "dense"):
        raise ValueError("unknown device format %r" % (fmt,))
    auto = fmt == "auto"
    if fmt == "dense" or (auto and not A.is_block
                          and max(A.shape) <= DENSE_CUTOFF
                          and A.nnz > 0.02 * A.shape[0] * A.shape[1]):
        return DenseMatrix(host_tensor(A.to_dense(), dtype, device))
    if fmt == "dia":
        if A.is_block:
            raise ValueError("DIA format takes scalar matrices, got %r" % A)
        return csr_to_dia(A, dtype, device)
    if fmt == "well":
        W = csr_to_windowed_ell(A, dtype, device=device)
        if W is None:
            raise ValueError(
                "windowed-ELL format needs banded column locality; apply "
                "a Cuthill-McKee reorder first (utils/adapters.py)")
        return W
    if fmt == "dwin":
        D = csr_to_dense_window(A, dtype, budget=budget, device=device)
        if D is None:
            raise ValueError(
                "dense-window format needs banded column locality within "
                "the storage budget (%d bytes); apply a Cuthill-McKee "
                "reorder first (utils/adapters.py)" % (
                    budget.total if budget is not None else DWIN_MAX_BYTES))
        return D
    if auto:
        # the structured candidates, cheapest predicted bytes first; each
        # attempt keeps its own guards, and ELL is the last resort
        # (amgcl_tpu/ops/device.py:498-560)
        itemsize = torch.empty((), dtype=dtype).element_size()
        for f in ranked_formats(_decision_candidates(A, itemsize, budget)):
            if f == "dia" and not A.is_block:
                nd, fill = dia_efficiency(A)
                if nd <= MAX_DIAGS and fill <= MAX_FILL \
                        and nd * A.nrows * itemsize < DIA_MAX_BYTES:
                    return csr_to_dia(A, dtype, device)
            elif f == "well" and not dtype.is_complex:
                W = csr_to_windowed_ell(A, dtype,
                                        max_win_bytes=WELL_MAX_WIN_BYTES,
                                        device=device)
                if W is not None:
                    return W
    return csr_to_ell(A, dtype, device)


def _decision_candidates(A, itemsize, budget):
    """The structure advisor's predicted cost table of A's formats
    (``telemetry/structure.candidate_table``) under this module's auto
    thresholds; dense window is priced but never eligible here
    (``on_tpu=False``)."""
    from amgcl_tpu_torch.telemetry.structure import candidate_table
    return candidate_table(
        A, itemsize=itemsize, on_tpu=False, dense_cutoff=DENSE_CUTOFF,
        max_diags=MAX_DIAGS, max_fill=MAX_FILL,
        well_max_win_bytes=WELL_MAX_WIN_BYTES,
        budget_remaining=budget.remaining() if budget is not None
        else None,
        budget_total=budget.total if budget is not None else None)


def ranked_formats(cands):
    """The order ``to_device('auto')`` tries its structured formats in
    (amgcl_tpu/ops/device.py:402-422): the eligible candidates, cheapest
    predicted SpMV bytes first, then the ineligible ones in the default
    order ("dia", "dwin", "well")."""
    default = ("dia", "dwin", "well")
    priced = {c["format"]: c for c in cands}

    def key(f):
        c = priced.get(f)
        if c is None or not c.get("eligible") \
                or not (c.get("predicted") or {}).get("bytes"):
            return (1, default.index(f))
        return (0, c["predicted"]["bytes"])

    return tuple(sorted(default, key=key))


def refresh_values(M, A: CSR, dtype):
    """M's format and structure with the values of the same-pattern host
    CSR A, on M's device (the numeric rebuild's route, amgcl_tpu/ops/
    device.py:564-620): DIA, dense, ELL and windowed ELL (scalar or
    block) repack A's values into M's structure. Returns None where the
    format has no value-only route (dense window) or where the structure
    A gives differs from M's; the caller then converts A afresh."""
    if isinstance(M, DiaMatrix) and not A.is_block:
        new = csr_to_dia(A, dtype, M.data.device)
        return new if new.offsets == M.offsets else None
    if isinstance(M, DenseMatrix) and not A.is_block:
        return DenseMatrix(host_tensor(A.to_dense(), dtype, M.a.device))
    if isinstance(M, EllMatrix):
        new = csr_to_ell(A, dtype, M.cols.device)
        return new if new.cols.shape == M.cols.shape else None
    if isinstance(M, WindowedEllMatrix):
        n_tiles, tile, K = M.cols_local.shape[:3]
        rows = A.expanded_rows()
        flat = rows * K + (np.arange(A.nnz) - A.ptr[rows])
        if A.nnz and (flat.max() >= n_tiles * tile * K
                      or A.row_nnz().max() > K):
            return None
        vals = np.zeros((n_tiles * tile * K,) + A.val.shape[1:],
                        dtype=np_dtype(dtype))
        vals[flat] = A.val
        return WindowedEllMatrix(
            M.window_starts, M.cols_local,
            host_tensor(vals.reshape((n_tiles, tile, K) + A.val.shape[1:]),
                        dtype, M.vals.device), A.shape, M.win, M.block)
    return None


# -- stacked (n, B) operands ---------------------------------------------------
#
# The JAX package batches its products natively or under a vmap
# (amgcl_tpu/ops/device.py:620-658). The port's hand kernels carry exact
# 1-D shapes, so a stacked operand goes through them column by column: a
# block is stored (B, n), its (n, B) view hands each column out as a
# contiguous vector the kernels take as it is.

def columns(X):
    """The B columns of a stacked (n, B) operand as the rows of a
    contiguous (B, n) tensor: ``X.T`` itself. A stacked operand is the
    (n, B) view of a (B, n) block, laid out once where it enters a
    solve (``solver/stacked.block``); any other layout here is a fault
    of the caller, not a copy to make on the hot path."""
    S = X.T
    if not S.is_contiguous():
        raise AssertionError("a stacked (n, B) operand is not the view of a "
                             "contiguous (B, n) block")
    return S


def stacked(cols):
    """The (n, B) view of the (B, n) stack of B 1-D results."""
    return torch.stack(list(cols)).T


def per_column(fn, *blocks):
    """``[fn(*column b of each block) for b]`` over stacked (n, B) blocks
    (None passes through as None): the 1-D path once a column, each
    column handed over as a contiguous vector."""
    cols = [None if b is None else columns(b) for b in blocks]
    nb = next(c for c in cols if c is not None).shape[0]
    return [fn(*(None if c is None else c[j] for c in cols))
            for j in range(nb)]


def is_stacked(*vecs) -> bool:
    """True when any operand is a stacked (n, B) block."""
    return any(v is not None and v.dim() == 2 for v in vecs)


# -- backend primitives (reference: amgcl/backend/interface.hpp:253-443) ----

def spmv(A, x):
    """y = A x; a stacked (n, B) x column by column through the 1-D
    product."""
    if x.dim() == 2:
        return stacked(per_column(A.mv, x))
    return A.mv(x)


def residual(f, A, x):
    """r = f − A x; one kernel pass for DIA, windowed-ELL (scalar or block)
    and dense-window operators (a stacked (n, B) pair column by
    column)."""
    if is_stacked(f, x):
        return stacked(per_column(lambda fc, xc: residual(fc, A, xc), f, x))
    if isinstance(A, DiaMatrix):
        return dk.dia_residual(A.offsets_t, A.data, f, x)
    if isinstance(A, WindowedEllMatrix):
        fn = wk.windowed_ell_residual if A.block == (1, 1) \
            else wbk.windowed_ell_block_residual
        return fn(A.window_starts, A.cols_local, A.vals, f, x, A.shape[0])
    if isinstance(A, DenseWindowMatrix):
        return dwk.dense_window_residual(A.window_starts, A.blocks, f, x,
                                         A.shape[0])
    return f - A.mv(x)


def scaled_correction(A, w, f, x):
    """x + w ∘ (f − A x) in one kernel pass for square DIA, windowed-ELL
    and dense-window operators with a per-unknown scale, and for square
    block windowed-ELL operators with a per-node (b, b) scale; else None
    (the smoother composes)."""
    if A.shape[0] != A.shape[1]:
        return None
    if isinstance(A, DiaMatrix) and w.dim() == 1:
        return dk.dia_scaled_correction(A.offsets_t, A.data, w, f, x)
    if isinstance(A, WindowedEllMatrix):
        args = (A.window_starts, A.cols_local, A.vals, w, f, x, A.shape[0])
        if A.block == (1, 1) and w.dim() == 1:
            return wk.windowed_ell_scaled_correction(*args)
        if w.dim() == 3 and A.block[0] == A.block[1] == w.shape[-1]:
            return wbk.windowed_ell_block_scaled_correction(*args)
    if isinstance(A, DenseWindowMatrix) and w.dim() == 1:
        return dwk.dense_window_scaled_correction(
            A.window_starts, A.blocks, w, f, x, A.shape[0])
    return None


def axpby(a, x, b, y):
    """a x + b y."""
    return a * x + b * y


def inner_product(x, y):
    """Real dot product as a 0-d tensor on the vectors' device. bfloat16
    vectors are summed in float32 and rounded once to bfloat16, as the
    JAX package's ``jnp.vdot`` and its kernels' dots round."""
    if x.dtype == torch.bfloat16:
        return torch.dot(x.float(), y.float()).to(torch.bfloat16)
    return torch.dot(x, y)


def small_solve(M, b):
    """``M⁻¹ b`` for the small dense systems of the Krylov solvers (the
    Gram systems of BiCGStab(L) and block CG, IDR(s)'s shadow system),
    batched over leading dims. torch has no bfloat16 LU, so a bfloat16
    system is solved in float32 and the solution rounded once to
    bfloat16 (the JAX package's ``jnp.linalg.solve`` refuses bfloat16
    on the CPU)."""
    if M.dtype == torch.bfloat16:
        return torch.linalg.solve_ex(M.float(), b.float())[0].to(M.dtype)
    return torch.linalg.solve_ex(M, b)[0]


def small_solve_upper(R, g):
    """``R⁻¹ g`` for an upper-triangular R (GMRES's least-squares
    factor), batched over leading dims; a bfloat16 system in float32,
    rounded once, as :func:`small_solve`."""
    if R.dtype == torch.bfloat16:
        return torch.linalg.solve_triangular(
            R.float(), g.float(), upper=True).to(R.dtype)
    return torch.linalg.solve_triangular(R, g, upper=True)


def spmv_dots(A, x, w=None):
    """(y, ⟨y,y⟩, ⟨y,x⟩, ⟨y,w⟩) with y = A x; one kernel pass for square
    DIA and windowed-ELL operators, block ones with square blocks (⟨y,w⟩
    is None without w). Other formats, dense window among them, compose
    ``mv`` and the dots, as the JAX package does. A stacked (n, B) x (and
    w) runs column by column, the dots then (B,) tensors."""
    if x.dim() == 2:
        got = per_column(lambda xc, wc: spmv_dots(A, xc, wc), x, w)
        return (stacked(g[0] for g in got),
                torch.stack([g[1] for g in got]),
                torch.stack([g[2] for g in got]),
                None if w is None else torch.stack([g[3] for g in got]))
    if A.shape[0] == A.shape[1]:
        if isinstance(A, DiaMatrix):
            return dk.dia_spmv_dots(A.offsets, A.data, x, w)
        if isinstance(A, WindowedEllMatrix) and A.block[0] == A.block[1]:
            fn = wk.windowed_ell_spmv_dots if A.block == (1, 1) \
                else wbk.windowed_ell_block_spmv_dots
            return fn(A.window_starts, A.cols_local, A.vals, x, w,
                      A.shape[0])
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
