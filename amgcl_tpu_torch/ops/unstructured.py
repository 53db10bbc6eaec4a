"""Windowed ELL: the device format for unstructured but banded matrices.

Counterpart of the scalar half of ``amgcl_tpu/ops/unstructured.py``.
Rows are binned into tiles of ``_TILE`` rows; each tile reads x through
one window ``x[start : start + win]``, and its column indices are stored
relative to the window start. The device arrays are::

    window_starts (n_tiles,)                  int32
    cols_local    (n_tiles, tile, K)           int32
    vals          (n_tiles, tile, K[, br, bc]) float32, float64 or
                                               bfloat16

with padding entries at local column 0 and value 0. Block matrices
(BCSR) index block columns and carry ``(br, bc)`` blocks; their shape is
in block units and x holds ``bc`` entries per block column. The port
builds the same arrays as the JAX package (same tile, window alignment,
K padding and decline rules), so the two can be compared entry for
entry. The TPU DMAs each window into VMEM; the Hopper kernels
(``amgcl_tpu_torch/csrc/well_block.cu``, scalar values as 1×1 blocks;
wrappers in :mod:`amgcl_tpu_torch.ops.well_kernels` and
:mod:`amgcl_tpu_torch.ops.well_block_kernels`; the products of scalar
operators with K ≤ 16, ``csrc/gather.cu`` through
:mod:`amgcl_tpu_torch.ops.gather_kernels`) gather from device memory and
L2 directly.
"""

from __future__ import annotations

import numpy as np
import torch

from amgcl_tpu_torch.ops import gather_kernels as gk
from amgcl_tpu_torch.ops import well_block_kernels as wbk
from amgcl_tpu_torch.ops import well_kernels as wk
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.utils.devices import host_tensor, np_dtype

_TILE = 1024          # rows per tile
_WIN_ALIGN = 1024     # window starts floored to, widths rounded up to this


class WindowedEllMatrix:
    """ELL storage binned into row tiles with per-tile x windows:
    ``cols_local[t, r, k]`` is the column of entry k of row ``t*tile + r``
    relative to ``window_starts[t]``. ``win`` is the widest window, rounded
    up to ``_WIN_ALIGN``. ``block`` is ``(br, bc)`` for block values
    (``vals`` then has trailing ``(br, bc)`` dims and ``shape`` counts
    block rows and columns), ``(1, 1)`` for scalar values."""

    def __init__(self, window_starts, cols_local, vals, shape, win,
                 block=(1, 1)):
        self.window_starts = window_starts    # (n_tiles,) int32
        self.cols_local = cols_local          # (n_tiles, tile, K) int32
        self.vals = vals                      # (n_tiles, tile, K[, br, bc])
        self.shape = (int(shape[0]), int(shape[1]))
        self.win = int(win)
        self.block = (int(block[0]), int(block[1]))

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def tile(self):
        return self.cols_local.shape[1]

    @property
    def K(self):
        return self.cols_local.shape[2]

    def mv(self, x):
        """y = A x: a scalar operator with K up to ``AUTO_MAX_K`` goes to
        the gather kernel (the reference's ``maybe_gather_spmv`` first
        branch, amgcl_tpu/ops/unstructured.py:115-126), any other to the
        windowed-ELL kernel of its values."""
        if self.block == (1, 1):
            fn = gk.gather_spmv if self.K <= gk.AUTO_MAX_K \
                else wk.windowed_ell_spmv
        else:
            fn = wbk.windowed_ell_block_spmv
        return fn(self.window_starts, self.cols_local, self.vals, x,
                  self.shape[0])

    def bytes(self):
        return (self.cols_local.numel() * self.cols_local.element_size()
                + self.vals.numel() * self.vals.element_size()
                + self.window_starts.numel() * 4)


def tile_windows(A: CSR, tile: int = _TILE):
    """Per-row-tile aligned column windows over tiles of ``tile`` rows
    (windowed ELL keeps _TILE, the dense window passes its 64): returns
    (n_tiles, rows, tiles, starts, win) with ``starts`` floored to
    _WIN_ALIGN and ``win`` the _WIN_ALIGN-rounded widest span. A tile
    without entries starts at the column count, floored like the others
    (its padding reads land at or past the end of x, which the kernels
    treat as zero)."""
    n, m = A.shape
    n_tiles = -(-n // tile)
    rows = A.expanded_rows()
    tiles = rows // tile
    # each row's column range, then each tile's
    row_min = np.full(n_tiles * tile, m, dtype=np.int64)
    row_max = np.full(n_tiles * tile, -1, dtype=np.int64)
    nz = np.flatnonzero(A.row_nnz())
    if len(nz):
        first = A.ptr[nz]
        row_min[nz] = np.minimum.reduceat(A.col, first)
        row_max[nz] = np.maximum.reduceat(A.col, first)
    starts = row_min.reshape(n_tiles, tile).min(axis=1)
    ends = row_max.reshape(n_tiles, tile).max(axis=1) + 1
    empty = ends <= starts
    starts[empty] = m
    ends[empty] = m + 1
    starts = (starts // _WIN_ALIGN) * _WIN_ALIGN
    span = ends - starts
    win = int(span.max()) if n_tiles else 1
    win = -(-win // _WIN_ALIGN) * _WIN_ALIGN
    return n_tiles, rows, tiles, starts, win


def csr_to_windowed_ell(A: CSR, dtype=torch.float32,
                        max_win_bytes: int = 8 << 20, why=None,
                        device="cpu"):
    """Pack a host CSR (scalar or BCSR) into windowed ELL on ``device``.
    Windows come from the matrix as given (apply a bandwidth-reducing
    permutation such as :func:`amgcl_tpu_torch.utils.adapters.
    cuthill_mckee` first where it pays). Returns None when the widest
    window, at 4 bytes a scalar column (``bc`` of them per block column),
    exceeds ``max_win_bytes`` (the reference's VMEM budget, kept so that
    the two packages choose the same format); ``why`` (a dict) then
    receives the reason."""
    br, bc = A.block_size
    n, m = A.shape
    nnz_row = A.row_nnz()
    K = max(4, int(nnz_row.max()) if n else 1)
    K = -(-K // 4) * 4
    n_tiles, rows, tiles, starts, win = tile_windows(A)
    if win * bc * np.dtype(np.float32).itemsize > max_win_bytes:
        if why is not None:
            why["why"] = "window %d col x 4 B > %d B VMEM budget" \
                % (win * bc, max_win_bytes)
        return None
    flat = rows * K + (np.arange(A.nnz) - A.ptr[rows])
    cols = np.zeros(n_tiles * _TILE * K, dtype=np.int32)
    cols[flat] = A.col - starts[tiles]
    blk = A.val.shape[1:]
    vals = np.zeros((n_tiles * _TILE * K,) + blk, dtype=np_dtype(dtype))
    vals[flat] = A.val
    return WindowedEllMatrix(
        torch.as_tensor(starts.astype(np.int32), device=device),
        torch.as_tensor(cols.reshape(n_tiles, _TILE, K), device=device),
        host_tensor(vals.reshape((n_tiles, _TILE, K) + blk), dtype, device),
        A.shape, win, (br, bc))


def fe_like_problem(n: int = 85623, nnz_target: int = 2_370_000,
                    seed: int = 0):
    """Synthetic unstructured FE-style SPD system with poisson3Db's
    profile (85,623 unknowns, about 2.37M nonzeros; the MatrixMarket file
    itself is not shipped): random points in a unit cube, their k-nearest
    neighbour graph, the symmetrised graph Laplacian plus a small mass
    term. Edge weights scale like a FE stiffness entry, 1/h² with h the
    node distance (floored at a fifth of the median distance), so the
    per-row weight spread gives strength-of-connection coarsening real
    structure. Returns ``(A, rhs)`` with ``rhs`` all ones; the same
    ``seed`` gives the same system as the JAX package's."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 3)
    k = max(int(round(nnz_target / n)) - 1, 4)
    from scipy.spatial import cKDTree
    tree = cKDTree(pts)
    dist, idx = tree.query(pts, k=k + 1)
    rows = np.repeat(np.arange(n), k)
    cols = idx[:, 1:].reshape(-1)
    d = dist[:, 1:].reshape(-1)
    d = np.maximum(d, 0.2 * np.median(d))
    d2 = d * d
    w = (1.0 / d2) * (0.9 + 0.2 * rng.rand(len(rows)))
    w *= np.mean(d2)
    import scipy.sparse as sp
    G = sp.coo_matrix((w, (rows, cols)), shape=(n, n))
    G = (G + G.T) * 0.5
    L = sp.diags(np.asarray(G.sum(axis=1)).ravel() + 0.01) - G
    Lc = L.tocsr()
    Lc.sort_indices()
    return CSR.from_scipy(Lc), np.ones(n)
