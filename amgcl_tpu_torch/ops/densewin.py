"""Dense window: gather-free storage for unstructured but banded matrices.

Counterpart of ``amgcl_tpu/ops/densewin.py``. Rows are binned into tiles
of 64; each tile's nonzeros lie in one aligned column window (the
windows of :func:`amgcl_tpu_torch.ops.unstructured.tile_windows`), and
the window slice of the tile is stored as a dense ``(64, win)`` block,
so that the product is

    y[tile] = blocks[tile] @ x[start[tile] : start[tile] + win]

with no gather. The JAX package offers it for the TPU, whose gathers are
slow; it trades device memory (``n_tiles·64·win`` values, 3.86 GB in
float32 for the 85,623-row FE level under RCM, for 2.37M nonzeros)
for a streaming product. The port offers it by name
(``to_device(fmt="dwin")``, ``AMGParams(matrix_format="dwin")``) and
never picks it in ``auto``: an H100 gathers from L2 natively, and the
windowed ELL moves two orders of magnitude fewer bytes for the same
product. Its kernels are in :mod:`amgcl_tpu_torch.ops.densewin_kernels`
(``csrc/densewin.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from amgcl_tpu_torch.ops import densewin_kernels as dwk
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.ops.unstructured import tile_windows
from amgcl_tpu_torch.telemetry.ledger import DWIN_MAX_BYTES
from amgcl_tpu_torch.utils.devices import resolve_device

_TILE = 64                 # rows per dense block


class DenseWindowMatrix:
    """blocks: (n_tiles, tile, win) dense window slices; window_starts:
    (n_tiles,) int32, multiples of 1,024. ``shape`` is the logical
    (n, m)."""

    def __init__(self, window_starts, blocks, shape, win):
        self.window_starts = window_starts
        self.blocks = blocks
        self.shape = (int(shape[0]), int(shape[1]))
        self.win = int(win)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def block(self):
        return (1, 1)

    def bytes(self):
        return (self.blocks.numel() * self.blocks.element_size()
                + self.window_starts.numel() * 4)

    def mv(self, x):
        return dwk.dense_window_spmv(self.window_starts, self.blocks, x,
                                     self.shape[0])


def csr_to_dense_window(A: CSR, dtype=torch.float32, budget=None, why=None,
                        device=None):
    """Build the dense-window form of a scalar CSR on ``device`` (None
    means CUDA), or None when it declines; ``why`` (a dict) then receives
    the reason, the JAX package's own: ``"block values"``, ``"complex
    dtype"``, ``"empty"``, ``"budget"`` (the blocks would fit the pool's
    total but not what earlier conversions left), ``"window"`` (too wide
    for the pool even when untouched) or ``"vmem"``.

    ``budget`` (:class:`amgcl_tpu_torch.telemetry.ledger.
    DeviceMemoryBudget`) is the hierarchy-wide pool: the build declines
    once the blocks would overdraw what is left and charges the pool on
    success. Without one, DWIN_MAX_BYTES caps this matrix alone.

    The blocks are built on the device by one scatter of the CSR values
    into a zeroed buffer, at flat index ``row·win + col − start[tile]``:
    no host dense array and no per-slot pass, each of which would hold
    several times the blocks' bytes."""
    def _decline(reason):
        if why is not None:
            why["why"] = reason
        return None

    if A.is_block or dtype.is_complex:
        return _decline("block values" if A.is_block else "complex dtype")
    n, m = A.shape
    if n == 0 or A.nnz == 0:
        return _decline("empty")
    n_tiles, rows, tiles, starts, win = tile_windows(A, _TILE)
    itemsize = torch.empty((), dtype=dtype).element_size()
    need = n_tiles * _TILE * win * itemsize
    if why is not None:
        why["need_bytes"] = int(need)
    if budget is not None:
        cap, hard = budget.remaining(), budget.total
    else:
        cap = hard = DWIN_MAX_BYTES
    if need > cap:
        return _decline("budget" if need <= hard else "window")
    # The reference's width rule (its TPU kernel double-buffers the
    # (tile, win) block and the window in 10 MiB of VMEM), kept so that
    # "dwin" accepts and refuses the same matrices in both packages; the
    # CUDA kernel has no such limit.
    if (2 * _TILE + 4) * win * itemsize > 10 << 20:
        return _decline("vmem")
    device = resolve_device(device)
    flat = rows * win + (A.col.astype(np.int64) - starts[tiles])
    blocks = torch.zeros(n_tiles * _TILE * win, dtype=dtype, device=device)
    if dtype == torch.bfloat16:
        _add_in_slot_order(blocks, flat, A.val)
    else:
        # accumulate: a duplicated (row, col) entry sums, as the
        # reference's one-hot build adds it
        blocks.index_put_(
            (torch.as_tensor(flat, device=device),),
            torch.as_tensor(A.val, device=device).to(dtype),
            accumulate=True)
    if budget is not None:
        # cannot fail: `need` was checked against remaining() above
        budget.try_charge(need)
    return DenseWindowMatrix(
        torch.as_tensor(starts.astype(np.int32), device=device),
        blocks.reshape(n_tiles, _TILE, win), A.shape, win)


def _add_in_slot_order(blocks, flat, val):
    """Add the CSR values ``val`` into bfloat16 ``blocks`` at ``flat`` as
    the reference's one-hot build does (amgcl_tpu/ops/densewin.py:370-381):
    each value rounded to bfloat16 through float32 on the host, and the
    duplicates of one (row, column) added in their CSR order, each sum
    rounded to bfloat16, on any device (an accumulating index_put_ sums
    duplicates in float32 on CUDA and so rounds once)."""
    v = torch.as_tensor(np.asarray(val, np.float32)).to(torch.bfloat16)
    order = np.argsort(flat, kind="stable")
    fs = flat[order]
    first = np.r_[True, fs[1:] != fs[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(fs)), 0))
    rank = np.empty(len(fs), np.int64)
    rank[order] = np.arange(len(fs)) - start
    for r in range(int(rank.max()) + 1 if len(rank) else 0):
        sel = np.flatnonzero(rank == r)
        idx = torch.as_tensor(flat[sel], device=blocks.device)
        blocks[idx] = blocks[idx] + v[sel].to(blocks.device)
