"""Dense-window kernels: a wrapper and a plain PyTorch version for each of
``dense_window_spmv``, ``dense_window_residual`` and
``dense_window_scaled_correction``.

Counterpart of the Pallas TPU kernels of ``amgcl_tpu/ops/densewin.py``
(``dense_window_spmv``, ``dense_window_fused`` in its residual and
correction modes), with their signatures less the window size ``win``,
which is the blocks' last dimension. The CUDA source is
``amgcl_tpu_torch/csrc/densewin.cu``. Storage is that of
:class:`amgcl_tpu_torch.ops.densewin.DenseWindowMatrix`: row ``i`` of
tile ``t = i // tile`` holds ``blocks[t, i % tile, j] = A[i,
window_starts[t] + j]``. A window may reach past the end of x; the
entries there are zero, and the TPU kernel reads them against x padded
with ``win`` zeros.

Every wrapper also takes bfloat16 blocks and vectors (a bfloat16
hierarchy in the dense-window format) in the JAX package's bfloat16
arithmetic: each product exact in float32, a row's sum in float32 and
rounded once, then f − A x, w ∘ r and x + w ∘ r each rounded. The plain
version sums a row in the kernel's order, so the two agree bit for bit.

Each wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it checks device, dtype, shape and contiguity and launches
the kernel, or raises. ``<wrapper>.launches`` counts kernel launches
(``<wrapper>.bf16_launches`` those in bfloat16) and ``<plain>.calls``
counts plain-version calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from amgcl_tpu_torch.ops import cuda_lib
from amgcl_tpu_torch.ops.dia_kernels import (_check_vec, count_launch,
                                             dtype_code)

_SPMV, _RESIDUAL, _CORRECTION = range(3)

_TILE = 64                 # rows per tile: the kernel's block
_WARPS = 8                 # warps of a block
#: bytes of one buffer of the staged x window
_CHUNK_BYTES = 8192
#: bfloat16 values in one 16-byte vector of the kernel
_VEC_BF16 = 8


# -- plain versions -----------------------------------------------------------

def _promoted(*tensors):
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


def _product(window_starts, blocks, x, n_out, out):
    """(A x)[:n_out] in the reference's ``_mv_xla`` arithmetic: each tile's
    window of x (x padded with ``win`` zeros) times its block, summed over
    the window, at the dtype ``out``; in bfloat16 in the kernel's order
    (:func:`_bf16_row_sums`)."""
    n_tiles, tile, win = blocks.shape
    xp = torch.cat([x, x.new_zeros(win)])
    cols = window_starts.to(torch.int64)[:, None] \
        + torch.arange(win, device=x.device)
    if out == torch.bfloat16:
        return _bf16_row_sums(blocks, xp[cols]).reshape(-1)[:n_out]
    y = (blocks.to(out) * xp[cols].to(out)[:, None, :]).sum(dim=2)
    return y.reshape(-1)[:n_out]


def _bf16_row_sums(blocks, xw):
    """The bfloat16 row sums of (n_tiles, tile, win) blocks against each
    tile's (win,) window ``xw``: each product exact in float32, as the JAX
    package forms the TPU kernel's bfloat16 product and ``jnp.sum`` on the
    CPU (densewin.py:231-233), summed in float32 in the kernel's order
    (lane l of a warp adds the 8-value vectors l, l + 32, ... of the row
    in column order, then an xor tree over the 32 lanes) and rounded
    once, so that the kernel's bfloat16 mode is bit for bit with it."""
    n_tiles, tile, win = blocks.shape
    steps = -(-win // (_VEC_BF16 * 32))
    p = blocks.float() * xw.float()[:, None, :]
    pad = steps * 32 * _VEC_BF16 - win
    if pad:
        # padding columns add +0, which leaves a sum that started at +0 as
        # it is
        p = torch.nn.functional.pad(p, (0, pad))
    # (step, value of the vector, tile, row, lane), the order of the adds
    p = p.reshape(n_tiles, tile, steps, 32, _VEC_BF16) \
        .permute(2, 4, 0, 1, 3).reshape(steps * _VEC_BF16, n_tiles, tile,
                                        32).contiguous()
    acc = torch.zeros((n_tiles, tile, 32), dtype=torch.float32,
                      device=blocks.device)
    for q in range(p.shape[0]):
        acc += p[q]
    lanes = torch.arange(32, device=blocks.device)
    for m in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, lanes ^ m]
    return acc[:, :, 0].to(torch.bfloat16)


def dense_window_spmv_plain(window_starts, blocks, x, n_out):
    """y = A x."""
    dense_window_spmv_plain.calls += 1
    return _product(window_starts, blocks, x, n_out, _promoted(blocks, x))


def dense_window_residual_plain(window_starts, blocks, f, x, n_out):
    """r = f − A x."""
    dense_window_residual_plain.calls += 1
    out = _promoted(blocks, x, f)
    return f.to(out) - _product(window_starts, blocks, x, n_out, out)


def dense_window_scaled_correction_plain(window_starts, blocks, w, f, x,
                                         n_out):
    """x + w ∘ (f − A x): one damped-Jacobi/SPAI-0 sweep."""
    dense_window_scaled_correction_plain.calls += 1
    out = _promoted(blocks, x, f, w)
    r = f.to(out) - _product(window_starts, blocks, x, n_out, out)
    return x[:n_out].to(out) + w.to(out) * r


for _fn in (dense_window_spmv_plain, dense_window_residual_plain,
            dense_window_scaled_correction_plain):
    _fn.calls = 0


# -- kernel launch ------------------------------------------------------------

class Geometry(NamedTuple):
    """The launch of one densewin.cu kernel."""
    rows_per_warp: int
    nblocks: int            # one block a tile
    chunk: int              # columns of x staged at a time
    smem: int               # dynamic shared memory: two chunk buffers


def launch_geometry(n_tiles, win, itemsize):
    """A block of 8 warps per 64-row tile, 8 rows a warp, and the x window
    staged in chunks: ``_CHUNK_BYTES`` of columns (2,048 float32, 1,024
    float64, 4,096 bfloat16), or the window rounded up to 128 columns (256
    in bfloat16: a chunk holds a multiple of 32 of the lanes' 16-byte
    vectors) where it is narrower, double-buffered."""
    align = 32 * max(4, 16 // int(itemsize))
    chunk = min(-(-int(win) // align) * align, _CHUNK_BYTES // itemsize)
    return Geometry(_TILE // _WARPS, int(n_tiles), chunk,
                    2 * chunk * itemsize)


def _launch(mode, window_starts, blocks, x, n_out, f=None, w=None):
    """Validate the operands and launch one densewin.cu kernel; returns
    the output vector of ``n_out`` rows."""
    if blocks.device.type != "cuda":
        raise ValueError("dense-window kernels run on CUDA tensors, got "
                         "blocks on %s" % blocks.device)
    code = dtype_code(blocks.dtype, "dense-window kernels")
    if blocks.dim() != 3 or not blocks.is_contiguous():
        raise ValueError("blocks must be a contiguous (n_tiles, tile, win) "
                         "tensor")
    n_tiles, tile, win = blocks.shape
    if tile != _TILE:
        raise ValueError("dense-window kernels take tiles of %d rows, got %d"
                         % (_TILE, tile))
    # the kernel reads each block row in 16-byte vectors
    vec = 16 // blocks.element_size()
    if win % vec or blocks.data_ptr() % 16:
        raise ValueError("blocks must start on a 16-byte boundary with a "
                         "window of a multiple of %d entries, got win=%d"
                         % (vec, win))
    if window_starts.device != blocks.device \
            or window_starts.dtype != torch.int32 \
            or window_starts.shape != (n_tiles,) \
            or not window_starts.is_contiguous():
        raise ValueError("window_starts must be a contiguous (%d,) int32 "
                         "tensor on %s" % (n_tiles, blocks.device))
    n_out = int(n_out)
    if not (n_tiles - 1) * tile < n_out <= n_tiles * tile \
            and not (n_tiles == 0 and n_out == 0):
        raise ValueError("n_out=%d does not fit %d tiles of %d rows"
                         % (n_out, n_tiles, tile))
    if x.dim() != 1:
        raise ValueError("x must be a vector, got shape %s"
                         % (tuple(x.shape),))
    ncols = x.shape[0]
    _check_vec("x", x, ncols, blocks)
    if f is not None:
        _check_vec("f", f, n_out, blocks)
    if w is not None:
        _check_vec("w", w, n_out, blocks)
    if mode == _CORRECTION and ncols != n_out:
        raise ValueError("the dense-window correction needs a square "
                         "operator, got %d x %d" % (n_out, ncols))
    y = torch.empty(n_out, dtype=blocks.dtype, device=blocks.device)
    if n_out == 0:
        return y
    geo = launch_geometry(n_tiles, win, blocks.element_size())
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cuda_lib.lib().amgcl_densewin(
            code, mode, n_out, ncols, geo.nblocks,
            tile, win, geo.chunk, window_starts.data_ptr(),
            blocks.data_ptr(), x.data_ptr(), ptr(f), ptr(w), y.data_ptr(),
            stream)
    cuda_lib.check(rc, "dense-window mode %d" % mode)
    return y


# -- wrappers -----------------------------------------------------------------

def dense_window_spmv(window_starts, blocks, x, n_out):
    """y = A x (square or rectangular), the first ``n_out`` rows."""
    if x.device.type == "cpu":
        return dense_window_spmv_plain(window_starts, blocks, x, n_out)
    y = _launch(_SPMV, window_starts, blocks, x, n_out)
    count_launch(dense_window_spmv, y.dtype)
    return y


def dense_window_residual(window_starts, blocks, f, x, n_out):
    """r = f − A x in one pass (square or rectangular)."""
    if x.device.type == "cpu":
        return dense_window_residual_plain(window_starts, blocks, f, x,
                                           n_out)
    r = _launch(_RESIDUAL, window_starts, blocks, x, n_out, f=f)
    count_launch(dense_window_residual, r.dtype)
    return r


def dense_window_scaled_correction(window_starts, blocks, w, f, x, n_out):
    """x + w ∘ (f − A x) in one pass (square operators)."""
    if x.device.type == "cpu":
        return dense_window_scaled_correction_plain(window_starts, blocks,
                                                    w, f, x, n_out)
    y = _launch(_CORRECTION, window_starts, blocks, x, n_out, f=f, w=w)
    count_launch(dense_window_scaled_correction, y.dtype)
    return y


for _fn in (dense_window_spmv, dense_window_residual,
            dense_window_scaled_correction):
    _fn.launches = 0
    _fn.bf16_launches = 0
