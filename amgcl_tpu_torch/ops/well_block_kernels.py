"""Block windowed-ELL kernels: a wrapper and a plain PyTorch version for
each of ``windowed_ell_block_spmv``, ``windowed_ell_block_residual``,
``windowed_ell_block_scaled_correction`` and
``windowed_ell_block_spmv_dots``.

Counterpart of the block Pallas TPU kernels of
``amgcl_tpu/ops/unstructured.py`` (``windowed_ell_block_spmv``,
``windowed_ell_block_fused``, ``windowed_ell_block_spmv_dots``), with
their signatures less the window size ``win``: the kernels read x where
it lies. The CUDA source is ``amgcl_tpu_torch/csrc/well_block.cu``, shared
with the scalar wrappers, which launch it with a block size of 1.
Storage is that of a block
:class:`amgcl_tpu_torch.ops.unstructured.WindowedEllMatrix`: node ``i``
of tile ``t = i // tile`` holds the ``(br, bc)`` block
``vals[t, i % tile, k]`` at block column
``window_starts[t] + cols_local[t, i % tile, k]``; x holds ``bc`` entries
per block column and the outputs ``br`` per node, flat. A slot whose
block column lies at or past the end of x contributes nothing (a tile
without entries points its padding there), as the TPU kernel's
zero-padded x gives.

Each wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it checks device, dtype, shape and contiguity and launches
the kernel, or raises; the kernels take square blocks of size
:data:`BLOCK_SIZES`. ``<wrapper>.launches`` counts kernel launches and
``<plain>.calls`` counts plain-version calls.
"""

from __future__ import annotations

import torch

from amgcl_tpu_torch.ops.dia_kernels import _acc_dtype
from amgcl_tpu_torch.ops.well_kernels import (BLOCK_SIZES, _CORRECTION,
                                              _RESIDUAL, _SPMV, _SPMV_DOTS,
                                              _launch)


# -- plain versions -----------------------------------------------------------

def _out_dtype(*tensors):
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


def _product(window_starts, cols_local, vals, x, n_out):
    """(A x) over the first ``n_out`` nodes, flat, in the reference's
    ``_mv_xla`` arithmetic: a gather of x's b-entry groups at the
    absolute block columns and an einsum over the K slots and the block
    columns, in the values' dtype."""
    bc = vals.shape[4]
    m = x.shape[0] // bc
    cols = cols_local.to(torch.int64) \
        + window_starts.to(torch.int64)[:, None, None]
    inside = (cols < m)[..., None]
    xg = torch.where(inside, x.reshape(m, bc)[cols.clamp(max=max(m - 1, 0))],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    y = torch.einsum("trkij,trkj->tri", vals, xg.to(vals.dtype))
    return y.reshape(-1)[:n_out * vals.shape[3]].to(_out_dtype(vals, x))


def windowed_ell_block_spmv_plain(window_starts, cols_local, vals, x, n_out):
    """y = A x."""
    windowed_ell_block_spmv_plain.calls += 1
    return _product(window_starts, cols_local, vals, x, n_out)


def windowed_ell_block_residual_plain(window_starts, cols_local, vals, f, x,
                                      n_out):
    """r = f − A x."""
    windowed_ell_block_residual_plain.calls += 1
    out = _out_dtype(vals, x, f)
    return f.to(out) - _product(window_starts, cols_local, vals, x,
                                n_out).to(out)


def windowed_ell_block_scaled_correction_plain(window_starts, cols_local,
                                               vals, S, f, x, n_out):
    """x + S ∘ (f − A x) with S the per-node (b, b) scale: one block
    SPAI-0/Jacobi sweep."""
    windowed_ell_block_scaled_correction_plain.calls += 1
    out = _out_dtype(vals, x, f, S)
    b = vals.shape[3]
    r = f.to(out) - _product(window_starts, cols_local, vals, x,
                             n_out).to(out)
    corr = torch.einsum("nij,nj->ni", S.to(out), r.reshape(-1, b))
    return x[:n_out * b].to(out) + corr.reshape(-1)


def windowed_ell_block_spmv_dots_plain(window_starts, cols_local, vals, x, w,
                                       n_out):
    """(y, ⟨y,y⟩, ⟨y,x⟩, ⟨y,w⟩) with y = A x (⟨y,w⟩ is None without w)."""
    windowed_ell_block_spmv_dots_plain.calls += 1
    y = _product(window_starts, cols_local, vals, x, n_out)
    acc = _acc_dtype(y.dtype)
    ya = y.to(acc)
    yy = torch.dot(ya, ya).to(y.dtype)
    yx = torch.dot(ya, x.to(acc)).to(y.dtype)
    yw = None if w is None else torch.dot(ya, w.to(acc)).to(y.dtype)
    return y, yy, yx, yw


for _fn in (windowed_ell_block_spmv_plain, windowed_ell_block_residual_plain,
            windowed_ell_block_scaled_correction_plain,
            windowed_ell_block_spmv_dots_plain):
    _fn.calls = 0


# -- wrappers -----------------------------------------------------------------

def windowed_ell_block_spmv(window_starts, cols_local, vals, x, n_out):
    """y = A x (square or rectangular), the first ``n_out`` nodes, flat."""
    if x.device.type == "cpu":
        return windowed_ell_block_spmv_plain(window_starts, cols_local, vals,
                                             x, n_out)
    y, _ = _launch(_SPMV, window_starts, cols_local, vals, x, n_out,
                   block=True)
    windowed_ell_block_spmv.launches += 1
    return y


def windowed_ell_block_residual(window_starts, cols_local, vals, f, x,
                                n_out):
    """r = f − A x in one pass (square or rectangular)."""
    if x.device.type == "cpu":
        return windowed_ell_block_residual_plain(window_starts, cols_local,
                                                 vals, f, x, n_out)
    r, _ = _launch(_RESIDUAL, window_starts, cols_local, vals, x, n_out,
                   f=f, block=True)
    windowed_ell_block_residual.launches += 1
    return r


def windowed_ell_block_scaled_correction(window_starts, cols_local, vals, S,
                                         f, x, n_out):
    """x + S ∘ (f − A x) in one pass, S the (n_out, b, b) per-node scale
    (square operators)."""
    if x.device.type == "cpu":
        return windowed_ell_block_scaled_correction_plain(
            window_starts, cols_local, vals, S, f, x, n_out)
    y, _ = _launch(_CORRECTION, window_starts, cols_local, vals, x, n_out,
                   f=f, w=S, block=True)
    windowed_ell_block_scaled_correction.launches += 1
    return y


def windowed_ell_block_spmv_dots(window_starts, cols_local, vals, x, w,
                                 n_out):
    """(y, ⟨y,y⟩, ⟨y,x⟩, ⟨y,w⟩) in one pass, y = A x; the dots are 0-d
    tensors on the device (⟨y,w⟩ is None without w). Square operators
    with square blocks."""
    if x.device.type == "cpu":
        return windowed_ell_block_spmv_dots_plain(
            window_starts, cols_local, vals, x, w, n_out)
    y, dots = _launch(_SPMV_DOTS, window_starts, cols_local, vals, x, n_out,
                      w=w, block=True)
    windowed_ell_block_spmv_dots.launches += 1
    return y, dots[0], dots[1], (None if w is None else dots[2])


for _fn in (windowed_ell_block_spmv, windowed_ell_block_residual,
            windowed_ell_block_scaled_correction,
            windowed_ell_block_spmv_dots):
    _fn.launches = 0
