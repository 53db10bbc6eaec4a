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
:data:`BLOCK_SIZES`. ``<wrapper>.launches`` counts kernel launches
(``<wrapper>.bf16_launches`` those in bfloat16) and ``<plain>.calls``
counts plain-version calls.

Every wrapper also takes bfloat16 values and vectors (a bfloat16 block
hierarchy's levels and its bfloat16 Krylov loop) in the JAX package's
bfloat16 arithmetic: a row's products summed in float32 in slot, then
block-column order and rounded once to bfloat16; f − A x rounded; the
correction's S r formed in float32 over the rounded residual, rounded,
then x + S r rounded; ``windowed_ell_block_spmv_dots`` sums its dots in
float32 over that y and rounds each once (the plain version in torch's
order: within one bfloat16 ULP of the kernel's dots).
"""

from __future__ import annotations

import torch

from amgcl_tpu_torch.ops.dia_kernels import _acc_dtype, count_launch
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
    columns, in the values' dtype. bfloat16 values sum a row's products
    in float32, slot by slot and then block column by block column (each
    product of two bfloat16 values exact there), and round the sum once
    to bfloat16, as the TPU kernel's bfloat16 einsum accumulates
    (unstructured.py:563-565) and as the JAX package forms it on the CPU
    in interpret mode, and in the kernel's order."""
    bc = vals.shape[4]
    m = x.shape[0] // bc
    cols = cols_local.to(torch.int64) \
        + window_starts.to(torch.int64)[:, None, None]
    inside = (cols < m)[..., None]
    xg = torch.where(inside, x.reshape(m, bc)[cols.clamp(max=max(m - 1, 0))],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    if vals.dtype == torch.bfloat16:
        # (slot, column, tile, row, component), the order of the adds
        p = (vals.float() * xg.to(vals.dtype).float()[:, :, :, None, :]) \
            .permute(2, 4, 0, 1, 3).flatten(0, 1).contiguous()
        y = torch.zeros(p.shape[1:], dtype=torch.float32,
                        device=vals.device)
        for q in range(p.shape[0]):
            y += p[q]
        y = y.to(torch.bfloat16)
    else:
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
    r = r.reshape(-1, b)
    if out == torch.bfloat16:
        # the b products of S and the rounded residual exact in float32,
        # summed in column order and rounded once (unstructured.py:618-620)
        corr = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        for c in range(b):
            corr += S[:, :, c].float() * r[:, c, None].float()
        corr = corr.to(out)
    else:
        corr = torch.einsum("nij,nj->ni", S.to(out), r)
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
    count_launch(windowed_ell_block_spmv, y.dtype)
    return y


def windowed_ell_block_residual(window_starts, cols_local, vals, f, x,
                                n_out):
    """r = f − A x in one pass (square or rectangular)."""
    if x.device.type == "cpu":
        return windowed_ell_block_residual_plain(window_starts, cols_local,
                                                 vals, f, x, n_out)
    r, _ = _launch(_RESIDUAL, window_starts, cols_local, vals, x, n_out,
                   f=f, block=True)
    count_launch(windowed_ell_block_residual, r.dtype)
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
    count_launch(windowed_ell_block_scaled_correction, y.dtype)
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
    count_launch(windowed_ell_block_spmv_dots, y.dtype)
    return y, dots[0], dots[1], (None if w is None else dots[2])


for _fn in (windowed_ell_block_spmv, windowed_ell_block_residual,
            windowed_ell_block_scaled_correction,
            windowed_ell_block_spmv_dots):
    _fn.launches = 0
    _fn.bf16_launches = 0
