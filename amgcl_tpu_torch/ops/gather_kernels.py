"""Gather SpMV: a wrapper and a plain PyTorch version of ``gather_spmv``,
y = A x for a scalar windowed-ELL operator of narrow K.

Counterpart of ``amgcl_tpu/ops/pallas_gather.py`` (the Pallas TPU kernel
``gather_spmv`` and its take-along reference ``gather_spmv_xla``), with
the kernel's signature less the window size ``win``: the kernel reads x
where it lies. The CUDA source is ``amgcl_tpu_torch/csrc/gather.cu``,
instantiated for K = 4, 8, 12 and 16 (``csr_to_windowed_ell`` pads K to a
multiple of 4, and :data:`AUTO_MAX_K` caps the dispatch at 16). Storage
is that of :class:`amgcl_tpu_torch.ops.unstructured.WindowedEllMatrix`
with scalar values: row ``i`` of tile ``t = i // tile`` holds
``vals[t, i % tile, k]`` at column ``window_starts[t] + cols_local[t,
i % tile, k]``. Each row sums its K slots in slot order into an
accumulator of the values' dtype; an absolute column at or past the end
of x contributes nothing, as the TPU kernel's zero-padded window gives.
bfloat16 values and x (a bfloat16 hierarchy's products) round each
product and each running sum to bfloat16, slot by slot, as the TPU
kernel's bfloat16 accumulator does (amgcl_tpu/ops/pallas_gather.py:
70-74; its interpret mode on the CPU rounds so too), and the plain
version follows the kernel there, not the JAX package's XLA fallback,
whose einsum sums a row once.

The wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it checks device, dtype, shape, K, contiguity and the
16-byte alignment of ``cols_local`` and ``vals`` (the kernel loads a
row's slots in 16-byte vectors, 8-byte ones in bfloat16) and launches
the kernel over the grid of :func:`launch_geometry`, or raises.
``gather_spmv.launches`` counts kernel launches (``.bf16_launches``
those in bfloat16) and ``gather_spmv_plain.calls`` plain-version
calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from amgcl_tpu_torch.ops import cuda_lib
from amgcl_tpu_torch.ops.dia_kernels import (_check_vec, count_launch,
                                             dtype_code)
from amgcl_tpu_torch.ops.well_kernels import check_geometry

#: the column-slot counts the kernel is instantiated for
KS = (4, 8, 12, 16)
#: widest K that ``WindowedEllMatrix.mv`` sends to this kernel (the
#: reference's ``_AUTO_MAX_K``, amgcl_tpu/ops/pallas_gather.py:53)
AUTO_MAX_K = 16


#: rows (threads) a block: at or under 64 and 128 on the paths' operators
#: (PERF.md §6), and at 64 registers a thread (K 16 in float64) 4 blocks
#: an SM, so an 85,623-row level's 335 blocks are in flight at once
THREADS = 256


class Geometry(NamedTuple):
    """The gather kernel's launch: a thread a row, blocks of ``threads``
    rows, ``nblocks`` blocks."""
    threads: int
    nblocks: int


def launch_geometry(n_out, K):
    """The grid that covers ``n_out`` rows of K slots, a thread a row:
    ceil(n_out / THREADS) blocks of :data:`THREADS`."""
    if K not in KS:
        raise ValueError("the gather kernel takes K in %s, got %d"
                         % (KS, K))
    return Geometry(THREADS, -(-int(n_out) // THREADS))


def gather_spmv_plain(window_starts, cols_local, vals, x, n_out):
    """y = A x, the reference's ``gather_spmv_xla``: absolute columns,
    one gather of x, a sum over the slots (in bfloat16 the kernel's sum,
    slot by slot, each product and sum rounded). Out-of-range columns
    read 0 (``gather_spmv_xla``'s ``jnp.take`` would fill them with NaN;
    the Pallas kernel's zero-padded window gives 0)."""
    gather_spmv_plain.calls += 1
    m = x.shape[0]
    cols = cols_local.to(torch.int64) \
        + window_starts.to(torch.int64)[:, None, None]
    xg = torch.where(cols < m, x[cols.clamp(max=max(m - 1, 0))],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    p = vals * xg.to(vals.dtype)
    if p.dtype == torch.bfloat16:
        y = torch.zeros(p.shape[:2], dtype=p.dtype, device=p.device)
        for k in range(p.shape[2]):
            y = y + p[:, :, k]
    else:
        y = p.sum(dim=2)
    return y.reshape(-1)[:n_out].to(torch.promote_types(vals.dtype,
                                                        x.dtype))


gather_spmv_plain.calls = 0


def gather_spmv(window_starts, cols_local, vals, x, n_out):
    """y = A x (square or rectangular), the first ``n_out`` rows, for
    scalar values with K in :data:`KS`."""
    if x.device.type == "cpu":
        return gather_spmv_plain(window_starts, cols_local, vals, x, n_out)
    _, tile, K, n_out = check_geometry(window_starts, cols_local, vals,
                                       n_out, block=False)
    geo = launch_geometry(n_out, K)
    if cols_local.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("the gather kernel takes cols_local and vals on "
                         "16-byte boundaries")
    if x.dim() != 1:
        raise ValueError("x must be a vector, got shape %s"
                         % (tuple(x.shape),))
    _check_vec("x", x, x.shape[0], vals)
    y = torch.empty(n_out, dtype=vals.dtype, device=vals.device)
    if n_out == 0:
        return y
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cuda_lib.lib().amgcl_gather_spmv(
            dtype_code(vals.dtype, "the gather kernel"), K, geo.threads,
            n_out, x.shape[0],
            tile, window_starts.data_ptr(), cols_local.data_ptr(),
            vals.data_ptr(), x.data_ptr(), y.data_ptr(), geo.nblocks,
            stream)
    cuda_lib.check(rc, "gather_spmv K %d" % K)
    count_launch(gather_spmv, y.dtype)
    return y


gather_spmv.launches = gather_spmv.bf16_launches = 0
