"""Windowed-ELL kernels: a wrapper and a plain PyTorch version for each of
``windowed_ell_spmv``, ``windowed_ell_residual``,
``windowed_ell_scaled_correction`` and ``windowed_ell_spmv_dots``.

Counterpart of the scalar Pallas TPU kernels of
``amgcl_tpu/ops/unstructured.py`` (``windowed_ell_spmv``,
``windowed_ell_fused``, ``windowed_ell_spmv_dots``), with their
signatures less the window size ``win``: the kernels read x where it
lies. The CUDA source is ``amgcl_tpu_torch/csrc/well_block.cu``: these
wrappers launch its scalar kernel, a sub-warp of
:func:`launch_geometry`'s lanes per row (the block wrappers of
:mod:`amgcl_tpu_torch.ops.well_block_kernels` share :func:`_launch` and
launch its block kernels, a sub-warp per node).
Storage is that of
:class:`amgcl_tpu_torch.ops.unstructured.WindowedEllMatrix`: row ``i``
of tile ``t = i // tile`` holds ``vals[t, i % tile, k]`` at column
``window_starts[t] + cols_local[t, i % tile, k]``. An entry whose
absolute column lies at or past the end of x contributes nothing (a tile
without entries points its padding there), as the TPU kernel's
zero-padded x gives.

Every wrapper also takes bfloat16 values and vectors (a bfloat16
hierarchy's levels and a bfloat16 Krylov loop): a row's products summed
in float32 in slot order (a product of two bfloat16 values is exact
there) and rounded to bfloat16, then the residual and correction rounded
to bfloat16 at each operation, where the TPU kernel rounds;
``windowed_ell_spmv_dots`` sums its dots in float32 over that y and
rounds each once to bfloat16 (the plain version in torch's order: within
one bfloat16 ULP of the kernel's dots). The products are kept in float32
as the JAX kernels' interpret mode keeps them on the CPU (XLA's excess
precision; its XLA path does the same). Rounding each product to
bfloat16 instead left a bfloat16 Krylov loop's counts on U1-like systems
far from the JAX package's (67 against 19 BiCGStab(L) iterations at
6,000 rows); this rule gives its counts and true residuals (PERF.md §6).

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
from amgcl_tpu_torch.ops.dia_kernels import (_BLOCK, _acc_dtype,
                                             _check_vec, count_launch,
                                             dtype_code)

_SPMV, _RESIDUAL, _CORRECTION, _SPMV_DOTS = range(4)

#: the square block sizes the block kernels are instantiated for (the
#: scalar wrappers launch the same kernels with a block size of 1)
BLOCK_SIZES = (2, 3, 4)


# -- plain versions -----------------------------------------------------------

def _product(window_starts, cols_local, vals, x, n_out):
    """(A x)[:n_out] in the reference's ``_mv_xla`` arithmetic: a gather
    of x at the absolute columns and a row sum over the K slots, in the
    values' dtype. bfloat16 values sum a row's products in float32, slot
    by slot (each product of two bfloat16 values exact there), then round
    the sum to bfloat16, as the TPU kernel's ``jnp.sum`` accumulates
    (unstructured.py:334-336) and as the JAX package forms it on the CPU
    in interpret mode, and in the kernel's slot order."""
    m = x.shape[0]
    cols = cols_local.to(torch.int64) \
        + window_starts.to(torch.int64)[:, None, None]
    inside = cols < m
    xg = torch.where(inside, x[cols.clamp(max=max(m - 1, 0))],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    if vals.dtype == torch.bfloat16:
        p = vals.float() * xg.to(vals.dtype).float()
        y = torch.zeros(p.shape[:2], dtype=torch.float32, device=p.device)
        for k in range(p.shape[2]):
            y += p[:, :, k]
        y = y.to(torch.bfloat16)
    else:
        y = (vals * xg.to(vals.dtype)).sum(dim=2)
    return y.reshape(-1)[:n_out].to(torch.promote_types(vals.dtype,
                                                        x.dtype))


def windowed_ell_spmv_plain(window_starts, cols_local, vals, x, n_out):
    """y = A x."""
    windowed_ell_spmv_plain.calls += 1
    return _product(window_starts, cols_local, vals, x, n_out)


def windowed_ell_residual_plain(window_starts, cols_local, vals, f, x, n_out):
    """r = f − A x."""
    windowed_ell_residual_plain.calls += 1
    out = torch.promote_types(torch.promote_types(vals.dtype, x.dtype),
                              f.dtype)
    return f.to(out) - _product(window_starts, cols_local, vals, x,
                                n_out).to(out)


def windowed_ell_scaled_correction_plain(window_starts, cols_local, vals, w,
                                         f, x, n_out):
    """x + w ∘ (f − A x): one damped-Jacobi/SPAI-0 sweep."""
    windowed_ell_scaled_correction_plain.calls += 1
    out = torch.promote_types(torch.promote_types(vals.dtype, x.dtype),
                              f.dtype)
    r = f.to(out) - _product(window_starts, cols_local, vals, x,
                             n_out).to(out)
    return x[:n_out].to(out) + w.to(out) * r


def windowed_ell_spmv_dots_plain(window_starts, cols_local, vals, x, w,
                                 n_out):
    """(y, ⟨y,y⟩, ⟨y,x⟩, ⟨y,w⟩) with y = A x (⟨y,w⟩ is None without w)."""
    windowed_ell_spmv_dots_plain.calls += 1
    y = _product(window_starts, cols_local, vals, x, n_out)
    acc = _acc_dtype(y.dtype)
    ya = y.to(acc)
    yy = torch.dot(ya, ya).to(y.dtype)
    yx = torch.dot(ya, x.to(acc)).to(y.dtype)
    yw = None if w is None else torch.dot(ya, w.to(acc)).to(y.dtype)
    return y, yy, yx, yw


for _fn in (windowed_ell_spmv_plain, windowed_ell_residual_plain,
            windowed_ell_scaled_correction_plain,
            windowed_ell_spmv_dots_plain):
    _fn.calls = 0


# -- kernel launch ------------------------------------------------------------

def check_geometry(window_starts, cols_local, vals, n_out, block):
    """Validate the windowed-ELL storage a kernel is handed: CUDA float32,
    float64 or bfloat16 ``vals`` of shape (n_tiles, tile, K), with
    trailing (b, b) dims when ``block``, and the int32 ``cols_local`` and
    ``window_starts`` beside it on the same device; ``n_out`` rows (or
    nodes) in the last tile. Returns (n_tiles, tile, K, n_out)."""
    what = "block windowed-ELL" if block else "windowed-ELL"
    if vals.device.type != "cuda":
        raise ValueError("%s kernels run on CUDA tensors, got vals on %s"
                         % (what, vals.device))
    dtype_code(vals.dtype, "these %s kernels" % what)
    if vals.dim() != (5 if block else 3) or not vals.is_contiguous():
        raise ValueError("vals must be a contiguous (n_tiles, tile, K%s) "
                         "tensor" % (", br, bc" if block else ""))
    n_tiles, tile, K = vals.shape[:3]
    if cols_local.device != vals.device or cols_local.dtype != torch.int32 \
            or cols_local.shape != vals.shape[:3] \
            or not cols_local.is_contiguous():
        raise ValueError("cols_local must be a contiguous %s int32 tensor "
                         "on %s" % (tuple(vals.shape[:3]), vals.device))
    if window_starts.device != vals.device \
            or window_starts.dtype != torch.int32 \
            or window_starts.shape != (n_tiles,) \
            or not window_starts.is_contiguous():
        raise ValueError("window_starts must be a contiguous (%d,) int32 "
                         "tensor on %s" % (n_tiles, vals.device))
    n_out = int(n_out)
    if not (n_tiles - 1) * tile < n_out <= n_tiles * tile \
            and not (n_tiles == 0 and n_out == 0):
        raise ValueError("n_out=%d does not fit %d tiles of %d rows"
                         % (n_out, n_tiles, tile))
    return n_tiles, tile, K, n_out


class Geometry(NamedTuple):
    """The launch of one well_block.cu kernel."""
    lanes: int              # threads per row (scalar) or node (block)
    rows_per_block: int     # rows (nodes) of a block of _BLOCK threads
    nblocks: int
    partials: int           # SPMV_DOTS's partial sums: ndots per 256 rows


#: lanes per node of the block kernels: 4 up to this K, 8 above
BLOCK_LANES_K = 8


def launch_geometry(n_out, K, block=False, ndots=0):
    """The grid that covers ``n_out`` rows (nodes) of K slots. A scalar
    row is loaded by one lane per 4-slot vector, rounded up to a power of
    two and at most 4 (K = 4: 1 lane, 8: 2, from 12: 4). A block node is
    loaded by 4 lanes up to K = :data:`BLOCK_LANES_K` and by 8 above, b of
    which then sum its b rows. A block of 256 threads covers 256 / lanes
    rows. ``partials`` holds ``ndots`` sums per 256 rows, as the dots are
    formed a thread per row."""
    if block:
        lanes = 4 if K <= BLOCK_LANES_K else 8
    else:
        lanes = 1
        while lanes < min(4, K // 4):
            lanes *= 2
    rows = _BLOCK // lanes
    nblocks = -(-int(n_out) // rows)
    return Geometry(lanes, rows, nblocks, -(-int(n_out) // _BLOCK) * ndots)


def _launch(mode, window_starts, cols_local, vals, x, n_out, f=None, w=None,
            block=False):
    """Validate the operands and launch one well_block.cu kernel, the
    scalar one for scalar values; returns (y, dots) with dots a (3,)
    tensor or None. For block values ``w`` is the (n_out, b, b) scale of
    the correction, and otherwise a vector."""
    _, tile, K, n_out = check_geometry(window_starts, cols_local, vals,
                                       n_out, block)
    b = 1
    if block:
        br, bc = vals.shape[3:]
        if br != bc or br not in BLOCK_SIZES:
            raise ValueError("block windowed-ELL kernels take square blocks "
                             "of size %s, got %dx%d"
                             % (" or ".join(map(str, BLOCK_SIZES)), br, bc))
        b = br
    if K % 4 or cols_local.data_ptr() % 16 or vals.data_ptr() % 16:
        # the kernels read each row (node) in 4-slot, 16-byte vectors
        raise ValueError("%swindowed-ELL kernels take K a multiple of 4 and "
                         "cols_local and vals on 16-byte boundaries, got "
                         "K=%d" % ("block " if block else "scalar ", K))
    if x.dim() != 1 or x.shape[0] % b:
        raise ValueError("x must be a vector of %d entries per column, got "
                         "shape %s" % (b, tuple(x.shape)))
    ncols = x.shape[0] // b
    _check_vec("x", x, ncols * b, vals)
    if f is not None:
        _check_vec("f", f, n_out * b, vals)
    if mode == _CORRECTION and block:
        if w.device != vals.device or w.dtype != vals.dtype \
                or w.shape != (n_out, b, b) or not w.is_contiguous():
            raise ValueError(
                "S must be a contiguous (%d, %d, %d) %s tensor on %s, got "
                "%s %s on %s" % (n_out, b, b, vals.dtype, vals.device,
                                 tuple(w.shape), w.dtype, w.device))
    elif w is not None:
        _check_vec("w", w, n_out * b, vals)
    if mode in (_CORRECTION, _SPMV_DOTS) and ncols != n_out:
        raise ValueError("this %swindowed-ELL kernel needs a square "
                         "operator, got %d x %d"
                         % ("block " if block else "", n_out, ncols))
    y = torch.empty(n_out * b, dtype=vals.dtype, device=vals.device)
    ndots = 3 if mode == _SPMV_DOTS else 0
    if n_out == 0:
        return y, (torch.zeros(ndots, dtype=vals.dtype, device=vals.device)
                   if ndots else None)
    geo = launch_geometry(n_out, K, block, ndots)
    # the reduction kernel writes every dot; bfloat16 sums in float32
    dots = torch.empty(ndots, dtype=vals.dtype, device=vals.device) \
        if ndots else None
    partials = torch.empty(geo.partials, dtype=_acc_dtype(vals.dtype),
                           device=vals.device) if ndots else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cuda_lib.lib().amgcl_well_block(
            dtype_code(vals.dtype, "windowed-ELL kernels"), mode, b,
            geo.lanes, n_out, ncols, tile,
            K, window_starts.data_ptr(), cols_local.data_ptr(),
            vals.data_ptr(), x.data_ptr(), ptr(f), ptr(w), y.data_ptr(),
            ptr(partials), ptr(dots), geo.nblocks, stream)
    cuda_lib.check(rc, "%swindowed-ELL mode %d"
                   % ("block " if block else "", mode))
    return y, dots


# -- wrappers -----------------------------------------------------------------

def windowed_ell_spmv(window_starts, cols_local, vals, x, n_out):
    """y = A x (square or rectangular), the first ``n_out`` rows."""
    if x.device.type == "cpu":
        return windowed_ell_spmv_plain(window_starts, cols_local, vals, x,
                                       n_out)
    y, _ = _launch(_SPMV, window_starts, cols_local, vals, x, n_out)
    count_launch(windowed_ell_spmv, y.dtype)
    return y


def windowed_ell_residual(window_starts, cols_local, vals, f, x, n_out):
    """r = f − A x in one pass (square or rectangular)."""
    if x.device.type == "cpu":
        return windowed_ell_residual_plain(window_starts, cols_local, vals,
                                           f, x, n_out)
    r, _ = _launch(_RESIDUAL, window_starts, cols_local, vals, x, n_out,
                   f=f)
    count_launch(windowed_ell_residual, r.dtype)
    return r


def windowed_ell_scaled_correction(window_starts, cols_local, vals, w, f,
                                   x, n_out):
    """x + w ∘ (f − A x) in one pass (square operators)."""
    if x.device.type == "cpu":
        return windowed_ell_scaled_correction_plain(
            window_starts, cols_local, vals, w, f, x, n_out)
    y, _ = _launch(_CORRECTION, window_starts, cols_local, vals, x, n_out,
                   f=f, w=w)
    count_launch(windowed_ell_scaled_correction, y.dtype)
    return y


def windowed_ell_spmv_dots(window_starts, cols_local, vals, x, w, n_out):
    """(y, ⟨y,y⟩, ⟨y,x⟩, ⟨y,w⟩) in one pass, y = A x; the dots are 0-d
    tensors on the device (⟨y,w⟩ is None without w). Square operators."""
    if x.device.type == "cpu":
        return windowed_ell_spmv_dots_plain(window_starts, cols_local, vals,
                                            x, w, n_out)
    y, dots = _launch(_SPMV_DOTS, window_starts, cols_local, vals, x, n_out,
                      w=w)
    count_launch(windowed_ell_spmv_dots, y.dtype)
    return y, dots[0], dots[1], (None if w is None else dots[2])


for _fn in (windowed_ell_spmv, windowed_ell_residual,
            windowed_ell_scaled_correction, windowed_ell_spmv_dots):
    _fn.launches = 0
    _fn.bf16_launches = 0
