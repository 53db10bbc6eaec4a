"""DIA kernels: a wrapper and a plain PyTorch version for each of
``dia_spmv``, ``dia_residual``, ``dia_scaled_correction``,
``dia_spmv_dots``/``dia_spmv_dot`` and ``dia_residual_dot``.

Counterpart of the Pallas TPU kernels in ``amgcl_tpu/ops/pallas_spmv.py``;
the CUDA source is ``amgcl_tpu_torch/csrc/dia.cu``. Storage: ``data[k, i]``
holds ``A[i, i + offsets[k]]``; ``offsets`` is an int32 tensor on the
data's device. Entries whose column ``i + offsets[k]`` falls outside
``[0, m)`` contribute nothing.

Each wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it checks device, dtype, shape and contiguity and launches
the kernel, or raises. ``<wrapper>.launches`` counts kernel launches and
``<plain>.calls`` counts plain-version calls, so a run can show which
path it took.
"""

from __future__ import annotations

import torch

from amgcl_tpu_torch.ops import cuda_lib

_SPMV, _RESIDUAL, _CORRECTION, _SPMV_DOTS, _RESIDUAL_DOT = range(5)
_NDOTS = {_SPMV_DOTS: 3, _RESIDUAL_DOT: 1}
MAX_DIAG = 512
_BLOCK = 256
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


# -- plain versions -----------------------------------------------------------

def _acc_dtype(dtype):
    """Dots accumulate in float32 for <=32-bit data, float64 otherwise
    (the TPU kernels' rule, pallas_spmv.py:429-430)."""
    return torch.float32 if dtype.itemsize <= 4 else torch.float64


def _dia_product(offsets, data, x, y, sign):
    """y += sign · A x over the in-range part of each diagonal, in
    diagonal order."""
    n, m = data.shape[1], x.shape[0]
    for k, d in enumerate(offsets.tolist()):
        lo, hi = max(0, -d), min(n, m - d)
        if hi > lo:
            t = data[k, lo:hi] * x[lo + d:hi + d]
            if sign > 0:
                y[lo:hi] += t
            else:
                y[lo:hi] -= t
    return y


def dia_spmv_plain(offsets, data, x):
    """y = A x."""
    dia_spmv_plain.calls += 1
    y = torch.zeros(data.shape[1], dtype=torch.promote_types(
        data.dtype, x.dtype), device=x.device)
    return _dia_product(offsets, data, x, y, +1)


def dia_residual_plain(offsets, data, f, x):
    """r = f − A x."""
    dia_residual_plain.calls += 1
    out = torch.promote_types(torch.promote_types(data.dtype, x.dtype),
                              f.dtype)
    return _dia_product(offsets, data, x, f.to(out, copy=True), -1)


def dia_scaled_correction_plain(offsets, data, w, f, x):
    """x + w ∘ (f − A x): one damped-Jacobi/SPAI-0 sweep."""
    dia_scaled_correction_plain.calls += 1
    out = torch.promote_types(torch.promote_types(data.dtype, x.dtype),
                              f.dtype)
    r = _dia_product(offsets, data, x, f.to(out, copy=True), -1)
    return x + w * r


def dia_spmv_dots_plain(offsets, data, x, w=None):
    """(y, ⟨y,y⟩, ⟨y,x⟩, ⟨y,w⟩) with y = A x (⟨y,w⟩ is None without w)."""
    dia_spmv_dots_plain.calls += 1
    y = torch.zeros(data.shape[1], dtype=torch.promote_types(
        data.dtype, x.dtype), device=x.device)
    _dia_product(offsets, data, x, y, +1)
    acc = _acc_dtype(y.dtype)
    ya = y.to(acc)
    yy = torch.dot(ya, ya).to(y.dtype)
    yx = torch.dot(ya, x.to(acc)).to(y.dtype)
    yw = None if w is None else torch.dot(ya, w.to(acc)).to(y.dtype)
    return y, yy, yx, yw


def dia_residual_dot_plain(offsets, data, f, x):
    """(r, ⟨r,r⟩) with r = f − A x."""
    dia_residual_dot_plain.calls += 1
    out = torch.promote_types(torch.promote_types(data.dtype, x.dtype),
                              f.dtype)
    r = _dia_product(offsets, data, x, f.to(out, copy=True), -1)
    ra = r.to(_acc_dtype(r.dtype))
    return r, torch.dot(ra, ra).to(r.dtype)


for _fn in (dia_spmv_plain, dia_residual_plain, dia_scaled_correction_plain,
            dia_spmv_dots_plain, dia_residual_dot_plain):
    _fn.calls = 0


# -- kernel launch ------------------------------------------------------------

def offsets_on(offsets, device):
    """The int32 tensor of the host ints ``offsets`` on ``device``, made
    once per (offsets, device): callers that keep offsets on the host
    pay no copy (and no host sync) per launch."""
    key = (offsets if type(offsets) is tuple
           else tuple(int(o) for o in offsets), torch.device(device))
    t = _OFFSETS.get(key)
    if t is None:
        t = _OFFSETS[key] = torch.tensor(key[0], dtype=torch.int32,
                                         device=key[1])
    return t


_OFFSETS = {}


def _check_vec(name, v, n, ref):
    if v.device != ref.device or v.dtype != ref.dtype \
            or v.shape != (n,) or not v.is_contiguous():
        raise ValueError(
            "%s must be a contiguous (%d,) %s tensor on %s, got %s %s "
            "on %s" % (name, n, ref.dtype, ref.device, tuple(v.shape),
                       v.dtype, v.device))


def _launch(mode, offsets, data, x, f=None, w=None):
    """Validate the operands and launch one dia.cu kernel; returns
    (y, dots) with dots an (ndots,) tensor or None."""
    if data.device.type != "cuda":
        raise ValueError("DIA kernels run on CUDA tensors, got data on %s"
                         % data.device)
    if data.dtype not in _DTYPE_CODE:
        raise ValueError("DIA kernels take float32 or float64, got %s"
                         % data.dtype)
    if data.dim() != 2 or not data.is_contiguous():
        raise ValueError("data must be a contiguous (ndiag, n) tensor")
    ndiag, n = data.shape
    if ndiag > MAX_DIAG:
        raise ValueError("%d diagonals exceed the kernel's limit of %d"
                         % (ndiag, MAX_DIAG))
    if offsets.device != data.device or offsets.dtype != torch.int32 \
            or offsets.shape != (ndiag,) or not offsets.is_contiguous():
        raise ValueError("offsets must be a contiguous (%d,) int32 tensor "
                         "on %s" % (ndiag, data.device))
    if x.dim() != 1:
        raise ValueError("x must be a vector, got shape %s"
                         % (tuple(x.shape),))
    m = x.shape[0]
    _check_vec("x", x, m, data)
    if f is not None:
        _check_vec("f", f, n, data)
    if w is not None:
        _check_vec("w", w, n, data)
    if mode in (_CORRECTION, _SPMV_DOTS, _RESIDUAL_DOT) and m != n:
        raise ValueError("this DIA kernel needs a square operator, got "
                         "%d x %d" % (n, m))
    y = torch.empty(n, dtype=data.dtype, device=data.device)
    ndots = _NDOTS.get(mode, 0)
    if n == 0:
        return y, (torch.zeros(ndots, dtype=data.dtype, device=data.device)
                   if ndots else None)
    # the reduction kernel writes every dot
    dots = torch.empty(ndots, dtype=data.dtype, device=data.device) \
        if ndots else None
    nblocks = -(-n // _BLOCK)
    partials = torch.empty(nblocks * ndots, dtype=data.dtype,
                           device=data.device) if ndots else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cuda_lib.lib().amgcl_dia(
            _DTYPE_CODE[data.dtype], mode, n, m, ndiag, offsets.data_ptr(),
            data.data_ptr(), x.data_ptr(), ptr(f), ptr(w), y.data_ptr(),
            ptr(partials), ptr(dots), nblocks, stream)
    cuda_lib.check(rc, "dia mode %d" % mode)
    return y, dots


# -- wrappers -----------------------------------------------------------------

def dia_spmv(offsets, data, x):
    """y = A x (square or rectangular)."""
    if x.device.type == "cpu":
        return dia_spmv_plain(offsets, data, x)
    y, _ = _launch(_SPMV, offsets, data, x)
    dia_spmv.launches += 1
    return y


def dia_residual(offsets, data, f, x):
    """r = f − A x in one pass (square or rectangular)."""
    if x.device.type == "cpu":
        return dia_residual_plain(offsets, data, f, x)
    r, _ = _launch(_RESIDUAL, offsets, data, x, f=f)
    dia_residual.launches += 1
    return r


def dia_scaled_correction(offsets, data, w, f, x):
    """x + w ∘ (f − A x) in one pass (square operators)."""
    if x.device.type == "cpu":
        return dia_scaled_correction_plain(offsets, data, w, f, x)
    y, _ = _launch(_CORRECTION, offsets, data, x, f=f, w=w)
    dia_scaled_correction.launches += 1
    return y


def dia_spmv_dots(offsets, data, x, w=None):
    """(y, ⟨y,y⟩, ⟨y,x⟩, ⟨y,w⟩) in one pass, y = A x; the dots are 0-d
    tensors on the device (⟨y,w⟩ is None without w). Square operators."""
    if x.device.type == "cpu":
        return dia_spmv_dots_plain(offsets, data, x, w)
    y, dots = _launch(_SPMV_DOTS, offsets, data, x, w=w)
    dia_spmv_dots.launches += 1
    return y, dots[0], dots[1], (None if w is None else dots[2])


def dia_spmv_dot(offsets, data, x):
    """(y, ⟨y, x⟩) — the CG pair; see dia_spmv_dots."""
    y, _, yx, _ = dia_spmv_dots(offsets, data, x)
    return y, yx


def dia_residual_dot(offsets, data, f, x):
    """(r, ⟨r, r⟩) with r = f − A x in one pass. Square operators."""
    if x.device.type == "cpu":
        return dia_residual_dot_plain(offsets, data, f, x)
    r, dots = _launch(_RESIDUAL_DOT, offsets, data, x, f=f)
    dia_residual_dot.launches += 1
    return r, dots[0]


for _fn in (dia_spmv, dia_residual, dia_scaled_correction, dia_spmv_dots,
            dia_residual_dot):
    _fn.launches = 0
