"""DIA kernels: a wrapper and a plain PyTorch version for each of
``dia_spmv``, ``dia_residual``, ``dia_scaled_correction``,
``dia_spmv_dots``/``dia_spmv_dot`` and ``dia_residual_dot``.

Counterpart of the Pallas TPU kernels in ``amgcl_tpu/ops/pallas_spmv.py``;
the CUDA source is ``amgcl_tpu_torch/csrc/dia.cu``. Storage: ``data[k, i]``
holds ``A[i, i + offsets[k]]``; ``offsets`` is an int32 tensor on the
data's device. Entries whose column ``i + offsets[k]`` falls outside
``[0, m)`` contribute nothing.

Every kernel also takes bfloat16 operands (a bfloat16 hierarchy's levels
and a bfloat16 Krylov loop): each product and each sum rounded to
bfloat16 in diagonal order, as the plain versions' torch operations and
the TPU kernel's bfloat16 accumulator round. The dot kernels' bfloat16
mode sums its dots in float32 over the bfloat16 y (or r) and rounds each
once to bfloat16, as the TPU kernels cast their float32 sums; the plain
versions sum in torch's order, so a dot may differ from the kernel's by
one bfloat16 ULP, and the vectors are equal bit for bit.

Each wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it checks device, dtype, shape and contiguity and launches
the kernel, or raises. ``<wrapper>.launches`` counts kernel launches
(``<wrapper>.bf16_launches`` those in bfloat16) and ``<plain>.calls``
counts plain-version calls, so a run can show which path it took.

The dot kernels (``dia_spmv_dots``, ``dia_residual_dot``) take their
offsets as kernel parameters: pass them as host ints (a tuple, as
``DiaMatrix.offsets``); a tensor is copied to the host at each call.
They sum their dots in one fixed order, :func:`ordered_dot`, and run as
one launch whose geometry is :func:`launch_geometry`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from amgcl_tpu_torch.ops import cuda_lib

_SPMV, _RESIDUAL, _CORRECTION, _SPMV_DOTS, _RESIDUAL_DOT = range(5)
MAX_DIAG = 512
_BLOCK = 256
#: rows of one partial of the dot kernels, and of one block's step
GROUP = 256
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
#: the C entries' code of bfloat16, which every kernel here takes
BF16_CODE = 2


# -- plain versions -----------------------------------------------------------

def _acc_dtype(dtype):
    """Dots accumulate in float32 for <=32-bit data, float64 otherwise
    (the TPU kernels' rule, pallas_spmv.py:429-430)."""
    return torch.float32 if dtype.itemsize <= 4 else torch.float64


def _dia_product(offsets, data, x, y, sign):
    """y += sign · A x over the in-range part of each diagonal, in
    diagonal order."""
    n, m = data.shape[1], x.shape[0]
    for k, d in enumerate(host_offsets(offsets)):
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

def host_offsets(offsets):
    """Offsets as a tuple of ints: a tensor's are copied to the host (a
    sync on the card), so a hot path passes a tuple (taken as it is)."""
    if isinstance(offsets, torch.Tensor):
        return tuple(offsets.tolist())
    if type(offsets) is tuple:
        return offsets
    return tuple(int(o) for o in offsets)


def c_ints(values):
    """The ctypes int array of a sequence of ints, made once per tuple of
    them (the C entries only read it): a warm solve launches with the
    same offsets again and again."""
    return _c_array(tuple(values))


@functools.lru_cache(maxsize=512)
def _c_array(values):
    if any(not -2 ** 31 <= v < 2 ** 31 for v in values):
        # ctypes would wrap the value silently
        raise ValueError("values outside int32: %s" % (values,))
    return (ctypes.c_int * len(values))(*values)


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


def dtype_code(dtype, what):
    """The C entries' code of ``dtype``, else a ValueError naming
    ``what``."""
    if dtype in _DTYPE_CODE:
        return _DTYPE_CODE[dtype]
    if dtype == torch.bfloat16:
        return BF16_CODE
    raise ValueError("%s take float32, float64 or bfloat16, got %s"
                     % (what, dtype))


def _check_operands(data, x, f, w):
    """Validate data, x and the optional f and w; returns (ndiag, n,
    m)."""
    if data.device.type != "cuda":
        raise ValueError("DIA kernels run on CUDA tensors, got data on %s"
                         % data.device)
    dtype_code(data.dtype, "DIA kernels")
    if data.dim() != 2 or not data.is_contiguous():
        raise ValueError("data must be a contiguous (ndiag, n) tensor")
    ndiag, n = data.shape
    if ndiag > MAX_DIAG:
        raise ValueError("%d diagonals exceed the kernel's limit of %d"
                         % (ndiag, MAX_DIAG))
    if x.dim() != 1:
        raise ValueError("x must be a vector, got shape %s"
                         % (tuple(x.shape),))
    m = x.shape[0]
    _check_vec("x", x, m, data)
    if f is not None:
        _check_vec("f", f, n, data)
    if w is not None:
        _check_vec("w", w, n, data)
    return ndiag, n, m


def _launch(mode, offsets, data, x, f=None, w=None):
    """Validate the operands and launch dia.cu's dia_kernel (SPMV,
    RESIDUAL, CORRECTION); returns y."""
    ndiag, n, m = _check_operands(data, x, f, w)
    if offsets.device != data.device or offsets.dtype != torch.int32 \
            or offsets.shape != (ndiag,) or not offsets.is_contiguous():
        raise ValueError("offsets must be a contiguous (%d,) int32 tensor "
                         "on %s" % (ndiag, data.device))
    if mode == _CORRECTION and m != n:
        raise ValueError("this DIA kernel needs a square operator, got "
                         "%d x %d" % (n, m))
    y = torch.empty(n, dtype=data.dtype, device=data.device)
    if n == 0:
        return y
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cuda_lib.lib().amgcl_dia(
            dtype_code(data.dtype, "DIA kernels"), mode, n, m, ndiag,
            offsets.data_ptr(), data.data_ptr(), x.data_ptr(), ptr(f),
            ptr(w), y.data_ptr(),
            -(-n // _BLOCK), stream)
    cuda_lib.check(rc, "dia mode %d" % mode)
    return y


class Geometry(NamedTuple):
    """The dot kernels' launch: ``groups`` of GROUP rows (one partial a
    dot each), groups [lo, hi) interior."""
    groups: int
    lo: int
    hi: int


def launch_geometry(n, m, offsets):
    """The groups of the dot kernels over ``n`` rows of an operator with
    ``m`` columns and these host offsets: ceil(n / GROUP), a thread a row
    (the kernel's blocks walk them, as many blocks as fit on the card).
    Groups [lo, hi) are interior: each of their rows is below n and each
    term's column ``i + offset`` lies in [0, m), so they run without a
    bounds test (an empty range is (0, 0))."""
    groups = -(-int(n) // GROUP)
    below = max([0] + [-o for o in offsets])
    above = max([0] + list(offsets))
    lo = -(-below // GROUP)
    hi = max(0, min(n, m - above)) // GROUP
    if hi <= lo:
        lo = hi = 0
    return Geometry(groups, lo, hi)


def _ticket(device, stream):
    """The dot kernels' ticket for launches on ``stream``: one zeroed
    counter per (device, stream), made once on that stream and left at 0
    by every launch, so two launches in flight on two streams never share
    one. A ticket is never made while the stream captures a CUDA graph:
    it would come from the graph's private pool and its zeroing would be
    a node of the graph, so a capture needs :func:`ensure_ticket` first."""
    key = (torch.device(device), stream)
    t = _TICKETS.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "no dot-kernel ticket for stream %#x on %s: make it with "
                "ensure_ticket before capturing a CUDA graph on that stream"
                % (stream, device))
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def ensure_ticket(stream):
    """Make, outside any capture, the ticket of the dot and tail kernels
    for launches on ``stream`` (a ``torch.cuda.Stream``), zeroed on that
    stream; returns it. Launches on the stream, captured or not, then
    reuse it."""
    with torch.cuda.stream(stream):
        return _ticket(stream.device, stream.cuda_stream)


_TICKETS = {}


def _launch_dots(mode, offsets, data, x, f=None, w=None):
    """Validate the operands and launch dia.cu's dots_kernel (SPMV_DOTS,
    RESIDUAL_DOT) once; returns (y, dots), dots an (ndots,) tensor of its
    own allocation (3 with w, 2 without, 1 for RESIDUAL_DOT). bfloat16
    operands sum their partials in float32."""
    ndiag, n, m = _check_operands(data, x, f, w)
    offs = host_offsets(offsets)
    if len(offs) != ndiag:
        raise ValueError("%d offsets for %d diagonals" % (len(offs), ndiag))
    if m != n:
        raise ValueError("this DIA kernel needs a square operator, got "
                         "%d x %d" % (n, m))
    ndots = 1 if mode == _RESIDUAL_DOT else (2 if w is None else 3)
    y = torch.empty(n, dtype=data.dtype, device=data.device)
    if n == 0:
        return y, torch.zeros(ndots, dtype=data.dtype, device=data.device)
    geo = launch_geometry(n, m, offs)
    # the kernel writes every dot and partial
    dots = torch.empty(ndots, dtype=data.dtype, device=data.device)
    partials = torch.empty(ndots * geo.groups, dtype=_acc_dtype(data.dtype),
                           device=data.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        ticket = _ticket(data.device, stream)
        rc = cuda_lib.lib().amgcl_dia_dots(
            dtype_code(data.dtype, "DIA kernels"), mode, n, m, ndiag,
            c_ints(offs), data.data_ptr(), x.data_ptr(), ptr(f), ptr(w),
            y.data_ptr(),
            partials.data_ptr(), dots.data_ptr(), ticket.data_ptr(),
            geo.groups, geo.lo, geo.hi, stream)
    cuda_lib.check(rc, "dia dots mode %d" % mode)
    return y, dots


# -- the dot kernels' order ---------------------------------------------------

def _tree(s):
    """Pairwise sums s[:, t] += s[:, t + stride] for stride = 128 … 1
    over the rows of a (k, 256) array; returns the (k,) sums."""
    while s.shape[1] > 1:
        half = s.shape[1] // 2
        s = s[:, :half] + s[:, half:]
    return s[:, 0]


def ordered_dot(a, b):
    """⟨a, b⟩ in numpy at a's type, summed in the dot kernels' order:
    the products a_i b_i, each rounded; per group of GROUP rows (rows past
    the end give 0) the tree of :func:`_tree`; then lane t of 256 adds
    partials t, t + 256, … to 0 in that order, and the same tree over the
    256 lanes. Numpy rounds each float32 or float64 operation as the card
    does, so on the kernel's own y this gives its dots bit for bit."""
    a, b = np.asarray(a), np.asarray(b)
    n = a.shape[0]
    groups = -(-n // GROUP)
    p = np.zeros(groups * GROUP, a.dtype)
    p[:n] = a * b
    part = _tree(p.reshape(groups, GROUP))
    lanes = np.zeros(256, a.dtype)
    for r in range(0, groups, 256):
        chunk = part[r:r + 256]
        lanes[:chunk.shape[0]] += chunk
    return _tree(lanes.reshape(1, 256))[0]


# -- wrappers -----------------------------------------------------------------

def count_launch(fn, dtype):
    """One launch of wrapper ``fn`` on ``dtype`` operands: ``fn.launches``
    counts every launch, ``fn.bf16_launches`` those of its bfloat16 mode
    (a wrapper with one)."""
    fn.launches += 1
    if dtype == torch.bfloat16:
        fn.bf16_launches += 1


def dia_spmv(offsets, data, x):
    """y = A x (square or rectangular)."""
    if x.device.type == "cpu":
        return dia_spmv_plain(offsets, data, x)
    y = _launch(_SPMV, offsets, data, x)
    count_launch(dia_spmv, y.dtype)
    return y


def dia_residual(offsets, data, f, x):
    """r = f − A x in one pass (square or rectangular)."""
    if x.device.type == "cpu":
        return dia_residual_plain(offsets, data, f, x)
    r = _launch(_RESIDUAL, offsets, data, x, f=f)
    count_launch(dia_residual, r.dtype)
    return r


def dia_scaled_correction(offsets, data, w, f, x):
    """x + w ∘ (f − A x) in one pass (square operators)."""
    if x.device.type == "cpu":
        return dia_scaled_correction_plain(offsets, data, w, f, x)
    y = _launch(_CORRECTION, offsets, data, x, f=f, w=w)
    count_launch(dia_scaled_correction, y.dtype)
    return y


def dia_spmv_dots(offsets, data, x, w=None):
    """(y, ⟨y,y⟩, ⟨y,x⟩, ⟨y,w⟩) in one launch, y = A x; the dots are 0-d
    tensors on the device (⟨y,w⟩ is None without w). Square operators;
    offsets as host ints or an int32 tensor (copied to the host)."""
    if x.device.type == "cpu":
        return dia_spmv_dots_plain(offsets, data, x, w)
    y, dots = _launch_dots(_SPMV_DOTS, offsets, data, x, w=w)
    count_launch(dia_spmv_dots, y.dtype)
    return y, dots[0], dots[1], (None if w is None else dots[2])


def dia_spmv_dot(offsets, data, x):
    """(y, ⟨y, x⟩) — the CG pair; see dia_spmv_dots."""
    y, _, yx, _ = dia_spmv_dots(offsets, data, x)
    return y, yx


def dia_residual_dot(offsets, data, f, x):
    """(r, ⟨r, r⟩) with r = f − A x in one launch. Square operators;
    offsets as for dia_spmv_dots."""
    if x.device.type == "cpu":
        return dia_residual_dot_plain(offsets, data, f, x)
    r, dots = _launch_dots(_RESIDUAL_DOT, offsets, data, x, f=f)
    count_launch(dia_residual_dot, r.dtype)
    return r, dots[0]


for _fn in (dia_spmv, dia_residual, dia_scaled_correction, dia_spmv_dots,
            dia_residual_dot):
    _fn.launches = 0
    _fn.bf16_launches = 0
