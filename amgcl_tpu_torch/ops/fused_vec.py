"""Fused vector updates of the Krylov outer loop.

Counterpart of ``amgcl_tpu/ops/fused_vec.py`` as far as CG needs it:

* :func:`xr_update` — the CG tail ``x += α·p``, ``r −= α·q`` and
  ``⟨r, r⟩`` from one read of {p, q, x, r}; on CUDA tensors the
  ``amgcl_tpu_torch/csrc/vec.cu`` kernel (replacing the TPU kernel
  ``_fused_pass`` in mode ``xr``), on CPU tensors :func:`xr_update_plain`.
* :func:`residual_dot` — ``r = f − A x`` and ``⟨r, r⟩`` in one operator
  pass (the DIA kernel for DIA operators, composed otherwise).
"""

from __future__ import annotations

import torch

from amgcl_tpu_torch.ops import cuda_lib
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops.dia_kernels import (_BLOCK, _DTYPE_CODE,
                                             _acc_dtype, dia_residual_dot)

#: fixed block count of the grid-stride pass: a constant grid keeps the
#: partial sums in the same order for a given n on every run
_MAX_BLOCKS = 1056


def xr_update_plain(alpha, p, q, x, r):
    """(x + α·p, r − α·q, ⟨r_new, r_new⟩)."""
    xr_update_plain.calls += 1
    xn = x + alpha * p
    rn = r - alpha * q
    ra = rn.to(_acc_dtype(rn.dtype))
    return xn, rn, torch.dot(ra, ra).to(rn.dtype)


xr_update_plain.calls = 0


def xr_update(alpha, p, q, x, r):
    """The CG iteration tail in one pass: ``(x + α·p, r − α·q, ⟨r', r'⟩)``
    with the dot a 0-d tensor on the device. ``alpha`` is a 0-d tensor of
    the vectors' dtype on their device (or a Python number)."""
    if x.device.type == "cpu":
        return xr_update_plain(alpha, p, q, x, r)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError("xr_update takes float32 or float64, got %s"
                         % x.dtype)
    n = x.shape[0]
    for name, v in (("p", p), ("q", q), ("x", x), ("r", r)):
        if v.device != x.device or v.dtype != x.dtype or v.shape != (n,) \
                or not v.is_contiguous():
            raise ValueError(
                "%s must be a contiguous (%d,) %s tensor on %s, got %s %s "
                "on %s" % (name, n, x.dtype, x.device, tuple(v.shape),
                           v.dtype, v.device))
    if not torch.is_tensor(alpha):
        alpha = torch.tensor(alpha, dtype=x.dtype, device=x.device)
    if alpha.device != x.device or alpha.dtype != x.dtype \
            or alpha.numel() != 1:
        raise ValueError("alpha must be one %s value on %s"
                         % (x.dtype, x.device))
    alpha = alpha.contiguous()
    xn = torch.empty_like(x)
    rn = torch.empty_like(r)
    if n == 0:
        return xn, rn, torch.zeros((), dtype=x.dtype, device=x.device)
    # the reduction kernel writes the dot
    dot = torch.empty(1, dtype=x.dtype, device=x.device)
    nblocks = min(-(-n // _BLOCK), _MAX_BLOCKS)
    partials = torch.empty(nblocks, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cuda_lib.lib().amgcl_xr(
            _DTYPE_CODE[x.dtype], n, alpha.data_ptr(), p.data_ptr(),
            q.data_ptr(), x.data_ptr(), r.data_ptr(), xn.data_ptr(),
            rn.data_ptr(), partials.data_ptr(), dot.data_ptr(), nblocks,
            stream)
    cuda_lib.check(rc, "xr_update")
    xr_update.launches += 1
    return xn, rn, dot[0]


xr_update.launches = 0


def residual_dot(f, A, x):
    """``(r, ⟨r, r⟩)`` with ``r = f − A x``: one kernel pass for square DIA
    operators, the residual seam plus a dot elsewhere."""
    if isinstance(A, dev.DiaMatrix) and A.shape[0] == A.shape[1]:
        return dia_residual_dot(A.offsets_t, A.data, f, x)
    r = dev.residual(f, A, x)
    return r, dev.inner_product(r, r)
