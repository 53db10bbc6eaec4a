"""Fused V-cycle leg kernels: a wrapper and a plain PyTorch version for
each of ``fused_down_sweep`` (base and zero-guess modes) and
``fused_up_sweep``.

Counterpart of the Pallas TPU kernels in ``amgcl_tpu/ops/pallas_vcycle.py``;
the CUDA source is ``amgcl_tpu_torch/csrc/vcycle.cu``. At a level with
grid-aligned 2×2×2 aggregates on fine dims ``dims = (f2, f1, f0)``, T the
tentative prolongation (``GridTentative``), A the level operator and M the
smoothing operator of P = (I − M) T (Mᵀ its transpose, all DIA):

* down: ``rc = Tᵀ (r − Mᵀ r)`` with ``r = f − A u``; with ``zero_guess``
  the ``u`` argument is the smoother scale w, the iterate ``u = w ∘ f`` is
  formed first, and the result is ``(u, rc)``.
* up: ``u' = u + T uc − M (T uc)``, then ``u' + w ∘ (f − A u')``.

Each wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it checks device, dtype (float32), shapes and contiguity and
launches the kernel, or raises. ``<wrapper>.launches`` counts kernel
launches and ``<plain>.calls`` plain-version calls.
"""

from __future__ import annotations

import torch

from amgcl_tpu_torch.ops import cuda_lib
from amgcl_tpu_torch.ops import dia_kernels as dk
from amgcl_tpu_torch.ops.structured import GridTentative

BLOCK = (2, 2, 2)
#: the kernels index rows with 32-bit ints, offsets included
MAX_ROWS = 1 << 30


def coarse_dims(dims):
    return tuple(-(-int(d) // 2) for d in dims)


def _tentative(dims):
    return GridTentative(dims, BLOCK, coarse_dims(dims))


# -- plain versions -----------------------------------------------------------

def fused_down_sweep_plain(a_offsets, a_data, mt_offsets, mt_data, f, u,
                           dims, zero_guess=False):
    """``Tᵀ (r − Mᵀ r)`` with ``r = f − A u``; ``(w ∘ f, rc)`` when
    ``zero_guess`` (``u`` is then the scale w)."""
    fused_down_sweep_plain.calls += 1
    if zero_guess:
        u = u * f
    r = dk.dia_residual_plain(a_offsets, a_data, f, u)
    rc = _tentative(dims).rmv(dk.dia_residual_plain(mt_offsets, mt_data,
                                                    r, r))
    return (u, rc) if zero_guess else rc


def fused_up_sweep_plain(a_offsets, a_data, m_offsets, m_data, w, f, u, uc,
                         dims):
    """``u' + w ∘ (f − A u')`` with ``u' = u + T uc − M (T uc)``."""
    fused_up_sweep_plain.calls += 1
    tuc = _tentative(dims).mv(uc)
    u1 = u + dk.dia_residual_plain(m_offsets, m_data, tuc, tuc)
    return dk.dia_scaled_correction_plain(a_offsets, a_data, w, f, u1)


fused_down_sweep_plain.calls = 0
fused_up_sweep_plain.calls = 0


# -- kernel launch ------------------------------------------------------------

def _check_dia(name, offsets, data, n, ref):
    if data.device != ref.device or data.dtype != torch.float32 \
            or data.dim() != 2 or data.shape[1] != n \
            or not data.is_contiguous():
        raise ValueError("%s data must be a contiguous (ndiag, %d) float32 "
                         "tensor on %s, got %s %s on %s"
                         % (name, n, ref.device, tuple(data.shape),
                            data.dtype, data.device))
    ndiag = data.shape[0]
    if not 0 < ndiag <= dk.MAX_DIAG:
        raise ValueError("%s has %d diagonals; the kernels take 1 to %d"
                         % (name, ndiag, dk.MAX_DIAG))
    if offsets.device != ref.device or offsets.dtype != torch.int32 \
            or offsets.shape != (ndiag,) or not offsets.is_contiguous():
        raise ValueError("%s offsets must be a contiguous (%d,) int32 "
                         "tensor on %s" % (name, ndiag, ref.device))


def _check_leg(dims, ref, operators, vectors):
    """Validate one leg's operands on the card; returns (n, nc)."""
    if ref.device.type != "cuda":
        raise ValueError("the fused V-cycle kernels run on CUDA tensors, "
                         "got %s" % ref.device)
    if ref.dtype != torch.float32:
        raise ValueError("the fused V-cycle kernels take float32, got %s"
                         % ref.dtype)
    dims = tuple(int(d) for d in dims)
    if len(dims) != 3 or min(dims) < 1:
        raise ValueError("dims must be three positive grid extents, got %s"
                         % (dims,))
    n = dims[0] * dims[1] * dims[2]
    if n >= MAX_ROWS:
        raise ValueError("%d rows exceed the kernels' limit of %d"
                         % (n, MAX_ROWS))
    c2, c1, c0 = coarse_dims(dims)
    nc = c2 * c1 * c0
    for name, offsets, data in operators:
        _check_dia(name, offsets, data, n, ref)
    for name, v, size in vectors:
        dk._check_vec(name, v, n if size is None else size, ref)
    return n, nc


def fused_down_sweep(a_offsets, a_data, mt_offsets, mt_data, f, u, dims,
                     zero_guess=False):
    """The whole down leg in one pass: ``rc = Tᵀ (r − Mᵀ r)``, ``r = f −
    A u``, as a flat coarse vector. With ``zero_guess`` the ``u`` argument
    is the smoother scale w and the result is ``(w ∘ f, rc)``: pre-smooth
    from zero, residual and restriction in one kernel."""
    if f.device.type == "cpu":
        return fused_down_sweep_plain(a_offsets, a_data, mt_offsets,
                                      mt_data, f, u, dims, zero_guess)
    n, nc = _check_leg(dims, f, [("A", a_offsets, a_data),
                                 ("Mt", mt_offsets, mt_data)],
                       [("f", f, None), ("w" if zero_guess else "u", u,
                                         None)])
    rc = torch.empty(nc, dtype=f.dtype, device=f.device)
    u_out = torch.empty(n, dtype=f.dtype, device=f.device) \
        if zero_guess else None
    f2, f1, f0 = (int(d) for d in dims)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        rcode = cuda_lib.lib().amgcl_fused_down(
            int(bool(zero_guess)), f2, f1, f0, a_data.shape[0],
            mt_data.shape[0], a_offsets.data_ptr(), a_data.data_ptr(),
            mt_offsets.data_ptr(), mt_data.data_ptr(), f.data_ptr(),
            u.data_ptr(), None if u_out is None else u_out.data_ptr(),
            rc.data_ptr(), stream)
    cuda_lib.check(rcode, "fused_down_sweep")
    fused_down_sweep.launches += 1
    return (u_out, rc) if zero_guess else rc


def fused_up_sweep(a_offsets, a_data, m_offsets, m_data, w, f, u, uc, dims):
    """The whole up leg in one pass: prolongation, correction and the
    first post-smoothing sweep, ``u' + w ∘ (f − A u')`` with ``u' = u +
    T uc − M (T uc)``."""
    if f.device.type == "cpu":
        return fused_up_sweep_plain(a_offsets, a_data, m_offsets, m_data, w,
                                    f, u, uc, dims)
    c2, c1, c0 = coarse_dims(dims)
    n, _ = _check_leg(dims, f, [("A", a_offsets, a_data),
                                ("M", m_offsets, m_data)],
                      [("f", f, None), ("u", u, None), ("w", w, None),
                       ("uc", uc, c2 * c1 * c0)])
    out = torch.empty(n, dtype=f.dtype, device=f.device)
    f2, f1, f0 = (int(d) for d in dims)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        rcode = cuda_lib.lib().amgcl_fused_up(
            f2, f1, f0, a_data.shape[0], m_data.shape[0],
            a_offsets.data_ptr(), a_data.data_ptr(), m_offsets.data_ptr(),
            m_data.data_ptr(), w.data_ptr(), f.data_ptr(), u.data_ptr(),
            uc.data_ptr(), out.data_ptr(), stream)
    cuda_lib.check(rcode, "fused_up_sweep")
    fused_up_sweep.launches += 1
    return out


fused_down_sweep.launches = 0
fused_up_sweep.launches = 0
