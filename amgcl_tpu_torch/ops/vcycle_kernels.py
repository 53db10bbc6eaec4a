"""Fused V-cycle leg kernels: a wrapper and a plain PyTorch version for
each of ``fused_down_sweep`` (base and zero-guess modes),
``fused_up_sweep``, and their framed modes ``fused_down_sweep_framed`` and
``fused_up_sweep_framed``.

Counterpart of the Pallas TPU kernels in ``amgcl_tpu/ops/pallas_vcycle.py``;
the CUDA source is ``amgcl_tpu_torch/csrc/vcycle.cu``. At a level with
grid-aligned 2×2×2 aggregates on fine dims ``dims = (f2, f1, f0)``, T the
tentative prolongation (``GridTentative``), A the level operator and M the
smoothing operator of P = (I − M) T (Mᵀ its transpose, all DIA):

* down: ``rc = Tᵀ (r − Mᵀ r)`` with ``r = f − A u``; with ``zero_guess``
  the ``u`` argument is the smoother scale w, the iterate ``u = w ∘ f`` is
  formed first, and the result is ``(u, rc)``.
* up: ``u' = u + T uc − M (T uc)``, then ``u' + w ∘ (f − A u')``.

The framed modes compute the same legs on one z-slab (``dims`` the
slab's own, an even number of planes) of a grid sharded over a mesh
(``parallel/dist_stencil.py``). The operands that a leg reads beyond the
slab arrive as frames carrying the neighbour slabs' rows: for the down
leg A, Mᵀ, f and u (or w) as frames of ``L = n + 2H`` rows, tile row i
at frame row ``H + i``, with H at least the reach of A plus that of Mᵀ;
for the up leg M and u as frames of ``hp`` coarse planes (2·hp fine
planes) on each side and uc with ``hp`` coarse planes on each side, with
2·hp fine planes at least the reach of A plus that of M. Their offsets
are Python ints (the reach is checked on the host).

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


def _offsets_cpu(offsets):
    return torch.tensor([int(o) for o in offsets], dtype=torch.int32)


def fused_down_sweep_framed_plain(a_offsets, a_frame, mt_offsets, mt_frame,
                                  f, u, dims, H, zero_guess=False):
    """The base down leg's residual and Mᵀ filter over the whole frame as
    one DIA problem of its L rows, sliced to the tile and restricted.
    Returns rc, or ``(w ∘ f, rc)`` on the tile with ``zero_guess``."""
    fused_down_sweep_framed_plain.calls += 1
    n = int(dims[0]) * int(dims[1]) * int(dims[2])
    if zero_guess:
        u = u * f
    r = dk.dia_residual_plain(_offsets_cpu(a_offsets), a_frame, f, u)
    t = dk.dia_residual_plain(_offsets_cpu(mt_offsets), mt_frame, r, r)
    rc = _tentative(dims).rmv(t[H:H + n])
    return (u[H:H + n], rc) if zero_guess else rc


def fused_up_sweep_framed_plain(a_offsets, a_data, m_offsets, m_frame, w, f,
                                u, uc, dims, halo_planes):
    """The base up leg over the frame's planes as one DIA problem (A, w
    and f zero outside the tile), sliced to the tile."""
    fused_up_sweep_framed_plain.calls += 1
    lz, d1, d0 = (int(d) for d in dims)
    n, t0 = lz * d1 * d0, 2 * int(halo_planes) * d1 * d0

    def frame(v):
        out = v.new_zeros(v.shape[:-1] + (n + 2 * t0,))
        out[..., t0:t0 + n] = v
        return out

    tuc = _tentative((lz + 4 * int(halo_planes), d1, d0)).mv(uc)
    u1 = u + dk.dia_residual_plain(_offsets_cpu(m_offsets), m_frame, tuc,
                                   tuc)
    return dk.dia_scaled_correction_plain(
        _offsets_cpu(a_offsets), frame(a_data), frame(w), frame(f),
        u1)[t0:t0 + n]


for _fn in (fused_down_sweep_plain, fused_up_sweep_plain,
            fused_down_sweep_framed_plain, fused_up_sweep_framed_plain):
    _fn.calls = 0


# -- kernel launch ------------------------------------------------------------

def _reach(offsets):
    return max((abs(int(o)) for o in offsets), default=0)


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


def _check_leg(dims, ref, operators, vectors, ncols=None):
    """Validate one leg's operands on the card (operators of ``ncols``
    columns, n by default); returns (n, nc)."""
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
        _check_dia(name, offsets, data, n if ncols is None else ncols, ref)
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
            int(bool(zero_guess)), f2, f1, f0, 0, n, a_data.shape[0],
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
            f2, f1, f0, 0, f2, a_data.shape[0], m_data.shape[0],
            a_offsets.data_ptr(), a_data.data_ptr(), m_offsets.data_ptr(),
            m_data.data_ptr(), w.data_ptr(), f.data_ptr(), u.data_ptr(),
            uc.data_ptr(), out.data_ptr(), stream)
    cuda_lib.check(rcode, "fused_up_sweep")
    fused_up_sweep.launches += 1
    return out


def _check_frame(dims, reach, halo, what):
    """The framed modes' geometry: an even number of slab planes, and a
    halo that covers the reach of both of the leg's operators."""
    dims = tuple(int(d) for d in dims)
    if len(dims) != 3 or min(dims) < 1 or dims[0] % 2:
        raise ValueError("the framed legs take a slab of an even number of "
                         "planes, got dims %s" % (dims,))
    if halo < reach:
        raise ValueError("%s of %d rows is short of the %d rows that the "
                         "operators reach" % (what, halo, reach))
    n = dims[0] * dims[1] * dims[2]
    if n + 2 * halo >= MAX_ROWS:
        raise ValueError("a frame of %d rows exceeds the kernels' limit of "
                         "%d" % (n + 2 * halo, MAX_ROWS))
    return dims, n


def fused_down_sweep_framed(a_offsets, a_frame, mt_offsets, mt_frame, f, u,
                            dims, H, zero_guess=False):
    """The down leg on a framed slab: ``a_frame`` (nA, L) and ``mt_frame``
    (nMt, L) hold A's and Mᵀ's diagonals, ``f`` and ``u`` (with
    ``zero_guess`` the smoother scale w) are frames of L = n + 2H rows,
    tile row i at frame row H + i, and H covers the reach of A plus that
    of Mᵀ (``a_offsets``, ``mt_offsets``: Python ints). Returns the slab's
    coarse rhs rc, or ``(w ∘ f, rc)`` on the slab with ``zero_guess``."""
    if f.device.type == "cpu":
        return fused_down_sweep_framed_plain(a_offsets, a_frame, mt_offsets,
                                             mt_frame, f, u, dims, H,
                                             zero_guess)
    H = int(H)
    dims, n = _check_frame(dims, _reach(a_offsets) + _reach(mt_offsets), H,
                           "the halo H")
    L = n + 2 * H
    oa = dk.offsets_on(a_offsets, f.device)
    om = dk.offsets_on(mt_offsets, f.device)
    _, nc = _check_leg(dims, f, [("A", oa, a_frame), ("Mt", om, mt_frame)],
                       [("f", f, L), ("w" if zero_guess else "u", u, L)],
                       ncols=L)
    rc = torch.empty(nc, dtype=f.dtype, device=f.device)
    u_out = torch.empty(n, dtype=f.dtype, device=f.device) \
        if zero_guess else None
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        rcode = cuda_lib.lib().amgcl_fused_down(
            int(bool(zero_guess)), *dims, H, L, a_frame.shape[0],
            mt_frame.shape[0], oa.data_ptr(), a_frame.data_ptr(),
            om.data_ptr(), mt_frame.data_ptr(), f.data_ptr(), u.data_ptr(),
            None if u_out is None else u_out.data_ptr(), rc.data_ptr(),
            stream)
    cuda_lib.check(rcode, "fused_down_sweep_framed")
    fused_down_sweep_framed.launches += 1
    return (u_out, rc) if zero_guess else rc


def fused_up_sweep_framed(a_offsets, a_data, m_offsets, m_frame, w, f, u, uc,
                          dims, halo_planes):
    """The up leg on a framed slab: ``a_data`` (nA, n), ``w`` and ``f`` are
    the slab's own; ``m_frame`` (nM, Lm) and ``u`` (Lm,) are frames of
    ``halo_planes`` (hp) coarse planes on each side, Lm = n + 4·hp·s with
    s a fine plane; ``uc`` is the slab's coarse vector with hp coarse
    planes of its neighbours on each side; 2·hp·s covers the reach of A
    plus that of M. Returns ``u' + w ∘ (f − A u')`` on the slab, with
    ``u' = u + T uc − M (T uc)``."""
    if f.device.type == "cpu":
        return fused_up_sweep_framed_plain(a_offsets, a_data, m_offsets,
                                           m_frame, w, f, u, uc, dims,
                                           halo_planes)
    hp = int(halo_planes)
    s2 = 2 * int(dims[1]) * int(dims[2])
    dims, n = _check_frame(dims, _reach(a_offsets) + _reach(m_offsets),
                           hp * s2, "a halo of %d coarse planes" % hp)
    if hp < 1:
        raise ValueError("the framed up leg needs at least one halo plane")
    Lm = n + 2 * hp * s2
    c2, c1, c0 = coarse_dims(dims)
    oa = dk.offsets_on(a_offsets, f.device)
    om = dk.offsets_on(m_offsets, f.device)
    _check_leg(dims, f, [("A", oa, a_data)],
               [("f", f, None), ("w", w, None), ("u", u, Lm),
                ("uc", uc, (c2 + 2 * hp) * c1 * c0)])
    _check_dia("M", om, m_frame, Lm, f)
    out = torch.empty(n, dtype=f.dtype, device=f.device)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        rcode = cuda_lib.lib().amgcl_fused_up(
            *dims, 2 * hp, dims[0] + 4 * hp, a_data.shape[0],
            m_frame.shape[0], oa.data_ptr(), a_data.data_ptr(),
            om.data_ptr(), m_frame.data_ptr(), w.data_ptr(), f.data_ptr(),
            u.data_ptr(), uc.data_ptr(), out.data_ptr(), stream)
    cuda_lib.check(rcode, "fused_up_sweep_framed")
    fused_up_sweep_framed.launches += 1
    return out


for _fn in (fused_down_sweep, fused_up_sweep, fused_down_sweep_framed,
            fused_up_sweep_framed):
    _fn.launches = 0
