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

Each leg stages its intermediates for a tile of the grid in shared
memory (``csrc/vcycle.cu``): the down leg r = f − A u (and u, or w ∘ f),
the up leg u' and T uc. :func:`down_tile` and :func:`up_tile` plan the
tile from the offsets and dims once per level, and the kernel checks it
against the offsets on the host, so the base legs take their offsets as
Python ints too (a tensor's are copied to the host at each call).

The base and zero-guess legs also run in bfloat16 (a bfloat16
hierarchy's levels), rounding where the TPU legs' bfloat16 dtype rounds
(see the plain versions); their boxes hold bfloat16, so the tiles are
planned in bytes. The framed legs take float32.

Each wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it checks device, dtype (float32, or bfloat16 in the base
legs), shapes and contiguity and launches the kernel, or raises.
``<wrapper>.launches`` counts kernel launches
(``<wrapper>.bf16_launches`` those in bfloat16) and ``<plain>.calls``
plain-version calls.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

import torch

from amgcl_tpu_torch.ops import cuda_lib
from amgcl_tpu_torch.ops import dia_kernels as dk
from amgcl_tpu_torch.ops.structured import GridTentative

BLOCK = (2, 2, 2)
#: the kernels index rows with 32-bit ints, offsets included
MAX_ROWS = 1 << 30
#: the legs' staged boxes: the dynamic shared memory a block may take
#: beside its static arrays (232,448 bytes less 4 × 512 offsets)
MAX_BOX_BYTES = 232448 - 4 * dk.MAX_DIAG * 4
#: the SMs of the H100 that down_tile and up_tile plan for
_SMS = 132
#: the down leg's clusters (cz, cy): pairs of tiles share the rows of box
#: R between them; clusters of 4 or 8 took 1.5× longer on an H100, whose
#: GPCs hold too few of them at once (PERF.md §6)
_CLUSTERS = ((1, 1), (2, 1), (1, 2))
#: a cluster's two syncs and its copies between blocks, as a share of the
#: busiest block's loads: fitted to kernel_ab.py's sweep on an H100, where
#: pairs paid at the 33-diagonal levels (the main path's L1, S1's L1
#: slab) and not at the 7-diagonal ones (PERF.md §6)
_CLUSTER_COST = 1.15


def coarse_dims(dims):
    return tuple(-(-int(d) // 2) for d in dims)


def _tentative(dims):
    return GridTentative(dims, BLOCK, coarse_dims(dims))


# -- plain versions -----------------------------------------------------------

def _stencil_sum(offsets, data, x):
    """Σ_k data[k] · x[· + offsets[k]] from 0 in offset order, each
    operation in x's dtype: the TPU legs' stencil sum
    (pallas_vcycle.py:238, :468), which in bfloat16 rounds each product
    and each sum."""
    return dk._dia_product(dk.host_offsets(offsets), data, x,
                           torch.zeros_like(x), +1)


def _restrict_bf16(t, dims):
    """Tᵀ t for a bfloat16 t as the TPU down leg forms it: each coarse
    cell's z pairs added in bfloat16, then its y pairs and its x pair in
    float32 (pallas_vcycle.py:250-263: float32 pair-sum dots), rounded
    once; a child past the grid's end adds 0."""
    f2, f1, f0 = (int(d) for d in dims)
    c2, c1, c0 = coarse_dims(dims)
    tp = torch.nn.functional.pad(t.reshape(1, f2, f1, f0),
                                 (0, 2 * c0 - f0, 0, 2 * c1 - f1,
                                  0, 2 * c2 - f2))[0]
    t2 = (tp[0::2] + tp[1::2]).to(torch.float32)
    ty = t2[:, 0::2, :] + t2[:, 1::2, :]
    return (ty[:, :, 0::2] + ty[:, :, 1::2]).to(t.dtype).reshape(-1)


def fused_down_sweep_plain(a_offsets, a_data, mt_offsets, mt_data, f, u,
                           dims, zero_guess=False):
    """``Tᵀ (r − Mᵀ r)`` with ``r = f − A u``; ``(w ∘ f, rc)`` when
    ``zero_guess`` (``u`` is then the scale w); offsets as int32 tensors
    or Python ints. In bfloat16 every operation rounds where the TPU
    kernel's does: r = f − Σ a·u and t = r − Σ mᵀ·r, each sum from 0,
    and the restriction of :func:`_restrict_bf16`."""
    fused_down_sweep_plain.calls += 1
    if zero_guess:
        u = u * f
    if f.dtype == torch.bfloat16:
        r = f - _stencil_sum(a_offsets, a_data, u)
        rc = _restrict_bf16(r - _stencil_sum(mt_offsets, mt_data, r), dims)
        return (u, rc) if zero_guess else rc
    r = dk.dia_residual_plain(_on(a_offsets, f.device), a_data, f, u)
    rc = _tentative(dims).rmv(dk.dia_residual_plain(
        _on(mt_offsets, f.device), mt_data, r, r))
    return (u, rc) if zero_guess else rc


def fused_up_sweep_plain(a_offsets, a_data, m_offsets, m_data, w, f, u, uc,
                         dims):
    """``u' + w ∘ (f − A u')`` with ``u' = u + T uc − M (T uc)``;
    offsets as int32 tensors or Python ints. In bfloat16 every operation
    rounds where the TPU kernel's does: u' = (u + T uc) − Σ m·T uc and
    u' + w ∘ (f − Σ a·u'), each sum from 0."""
    fused_up_sweep_plain.calls += 1
    tuc = _tentative(dims).mv(uc)
    if f.dtype == torch.bfloat16:
        u1 = (u + tuc) - _stencil_sum(m_offsets, m_data, tuc)
        return u1 + w * (f - _stencil_sum(a_offsets, a_data, u1))
    u1 = u + dk.dia_residual_plain(_on(m_offsets, f.device), m_data, tuc,
                                   tuc)
    return dk.dia_scaled_correction_plain(_on(a_offsets, f.device), a_data,
                                          w, f, u1)


def _on(offsets, device):
    """The int32 offsets on ``device``: the tensor given, or the cached
    copy of Python ints."""
    if isinstance(offsets, torch.Tensor):
        return offsets
    return dk.offsets_on(offsets, device)


def fused_down_sweep_framed_plain(a_offsets, a_frame, mt_offsets, mt_frame,
                                  f, u, dims, H, zero_guess=False):
    """The base down leg's residual and Mᵀ filter over the whole frame as
    one DIA problem of its L rows, sliced to the tile and restricted.
    Returns rc, or ``(w ∘ f, rc)`` on the tile with ``zero_guess``."""
    fused_down_sweep_framed_plain.calls += 1
    n = int(dims[0]) * int(dims[1]) * int(dims[2])
    if zero_guess:
        u = u * f
    r = dk.dia_residual_plain(_on(a_offsets, "cpu"), a_frame, f, u)
    t = dk.dia_residual_plain(_on(mt_offsets, "cpu"), mt_frame, r, r)
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
    u1 = u + dk.dia_residual_plain(_on(m_offsets, "cpu"), m_frame, tuc,
                                   tuc)
    return dk.dia_scaled_correction_plain(
        _on(a_offsets, "cpu"), frame(a_data), frame(w), frame(f),
        u1)[t0:t0 + n]


for _fn in (fused_down_sweep_plain, fused_up_sweep_plain,
            fused_down_sweep_framed_plain, fused_up_sweep_framed_plain):
    _fn.calls = 0


# -- kernel launch ------------------------------------------------------------

def _reach(offsets):
    return max((abs(int(o)) for o in offsets), default=0)


def split_nearest(o, s, f0):
    """Flat offset ``o`` as ``dz·s + dy·f0 + dx`` with each part rounded
    to the nearest (dx in [−f0/2, f0/2), dy then likewise within a
    plane): the decomposition by which the up leg's boxes are sized and
    indexed (``split_nearest`` in csrc/vcycle.cu). A truncating split
    would write a step of (−1, 0, +1) as (0, 1 − f1, 1 − f0) and ask for
    a halo of nearly a plane."""
    dz = (o + s // 2) // s
    rem = o - dz * s
    dy = (rem + f0 // 2) // f0
    return dz, dy, rem - dy * f0


def up_halo(offsets, dims):
    """The halo that a box of the up leg needs around its inner rows for
    ``offsets`` on fine dims: (planes below, planes above, rows before,
    rows after). A neighbour lies ``dz`` planes and ``dy`` rows away (the
    nearest split), one row further where its x step leaves the grid row
    (dx < 0 at the row's start, dx > 0 at its end); rows are counted past
    the plane's end, so a neighbour whose row wraps into the next plane is
    inside too."""
    _, f1, f0 = (int(d) for d in dims)
    parts = [split_nearest(int(o), f1 * f0, f0) for o in offsets]
    return (max([0] + [-dz for dz, _, _ in parts]),
            max([0] + [dz for dz, _, _ in parts]),
            max([0] + [(dx < 0) - dy for _, dy, dx in parts]),
            max([0] + [dy + (dx > 0) for _, dy, dx in parts]))


class UpTile(NamedTuple):
    """The up leg's launch: a block of 1,024 threads on each tile of
    ``tz`` planes × ``ty`` rows × all f0. Box U (the tile with A's
    ``halo``) stages u', box T (U with M's ``mhalo``) T uc; ``smem`` bytes
    for both, ``nblocks`` tiles."""
    tz: int
    ty: int
    halo: tuple
    mhalo: tuple
    nblocks: int
    smem: int


def _extents(f):
    return sorted({c for c in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32) if c <= f}
                  | ({f} if f <= 32 else set()))


def up_boxes(tz, ty, halo, mhalo):
    """(U rows, T rows): the grid rows (of f0 points) of the two boxes a
    tile of ``tz`` planes × ``ty`` rows stages."""
    bz, by = tz + halo[0] + halo[1], ty + halo[2] + halo[3]
    return bz * by, (bz + mhalo[0] + mhalo[1]) * (by + mhalo[2] + mhalo[3])


def up_box(tz, ty, halo, mhalo, f0, itemsize=4):
    """Bytes of shared memory the two boxes of a tile take, each entry
    ``itemsize`` bytes (4 in float32, 2 in bfloat16)."""
    return sum(up_boxes(tz, ty, halo, mhalo)) * f0 * itemsize


@functools.lru_cache(maxsize=256)
def _up_tile(a_offsets, m_offsets, dims, itemsize=4):
    f2, f1, f0 = dims
    halo, mhalo = up_halo(a_offsets, dims), up_halo(m_offsets, dims)
    na, nm = len(a_offsets), len(m_offsets)
    best = None
    for tz in _extents(f2):
        for ty in _extents(f1):
            smem = up_box(tz, ty, halo, mhalo, f0, itemsize)
            if smem > MAX_BOX_BYTES:
                continue
            nblocks = -(-f2 // tz) * -(-f1 // ty)
            # the busiest SM's loads (a 1,024-thread block of 64
            # registers a thread holds an SM alone): uc at each T row, M
            # and u at each U row, A, f and w at each tile row
            rows_u, rows_t = up_boxes(tz, ty, halo, mhalo)
            work = -(-nblocks // _SMS) * (rows_t + rows_u * (nm + 1)
                                          + tz * ty * (na + 3))
            if best is None or (work, smem) < best[0]:
                best = ((work, smem), UpTile(tz, ty, halo, mhalo, nblocks,
                                             smem))
    return None if best is None else best[1]


def up_tile(a_offsets, m_offsets, dims, dtype=torch.float32):
    """The up leg's tile for A's and M's offsets (Python ints) on fine
    dims (f2, f1, f0) in ``dtype`` (its boxes' bytes), or None where not
    even one plane by one row fits the shared memory: of the tiles of
    1–32 planes and rows whose boxes fit, the one with the least loads on
    the busiest of 132 SMs. Computed once per (offsets, dims, dtype)."""
    return _up_tile(tuple(int(o) for o in a_offsets),
                    tuple(int(o) for o in m_offsets),
                    tuple(int(d) for d in dims), dtype.itemsize)


class DownTile(NamedTuple):
    """The down leg's launch: a block of 1,024 threads on each tile of
    ``tz`` planes × ``ty`` rows × all f0, both even, in clusters of ``cz``
    × ``cy`` tiles. Box R (the tile with Mᵀ's ``halo``) stages r = f − A
    u, each row formed by one block of the cluster: its tile's rows and
    the cluster's outer halo beside them; box U (the rows a block forms,
    with A's ``ahalo``) stages u or w ∘ f, and then t = r − Mᵀ r.
    ``smem`` bytes, ``nblocks`` blocks launched."""
    tz: int
    ty: int
    halo: tuple
    ahalo: tuple
    nblocks: int
    smem: int
    cz: int = 1
    cy: int = 1


def down_halo(a_offsets, mt_offsets, dims):
    """(box R's halo, box U's halo): Mᵀ's reach around the tile, A's
    around R, each as :func:`up_halo` sizes a box."""
    return up_halo(mt_offsets, dims), up_halo(a_offsets, dims)


def down_owned(tz, ty, halo, cz=1, cy=1):
    """(planes, rows) of box R that the busiest block of a cluster of cz
    × cy tiles forms: its tile and, at the cluster's edge, the halo beside
    it; all of R alone."""
    z_lo, z_hi, y_lo, y_hi = halo
    return (tz + (z_lo + z_hi if cz == 1 else max(z_lo, z_hi)),
            ty + (y_lo + y_hi if cy == 1 else max(y_lo, y_hi)))


def down_boxes(tz, ty, halo, ahalo, cz=1, cy=1):
    """(R rows, U rows): the grid rows of the two boxes a down tile of
    ``tz`` planes × ``ty`` rows stages (U at the busiest block of a
    cluster of cz × cy tiles)."""
    oz, oy = down_owned(tz, ty, halo, cz, cy)
    return ((tz + halo[0] + halo[1]) * (ty + halo[2] + halo[3]),
            (oz + ahalo[0] + ahalo[1]) * (oy + ahalo[2] + ahalo[3]))


def down_box(tz, ty, halo, ahalo, f0, cz=1, cy=1, itemsize=4):
    """Bytes of shared memory the two boxes of a down tile take (box U
    holds the tile's t after u), each entry ``itemsize`` bytes."""
    return sum(down_boxes(tz, ty, halo, ahalo, cz, cy)) * f0 * itemsize


def _even_extents(f):
    top = f + f % 2
    return sorted({c for c in (2, 4, 6, 8, 12, 16, 24, 32) if c <= top}
                  | ({top} if top <= 32 else set()))


@functools.lru_cache(maxsize=256)
def _down_tile(a_offsets, mt_offsets, dims, itemsize=4):
    f2, f1, f0 = dims
    halo, ahalo = down_halo(a_offsets, mt_offsets, dims)
    na, nm = len(a_offsets), len(mt_offsets)
    best = None
    for (cz, cy), tz, ty in itertools.product(_CLUSTERS, _even_extents(f2),
                                              _even_extents(f1)):
        smem = down_box(tz, ty, halo, ahalo, f0, cz, cy, itemsize)
        if smem > MAX_BOX_BYTES or (cz > 1 and tz >= f2) \
                or (cy > 1 and ty >= f1):
            continue
        nblocks = -(-f2 // (cz * tz)) * -(-f1 // (cy * ty)) * cz * cy
        # the busiest SM's loads: u at each U row, A and f at each row of
        # R the block forms, the rest of R from its cluster, Mᵀ at each
        # tile row and the tile's writes
        oz, oy = down_owned(tz, ty, halo, cz, cy)
        rows_r, rows_u = down_boxes(tz, ty, halo, ahalo, cz, cy)
        work = -(-nblocks // _SMS) * (rows_u + oz * oy * (na + 1)
                                      + rows_r - oz * oy
                                      + tz * ty * (nm + 1))
        if cz * cy > 1:
            work *= _CLUSTER_COST
        if best is None or (work, smem) < best[0]:
            best = ((work, smem), DownTile(tz, ty, halo, ahalo, nblocks,
                                           smem, cz, cy))
    return None if best is None else best[1]


def down_tile(a_offsets, mt_offsets, dims, dtype=torch.float32):
    """The down leg's tile for A's and Mᵀ's offsets (Python ints) on fine
    dims (f2, f1, f0) in ``dtype`` (its boxes' bytes), or None where not
    even two planes by two rows fit the shared memory: of the tiles of
    2–32 planes and rows (even) whose boxes fit, alone or in pairs, the
    one with the least loads on the busiest of 132 SMs. Computed once per
    (offsets, dims, dtype)."""
    return _down_tile(tuple(int(o) for o in a_offsets),
                      tuple(int(o) for o in mt_offsets),
                      tuple(int(d) for d in dims), dtype.itemsize)


def _check_dia(name, offsets, data, n, ref):
    if data.device != ref.device or data.dtype != ref.dtype \
            or data.dim() != 2 or data.shape[1] != n \
            or not data.is_contiguous():
        raise ValueError("%s data must be a contiguous (ndiag, %d) %s "
                         "tensor on %s, got %s %s on %s"
                         % (name, n, ref.dtype, ref.device,
                            tuple(data.shape), data.dtype, data.device))
    ndiag = data.shape[0]
    if not 0 < ndiag <= dk.MAX_DIAG:
        raise ValueError("%s has %d diagonals; the kernels take 1 to %d"
                         % (name, ndiag, dk.MAX_DIAG))
    if offsets.device != ref.device or offsets.dtype != torch.int32 \
            or offsets.shape != (ndiag,) or not offsets.is_contiguous():
        raise ValueError("%s offsets must be a contiguous (%d,) int32 "
                         "tensor on %s" % (name, ndiag, ref.device))


#: the C entries' dtype codes: float32, and bfloat16 in the base legs
_LEG_CODE = {torch.float32: 0, torch.bfloat16: dk.BF16_CODE}


def _check_leg(dims, ref, operators, vectors, ncols=None, framed=False):
    """Validate one leg's operands on the card (operators of ``ncols``
    columns, n by default); returns (n, nc)."""
    if ref.device.type != "cuda":
        raise ValueError("the fused V-cycle kernels run on CUDA tensors, "
                         "got %s" % ref.device)
    if ref.dtype != torch.float32 and (framed
                                       or ref.dtype != torch.bfloat16):
        raise ValueError(
            "the %s V-cycle kernels take float32%s, got %s"
            % ("framed" if framed else "fused",
               " (their bfloat16 mode is ROADMAP B.18)" if framed
               else " or bfloat16", ref.dtype))
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


def _launch_down(oa_host, om_host, oa, a_data, om, mt_data, f, u, dims,
                 H, L, zero_guess, tile, what):
    """Launch down_kernel on the checked operands over ``tile``
    (DownTile); returns rc, or ``(w ∘ f, rc)`` with ``zero_guess``."""
    if tile is None:
        raise ValueError("%s: no tile of the down leg on fine dims %s holds "
                         "the operators' reach in %d bytes of shared "
                         "memory" % (what, tuple(dims), MAX_BOX_BYTES))
    n = dims[0] * dims[1] * dims[2]
    c2, c1, c0 = coarse_dims(dims)
    rc = torch.empty(c2 * c1 * c0, dtype=f.dtype, device=f.device)
    u_out = torch.empty(n, dtype=f.dtype, device=f.device) \
        if zero_guess else None
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        rcode = cuda_lib.lib().amgcl_fused_down(
            _LEG_CODE[f.dtype], int(bool(zero_guess)), *dims, H, L, len(oa_host), len(om_host),
            dk.c_ints(oa_host), dk.c_ints(om_host), tile.tz, tile.ty, tile.cz,
            tile.cy, dk.c_ints(tile.halo + tile.ahalo), oa.data_ptr(),
            a_data.data_ptr(), om.data_ptr(), mt_data.data_ptr(),
            f.data_ptr(), u.data_ptr(),
            None if u_out is None else u_out.data_ptr(), rc.data_ptr(),
            stream)
    cuda_lib.check(rcode, what)
    return (u_out, rc) if zero_guess else rc


def fused_down_sweep(a_offsets, a_data, mt_offsets, mt_data, f, u, dims,
                     zero_guess=False):
    """The whole down leg in one pass: ``rc = Tᵀ (r − Mᵀ r)``, ``r = f −
    A u``, as a flat coarse vector. With ``zero_guess`` the ``u`` argument
    is the smoother scale w and the result is ``(w ∘ f, rc)``: pre-smooth
    from zero, residual and restriction in one kernel. Offsets are int32
    tensors or Python ints; the kernel needs them on the host to check
    its tile (``down_tile``), so a hot path passes them as ints."""
    if f.device.type == "cpu":
        return fused_down_sweep_plain(a_offsets, a_data, mt_offsets,
                                      mt_data, f, u, dims, zero_guess)
    oa_host, om_host = dk.host_offsets(a_offsets), dk.host_offsets(mt_offsets)
    oa, om = _on(a_offsets, f.device), _on(mt_offsets, f.device)
    n, _ = _check_leg(dims, f, [("A", oa, a_data), ("Mt", om, mt_data)],
                      [("f", f, None), ("w" if zero_guess else "u", u,
                                        None)])
    dims = tuple(int(d) for d in dims)
    out = _launch_down(oa_host, om_host, oa, a_data, om, mt_data, f, u,
                       dims, 0, n, zero_guess,
                       _down_tile(oa_host, om_host, dims,
                                  f.element_size()),
                       "fused_down_sweep")
    dk.count_launch(fused_down_sweep, f.dtype)
    return out


def _launch_up(oa_host, om_host, oa, a_data, om, m_data, w, f, u, uc, dims,
               zoff, fz, tile, what):
    """Launch up_kernel on the checked operands over ``tile`` (UpTile)."""
    if tile is None:
        raise ValueError("%s: no tile of the up leg on fine dims %s holds "
                         "the operators' reach in %d bytes of shared "
                         "memory" % (what, tuple(dims), MAX_BOX_BYTES))
    out = torch.empty(f.shape[0], dtype=f.dtype, device=f.device)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        rcode = cuda_lib.lib().amgcl_fused_up(
            _LEG_CODE[f.dtype], *dims, zoff, fz, len(oa_host), len(om_host), dk.c_ints(oa_host),
            dk.c_ints(om_host), tile.tz, tile.ty,
            dk.c_ints(tile.halo + tile.mhalo),
            oa.data_ptr(), a_data.data_ptr(), om.data_ptr(),
            m_data.data_ptr(), w.data_ptr(), f.data_ptr(), u.data_ptr(),
            uc.data_ptr(), out.data_ptr(), stream)
    cuda_lib.check(rcode, what)
    return out


def fused_up_sweep(a_offsets, a_data, m_offsets, m_data, w, f, u, uc, dims):
    """The whole up leg in one pass: prolongation, correction and the
    first post-smoothing sweep, ``u' + w ∘ (f − A u')`` with ``u' = u +
    T uc − M (T uc)``. Offsets are int32 tensors or Python ints; the
    kernel needs them on the host to check its tile (``up_tile``), so a
    hot path passes them as ints."""
    if f.device.type == "cpu":
        return fused_up_sweep_plain(a_offsets, a_data, m_offsets, m_data, w,
                                    f, u, uc, dims)
    oa_host, om_host = dk.host_offsets(a_offsets), dk.host_offsets(m_offsets)
    oa, om = _on(a_offsets, f.device), _on(m_offsets, f.device)
    c2, c1, c0 = coarse_dims(dims)
    n, _ = _check_leg(dims, f, [("A", oa, a_data), ("M", om, m_data)],
                      [("f", f, None), ("u", u, None), ("w", w, None),
                       ("uc", uc, c2 * c1 * c0)])
    dims = tuple(int(d) for d in dims)
    out = _launch_up(oa_host, om_host, oa, a_data, om, m_data, w, f, u, uc,
                     dims, 0, dims[0],
                     _up_tile(oa_host, om_host, dims, f.element_size()),
                     "fused_up_sweep")
    dk.count_launch(fused_up_sweep, f.dtype)
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
    oa_host, om_host = dk.host_offsets(a_offsets), dk.host_offsets(mt_offsets)
    oa = dk.offsets_on(oa_host, f.device)
    om = dk.offsets_on(om_host, f.device)
    _check_leg(dims, f, [("A", oa, a_frame), ("Mt", om, mt_frame)],
               [("f", f, L), ("w" if zero_guess else "u", u, L)], ncols=L,
               framed=True)
    out = _launch_down(oa_host, om_host, oa, a_frame, om, mt_frame, f, u,
                       dims, H, L, zero_guess,
                       _down_tile(oa_host, om_host, dims),
                       "fused_down_sweep_framed")
    fused_down_sweep_framed.launches += 1
    return out


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
    oa_host, om_host = dk.host_offsets(a_offsets), dk.host_offsets(m_offsets)
    oa = dk.offsets_on(oa_host, f.device)
    om = dk.offsets_on(om_host, f.device)
    _check_leg(dims, f, [("A", oa, a_data)],
               [("f", f, None), ("w", w, None), ("u", u, Lm),
                ("uc", uc, (c2 + 2 * hp) * c1 * c0)], framed=True)
    _check_dia("M", om, m_frame, Lm, f)
    out = _launch_up(oa_host, om_host, oa, a_data, om, m_frame, w, f, u, uc,
                     dims, 2 * hp, dims[0] + 4 * hp,
                     _up_tile(oa_host, om_host, dims),
                     "fused_up_sweep_framed")
    fused_up_sweep_framed.launches += 1
    return out


for _fn in (fused_down_sweep, fused_up_sweep, fused_down_sweep_framed,
            fused_up_sweep_framed):
    _fn.launches = 0
for _fn in (fused_down_sweep, fused_up_sweep):
    _fn.bf16_launches = 0
