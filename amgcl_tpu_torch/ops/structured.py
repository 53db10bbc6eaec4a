"""Structure detection and matrix-free transfer operators.

Counterpart of ``amgcl_tpu/ops/structured.py``:

1. **Grid detection** (:func:`detect_grid`): recognise a tensor-product
   stencil (index = z*d1*d0 + y*d0 + x, every nonzero offset decomposes
   as dx + d0*dy + d0*d1*dz with a small radius), so grid-aligned
   aggregation keeps every Galerkin coarse operator a stencil (DIA).
2. **Implicit smoothed-aggregation transfers**: P = (I − ω D⁻¹ A_f)·T
   (reference: amgcl/coarsening/smoothed_aggregation.hpp:202-243) is
   applied matrix-free as ``P x = u − M u`` with ``u = T x`` and
   ``M = ω D⁻¹ A_f`` a DIA matrix; for grid-aligned aggregates T is a
   reshape/expand/sum.
"""

from __future__ import annotations

import numpy as np
import torch

from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops.csr import CSR


# -- grid detection ---------------------------------------------------------

def _decompose_1d(offsets, stride, radius):
    """Split each offset o into (residue, quotient) with o = residue +
    stride*quotient and |residue| <= radius. Returns the quotient set or
    None if any offset has no valid decomposition."""
    quotients = set()
    for o in offsets:
        q0 = int(round(o / stride))
        ok = False
        for q in (q0 - 1, q0, q0 + 1):
            r = o - q * stride
            if abs(r) <= radius:
                quotients.add(q)
                ok = True
                break
        if not ok:
            return None
    return quotients


def detect_grid(offsets, n, max_radius=2, min_dim=3):
    """Infer tensor-product grid dims from a matrix's diagonal offsets.

    Returns ``(d2, d1, d0)`` with ``d2*d1*d0 == n`` and every offset
    decomposable as ``dx + d0*dy + d0*d1*dz`` (|dx|,|dy|,|dz| <= radius),
    or None. 2-D grids come back as (1, d1, d0), 1-D as (1, 1, n)."""
    offs = sorted(set(int(o) for o in offsets))
    if not offs or n < min_dim:
        return None
    pos = [o for o in offs if o > 0]
    for radius in range(1, max_radius + 1):
        if all(abs(o) <= radius for o in offs):
            return (1, 1, n)
        beyond = [o for o in pos if o > radius]
        if not beyond:
            continue
        # the smallest non-x offset is d0*1 + dx for some |dx| <= radius
        for dx in range(-radius, radius + 1):
            d0 = beyond[0] + dx
            if d0 <= radius or d0 < min_dim or n % d0:
                continue
            qs = _decompose_1d(offs, d0, radius)
            if qs is None:
                continue
            qs.discard(0)
            if all(abs(q) <= radius for q in qs):
                d1 = n // d0
                if d1 >= min_dim:
                    return (1, d1, d0)
                continue
            qpos = sorted(q for q in qs if q > radius)
            if not qpos:
                # one-sided z coupling: mirror to find the z stride
                qpos = sorted(-q for q in qs if q < -radius)
            found = None
            for dy in range(-radius, radius + 1):
                d1 = qpos[0] + dy
                if d1 <= radius or d1 < min_dim or n % (d0 * d1):
                    continue
                d2 = n // (d0 * d1)
                if d2 < min_dim:
                    continue
                zs = _decompose_1d(qs, d1, radius)
                if zs is None:
                    continue
                zs.discard(0)
                if all(abs(z) <= radius for z in zs):
                    found = (d2, d1, d0)
                    break
            if found:
                return found
    return None


def detect_grid_csr(A: CSR, max_radius=2):
    """Grid dims for a square CSR matrix via its distinct diagonal
    offsets; cached on the matrix."""
    if A.nrows != A.ncols:
        return None
    hint = getattr(A, "_grid_dims", None)
    if hint is not None and int(np.prod(hint)) == A.nrows:
        return tuple(hint)
    from amgcl_tpu_torch.ops.device import dia_offsets
    offs = dia_offsets(A)
    if len(offs) > (2 * max_radius + 1) ** 3:
        return None
    g = detect_grid(offs, A.nrows, max_radius)
    if g is not None:
        A._grid_dims = g
    return g


def _offset_axis(o, dims, radius=2):
    """Axis index (0=z, 1=y, 2=x) if offset o is purely along one grid
    axis, else None."""
    d2, d1, d0 = dims
    dz = int(round(o / (d0 * d1))) if d2 > 1 else 0
    dz = max(-radius, min(radius, dz))
    rem = o - dz * d0 * d1
    dy = int(round(rem / d0)) if d1 > 1 else 0
    dy = max(-radius, min(radius, dy))
    dx = rem - dy * d0
    if abs(dx) > radius:
        return None
    live = (dz != 0) + (dy != 0) + (dx != 0)
    if live != 1:
        return None
    return 0 if dz else (1 if dy else 2)


def strength_blocks(Af: CSR, dims, block=2, threshold=0.5):
    """Per-axis aggregation blocks from the strength-filtered matrix:
    aggregate along an axis only when most rows kept a strong neighbour
    in that direction (semicoarsening). Returns a per-axis block tuple,
    or None when no axis is strong (the caller falls back to MIS)."""
    rows = Af.expanded_rows()
    d = Af.col.astype(np.int64) - rows
    base = Af.nrows - 1
    counts = np.bincount(d + base, minlength=base + Af.ncols)
    offsets = np.flatnonzero(counts) - base
    axis_count = [0.0, 0.0, 0.0]
    for o in offsets:
        if o == 0:
            continue
        ax = _offset_axis(int(o), dims)
        if ax is not None:
            axis_count[ax] += counts[o + base]
    n = Af.nrows
    blocks = tuple(
        min(block, dims[k])
        if dims[k] > 1 and axis_count[k] >= threshold * n else 1
        for k in range(3))
    if all(b == 1 for b in blocks):
        return None
    return blocks


def grid_aggregates(dims, blocks):
    """Grid-aligned aggregation: fine point (z,y,x) joins aggregate
    (z//b2, y//b1, x//b0), ids in C-order on the coarse grid. Returns
    (agg ids (n,), n_agg, coarse_dims, blocks)."""
    dims = tuple(int(d) for d in dims)
    coarse = tuple(-(-d // b) for d, b in zip(dims, blocks))
    d2, d1, d0 = dims
    b2, b1, b0 = blocks
    c2, c1, c0 = coarse
    iz = (np.arange(d2) // b2).astype(np.int32)
    iy = (np.arange(d1) // b1).astype(np.int32)
    ix = (np.arange(d0) // b0).astype(np.int32)
    agg = (iz[:, None, None] * (c1 * c0) + iy[None, :, None] * c0
           + ix[None, None, :]).ravel()
    return agg, c2 * c1 * c0, coarse, blocks


# -- device-side implicit transfer operators --------------------------------

class GridTentative:
    """Piecewise-constant tentative prolongation over grid-aligned blocks:
    ``mv`` prolongs (coarse -> fine) as a reshape/expand, ``rmv``
    restricts (fine -> coarse, the exact transpose) as a pad/reshape/sum
    (reference: amgcl/coarsening/tentative_prolongation.hpp:150-163)."""

    def __init__(self, fine, block, coarse):
        self.fine = tuple(int(d) for d in fine)
        self.block = tuple(int(b) for b in block)
        self.coarse = tuple(int(c) for c in coarse)
        self.shape = (int(np.prod(self.fine)), int(np.prod(self.coarse)))

    def mv(self, x):
        (f2, f1, f0), (b2, b1, b0), (c2, c1, c0) = \
            self.fine, self.block, self.coarse
        u = x.reshape(c2, 1, c1, 1, c0, 1).expand(c2, b2, c1, b1, c0, b0)
        u = u.reshape(c2 * b2, c1 * b1, c0 * b0)
        return u[:f2, :f1, :f0].reshape(-1)

    def rmv(self, y):
        (f2, f1, f0), (b2, b1, b0), (c2, c1, c0) = \
            self.fine, self.block, self.coarse
        yp = torch.nn.functional.pad(
            y.reshape(1, f2, f1, f0),
            (0, c0 * b0 - f0, 0, c1 * b1 - f1, 0, c2 * b2 - f2))
        yp = yp.reshape(c2, b2, c1, b1, c0, b0)
        return yp.sum(dim=(1, 3, 5)).reshape(-1)

    def bytes(self):
        return 0


class AggTentative:
    """Tentative prolongation over arbitrary (MIS) aggregates. ``mv`` is
    one gather of the fine-point aggregate ids; ``rmv`` permutes entries
    into aggregate order and takes each segment's sum as the difference
    of a float64 inclusive scan at the segment bounds — deterministic,
    unlike an atomic scatter-add, with error ~eps64 · the global prefix."""

    def __init__(self, agg, perm, bounds, shape):
        self.agg = agg          # (nf,) int64 aggregate id, -1 = excluded
        self.perm = perm        # (nk,) fine indices sorted by aggregate
        self.bounds = bounds    # (nc+1,) segment boundaries into perm
        self.shape = (int(shape[0]), int(shape[1]))

    @classmethod
    def build(cls, agg: np.ndarray, n_agg: int, device):
        agg = np.asarray(agg, dtype=np.int64)
        keep = np.flatnonzero(agg >= 0)
        perm = keep[np.argsort(agg[keep], kind="stable")]
        counts = np.bincount(agg[keep], minlength=n_agg)
        bounds = np.concatenate([[0], np.cumsum(counts)])
        t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        return cls(t(agg), t(perm), t(bounds), (len(agg), n_agg))

    def mv(self, x):
        u = x[self.agg.clamp(min=0)]
        return torch.where(self.agg >= 0, u, torch.zeros_like(u))

    def rmv(self, y):
        c = torch.cumsum(y[self.perm].to(torch.float64), 0)
        c = torch.cat([c.new_zeros(1), c])
        return (c[self.bounds[1:]] - c[self.bounds[:-1]]).to(y.dtype)

    def bytes(self):
        return sum(t.numel() * t.element_size()
                   for t in (self.agg, self.perm, self.bounds))


class ImplicitSmoothedP:
    """P = (I − M) T applied matrix-free; M = ω D⁻¹ A_f on the device."""

    def __init__(self, T, M):
        self.T = T
        self.M = M
        self.shape = (T.shape[0], T.shape[1])

    def mv(self, x):
        u = self.T.mv(x)
        # u − M u is residual-shaped: one fused kernel pass
        return dev.residual(u, self.M, u)

    def bytes(self):
        return self.T.bytes() + self.M.bytes()


class ImplicitSmoothedR:
    """R = Pᵀ = Tᵀ (I − Mᵀ); Mt is M's transpose packed for the device."""

    def __init__(self, T, Mt):
        self.T = T
        self.Mt = Mt
        self.shape = (T.shape[1], T.shape[0])

    def mv(self, y):
        return self.T.rmv(dev.residual(y, self.Mt, y))

    def bytes(self):
        return self.T.bytes() + self.Mt.bytes()


def build_implicit_transfers(spec, dtype, device):
    """Realise a coarsening's implicit-transfer spec on the device.

    spec keys: 'M' (host CSR or HostDia, = ω D⁻¹ A_f); either
    'fine'/'block'/'coarse' grid dims (grid-aligned aggregates) or
    'agg'/'n_agg' (MIS aggregates). Returns (P_dev, R_dev)."""
    if "fine" in spec:
        T = GridTentative(spec["fine"], spec["block"], spec["coarse"])
    else:
        T = AggTentative.build(spec["agg"], spec["n_agg"], device)
    M = dev.to_device(spec["M"], "auto", dtype, device)
    Mt = dev.to_device(spec["M"].transpose(), "auto", dtype, device)
    return ImplicitSmoothedP(T, M), ImplicitSmoothedR(T, Mt)
