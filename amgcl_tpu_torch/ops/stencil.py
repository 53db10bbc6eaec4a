"""Stencil (host-DIA) setup algebra for structured grids.

Counterpart of the host parts of ``amgcl_tpu/ops/stencil.py``. The
smoothed-aggregation setup (reference:
amgcl/coarsening/smoothed_aggregation.hpp:55-243, Galerkin product at
amgcl/coarsening/detail/galerkin.hpp:53) is re-expressed as vectorized
operations on diagonal data vectors:

- the strength filter, row scaling, and Gershgorin bound are elementwise
  per diagonal;
- the matrix products inside Ac = Tᵀ(I − Mᵀ)A(I − M)T reduce to shifted
  elementwise multiply-adds between diagonal pairs (offsets add);
- the tentative-operator collapse Tᵀ·T is a parity-sliced reshape-sum
  onto the coarse grid.

Diagonal offsets are tracked as 3-D grid tuples, so product offsets
combine exactly. Scalar real dtypes only; the numerics run in numpy and
the native set-up library, and the Galerkin plan's numeric pass also in
torch on the build's set-up device.
"""

from __future__ import annotations

import collections

import numpy as np

from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.telemetry.tracing import setup_substage

#: numeric passes of :class:`StencilGalerkinPlan` by route ("host",
#: "device") since the process started
calls = collections.Counter()


def _flat(off3, dims):
    d2, d1, d0 = dims
    return off3[0] * d1 * d0 + off3[1] * d0 + off3[2]


def _shift(v: np.ndarray, s: int) -> np.ndarray:
    """out[i] = v[i + s], zero-filled beyond the ends."""
    if s == 0:
        return v
    out = np.zeros_like(v)
    if s > 0:
        out[:len(v) - s] = v[s:]
    else:
        out[-s:] = v[:len(v) + s]
    return out


def _shift_into(v: np.ndarray, s: int, out: np.ndarray) -> np.ndarray:
    """out[i] = v[i + s] into a preallocated buffer (the setup hot loops
    reuse workspaces: fresh large temporaries pay first-touch page
    faults on every pass)."""
    n = len(v)
    if s == 0:
        out[:] = v
    elif s > 0:
        out[:n - s] = v[s:]
        out[n - s:] = 0
    else:
        out[-s:] = v[:n + s]
        out[:-s] = 0
    return out


class HostDia:
    """Host diagonal-storage matrix over a tensor-product grid.

    ``offsets3`` is a list of (dz, dy, dx) tuples; ``data[k, i]`` holds
    ``A[i, i + flat(offsets3[k])]`` in C-order flat indexing (zero where
    the stencil leaves the grid or the entry is absent).
    """

    def __init__(self, offsets3, data, dims):
        self.offsets3 = [tuple(int(c) for c in o) for o in offsets3]
        self.data = data                      # (ndiag, n) float array
        self.dims = tuple(int(d) for d in dims)
        n = int(np.prod(self.dims))
        self.shape = (n, n)

    @property
    def nrows(self):
        return self.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    def flat_offsets(self):
        return [_flat(o, self.dims) for o in self.offsets3]

    def diagonal(self) -> np.ndarray:
        z = (0, 0, 0)
        if z in self.offsets3:
            return self.data[self.offsets3.index(z)]
        return np.zeros(self.nrows, dtype=self.dtype)

    def transpose(self) -> "HostDia":
        """Aᵀ[i, i+o] = A[i+o, i]: negate offsets, shift the diagonals."""
        offs = [tuple(-c for c in o) for o in self.offsets3]
        data = np.stack([_shift(self.data[k], _flat(offs[k], self.dims))
                         for k in range(len(offs))])
        return HostDia(offs, data, self.dims)

    def drop_empty(self) -> "HostDia":
        keep = [k for k in range(len(self.offsets3))
                if np.any(self.data[k])]
        if len(keep) == len(self.offsets3):
            return self
        return HostDia([self.offsets3[k] for k in keep],
                       self.data[keep], self.dims)

    def to_csr(self) -> CSR:
        """Explicit CSR (boundary slots and absent entries dropped),
        carrying the grid dims and the prepacked DIA data so the device
        conversion is a pure transfer."""
        n = self.nrows
        flat0 = self.flat_offsets()
        # physically distinct 3-D couplings can share a flat diagonal on
        # small grids (e.g. (0,1,-2) vs (0,0,2) when d0 = 4): they are the
        # same matrix diagonal with disjoint row support — merge by sum
        uniq = {}
        for k, f in enumerate(flat0):
            if f in uniq:
                uniq[f] = uniq[f] + self.data[k]
            else:
                uniq[f] = self.data[k]
        flats = sorted(uniq)
        mdata = np.stack([uniq[f] for f in flats])
        # row-major CSR assembly: the layout is row-aligned and the
        # offsets sorted, so a (rows, ndiag) transpose + boolean compress
        # yields sorted-column CSR in one vectorized pass
        offs = np.asarray(flats, dtype=np.int64)
        cols2 = offs[None, :] + np.arange(n, dtype=np.int64)[:, None]
        vals2 = mdata.T
        valid = (cols2 >= 0) & (cols2 < n) & (vals2 != 0)
        ptr = np.concatenate(
            [[0], np.cumsum(valid.sum(axis=1))]).astype(np.int64)
        A = CSR(ptr, cols2[valid].astype(np.int32), vals2[valid], n)
        A._grid_dims = self.dims
        A._dia_prepacked = (flats, mdata)
        A._dia_offsets_cache = np.asarray(flats)
        A._host_dia = self           # next level's setup skips the repack
        A._host_dia_fp = _val_fingerprint(A)
        return A


def host_dia_from_csr(A: CSR, dims, dtype=None) -> HostDia:
    """Pack a grid-structured scalar CSR into HostDia (optionally casting
    to ``dtype``, fused into the native scatter where the library takes
    the pair of dtypes). Returns None when an offset does not decompose
    onto the grid (caller falls back)."""
    dt = np.dtype(dtype) if dtype is not None else np.dtype(A.val.dtype)
    fp = _val_fingerprint(A)
    cached = getattr(A, "_host_dia", None)
    if (cached is not None and cached.dims == tuple(int(d) for d in dims)
            and cached.dtype == dt
            and getattr(A, "_host_dia_fp", None) == fp):
        return cached
    from amgcl_tpu_torch.ops.device import dia_offsets
    flat = dia_offsets(A)
    offs3 = _decompose_offsets(flat, dims)
    if offs3 is None:
        return None
    from amgcl_tpu_torch.native import native_dia_pack
    data = native_dia_pack(A, flat, dt)
    if data is None:
        data = _numpy_dia_pack(A, flat).astype(dt, copy=False)
    H = HostDia([offs3[int(o)] for o in flat], data, dims)
    A._host_dia = H
    A._host_dia_fp = fp
    return H


def _val_fingerprint(A: CSR):
    """Content fingerprint of A.val, so a cached DIA packing is dropped
    when a caller mutates values in place: full-array sums touch every
    element, and a strided sample hash guards the exact
    sum-and-magnitude-preserving edits."""
    v = A.val
    sample = v[:: max(1, v.shape[0] // 1024)]
    return (v.shape[0], float(v.sum(dtype=np.float64)),
            float(np.abs(v).sum(dtype=np.float64)),
            hash(np.ascontiguousarray(sample).tobytes()))


def _numpy_dia_pack(A: CSR, flat) -> np.ndarray:
    rows = A.expanded_rows()
    d = A.col.astype(np.int64) - rows
    slot_lut = np.full(int(flat[-1]) - int(flat[0]) + 1, -1, dtype=np.int64)
    slot_lut[np.asarray(flat) - int(flat[0])] = np.arange(len(flat))
    slots = slot_lut[d - int(flat[0])]
    data = np.zeros((len(flat), A.nrows), dtype=A.val.dtype)
    data[slots, rows] = A.val
    return data


def _decompose_offsets(flat, dims, radius=4):
    """Exact (dz, dy, dx) per flat offset with each |component| ≤ radius,
    or None when a decomposition is missing or ambiguous."""
    d2, d1, d0 = dims
    out = {}
    for o in flat:
        o = int(o)
        dz = int(np.round(o / (d1 * d0))) if d2 > 1 else 0
        best = None
        # degenerate grid axes admit only a zero component
        z_cands = (dz - 1, dz, dz + 1) if d2 > 1 else (0,)
        for z in z_cands:
            rem_z = o - z * d1 * d0
            dy = int(np.round(rem_z / d0)) if d1 > 1 else 0
            y_cands = (dy - 1, dy, dy + 1) if d1 > 1 else (0,)
            for y in y_cands:
                dx = rem_z - y * d0
                if (abs(dx) <= radius and abs(y) <= radius
                        and abs(z) <= radius):
                    cand = (z, y, dx)
                    if best is not None and cand != best:
                        return None          # ambiguous decomposition
                    best = cand
        if best is None:
            return None
        out[o] = best
    return out


# -- setup-phase elementwise passes -----------------------------------------

def filtered_dia(A: HostDia, eps_strong: float):
    """(Af, Dinv): strength-filtered matrix and inverted filtered diagonal.

    Weak off-diagonal entries (|a_ij|² ≤ ε²|a_ii a_jj|) are removed and
    lumped onto the diagonal (reference:
    amgcl/coarsening/plain_aggregates.hpp:113-140 for the strength test;
    smoothed_aggregation.hpp:157-199 for the lumping)."""
    dims = A.dims
    dia = np.abs(A.diagonal())
    eps2 = eps_strong * eps_strong
    n = A.nrows
    out = np.empty_like(A.data)
    lump = np.zeros(n, dtype=A.dtype)
    main_k = None
    for k, o in enumerate(A.offsets3):
        if o == (0, 0, 0):
            main_k = k
            out[k] = A.data[k]
            continue
        a = A.data[k]
        dj = _shift(dia, _flat(o, dims))
        strong = (a * a) > (eps2 * dia * dj)
        out[k] = np.where(strong, a, 0)
        lump += np.where(strong, 0, a)
    if main_k is None:
        main = lump.copy()
    else:
        main = out[main_k] + lump
        out[main_k] = main
    Af = HostDia(list(A.offsets3), out, dims)
    if main_k is None:
        Af.offsets3.append((0, 0, 0))
        Af.data = np.concatenate([Af.data, main[None]], axis=0)
    Dinv = np.where(main != 0, 1.0 / np.where(main != 0, main, 1), 1.0)
    return Af, Dinv


def gershgorin_scaled(Af: HostDia, Dinv: np.ndarray) -> float:
    """Gershgorin bound on ρ(D⁻¹ Af): max_i |1/d_i| Σ_j |a_ij|
    (reference: amgcl/backend/builtin.hpp:775-820)."""
    s = np.abs(Af.data).sum(axis=0)
    return float(np.max(np.abs(Dinv) * s))


def strength_axes(Af: HostDia, threshold: float = 0.5, block: int = 2):
    """Per-axis aggregation blocks from the filtered stencil — the DIA
    equivalent of ops/structured.strength_blocks (semicoarsening under
    anisotropy). Returns the per-axis block tuple or None."""
    dims = Af.dims
    axis_count = [0.0, 0.0, 0.0]
    for k, o in enumerate(Af.offsets3):
        live = [i for i, c in enumerate(o) if c != 0]
        if len(live) != 1:
            continue
        axis_count[live[0]] += int(np.count_nonzero(Af.data[k]))
    n = Af.nrows
    blocks = tuple(
        min(block, dims[i])
        if dims[i] > 1 and axis_count[i] >= threshold * n else 1
        for i in range(3))
    if all(b == 1 for b in blocks):
        return None
    return blocks


def scale_rows(A: HostDia, s: np.ndarray) -> HostDia:
    return HostDia(list(A.offsets3), A.data * s[None, :], A.dims)


# -- the Galerkin product ---------------------------------------------------

def _osum(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _odiff(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


class StencilGalerkinPlan:
    """Static plan for the diagonal-space Galerkin product
    ``Ac = Tᵀ (I − Mᵀ) A (I − M) T`` (``m_offs3=None``: the plain
    aggregation collapse ``Tᵀ A T``).

    Everything value-independent — the pair multiply lists for
    X = A − A·M and S = X − Mᵀ·X, the Mᵀ shift table, and the parity→
    coarse-diagonal collapse keys — is computed once from the stencil
    offsets and cached on the transfer spec. The numeric pass runs on
    the host (the native batched multiply-add, else numpy) or, given a
    device, in torch there (the JAX package's jitted device route,
    amgcl_tpu/ops/stencil.py:523-600), in the same order of operations
    either way."""

    def __init__(self, a_offs3, m_offs3, dims, blocks, coarse_dims, dtype):
        self.a_offs = [tuple(int(c) for c in o) for o in a_offs3]
        self.m_offs = None if m_offs3 is None else \
            [tuple(int(c) for c in o) for o in m_offs3]
        self.dims = tuple(int(d) for d in dims)
        self.blocks = tuple(int(b) for b in blocks)
        self.coarse = tuple(int(c) for c in coarse_dims)
        self.dtype = np.dtype(dtype)
        self.n = int(np.prod(self.dims))
        dims_ = self.dims
        if self.m_offs is None:
            # plain aggregation (P = T): S is A itself
            self.s_offs = list(self.a_offs)
        else:
            self._pair_lists(dims_)
        # collapse keys: every (s_offset, parity) maps to one coarse
        # diagonal — the static output pattern of the product
        b2, b1, b0 = self.blocks
        c2, c1, c0 = self.coarse
        self.dims_p = (c2 * b2, c1 * b1, c0 * b0)
        co_slot = {}
        keys = []
        for oc in self.s_offs:
            oz, oy, ox = oc
            for pz in range(b2):
                for py in range(b1):
                    for px in range(b0):
                        co = ((pz + oz) // b2, (py + oy) // b1,
                              (px + ox) // b0)
                        if co not in co_slot:
                            co_slot[co] = len(co_slot)
                        keys.append(co_slot[co])
        order = sorted(co_slot, key=lambda o: _flat(o, self.coarse))
        remap = {co_slot[o]: k for k, o in enumerate(order)}
        self.coarse_offs = order
        self.collapse_keys = np.asarray([remap[k] for k in keys],
                                        dtype=np.int64).reshape(
            len(self.s_offs), b2 * b1 * b0)

    def _pair_lists(self, dims_):
        """The pair multiply lists of X = A − A·M and S = X − Mᵀ·X."""
        a_idx = {o: k for k, o in enumerate(self.a_offs)}
        m_idx = {o: k for k, o in enumerate(self.m_offs)}
        self.x_offs = sorted(
            set(self.a_offs) | {_osum(oa, ob) for oa in self.a_offs
                                for ob in self.m_offs},
            key=lambda o: _flat(o, dims_))
        x_idx = {o: k for k, o in enumerate(self.x_offs)}
        self.x_base = [a_idx.get(o) for o in self.x_offs]
        pa, pb, ps, po = [], [], [], []
        for kx, oc in enumerate(self.x_offs):
            for oa in self.a_offs:
                kb = m_idx.get(_odiff(oc, oa))
                if kb is None:
                    continue
                pa.append(a_idx[oa])
                pb.append(kb)
                ps.append(_flat(oa, dims_))
                po.append(kx)
        self.pairs_x = (pa, pb, ps, po)
        self.mt_offs = [(-o[0], -o[1], -o[2]) for o in self.m_offs]
        self.mt_shifts = [_flat(ot, dims_) for ot in self.mt_offs]
        self.s_offs = sorted(
            set(self.x_offs) | {_osum(omt, ox) for omt in self.mt_offs
                                for ox in self.x_offs},
            key=lambda o: _flat(o, dims_))
        self.s_base = [x_idx.get(o) for o in self.s_offs]
        pa, pb, ps, po = [], [], [], []
        for ks, oc in enumerate(self.s_offs):
            for kmt, omt in enumerate(self.mt_offs):
                kx = x_idx.get(_odiff(oc, omt))
                if kx is None:
                    continue
                pa.append(kmt)
                pb.append(kx)
                ps.append(self.mt_shifts[kmt])
                po.append(ks)
        self.pairs_s = (pa, pb, ps, po)

    def _s_diagonals(self, a_data, m_data):
        """The fine-grid sandwich S = (I − Mᵀ)A(I − M) as (nS, n) rows."""
        n, dt = self.n, self.dtype
        if self.m_offs is None:
            return a_data
        from amgcl_tpu_torch.native import native_dia_fnma_batch
        scratch = np.empty(n, dtype=dt)

        def apply_pairs(abase, bbase, pairs, obase):
            """obase[o] -= abase[a] * shift(bbase[b], s) per pair: one
            native call for all of them, else numpy pair by pair (the
            same operations in the same order)."""
            if not pairs[0] or native_dia_fnma_batch(
                    abase, pairs[0], bbase, pairs[1], pairs[2], obase,
                    pairs[3]):
                return
            for a, b, s, o in zip(*pairs):
                _shift_into(bbase[b], s, scratch)
                np.multiply(abase[a], scratch, out=scratch)
                out = obase[o]
                np.subtract(out, scratch, out=out)

        X = np.empty((len(self.x_offs), n), dtype=dt)
        Mt = np.empty((len(self.mt_shifts), n), dtype=dt)
        S = np.empty((len(self.s_offs), n), dtype=dt)
        for kx, ka in enumerate(self.x_base):
            X[kx] = a_data[ka] if ka is not None else 0
        apply_pairs(a_data, m_data, self.pairs_x, X)
        for k, s in enumerate(self.mt_shifts):
            _shift_into(m_data[k], s, Mt[k])
        for ks, kx in enumerate(self.s_base):
            S[ks] = X[kx] if kx is not None else 0
        apply_pairs(Mt, X, self.pairs_s, S)
        return S

    def _collapse(self, S) -> HostDia:
        b2, b1, b0 = self.blocks
        # accumulate into (ndiagC, c2, c1, c0) so each parity slice adds
        # as a strided view
        out = np.zeros((len(self.coarse_offs),) + self.coarse,
                       dtype=self.dtype)
        f2, f1, f0 = self.dims
        buf = np.zeros(self.dims_p, dtype=self.dtype) \
            if self.dims_p != self.dims else None
        for ks in range(len(self.s_offs)):
            v3 = S[ks].reshape(self.dims)
            if buf is not None:
                buf[:f2, :f1, :f0] = v3
                v3 = buf
            p = 0
            for pz in range(b2):
                for py in range(b1):
                    for px in range(b0):
                        out[self.collapse_keys[ks, p]] += \
                            v3[pz::b2, py::b1, px::b0]
                        p += 1
        return HostDia(self.coarse_offs,
                       out.reshape(len(self.coarse_offs), -1),
                       self.coarse)

    def _s_device(self, a, m):
        """S = (I − Mᵀ)A(I − M) as (nS, n) rows of a tensor on a's
        device: the host pass's pairs in its order, each product rounded
        before its subtraction as on the host (``stencil_device.
        _fnma_scan``'s ``addcmul_`` may fuse the two), so that the two
        routes agree bit for bit."""
        import torch
        from amgcl_tpu_torch.ops.stencil_device import _shift
        if self.m_offs is None:
            return a
        n = self.n

        def fnma(out, src, dst, pairs):
            for ka, kb, s, ko in zip(*pairs):
                lo, hi = max(0, -s), min(n, n - s)
                if hi > lo:
                    out[ko, lo:hi] -= src[ka, lo:hi] * dst[kb, lo + s:hi + s]
            return out

        def embed(src, base, rows):
            out = torch.zeros((rows, self.n), dtype=a.dtype, device=a.device)
            keep = [(k, j) for k, j in enumerate(base) if j is not None]
            if keep:
                out[[k for k, _ in keep]] = src[[j for _, j in keep]]
            return out

        X = fnma(embed(a, self.x_base, len(self.x_offs)), a, m,
                 self.pairs_x)
        Mt = torch.stack([_shift(m[k], s)
                          for k, s in enumerate(self.mt_shifts)])
        return fnma(embed(X, self.s_base, len(self.s_offs)), Mt, X,
                    self.pairs_s)

    def _collapse_device(self, S) -> np.ndarray:
        """The parity collapse of S's rows into the coarse diagonals, on
        S's device; the (ndiagC, nc) result fetched to the host."""
        import torch
        b2, b1, b0 = self.blocks
        c2, c1, c0 = self.coarse
        f2, f1, f0 = self.dims
        p2, p1, p0 = self.dims_p
        out = torch.zeros((len(self.coarse_offs), c2, c1, c0),
                          dtype=S.dtype, device=S.device)
        for ks in range(len(self.s_offs)):
            v3 = S[ks].reshape(self.dims)
            if self.dims_p != self.dims:
                v3 = torch.nn.functional.pad(
                    v3, (0, p0 - f0, 0, p1 - f1, 0, p2 - f2))
            v6 = v3.reshape(c2, b2, c1, b1, c0, b0)
            p = 0
            for pz in range(b2):
                for py in range(b1):
                    for px in range(b0):
                        out[self.collapse_keys[ks, p]] += \
                            v6[:, pz, :, py, :, px]
                        p += 1
        return out.reshape(len(self.coarse_offs), -1).cpu().numpy()

    def apply(self, a_data, m_data, device=None) -> HostDia:
        """Numeric Galerkin product; returns the full (pre-drop_empty)
        coarse HostDia in the plan's static diagonal order. ``device``
        None runs it on the host; a torch device runs it there and
        fetches the result. ``calls`` counts each route."""
        a = np.asarray(a_data, dtype=self.dtype)
        m = None if m_data is None else np.asarray(m_data, dtype=self.dtype)
        with setup_substage("stencil_galerkin"):
            if device is None:
                calls["host"] += 1
                return self._collapse(self._s_diagonals(a, m))
            import torch
            calls["device"] += 1
            t = lambda v: torch.as_tensor(v, device=device)
            data = self._collapse_device(
                self._s_device(t(a), None if m is None else t(m)))
            return HostDia(self.coarse_offs, data, self.coarse)


# -- transfer-operator proxies ----------------------------------------------

class StencilTransfer:
    """Host-side handle for grid-implicit transfer operators: stands in
    for the explicit CSR P/R in the hierarchy's host levels. The device
    realization reads ``_implicit_spec``
    (ops/structured.build_implicit_transfers) and the coarse operator is
    computed by :func:`stencil_coarse_operator` — an explicit sparse P is
    never formed."""

    def __init__(self, spec, shape):
        self._implicit_spec = spec
        self.shape = (int(shape[0]), int(shape[1]))

    @property
    def nrows(self):
        return self.shape[0]

    @property
    def ncols(self):
        return self.shape[1]

    def __repr__(self):
        return "StencilTransfer(%dx%d)" % self.shape


def stencil_transfer_operators(A: CSR, grid, eps_strong, relax_omega,
                               power_iters=0, setup_dtype=None):
    """The whole smoothed-aggregation transfer construction on diagonals.

    Returns (P, R) StencilTransfer proxies, or None when the
    matrix/strength structure falls off the stencil path (caller uses the
    generic CSR route). ``setup_dtype`` optionally runs the setup algebra
    in a narrower dtype (float32 when the device hierarchy is float32);
    ``power_iters`` > 0 estimates ρ(D⁻¹ A_f) by power iteration instead of
    the Gershgorin bound."""
    if np.iscomplexobj(A.val):
        return None
    Ad = host_dia_from_csr(A, grid, setup_dtype)
    if Ad is None:
        return None
    if len(Ad.offsets3) > 13:
        # diagonal-pair Galerkin costs O(n·ndiag²) on dense intermediate
        # diagonals; past ~13 diagonals (radius-1 cross stencils) the
        # SpGEMM route exploits transfer sparsity better
        return None
    Af, Dinv = filtered_dia(Ad, eps_strong)
    blocks = strength_axes(Af)
    if blocks is None:
        return None                    # no strong axis: MIS fallback
    coarse = tuple(-(-d // b) for d, b in zip(grid, blocks))
    if power_iters and power_iters > 0:
        from amgcl_tpu_torch.ops.csr import spectral_radius
        rho = spectral_radius(Af.to_csr(), power_iters, scale=True)
    else:
        rho = gershgorin_scaled(Af, Dinv)
    omega = relax_omega * (4.0 / 3.0) / max(rho, 1e-30)
    M = scale_rows(Af, Dinv)
    M.data = M.data * omega
    M = M.drop_empty()
    nc = int(np.prod(coarse))
    spec = {"M": M, "fine": grid, "block": blocks, "coarse": coarse}
    P = StencilTransfer(spec, (A.nrows, nc))
    R = StencilTransfer(spec, (nc, A.nrows))
    return P, R


def stencil_plain_transfer_operators(A: CSR, grid, eps_strong,
                                     setup_dtype=None):
    """Plain aggregation's transfers on the grid, P = T (reference:
    amgcl/coarsening/aggregation.hpp:71-160): (P, R) proxies with no M,
    or None (the caller takes the aggregate route)."""
    if np.iscomplexobj(A.val):
        return None
    Ad = host_dia_from_csr(A, grid, setup_dtype)
    if Ad is None or len(Ad.offsets3) > 13:
        return None
    Af, _ = filtered_dia(Ad, eps_strong)
    blocks = strength_axes(Af)
    if blocks is None:
        return None
    coarse = tuple(-(-d // b) for d, b in zip(grid, blocks))
    nc = int(np.prod(coarse))
    spec = {"M": None, "dtype": Ad.dtype, "fine": grid, "block": blocks,
            "coarse": coarse}
    return (StencilTransfer(spec, (A.nrows, nc)),
            StencilTransfer(spec, (nc, A.nrows)))


def stencil_coarse_operator(A: CSR, P: StencilTransfer, scale=None,
                            device=None) -> CSR:
    """Galerkin product for the stencil path; the result CSR carries its
    grid dims and prepacked DIA data for a transfer-only device move.
    ``spec["M"] is None`` is plain aggregation (P = T): the product is
    the parity collapse of A itself. ``scale`` multiplies the product
    (plain aggregation's over-interpolation correction). ``device``, the
    build's set-up device (None: the host), runs the plan's numeric pass
    there.
    The pair/collapse plan and the coarse DIA→CSR index map cache on the
    transfer spec, so a second product through the same transfer pays
    only the numeric passes."""
    spec = P._implicit_spec
    M = spec["M"]
    Ad = host_dia_from_csr(A, spec["fine"],
                           M.dtype if M is not None else spec["dtype"])
    if Ad is None:
        raise ValueError("matrix does not match the transfer grid")
    plan = spec.get("_gplan")
    if plan is None or plan.a_offs != Ad.offsets3 \
            or plan.dtype != Ad.dtype:
        plan = StencilGalerkinPlan(
            Ad.offsets3, None if M is None else M.offsets3, Ad.dims,
            spec["block"], spec["coarse"], Ad.dtype)
        spec["_gplan"] = plan
        spec.pop("_csr_cache", None)
    Ac = plan.apply(Ad.data, None if M is None else M.data, device)
    if scale is not None and scale != 1.0:
        Ac = HostDia(Ac.offsets3, Ac.data * Ac.dtype.type(scale), Ac.dims)
    cache = spec.get("_csr_cache")
    if cache is not None:
        got = _csr_from_dia_cache(Ac, cache)
        if got is not None:
            return got
        # value pattern drifted (an entry exactly 0.0 at the first build
        # turned nonzero): rebuild the map from the new values
        spec.pop("_csr_cache", None)
    kept = [k for k in range(len(Ac.offsets3)) if np.any(Ac.data[k])]
    Acd = HostDia([Ac.offsets3[k] for k in kept], Ac.data[kept], Ac.dims)
    out = Acd.to_csr()
    spec["_csr_cache"] = _build_dia_csr_cache(kept, Acd, out)
    return out


def _build_dia_csr_cache(kept, Acd: HostDia, out: CSR) -> dict:
    """Index map from the plan's static coarse-diagonal output to the CSR
    the first product produced: later products skip the DIA→CSR
    assembly (values land by one fancy-index gather)."""
    flats = np.asarray(out._dia_prepacked[0], dtype=np.int64)
    members = [[] for _ in flats]
    for k, o in enumerate(Acd.offsets3):
        members[int(np.searchsorted(flats, _flat(o, Acd.dims)))].append(k)
    rows = out.expanded_rows()
    d = out.col.astype(np.int64) - rows
    return {"kept": np.asarray(kept, dtype=np.int64),
            "offs3": list(Acd.offsets3), "flats": flats,
            "members": members, "ptr": out.ptr, "col": out.col,
            "k_idx": np.searchsorted(flats, d), "i_idx": rows,
            "coarse": Acd.dims}


def _csr_from_dia_cache(Ac_full: HostDia, cache: dict):
    """Values through the cached DIA→CSR map, or None when the value
    pattern drifted past the cache (a nonzero outside the first
    product's entry set would be silently dropped)."""
    kept_mask = np.zeros(len(Ac_full.offsets3), dtype=bool)
    kept_mask[cache["kept"]] = True
    for k in np.flatnonzero(~kept_mask):
        if np.any(Ac_full.data[k]):
            return None                 # a dropped diagonal came alive
    data = Ac_full.data[cache["kept"]]
    mdata = np.empty((len(cache["flats"]), Ac_full.nrows),
                     dtype=Ac_full.dtype)
    for gi, mem in enumerate(cache["members"]):
        mdata[gi] = data[mem[0]]
        for m in mem[1:]:
            mdata[gi] += data[m]
    vals = mdata[cache["k_idx"], cache["i_idx"]]
    # every nonzero of the merged diagonals must land on a cached CSR
    # position; a surplus nonzero means the entry pattern grew
    if np.count_nonzero(mdata) > np.count_nonzero(vals):
        return None
    out = CSR(cache["ptr"], cache["col"], vals, Ac_full.nrows)
    out._grid_dims = cache["coarse"]
    out._dia_prepacked = (cache["flats"].tolist(), mdata)
    out._dia_offsets_cache = cache["flats"]
    out._host_dia = HostDia(cache["offs3"], data, cache["coarse"])
    out._host_dia_fp = _val_fingerprint(out)
    return out
