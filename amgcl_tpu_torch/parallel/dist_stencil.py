"""Mesh-sharded stencil setup and solve: the hierarchy of a structured
problem built shard by shard over z-slabs, and AMG-preconditioned CG on
it.

Counterpart of ``amgcl_tpu/parallel/dist_stencil.py`` (reference: the
distributed build of amgcl/mpi/amg.hpp:163-330). The device setup of
``ops/stencil_device.py`` is a sequence of per-diagonal passes with
static shifts, so on a mesh (``parallel/mesh.py``):

- rows split into contiguous z-slabs, one per shard;
- every static shift reads the neighbour slabs' edge rows through a ring
  halo (:func:`_halo_extend`, zeros at the global boundary, as the
  serial zero-filled shifts);
- the Gershgorin bound and the strength and nonzero counts are reduced
  over the shards (the reference's ``pmax`` and ``psum``);
- the pair-product scans and the parity collapse run on each slab as
  they are, since slab boundaries align with the 2× aggregation blocks.

The solve reuses the slabs. At a level whose slabs are eligible the
cycle runs the fused legs in their framed mode (``ops/vcycle_kernels.py``)
on frames that carry the neighbour slabs' rows: A's, Mᵀ's and M's
diagonals and the smoother scale framed once at setup, f, u and uc framed
at each cycle. Elsewhere it composes halo SpMVs
(``parallel/dist_matrix.py``). Below the sharded levels the gathered
coarse level is a replicated :class:`~amgcl_tpu_torch.models.amg.AMG` on
the first shard's device (the repartition-merge analogue,
amgcl/mpi/partition/merge.hpp:47-137). CG runs inline, one host sync an
iteration for its convergence test.

A level's framed legs are chosen by geometry alone: 2×2×2 blocks (an
even slab), ``npre == 1`` for the down leg, a halo H = reach(A) +
reach(Mᵀ) ≤ nl for its frames and a tile of the slab whose boxes fit
shared memory (``vk.down_tile``), and for the up leg ``npost ≥ 1``,
hp ≤ cz and hp·2s ≤ nl with hp = ceil((reach(A) + reach(M)) / 2s). A
level keeps its M and Mᵀ slabs only for a leg that it composes. A kernel
that does not build, launch or agree raises; nothing falls back.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Any

import numpy as np
import torch

from amgcl_tpu_torch.ops import vcycle_kernels as vk
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.ops.stencil import HostDia, _flat, _osum, \
    host_dia_from_csr
from amgcl_tpu_torch.ops.stencil_device import (_MAX_DIAGS, _collapse_plan,
                                                _fnma_scan, _oneg,
                                                _product_plan,
                                                sa_fields_allow,
                                                smoother_damping,
                                                smoother_scale)
from amgcl_tpu_torch.ops.vcycle import up_geometry
from amgcl_tpu_torch.parallel.dist_matrix import (_ring_exchange,
                                                  dia_halo_mv,
                                                  dist_inner_product)
from amgcl_tpu_torch.parallel.mesh import Mesh, host_full, put_sharded
from amgcl_tpu_torch.telemetry.report import SolveReport


def _halo_extend(slabs, w):
    """Per shard ``(…, nl) → (…, nl + 2w)``: the slab framed by the last
    ``w`` rows of the previous shard and the first ``w`` of the next
    (zeros at the global boundary; on one shard, zeros on both sides)."""
    if w == 0:
        return list(slabs)
    if len(slabs) == 1:
        return [torch.nn.functional.pad(slabs[0], (w, w))]
    return [torch.cat([p, x, q], dim=-1)
            for x, (p, q) in zip(slabs, _ring_exchange(slabs, w))]


# -- one sharded level ---------------------------------------------------------

def _sharded_level_setup(adata, eps_strong, relax, offs, gdims, lz, blocks,
                         coarse, damping=None):
    """One hierarchy level over the shards: ``ops/stencil_device``'s level
    with halo shifts and reductions over the shards. ``adata``: per-shard
    ``(ndiag, nl)`` slabs; ``gdims`` the global grid, ``lz`` the planes of
    a slab. Returns per-shard lists (M, Mᵀ, every candidate coarse
    diagonal, the smoother's diagonal: SPAI-0's, or damped Jacobi's with
    ``damping``) and the host arrays of the global nonzeros of
    each candidate and strong connections per axis."""
    d2, d1, d0 = gdims
    nl = adata[0].shape[1]
    dt = adata[0].dtype
    offs = list(offs)
    flats = [_flat(o, gdims) for o in offs]
    main_k = offs.index((0, 0, 0)) if (0, 0, 0) in offs else None
    zeros = [torch.zeros(nl, dtype=dt, device=a.device) for a in adata]

    # 1. strength filter + lumping, against the neighbours' diagonal
    hmax = max(max(abs(f) for f in flats), 1)
    dia = [a[main_k].abs() if main_k is not None else z
           for a, z in zip(adata, zeros)]
    dia_ext = _halo_extend(dia, hmax)
    af, dinv = [], []
    for a, di, de, z in zip(adata, dia, dia_ext, zeros):
        eps = torch.tensor(eps_strong, dtype=torch.float32, device=a.device)
        eps2 = (eps * eps).to(dt)
        zero = torch.zeros((), dtype=dt, device=a.device)
        rows = [None] * len(offs)
        lump = z
        for k in range(len(offs)):
            if k == main_k:
                continue
            dj = de[hmax + flats[k]:hmax + flats[k] + nl]
            strong = (a[k] * a[k]) > (eps2 * di * dj)
            rows[k] = torch.where(strong, a[k], zero)
            lump = lump + torch.where(strong, zero, a[k])
        main = (a[main_k] if main_k is not None else z) + lump
        if main_k is not None:
            rows[main_k] = main
        else:
            rows.append(main)
        af.append(torch.stack(rows))
        one = torch.ones((), dtype=dt, device=a.device)
        dinv.append(torch.where(main != 0,
                                one / torch.where(main != 0, main, one), one))
    af_offs = offs + ([] if main_k is not None else [(0, 0, 0)])

    # strong connections per axis, summed over the shards
    axis_strong = []
    for ax in range(3):
        ks = [k for k, o in enumerate(af_offs)
              if [i for i, c in enumerate(o) if c != 0] == [ax]]
        axis_strong.append(sum(int(torch.count_nonzero(f[ks])) if ks else 0
                               for f in af))

    # 2. Gershgorin rho, the largest over the shards -> omega
    rho = torch.stack([(di.abs() * f.abs().sum(dim=0)).max()
                       .to(adata[0].device) for di, f in zip(dinv, af)]).max()
    m = []
    for f, di in zip(af, dinv):
        omega = (torch.tensor(relax, dtype=torch.float32,
                              device=f.device).to(dt)
                 * torch.tensor(4.0 / 3.0, dtype=dt, device=f.device)
                 / torch.clamp_min(rho.to(f.device), 1e-30))
        # 3. M = omega D^-1 Af
        m.append(f * (di * omega)[None, :])
    del af, dinv

    # ... and its transpose, reading the neighbours' rows
    hm = max(max(abs(_flat(o, gdims)) for o in af_offs), 1)
    mt = [torch.stack([me[k, hm + _flat(_oneg(o), gdims):
                          hm + _flat(_oneg(o), gdims) + nl]
                       for k, o in enumerate(af_offs)])
          for me in _halo_extend(m, hm)]
    mt_offs = [_oneg(o) for o in af_offs]

    # 4. X = A - A·M ; S = X - Mt·X over halo'd sources
    x_offs, _, _ = _product_plan(offs, af_offs, gdims)
    x_idx = {o: k for k, o in enumerate(x_offs)}
    x_pairs = [(ka, kb, _flat(oa, gdims), x_idx[_osum(oa, ob)])
               for ka, oa in enumerate(offs)
               for kb, ob in enumerate(af_offs)]
    pad_m = max(max(abs(p[2]) for p in x_pairs), 1)
    X = []
    for a, me in zip(adata, _halo_extend(m, pad_m)):
        x = torch.zeros((len(x_offs), nl), dtype=dt, device=a.device)
        x[[x_idx[o] for o in offs]] = a
        X.append(_fnma_scan(x, a, me, x_pairs, pad_m))
    s_offs, s_embed, s_pairs = _product_plan(mt_offs, x_offs, gdims)
    pad_x = max(max(abs(p[2]) for p in s_pairs), 1)
    S = []
    for x, mtl, xe in zip(X, mt, _halo_extend(X, pad_x)):
        sl = torch.zeros((len(s_offs), nl), dtype=dt, device=x.device)
        sl[s_embed] = x
        S.append(_fnma_scan(sl, mtl, xe, s_pairs, pad_x))
    del X

    # 5. collapse Ac = T^T S T on each slab (aligned with the 2x z-blocks)
    c_offs, parities, table = _collapse_plan(s_offs, gdims, blocks, coarse)
    b2, b1, b0 = blocks
    _, c1, c0 = coarse
    lcz = lz // b2 if b2 > 1 else lz
    dims_p = (lcz * b2, c1 * b1, c0 * b0)
    ac = []
    for sl in S:
        acc = torch.zeros((len(c_offs), lcz, c1, c0), dtype=dt,
                          device=sl.device)
        for i in range(len(s_offs)):
            v3 = sl[i].view(lz, d1, d0)
            if dims_p != (lz, d1, d0):
                v3 = torch.nn.functional.pad(
                    v3, (0, dims_p[2] - d0, 0, dims_p[1] - d1,
                         0, dims_p[0] - lz))
            for j, (pz, py, px) in enumerate(parities):
                acc[int(table[i, j])] += v3[pz::b2, py::b1, px::b0]
        ac.append(acc.view(len(c_offs), -1))
    del S
    counts = sum((c != 0).sum(dim=1).cpu().numpy() for c in ac)

    # 6. the smoother's diagonal from the original operator
    scale = [smoother_scale(a, main_k, damping) for a in adata]
    return m, mt, ac, scale, counts, np.asarray(axis_strong)


# -- the sharded hierarchy ---------------------------------------------------

class FusedSlab:
    """Per-shard framed operands of the fused legs at one sharded level:
    A's and Mᵀ's diagonals and the smoother scale framed by ``H`` rows of
    the neighbour slabs for the down leg (None when it is not eligible),
    M's diagonals framed by ``hp`` coarse planes for the up leg (None
    likewise). Each is a list over the shards. The flat offsets are the
    level's, which are the global ones: shards split whole z-planes."""

    def __init__(self, a_fr, mt_fr, w_fr, m_fr, H, hp, ldims, lcoarse):
        self.a_fr = a_fr        # [(nA, nl + 2H)] or None
        self.mt_fr = mt_fr      # [(nMt, nl + 2H)] or None
        self.w_fr = w_fr        # [(nl + 2H,)] or None
        self.m_fr = m_fr        # [(nM, nl + 4·hp·s)] or None
        self.H = int(H)
        self.hp = int(hp)
        self.ldims = tuple(int(d) for d in ldims)
        self.lcoarse = tuple(int(c) for c in lcoarse)

    @property
    def down_ok(self):
        return self.a_fr is not None

    @property
    def up_ok(self):
        return self.m_fr is not None


def _reach(flats):
    return max((abs(int(f)) for f in flats), default=0)


def framed_geometry(a_flats, m_flats, mt_flats, ldims, lcoarse, blocks,
                    npre=1, npost=1):
    """``(down_ok, up_ok, H, hp)``: which fused legs a sharded level runs
    framed, by geometry alone (see the module docstring), and their
    halos."""
    lz, d1, d0 = ldims
    s = d1 * d0
    H = _reach(a_flats) + _reach(mt_flats)
    hp = up_geometry(a_flats, m_flats, ldims) if m_flats else 0
    if tuple(blocks) != vk.BLOCK or lz % 2 or not (a_flats and m_flats
                                                   and mt_flats):
        return False, False, H, hp
    return (npre == 1 and H <= lz * s
            and vk.down_tile(a_flats, mt_flats, ldims) is not None,
            npost >= 1 and hp <= lcoarse[0] and hp * 2 * s <= lz * s, H, hp)


def _build_fused_slab(adata, mdata, mtdata, scale, a_flats, m_flats,
                      mt_flats, ldims, lcoarse, blocks, npre=1, npost=1):
    """FusedSlab for an eligible sharded level, else None."""
    down_ok, up_ok, H, hp = framed_geometry(a_flats, m_flats, mt_flats,
                                            ldims, lcoarse, blocks, npre,
                                            npost)
    if not (down_ok or up_ok):
        return None
    a_fr = mt_fr = w_fr = m_fr = None
    if down_ok:
        a_fr, mt_fr = _halo_extend(adata, H), _halo_extend(mtdata, H)
        w_fr = _halo_extend(scale, H)
    if up_ok:
        m_fr = _halo_extend(mdata, hp * 2 * ldims[1] * ldims[2])
    return FusedSlab(a_fr, mt_fr, w_fr, m_fr, H, hp, ldims, lcoarse)


class DistStencilLevel:
    """One sharded level: per-shard slabs of the operator, smoother scale
    and transfer diagonals, and the static grid plan. M's slabs are None
    where the up leg runs framed, Mᵀ's where the down leg does: the
    frames carry them."""

    def __init__(self, adata, scale, mdata, mtdata, a_flats, m_flats,
                 mt_flats, ldims, lcoarse, blocks, fused=None):
        self.adata = adata          # [(ndiag, nl)] per shard
        self.scale = scale          # [(nl,)]
        self.mdata = mdata          # [(nM, nl)] or None
        self.mtdata = mtdata        # [(nMt, nl)] or None
        self.a_flats = tuple(a_flats)     # global flat offsets
        self.m_flats = tuple(m_flats)
        self.mt_flats = tuple(mt_flats)
        self.ldims = tuple(ldims)         # slab dims (lz, d1, d0)
        self.lcoarse = tuple(lcoarse)     # the slab's coarse dims
        self.blocks = tuple(blocks)
        self.fused = fused                # FusedSlab or None

    def t_mv(self, uc):
        """The tentative prolongation on one slab."""
        (lz, d1, d0), (cz, c1, c0), (b2, b1, b0) = \
            self.ldims, self.lcoarse, self.blocks
        u = uc.reshape(cz, 1, c1, 1, c0, 1).expand(cz, b2, c1, b1, c0, b0)
        u = u.reshape(cz * b2, c1 * b1, c0 * b0)
        return u[:lz, :d1, :d0].reshape(-1)

    def t_rmv(self, v):
        """The tentative restriction on one slab."""
        (lz, d1, d0), (cz, c1, c0), (b2, b1, b0) = \
            self.ldims, self.lcoarse, self.blocks
        v3 = v.reshape(lz, d1, d0)
        if (cz * b2, c1 * b1, c0 * b0) != (lz, d1, d0):
            v3 = torch.nn.functional.pad(
                v3, (0, c0 * b0 - d0, 0, c1 * b1 - d1, 0, cz * b2 - lz))
        return v3.reshape(cz, b2, c1, b1, c0, b0).sum(dim=(1, 3, 5)) \
            .reshape(-1)


class DistStencilHierarchy:
    """Sharded stencil levels and the replicated serial tail."""

    def __init__(self, levels, rep_amg, n_rep, npre=1, npost=1):
        self.levels = list(levels)
        self.rep_amg = rep_amg        # the tail's AMG
        self.rep_hier = rep_amg.hierarchy
        self.n_rep = int(n_rep)       # rows of the tail's top level
        self.npre = int(npre)
        self.npost = int(npost)

    def _smooth(self, lv, f, u):
        """u + w ∘ (f − A u) on every shard."""
        return [ui + w * (fi - ai) for ui, w, fi, ai in
                zip(u, lv.scale, f, dia_halo_mv(lv.adata, lv.a_flats, u))]

    def shard_cycle(self, i, f):
        """One V-cycle from level i for the per-shard rhs slabs ``f``, zero
        initial guess; returns the per-shard slabs of the correction."""
        if i == len(self.levels):
            # replicated tail: gather, the serial cycle, scatter
            dev, nl = f[0].device, f[0].shape[0]
            u = self.rep_hier.apply(torch.cat([x.to(dev) for x in f])
                                    [:self.n_rep])
            u = torch.nn.functional.pad(u, (0, nl * len(f) - self.n_rep))
            return [u[j * nl:(j + 1) * nl].to(x.device)
                    for j, x in enumerate(f)]
        lv = self.levels[i]
        fz = lv.fused
        if fz is not None and fz.down_ok:
            # the whole down leg as one kernel per shard on halo frames
            u, fc = zip(*(vk.fused_down_sweep_framed(
                lv.a_flats, a, lv.mt_flats, mt, ff, w, fz.ldims, fz.H,
                zero_guess=True) for a, mt, ff, w in zip(
                    fz.a_fr, fz.mt_fr, _halo_extend(f, fz.H), fz.w_fr)))
        else:
            u = [w * x for w, x in zip(lv.scale, f)]
            for _ in range(self.npre - 1):
                u = self._smooth(lv, f, u)
            r = [fi - ai for fi, ai in
                 zip(f, dia_halo_mv(lv.adata, lv.a_flats, u))]
            # restrict: fc = Tᵀ (r − Mᵀ r)
            fc = [lv.t_rmv(ri - qi) for ri, qi in
                  zip(r, dia_halo_mv(lv.mtdata, lv.mt_flats, r))]
        uc = self.shard_cycle(i + 1, list(fc))
        if fz is not None and fz.up_ok:
            # prolong + correct + first post-sweep as one kernel per shard
            _, c1, c0 = fz.lcoarse
            s2 = 2 * fz.ldims[1] * fz.ldims[2]
            u = [vk.fused_up_sweep_framed(lv.a_flats, a, lv.m_flats, m, w,
                                          ff, uf, cf, fz.ldims, fz.hp)
                 for a, m, w, ff, uf, cf in zip(
                     lv.adata, fz.m_fr, lv.scale, f,
                     _halo_extend(list(u), fz.hp * s2),
                     _halo_extend(uc, fz.hp * c1 * c0))]
            extra = self.npost - 1
        else:
            t = [lv.t_mv(c) for c in uc]
            u = [ui + ti - qi for ui, ti, qi in
                 zip(u, t, dia_halo_mv(lv.mdata, lv.m_flats, t))]
            extra = self.npost
        for _ in range(extra):
            u = self._smooth(lv, f, u)
        return u

    def shard_apply(self, r):
        """The preconditioner: one V-cycle on the per-shard slabs ``r``."""
        return self.shard_cycle(0, r)


def dist_stencil_build(A: CSR, mesh: Mesh, prm, rep_coarse_enough=3000):
    """Sharded hierarchy construction. Returns ``(DistStencilHierarchy,
    per-level row counts)``, or None when the system or configuration
    lies outside the sharded stencil path, as the reference's declines
    (amgcl_tpu/parallel/dist_stencil.py:707-732), in its order: a
    coarsening other than smoothed aggregation or one with a field the
    device builds decline (``stencil_device.sa_fields_allow``), block or
    complex values, a dtype other than float32 (bfloat16 too), a smoother
    other than SPAI-0 and damped Jacobi, no grid, a z extent that does not
    split into even slabs, a stencil of too many diagonals. The JAX
    package sends no such call elsewhere: its DistStencilSolver raises
    ValueError, as the port's does; a caller builds a distributed AMG
    solver itself (ROADMAP A.12)."""
    from amgcl_tpu_torch.coarsening.smoothed_aggregation import \
        SmoothedAggregation
    from amgcl_tpu_torch.models.amg import AMG
    from amgcl_tpu_torch.ops.structured import detect_grid_csr

    c = prm.coarsening
    if type(c) is not SmoothedAggregation or not sa_fields_allow(c):
        return None
    if A.is_block or np.iscomplexobj(A.val) or prm.dtype != torch.float32:
        return None
    damping = smoother_damping(prm.relax)
    if damping is False:
        return None
    grid = detect_grid_csr(A)
    if grid is None:
        return None
    nd = mesh.size
    if grid[0] % (2 * nd):
        return None
    Ad = host_dia_from_csr(A, grid, np.float32)
    if Ad is None or len(Ad.offsets3) > _MAX_DIAGS:
        return None

    dims = tuple(grid)
    offs = list(Ad.offsets3)
    adata = put_sharded(np.ascontiguousarray(Ad.data), mesh, axis=1)
    eps = float(c.eps_strong)
    meta = [int(np.prod(dims))]
    levels = []

    while True:
        lz = dims[0] // nd
        n = int(np.prod(dims))
        # z must split evenly over the mesh; z-coarsening also needs an
        # even slab (zb below), semicoarsening in x/y alone does not
        if (n <= rep_coarse_enough or len(offs) > _MAX_DIAGS
                or dims[0] % nd):
            break
        # halo-width guard: one ring hop supplies at most one slab, so a
        # coupling that reaches past the neighbour slab ends the sharding
        if max(max(abs(_flat(o, dims)) for o in offs), 1) \
                > lz * dims[1] * dims[2]:
            break
        zb = 2 if dims[0] > 1 and lz % 2 == 0 else 1
        blocks = (zb, 2 if dims[1] > 1 else 1, 2 if dims[2] > 1 else 1)
        if all(b == 1 for b in blocks):
            break
        coarse = tuple(-(-d // b) for d, b in zip(dims, blocks))
        m, mt, ac, scale, counts, axis = _sharded_level_setup(
            adata, eps, c.relax, offs, dims, lz, blocks, coarse, damping)
        want = tuple(min(2, dims[i]) if dims[i] > 1 and axis[i] >= 0.5 * n
                     else 1 for i in range(3))
        if want != blocks:
            # semicoarsening: rerun with the measured strong axes. A strong
            # z-axis over odd slabs cannot coarsen on this mesh: the
            # replicated tail takes over
            if all(b == 1 for b in want) or (want[0] == 2 and zb == 1):
                if not levels:
                    return None
                break
            blocks = want
            coarse = tuple(-(-d // b) for d, b in zip(dims, blocks))
            m, mt, ac, scale, counts, _ = _sharded_level_setup(
                adata, eps, c.relax, offs, dims, lz, blocks, coarse,
                damping)

        af_offs = offs + ([] if (0, 0, 0) in offs else [(0, 0, 0)])
        mt_offs = [_oneg(o) for o in af_offs]
        s_offs, _, _ = _product_plan(
            mt_offs, _product_plan(offs, af_offs, dims)[0], dims)
        c_offs, _, _ = _collapse_plan(s_offs, dims, blocks, coarse)
        keep = np.flatnonzero(counts)
        if len(keep) == 0:
            return None

        a_fl = [_flat(o, dims) for o in offs]
        m_fl = [_flat(o, dims) for o in af_offs]
        mt_fl = [_flat(o, dims) for o in mt_offs]
        ld = (lz, dims[1], dims[2])
        lc = (lz // 2 if blocks[0] > 1 else lz, coarse[1], coarse[2])
        fz = _build_fused_slab(adata, m, mt, scale, a_fl, m_fl, mt_fl, ld,
                               lc, blocks, prm.npre, prm.npost)
        levels.append(DistStencilLevel(
            adata, scale, None if fz and fz.up_ok else m,
            None if fz and fz.down_ok else mt, a_fl, m_fl, mt_fl, ld, lc,
            blocks, fused=fz))
        adata = [a[torch.as_tensor(keep, device=a.device)] for a in ac]
        offs = [c_offs[k] for k in keep]
        dims = coarse
        meta.append(int(np.prod(dims)))
        eps *= 0.5

    if not levels:
        return None
    # the replicated serial tail from the gathered coarse level
    Acsr = HostDia(offs, host_full(adata, axis=1), dims).to_csr()
    prm2 = replace(prm, coarsening=SmoothedAggregation(eps_strong=eps,
                                                       relax=c.relax),
                   dtype=torch.float32)
    hier = DistStencilHierarchy(levels, AMG(Acsr, prm2,
                                            device=mesh.devices[0]),
                                Acsr.nrows, prm.npre, prm.npost)
    return hier, meta


def _shard_vector(v, mesh, n, what):
    """A host array or a tensor of ``n`` entries as float32 slabs on the
    mesh (``put_sharded``)."""
    shape = tuple(v.shape) if torch.is_tensor(v) else np.shape(v)
    if shape != (n,):
        raise ValueError("%s has shape %s; the system has %d unknowns"
                         % (what, shape, n))
    return put_sharded(v, mesh, dtype=torch.float32)


class DistStencilSolver:
    """AMG-preconditioned CG over a mesh, with the hierarchy of a stencil
    problem built shard by shard: ``s = DistStencilSolver(A, mesh, prm,
    solver)``, then ``x, info = s(rhs, x0=None)``. ``solver`` supplies
    ``maxiter`` and ``tol`` (a ``CG``; 100 and 1e-6 without one). ``x`` is
    a float32 tensor on the first shard's device; ``info`` a SolveReport
    with ``solver="dist_stencil_cg"`` and the shard count in ``extra``."""

    def __init__(self, A, mesh: Mesh, prm=None, solver: Any = None,
                 rep_coarse_enough: int = 3000):
        from amgcl_tpu_torch.models.amg import AMGParams
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        self.mesh = mesh
        self.prm = prm or AMGParams()
        self.solver = solver
        t0 = time.perf_counter()
        got = dist_stencil_build(A, mesh, self.prm, rep_coarse_enough)
        if got is None:
            raise ValueError(
                "matrix or configuration outside the sharded stencil path "
                "(it needs a structured grid whose z extent splits into "
                "even slabs over %d shards, scalar real values, float32 "
                "and smoothed aggregation with SPAI-0 or damped Jacobi)"
                % mesh.size)
        self.hier, self.meta = got
        self.n = A.nrows
        self.setup_seconds = time.perf_counter() - t0

    def __call__(self, rhs, x0=None):
        maxiter = getattr(self.solver, "maxiter", 100) if self.solver \
            else 100
        tol = getattr(self.solver, "tol", 1e-6) if self.solver else 1e-6
        t0 = time.perf_counter()
        f = _shard_vector(rhs, self.mesh, self.n, "rhs")
        x = [torch.zeros_like(v) for v in f] if x0 is None \
            else _shard_vector(x0, self.mesh, self.n, "x0")
        dot = dist_inner_product
        lv0 = self.hier.levels[0]

        def amv(v):
            return dia_halo_mv(lv0.adata, lv0.a_flats, v)

        def on(t, v):
            return t.to(v.device)

        r = [fi - qi for fi, qi in zip(f, amv(x))]
        nb, res = torch.stack([dot(f, f), dot(r, r)]).abs().sqrt().tolist()
        # if ||rhs|| == 0 the solution is x = 0
        scale = nb if nb > 0 else 1.0
        eps = tol * scale
        p = [torch.zeros_like(v) for v in r]
        rho_p = torch.zeros((), dtype=torch.float32, device=f[0].device)
        zero = torch.zeros_like(rho_p)
        k = 0
        while k < maxiter and res > eps:
            s = self.hier.shard_apply(r)
            rho = dot(r, s)
            beta = torch.where(rho_p == 0, zero, rho / rho_p)
            p = [si + on(beta, si) * pi for si, pi in zip(s, p)]
            q = amv(p)
            alpha = rho / dot(q, p)
            x = [xi + on(alpha, xi) * pi for xi, pi in zip(x, p)]
            r = [ri - on(alpha, ri) * qi for ri, qi in zip(r, q)]
            res = float(dot(r, r).abs().sqrt())     # the one host sync
            rho_p = rho
            k += 1
        dev = f[0].device
        x = torch.cat([xi.to(dev) for xi in x])
        if nb == 0:
            x = torch.zeros_like(x)
        info = SolveReport(
            k, res / scale, wall_time_s=time.perf_counter() - t0,
            solver="dist_stencil_cg",
            extra={"shards": self.mesh.size,
                   "devices": len(set(self.mesh.devices))})
        return x, info

    def __repr__(self):
        rows = ["DistStencilSolver over %d shards (sharded setup)"
                % self.mesh.size]
        for i, m in enumerate(self.meta):
            rows.append("%5d %12d" % (i, m))
        return "\n".join(rows)
