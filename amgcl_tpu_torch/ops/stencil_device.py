"""Device-resident stencil setup: the smoothed-aggregation hierarchy of a
structured problem built level by level on the hierarchy's device.

Counterpart of ``amgcl_tpu/ops/stencil_device.py``. The host stencil setup
(``ops/stencil.py``) runs the same algebra in numpy, bound to one core's
memory bandwidth; here every per-level pass is a torch operation on the
device, where it streams at the card's bandwidth, and the coarse operator
is born on the device. Per level (:func:`_level_setup`):

1. strength filter and lumping, elementwise per diagonal (reference:
   amgcl/coarsening/smoothed_aggregation.hpp:157-199);
2. the Gershgorin bound ρ and ω = relax·(4/3)/ρ as device scalars
   (reference: amgcl/backend/builtin.hpp:775-820);
3. M = ω D⁻¹ A_f and its transpose (offset negation plus static shifts);
4. X = A − A·M and S = X − Mᵀ·X as shifted multiply-adds over the static
   list of diagonal pairs (reference Galerkin:
   amgcl/coarsening/detail/galerkin.hpp:53);
5. the tentative collapse Ac = Tᵀ S T by parity slices;
6. the smoother's diagonal from the original operator: SPAI-0's
   (reference: amgcl/relaxation/spai0.hpp:49-117) or damped Jacobi's
   ω/a_ii, 0 where a_ii is 0 (amgcl/relaxation/damped_jacobi.hpp);
7. per-coarse-diagonal nonzero counts, the only per-level fetch to the
   host: which candidate diagonals survive fixes the next level's plan.

The aggregation shape is decided speculatively (every axis with extent > 1
coarsens by 2) and checked against the measured strong-connection counts;
a mismatch reruns the level with the measured axes (semicoarsening).
Once a level's stencil has more than ``_MAX_DIAGS`` diagonals, the build
stops and hands that level to the host loop as CSR. Torch is eager, so
the static-slice forms of the reference's TPU branches are the ones
ported. Gates: the port's ``SmoothedAggregation`` with its stencil,
grid and implicit-transfer routes on and none of ``nullspace``,
``aggregator``, ``block_size`` or ``power_iters`` set; float32; SPAI-0 or
damped Jacobi.
"""

from __future__ import annotations

import numpy as np
import torch

from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.ops.stencil import HostDia, _flat, _osum, \
    host_dia_from_csr

_MAX_DIAGS = 34          # per-level gate: the pair lists stay ~10^3 long


def _oneg(a):
    return (-a[0], -a[1], -a[2])


def _shift(v, s):
    """out[i] = v[i + s], zero-filled."""
    if s == 0:
        return v
    out = torch.zeros_like(v)
    if s > 0:
        out[:-s] = v[s:]
    else:
        out[-s:] = v[:s]
    return out


# -- static plans ---------------------------------------------------------------

def _product_plan(src_offs, dst_offs, dims):
    """Static plan for OUT = EMBED − SRC·DST: (out_offs, embed_slots,
    pairs) with pairs rows (k_src, k_dst, flat_shift(src), k_out)."""
    out_offs = sorted(
        set(dst_offs) | {_osum(oa, ob) for oa in src_offs
                         for ob in dst_offs},
        key=lambda o: _flat(o, dims))
    out_idx = {o: k for k, o in enumerate(out_offs)}
    pairs = [(ka, kb, _flat(oa, dims), out_idx[_osum(oa, ob)])
             for ka, oa in enumerate(src_offs)
             for kb, ob in enumerate(dst_offs)]
    embed = [out_idx[o] for o in dst_offs]
    return out_offs, embed, pairs


def _collapse_plan(s_offs, dims, blocks, coarse):
    """Coarse offsets, the parities and the (ns, n_par) slot table of the
    Tᵀ·T parity collapse (the plan of ops/stencil.StencilGalerkinPlan)."""
    b2, b1, b0 = blocks
    parities = [(pz, py, px) for pz in range(b2) for py in range(b1)
                for px in range(b0)]
    c_set = {}
    rows = []
    for oz, oy, ox in s_offs:
        row = []
        for pz, py, px in parities:
            co = ((pz + oz) // b2, (py + oy) // b1, (px + ox) // b0)
            if co not in c_set:
                c_set[co] = len(c_set)
            row.append(c_set[co])
        rows.append(row)
    c_offs = sorted(c_set, key=lambda o: _flat(o, coarse))
    remap = {c_set[o]: k for k, o in enumerate(c_offs)}
    table = np.asarray([[remap[s] for s in row] for row in rows], np.int64)
    return c_offs, tuple(parities), table


def _fnma_scan(out, src, dst, pairs, pad=0):
    """out[ko] −= src[ka] · shift(dst[kb], s) for every pair, in order: one
    in-place multiply-add over the rows where i + s stays in range. ``dst``
    may carry ``pad`` halo columns on each side (a sharded slab framed by
    its neighbours' rows, ``parallel/dist_stencil.py``); row i then reads
    its column ``pad + i + s``."""
    n = out.shape[1]
    for ka, kb, s, ko in pairs:
        lo, hi = max(0, -s - pad), min(n, n + pad - s)
        if hi > lo:
            out[ko, lo:hi].addcmul_(
                src[ka, lo:hi], dst[kb, lo + s + pad:hi + s + pad],
                value=-1)
    return out


# -- one level -------------------------------------------------------------------

def smoother_scale(adata, main_k, damping):
    """The smoother's diagonal from the operator's diagonal rows: SPAI-0's
    a_ii / Σ_j a_ij² (``damping`` None), else damped Jacobi's
    damping / a_ii, 0 where a_ii is 0."""
    n = adata.shape[1]
    dt, device = adata.dtype, adata.device
    one = torch.ones((), dtype=dt, device=device)
    d0 = adata[main_k] if main_k is not None \
        else torch.ones(n, dtype=dt, device=device)
    if damping is None:
        denom = (adata * adata).sum(dim=0)
        return d0 / torch.where(denom != 0, denom, one)
    w = torch.tensor(damping, dtype=torch.float32, device=device).to(dt)
    return w * torch.where(d0 != 0, one / torch.where(d0 != 0, d0, one),
                           torch.zeros((), dtype=dt, device=device))


def _level_setup(adata, eps_strong, relax, offs, dims, blocks, coarse,
                 damping=None):
    """One hierarchy level on the data's device. Returns (m, mt, ac_all,
    smoother_scale, ac_counts, axis_strong): M and Mᵀ rows in the filtered
    operator's offset order, every candidate coarse diagonal, the
    smoother's diagonal (SPAI-0's, or damped Jacobi's with ``damping``),
    the nonzeros of each candidate and the strong connections per axis
    (host arrays for the last two)."""
    n = adata.shape[1]
    dt, device = adata.dtype, adata.device
    eps = torch.tensor(eps_strong, dtype=torch.float32, device=device)
    eps2 = (eps * eps).to(dt)
    zero = torch.zeros((), dtype=dt, device=device)

    # 1. strength filter + lumping (ops/stencil.filtered_dia semantics)
    main_k = offs.index((0, 0, 0)) if (0, 0, 0) in offs else None
    dia = adata[main_k].abs() if main_k is not None \
        else torch.zeros(n, dtype=dt, device=device)
    af_rows = [None] * len(offs)
    lump = torch.zeros(n, dtype=dt, device=device)
    for k, o in enumerate(offs):
        if k == main_k:
            continue
        a = adata[k]
        strong = (a * a) > (eps2 * dia * _shift(dia, _flat(o, dims)))
        af_rows[k] = torch.where(strong, a, zero)
        lump = lump + torch.where(strong, zero, a)
    main = (adata[main_k] if main_k is not None
            else torch.zeros(n, dtype=dt, device=device)) + lump
    if main_k is not None:
        af_rows[main_k] = main
        af_offs = list(offs)
    else:
        af_rows.append(main)
        af_offs = list(offs) + [(0, 0, 0)]
    af = torch.stack(af_rows)
    one = torch.ones((), dtype=dt, device=device)
    dinv = torch.where(main != 0, one / torch.where(main != 0, main, one),
                       one)

    # strong connections per axis (speculation check;
    # ops/stencil.strength_axes semantics)
    axis_strong = []
    for ax in range(3):
        ks = [k for k, o in enumerate(af_offs)
              if [i for i, c in enumerate(o) if c != 0] == [ax]]
        axis_strong.append(torch.count_nonzero(af[ks]) if ks
                           else torch.zeros((), dtype=torch.int64,
                                            device=device))
    axis_strong = torch.stack(axis_strong)

    # 2. Gershgorin rho -> omega, on the device
    rho = (dinv.abs() * af.abs().sum(dim=0)).max()
    omega = (torch.tensor(relax, dtype=torch.float32, device=device).to(dt)
             * torch.tensor(4.0 / 3.0, dtype=dt, device=device)
             / torch.clamp_min(rho, 1e-30))

    # 3. M = omega D^-1 Af and its transpose
    m = af * (dinv * omega)[None, :]
    mt = torch.stack([_shift(m[k], _flat(_oneg(o), dims))
                      for k, o in enumerate(af_offs)])
    mt_offs = [_oneg(o) for o in af_offs]
    del af

    # 4. X = A - A·M ; S = X - Mt·X
    x_offs, _, _ = _product_plan(offs, af_offs, dims)
    x_idx = {o: k for k, o in enumerate(x_offs)}
    X = torch.zeros((len(x_offs), n), dtype=dt, device=device)
    X[[x_idx[o] for o in offs]] = adata
    x_pairs = [(ka, kb, _flat(oa, dims), x_idx[_osum(oa, ob)])
               for ka, oa in enumerate(offs)
               for kb, ob in enumerate(af_offs)]
    _fnma_scan(X, adata, m, x_pairs)
    s_offs, s_embed, s_pairs = _product_plan(mt_offs, x_offs, dims)
    S = torch.zeros((len(s_offs), n), dtype=dt, device=device)
    S[s_embed] = X
    _fnma_scan(S, mt, X, s_pairs)
    del X

    # 5. collapse Ac = T^T S T
    c_offs, parities, table = _collapse_plan(s_offs, dims, blocks, coarse)
    b2, b1, b0 = blocks
    f2, f1, f0 = dims
    dims_p = tuple(c * b for c, b in zip(coarse, blocks))
    ac_all = torch.zeros((len(c_offs),) + tuple(coarse), dtype=dt,
                         device=device)
    for i in range(len(s_offs)):
        v3 = S[i].view(f2, f1, f0)
        if dims_p != tuple(dims):
            v3 = torch.nn.functional.pad(
                v3, (0, dims_p[2] - f0, 0, dims_p[1] - f1,
                     0, dims_p[0] - f2))
        for j, (pz, py, px) in enumerate(parities):
            ac_all[int(table[i, j])] += v3[pz::b2, py::b1, px::b0]
    del S
    ac_all = ac_all.view(len(c_offs), -1)
    ac_counts = (ac_all != 0).sum(dim=1)

    # 6. the smoother's diagonal from the original operator
    scale = smoother_scale(adata, main_k, damping)
    return m, mt, ac_all, scale, ac_counts.cpu().numpy(), \
        axis_strong.cpu().numpy()


# -- orchestration -------------------------------------------------------------------

def sa_fields_allow(c) -> bool:
    """The device builds' gates on ``SmoothedAggregation``'s fields
    (``amgcl_tpu/ops/stencil_device.py:412-415``): its stencil, grid and
    implicit-transfer routes on; no nullspace, aggregator, block size or
    power iteration."""
    return (c.stencil_setup and c.structured and c.implicit_transfers
            and c.nullspace is None and c.aggregator is None
            and c.block_size == 1 and not c.power_iters)


def smoother_damping(relax):
    """None for SPAI-0, the damping for damped Jacobi, False for a
    smoother the device builds do not form."""
    from amgcl_tpu_torch.relaxation.jacobi import DampedJacobi
    from amgcl_tpu_torch.relaxation.spai0 import Spai0
    if isinstance(relax, Spai0):
        return None
    if isinstance(relax, DampedJacobi):
        return float(relax.damping)
    return False


def _to_dia_matrix(data, offs3, dims, dtype):
    """Device DIA operator from diagonal rows: flat-sort the offsets and
    merge 3-D couplings that share a flat diagonal on small grids (the
    merge HostDia.to_csr performs)."""
    from amgcl_tpu_torch.ops.device import DiaMatrix
    n = int(np.prod(dims))
    uniq = {}
    for k, o in enumerate(offs3):
        uniq.setdefault(int(_flat(o, dims)), []).append(k)
    flats = sorted(uniq)
    rows = []
    for f in flats:
        idxs = uniq[f]
        row = data[idxs[0]]
        for i in idxs[1:]:
            row = row + data[i]
        rows.append(row)
    return DiaMatrix(flats, torch.stack(rows).to(dtype), (n, n))


class _LevelMeta:
    """Host-side stand-in for a device-built level in the hierarchy's
    bookkeeping rows (its CSR is never formed)."""

    def __init__(self, nrows, nnz):
        self.nrows = int(nrows)
        self.nnz = int(nnz)


def device_build(A: CSR, prm, device, device_inv=False):
    """Build the SA hierarchy on ``device`` as far as the diagonal-pair
    Galerkin stays cheap (``device_inv`` as for ``AMG``). Returns None
    when the configuration falls outside the gates, else a dict:

    - ``levels``: the device ``Level`` list built so far, with their fused
      V-cycle handles,
    - ``meta``: one ``_LevelMeta`` per level (bookkeeping rows),
    - ``leftover``: None if the build reached the coarsest level, else the
      fetched next operator as CSR (with its DIA packing and grid dims)
      for the host loop to continue from,
    - ``coarse``: the direct solver (only when leftover is None),
    - ``eps_next``: eps_strong after the per-level decay, for the host
      loop's build context."""
    from amgcl_tpu_torch.coarsening.smoothed_aggregation import \
        SmoothedAggregation
    from amgcl_tpu_torch.models.amg import Level, check_coarse_size
    from amgcl_tpu_torch.ops.structured import (GridTentative,
                                                ImplicitSmoothedP,
                                                ImplicitSmoothedR,
                                                detect_grid_csr)
    from amgcl_tpu_torch.ops.vcycle import build_fused_down, build_fused_up
    from amgcl_tpu_torch.relaxation.base import ScaledResidualSmoother
    from amgcl_tpu_torch.solver.direct import DenseDirectSolver

    c = prm.coarsening
    if type(c) is not SmoothedAggregation or np.iscomplexobj(A.val):
        return None
    if not sa_fields_allow(c):
        return None
    if prm.matrix_format not in ("auto", "dia"):
        return None
    # float32 and bfloat16 levels (amgcl_tpu/ops/stencil_device.py:421-423):
    # the setup algebra runs in float32 either way, and a bfloat16 level
    # casts its A, M, Mᵀ and scale at the end (_to_dia_matrix)
    damping = smoother_damping(prm.relax)
    if prm.dtype not in (torch.float32, torch.bfloat16) or damping is False:
        return None
    grid = detect_grid_csr(A)
    if grid is None:
        return None
    Ad = host_dia_from_csr(A, grid, np.float32)
    if Ad is None or len(Ad.offsets3) > _MAX_DIAGS:
        return None

    dtype = prm.dtype
    offs = list(Ad.offsets3)
    dims = tuple(Ad.dims)
    adata = torch.as_tensor(Ad.data, device=device)
    eps = float(c.eps_strong)
    n = int(np.prod(dims))
    meta = [_LevelMeta(n, A.nnz)]
    levels = []

    def result(leftover, coarse_solver):
        return {"levels": levels, "meta": meta, "leftover": leftover,
                "coarse": coarse_solver, "eps_next": eps}

    def leftover():
        """The current level fetched to the host as CSR, carrying its DIA
        packing and grid dims."""
        if not levels:
            return None
        return result(HostDia(offs, adata.cpu().numpy(), dims).to_csr(),
                      None)

    while n > prm.coarse_enough and len(levels) + 1 < prm.max_levels:
        if len(offs) > _MAX_DIAGS:
            return leftover()
        blocks = tuple(2 if d > 1 else 1 for d in dims)
        if all(b == 1 for b in blocks):
            return leftover()
        coarse = tuple(-(-d // b) for d, b in zip(dims, blocks))
        m, mt, ac_all, scale, counts, axis = _level_setup(
            adata, eps, c.relax, offs, dims, blocks, coarse, damping)
        # speculation check: every extent>1 axis must be strongly coupled;
        # otherwise rerun with the measured axes (semicoarsening), or hand
        # over when no axis is strong (aggregation would stall)
        want = tuple(min(2, dims[i]) if dims[i] > 1 and axis[i] >= 0.5 * n
                     else 1 for i in range(3))
        if want != blocks:
            if all(b == 1 for b in want):
                return leftover()
            blocks = want
            coarse = tuple(-(-d // b) for d, b in zip(dims, blocks))
            m, mt, ac_all, scale, counts, _ = _level_setup(
                adata, eps, c.relax, offs, dims, blocks, coarse, damping)

        af_offs = offs + ([] if (0, 0, 0) in offs else [(0, 0, 0)])
        mt_offs = [_oneg(o) for o in af_offs]
        s_offs, _, _ = _product_plan(
            mt_offs, _product_plan(offs, af_offs, dims)[0], dims)
        c_offs, _, _ = _collapse_plan(s_offs, dims, blocks, coarse)
        keep = np.flatnonzero(counts)
        if len(keep) == 0:
            return None

        T = GridTentative(dims, blocks, coarse)
        A_lvl = _to_dia_matrix(adata, offs, dims, dtype)
        P_lvl = ImplicitSmoothedP(T, _to_dia_matrix(m, af_offs, dims, dtype))
        R_lvl = ImplicitSmoothedR(T, _to_dia_matrix(mt, mt_offs, dims,
                                                    dtype))
        relax_lvl = ScaledResidualSmoother(scale.to(dtype))
        levels.append(Level(A_lvl, relax_lvl, P_lvl, R_lvl,
                            build_fused_down(A_lvl, R_lvl, relax_lvl),
                            build_fused_up(A_lvl, P_lvl, relax_lvl)))

        adata = ac_all[torch.as_tensor(keep, device=device)]
        offs = [c_offs[k] for k in keep]
        dims = coarse
        n = int(np.prod(dims))
        meta.append(_LevelMeta(n, int(counts[keep].sum())))
        eps *= 0.5

    # coarsest level: small; the direct solver is built on the host from
    # the fetched data
    check_coarse_size(n, prm)
    A_last = _to_dia_matrix(adata, offs, dims, dtype)
    if prm.direct_coarse:
        Hl = HostDia(offs, adata.double().cpu().numpy(), dims)
        coarse_solver = DenseDirectSolver.build(Hl.to_csr(), dtype, device,
                                                device_inv)
        levels.append(Level(A_last, None))
    else:
        coarse_solver = None
        main_k = offs.index((0, 0, 0)) if (0, 0, 0) in offs else None
        levels.append(Level(A_last, ScaledResidualSmoother(
            smoother_scale(adata, main_k, damping).to(dtype))))
    return result(None, coarse_solver)
