"""The port's sharded stencil path (``amgcl_tpu_torch/parallel/``) against
the JAX package's (``amgcl_tpu/parallel/dist_stencil.py``) on the CPU.

The port drives every shard from one process; the JAX package runs the
same per-shard programs under ``shard_map`` on the 8 virtual CPU devices
of ``tests/conftest.py``. On the CPU the port's framed legs run their
plain versions. Covered:

- the framed legs, shard by shard, against the JAX package's Pallas
  kernels in interpret mode on the JAX level's own frames, carried across
  with ``convert.fused_slab_from_arrays`` (the 16×8×64 grid of
  ``tests/test_dist_stencil.py`` over 8 shards): zero-guess and base down
  legs, the up leg; and the base legs as the framed legs on a zero frame;
- the halo SpMV in all three regimes and the distributed dot on meshes of
  1, 2 and 8 shards;
- the sharded build (levels, slabs, offsets, every A, M, Mᵀ and scale
  slab), also with the semicoarsening re-run;
- the slice end to end (iterations, x), a warm start, and the refusals.

Tolerances (float32): the kernels and the halo SpMV within 1e-5 and 1e-6
of the largest entry of the result (the two sides sum in other orders),
the dot within 1e-6 of Σ|x y|; the build's slabs within 1e-5 of the
largest entry of the slab; x within 1e-4 relative.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from amgcl_tpu.models.amg import AMGParams as RefParams
from amgcl_tpu.ops import pallas_vcycle as pv
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.parallel import dist_matrix as ref_dm
from amgcl_tpu.parallel.compat import shard_map
from amgcl_tpu.parallel.dist_stencil import DistStencilSolver as RefSolver
from amgcl_tpu.parallel.dist_stencil import \
    dist_stencil_build as ref_build
from amgcl_tpu.parallel.mesh import ROWS_AXIS
from amgcl_tpu.parallel.mesh import make_mesh as ref_mesh
from amgcl_tpu.relaxation.jacobi import DampedJacobi
from amgcl_tpu.solver.cg import CG as RefCG
from amgcl_tpu.utils.sample_problem import poisson3d as ref_poisson3d

import amgcl_tpu_torch as T
from amgcl_tpu_torch.convert import fused_slab_from_arrays
from amgcl_tpu_torch.ops import vcycle_kernels as vk
from amgcl_tpu_torch.parallel import (DistStencilSolver, dia_halo_mv,
                                      dist_inner_product,
                                      dist_stencil_build, host_full,
                                      make_mesh, put_sharded)
from amgcl_tpu_torch.parallel.dist_stencil import _halo_extend


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS, OpenMP and torch thread while this module runs: its
    small problems gain nothing from threads, and the test suite's
    parallel workers would oversubscribe the cores."""
    from threadpoolctl import threadpool_limits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


def _close(got, want, rtol):
    """Entries within rtol of the largest entry of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _shards(arr):
    """A sharded JAX array's per-shard blocks, in shard order."""
    parts = sorted(arr.addressable_shards,
                   key=lambda s: s.index[0].start or 0)
    return [np.asarray(s.data)[0] for s in parts]


def _laplacian(d2, d1, d0):
    def t(n):
        e = np.ones(n)
        return sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1], format="csr")
    eye = sp.identity
    A = (sp.kron(eye(d2), sp.kron(eye(d1), t(d0)))
         + sp.kron(eye(d2), sp.kron(t(d1), eye(d0)))
         + sp.kron(t(d2), sp.kron(eye(d1), eye(d0)))).tocsr()
    A.sort_indices()
    return A


# -- the framed legs against the JAX kernels -----------------------------------

_NSH = 8


@pytest.fixture(scope="module")
def framed():
    """The JAX level 0 of the 16×8×64 grid over 8 shards, built with the
    Pallas kernels in interpret mode (so that its FusedSlab exists), the
    port's FusedSlab carried across from its frames, and seeded vectors."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AMGCL_TPU_PALLAS_INTERPRET", "1")
        ref = RefSolver(RefCSR.from_scipy(_laplacian(16, 8, 64)),
                        ref_mesh(_NSH),
                        RefParams(dtype=jnp.float32, coarse_enough=64),
                        RefCG(maxiter=40, tol=1e-5))
    lv = ref.hier.levels[0]
    fz = lv.fused
    assert fz is not None and fz.a_fr is not None and fz.up_ok
    slab = {k: getattr(fz, k) for k in ("H", "hp", "ldims", "lcoarse")}
    for k in ("a_fr", "mt_fr", "w_fr", "m_fr"):
        slab[k] = _shards(getattr(fz, k))
    port = fused_slab_from_arrays(slab, device="cpu")
    lz, d1, d0 = fz.ldims
    nl, s = lz * d1 * d0, d1 * d0
    cz, c1, c0 = fz.lcoarse
    rng = np.random.RandomState(8)
    vec = lambda n: torch.as_tensor(rng.standard_normal(n).astype(
        np.float32))
    split = lambda v: list(torch.tensor_split(v, _NSH))
    f, u = vec(_NSH * nl), vec(_NSH * nl)
    uc = vec(_NSH * cz * c1 * c0)
    return {
        "ref": fz, "port": port, "nl": nl,
        "adata": np.asarray(lv.adata), "scale": np.asarray(lv.scale),
        "f": split(f), "f_fr": _halo_extend(split(f), fz.H),
        "u_fr": _halo_extend(split(u), fz.H),
        "u_up": _halo_extend(split(u), fz.hp * 2 * s),
        "uc_fr": _halo_extend(split(uc), fz.hp * c1 * c0)}


def test_frames_carry_the_reference_geometry(framed):
    fz, port = framed["ref"], framed["port"]
    assert (port.H, port.hp, port.ldims, port.lcoarse) \
        == (fz.H, fz.hp, fz.ldims, fz.lcoarse)
    lz, d1, d0 = fz.ldims
    L, Lm = framed["nl"] + 2 * fz.H, framed["nl"] + 4 * fz.hp * d1 * d0
    assert [tuple(a.shape) for a in port.a_fr] \
        == [(len(fz.offs_a), L)] * _NSH
    assert [tuple(m.shape) for m in port.m_fr] \
        == [(len(fz.offs_m), Lm)] * _NSH
    # the halos hold the neighbours' rows: real on interior shards, zero
    # at the ends of the mesh
    assert port.a_fr[3][:, :fz.H].any() and port.a_fr[3][:, -fz.H:].any()
    assert not port.a_fr[0][:, :fz.H].any()
    assert not port.a_fr[-1][:, -fz.H:].any()


@pytest.mark.parametrize("shard", range(_NSH))
def test_framed_down_zero_guess_matches_jax(framed, shard):
    fz, port, j = framed["ref"], framed["port"], shard
    calls = vk.fused_down_sweep_framed_plain.calls
    u, rc = vk.fused_down_sweep_framed(
        fz.offs_a, port.a_fr[j], fz.offs_mt, port.mt_fr[j],
        framed["f_fr"][j], port.w_fr[j], port.ldims, port.H,
        zero_guess=True)
    assert vk.fused_down_sweep_framed_plain.calls == calls + 1
    rc3, u_ref = pv.fused_down_sweep(
        jnp.asarray(port.a_fr[j].numpy().reshape(-1)),
        jnp.asarray(port.mt_fr[j].numpy().reshape(-1)), fz.red_a, fz.red_b,
        jnp.asarray(framed["f_fr"][j].numpy()),
        jnp.asarray(port.w_fr[j].numpy()), offs_a=fz.offs_a,
        offs_m=fz.offs_mt, dims=fz.ldims, coarse=fz.lcoarse, H=fz.H,
        zero_guess=True, framed=True, interpret=True)
    _close(rc, np.asarray(rc3).reshape(-1), 1e-5)
    _close(u, np.asarray(u_ref), 1e-5)


@pytest.mark.parametrize("shard", [0, 3, _NSH - 1])
def test_framed_down_base_mode_matches_jax(framed, shard):
    fz, port, j = framed["ref"], framed["port"], shard
    rc = vk.fused_down_sweep_framed(
        fz.offs_a, port.a_fr[j], fz.offs_mt, port.mt_fr[j],
        framed["f_fr"][j], framed["u_fr"][j], port.ldims, port.H)
    rc3 = pv.fused_down_sweep(
        jnp.asarray(port.a_fr[j].numpy().reshape(-1)),
        jnp.asarray(port.mt_fr[j].numpy().reshape(-1)), fz.red_a, fz.red_b,
        jnp.asarray(framed["f_fr"][j].numpy()),
        jnp.asarray(framed["u_fr"][j].numpy()), offs_a=fz.offs_a,
        offs_m=fz.offs_mt, dims=fz.ldims, coarse=fz.lcoarse, H=fz.H,
        framed=True, interpret=True)
    _close(rc, np.asarray(rc3).reshape(-1), 1e-5)


@pytest.mark.parametrize("shard", range(_NSH))
def test_framed_up_matches_jax(framed, shard):
    fz, port, j, nl = framed["ref"], framed["port"], shard, framed["nl"]
    a = torch.as_tensor(framed["adata"][:, j * nl:(j + 1) * nl].copy())
    w = torch.as_tensor(framed["scale"][j * nl:(j + 1) * nl].copy())
    f, u_fr, uc_fr = framed["f"][j], framed["u_up"][j], framed["uc_fr"][j]
    calls = vk.fused_up_sweep_framed_plain.calls
    got = vk.fused_up_sweep_framed(fz.offs_a, a, fz.offs_m, port.m_fr[j],
                                   w, f, u_fr, uc_fr, port.ldims, port.hp)
    assert vk.fused_up_sweep_framed_plain.calls == calls + 1
    lz, d1, d0 = fz.ldims
    cz, c1, c0 = fz.lcoarse
    _, _, cv = pv._pack_shape(d1, d0, c1, c0)
    want = pv.fused_up_sweep(
        jnp.asarray(a.numpy()), jnp.asarray(port.m_fr[j].numpy()
                                            .reshape(-1)),
        fz.exp_a, fz.exp_b,
        jnp.asarray(uc_fr.numpy().reshape(cz + 2 * fz.hp, *cv)),
        jnp.asarray(f.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(u_fr.numpy()), offs_a=fz.offs_a, offs_m=fz.offs_m,
        dims=fz.ldims, coarse=fz.lcoarse, halo_planes=fz.hp, framed=True,
        interpret=True)
    _close(got, np.asarray(want), 1e-5)


def _random_leg(dims, seed):
    rng = np.random.RandomState(seed)
    _, f1, f0 = dims
    s = f1 * f0
    offs = (-s, -f0, -1, 0, 1, f0, s)
    n = int(np.prod(dims))
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32))
    return offs, t(len(offs), n), t(len(offs), n), t(n), t(n), t(n), \
        t(int(np.prod(vk.coarse_dims(dims))))


@pytest.mark.parametrize("dims", [(4, 6, 10), (2, 5, 7), (6, 4, 4)])
def test_base_legs_are_the_framed_legs_on_a_zero_frame(dims):
    """The framed plain versions on frames whose halos are zero give the
    base plain versions' results exactly."""
    offs, a, m, w, f, u, uc = _random_leg(dims, sum(dims))
    off_t = torch.tensor(offs, dtype=torch.int32)
    n, s = a.shape[1], dims[1] * dims[2]
    H = 2 * s + 3
    pad = lambda v, h: torch.nn.functional.pad(v, (h, h))
    for zero_guess, x in ((True, w), (False, u)):
        got = vk.fused_down_sweep_framed(offs, pad(a, H), offs, pad(m, H),
                                         pad(f, H), pad(x, H), dims, H,
                                         zero_guess)
        want = vk.fused_down_sweep_plain(off_t, a, off_t, m, f, x, dims,
                                         zero_guess)
        for g, p in zip(got if zero_guess else (got,),
                        want if zero_guess else (want,)):
            assert torch.equal(g, p)
    hp = 1
    t0 = 2 * hp * s
    cpad = hp * int(np.prod(vk.coarse_dims(dims)[1:]))
    got = vk.fused_up_sweep_framed(offs, a, offs, pad(m, t0), w, f,
                                   pad(u, t0), pad(uc, cpad), dims, hp)
    assert torch.equal(got, vk.fused_up_sweep_plain(off_t, a, off_t, m, w,
                                                    f, u, uc, dims))


# -- the halo SpMV and the distributed dot -------------------------------------

_REGIMES = {
    # name: (rows per shard, flat offsets)
    "split": (64, (-8, -3, -1, 0, 1, 3, 8)),
    "thin": (16, (-8, -1, 0, 2, 8)),          # 2w >= nl
    "gather": (4, (-9, -1, 0, 1, 6)),          # w > nl
}


@pytest.mark.parametrize("nd", [1, 2, 8])
@pytest.mark.parametrize("regime", sorted(_REGIMES))
def test_halo_mv_and_dot_match_jax(nd, regime):
    nl, offs = _REGIMES[regime]
    n = nd * nl
    rng = np.random.RandomState(nd * 10 + nl)
    data = rng.standard_normal((len(offs), n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    mesh = ref_mesh(nd)
    mv = shard_map(lambda d, v: ref_dm.dia_halo_mv(d, offs, v), mesh=mesh,
                   in_specs=(P(None, ROWS_AXIS), P(ROWS_AXIS)),
                   out_specs=P(ROWS_AXIS), check_vma=False)
    dot = shard_map(ref_dm.dist_inner_product, mesh=mesh,
                    in_specs=(P(ROWS_AXIS), P(ROWS_AXIS)), out_specs=P(),
                    check_vma=False)
    want = np.asarray(jax.jit(mv)(data, x))
    want_dot = float(jax.jit(dot)(x, y))

    pm = make_mesh(nd, device="cpu")
    got = dia_halo_mv(put_sharded(data, pm, axis=1), offs,
                      put_sharded(x, pm))
    assert [tuple(g.shape) for g in got] == [(nl,)] * nd
    _close(host_full(got), want, 1e-6)
    got_dot = dist_inner_product(put_sharded(x, pm), put_sharded(y, pm))
    assert got_dot.dim() == 0
    assert abs(float(got_dot) - want_dot) \
        <= 1e-6 * float(np.abs(x.astype(np.float64) * y).sum())


def test_halo_mv_split_runs_the_dia_spmv_interior():
    from amgcl_tpu_torch.ops import dia_kernels as dk
    nl, offs = _REGIMES["split"]
    pm = make_mesh(4, device="cpu")
    rng = np.random.RandomState(1)
    data = rng.standard_normal((len(offs), 4 * nl)).astype(np.float32)
    x = rng.standard_normal(4 * nl).astype(np.float32)
    calls = dk.dia_spmv_plain.calls
    dia_halo_mv(put_sharded(data, pm, axis=1), offs, put_sharded(x, pm))
    assert dk.dia_spmv_plain.calls == calls + 4


# -- the sharded build ---------------------------------------------------------

_BUILDS = {
    # name: (grid n, anisotropy, coarse_enough and rep_coarse_enough)
    "poisson32": (32, 1.0, 3000),
    "anisotropic16": (16, 1e-3, 300),
}


def _transfer_slabs(lv):
    """A level's M and Mᵀ slabs: its own, or the tiles of its frames
    where a leg runs framed (the level then keeps no slab of its own)."""
    fz, nl = lv.fused, int(np.prod(lv.ldims))
    mdata, mtdata = lv.mdata, lv.mtdata
    if mdata is None:
        h = 2 * fz.hp * lv.ldims[1] * lv.ldims[2]
        mdata = [m[:, h:h + nl] for m in fz.m_fr]
    if mtdata is None:
        mtdata = [m[:, fz.H:fz.H + nl] for m in fz.mt_fr]
    return mdata, mtdata


@pytest.mark.parametrize("name", sorted(_BUILDS))
def test_sharded_build_matches_jax(name):
    n, aniso, ce = _BUILDS[name]
    A_ref, _ = ref_poisson3d(n, anisotropy=aniso)
    ref_hier, ref_meta = ref_build(A_ref, ref_mesh(_NSH),
                                   RefParams(dtype=jnp.float32,
                                             coarse_enough=ce), ce)
    A, _ = T.poisson3d(n, anisotropy=aniso)
    hier, meta = dist_stencil_build(A, make_mesh(_NSH, device="cpu"),
                                    T.AMGParams(coarse_enough=ce), ce)
    assert meta == ref_meta
    assert len(hier.levels) == len(ref_hier.levels)
    if aniso != 1.0:
        assert hier.levels[0].blocks != (2, 2, 2)   # semicoarsening
    for lv, rl in zip(hier.levels, ref_hier.levels):
        assert (lv.ldims, lv.lcoarse, lv.blocks) \
            == (rl.ldims, rl.lcoarse, rl.blocks)
        assert (lv.a_flats, lv.m_flats, lv.mt_flats) \
            == (rl.a_flats, rl.m_flats, rl.mt_flats)
        nl = int(np.prod(lv.ldims))
        mdata, mtdata = _transfer_slabs(lv)
        for mine, theirs in ((lv.adata, rl.adata), (mdata, rl.mdata),
                             (mtdata, rl.mtdata), (lv.scale, rl.scale)):
            theirs = np.asarray(theirs)
            assert len(mine) == _NSH
            for j, slab in enumerate(mine):
                _close(slab, theirs[..., j * nl:(j + 1) * nl], 1e-5)
    assert hier.n_rep == ref_hier.n_rep


# -- the slice end to end ------------------------------------------------------

@pytest.fixture(scope="module")
def p32():
    A_ref, rhs = ref_poisson3d(32)
    A, _ = T.poisson3d(32)
    return A_ref, A, rhs


@pytest.mark.parametrize("nd", [4, 8])
def test_solver_matches_jax(p32, nd):
    A_ref, A, rhs = p32
    ref = RefSolver(A_ref, ref_mesh(nd), RefParams(dtype=jnp.float32),
                    RefCG(maxiter=100, tol=1e-6))
    x_ref, info_ref = ref(rhs)
    s = DistStencilSolver(A, make_mesh(nd, device="cpu"), T.AMGParams(),
                          T.CG(maxiter=100, tol=1e-6))
    assert s.meta == [32768, 4096, 512]
    framed = [lv.fused is not None and lv.fused.down_ok
              and lv.fused.up_ok for lv in s.hier.levels]
    # the slabs' L1 at 8 shards is 2 planes thin: its halo exceeds it
    assert framed == ([True, True] if nd == 4 else [True, False])
    calls = (vk.fused_down_sweep_framed_plain.calls,
             vk.fused_up_sweep_framed_plain.calls)
    x, info = s(rhs)
    assert info.iters == info_ref.iters == 9
    per_cycle = nd * sum(framed)
    assert (vk.fused_down_sweep_framed_plain.calls - calls[0],
            vk.fused_up_sweep_framed_plain.calls - calls[1]) \
        == (per_cycle * info.iters,) * 2
    assert info.solver == "dist_stencil_cg"
    assert info.extra == {"shards": nd, "devices": 1}
    assert x.dtype == torch.float32 and x.shape == (A.nrows,)
    x_ref = np.asarray(x_ref, np.float64)
    assert np.linalg.norm(x.double().numpy() - x_ref) \
        <= 1e-4 * np.linalg.norm(x_ref)
    true = np.linalg.norm(rhs - A.spmv(x.double().numpy())) \
        / np.linalg.norm(rhs)
    assert info.resid <= 1e-6 and true <= 1e-4


def test_warm_start_matches_jax(p32):
    A_ref, A, rhs = p32
    ref = RefSolver(A_ref, ref_mesh(4), RefParams(dtype=jnp.float32),
                    RefCG(maxiter=100, tol=1e-6))
    x_ref, _ = ref(rhs)
    _, warm_ref = ref(rhs, x0=x_ref)
    s = DistStencilSolver(A, make_mesh(4, device="cpu"), T.AMGParams(),
                          T.CG(maxiter=100, tol=1e-6))
    x, info = s(rhs)
    x2, warm = s(rhs, x0=x)
    assert warm.iters == warm_ref.iters and warm.iters <= 2 < info.iters
    assert np.linalg.norm(x2.double().numpy() - x.double().numpy()) \
        <= 1e-4 * np.linalg.norm(x.double().numpy())


def _reference_gates(a, m, mt, ldims, lcoarse, npre=1):
    """The JAX package's framed-level eligibility
    (``amgcl_tpu/parallel/dist_stencil.py::_build_fused_slab``, its lines
    85-104: the structural gates, the TPU's lane packing and 512-row
    planes, and its VMEM cap), before its compile probe and value check."""
    lz, d1, d0 = ldims
    k = 128 // d0 if d0 and 128 % d0 == 0 else 0
    s = d1 * d0
    if (not k) or d0 % 2 or d1 % 2 or (k > 1 and d1 % k) or s % 512 \
            or lz % 2 or lz < 2:
        return False, False
    H, _, vmem_dn = pv.down_geometry(a, mt, ldims)
    hp, _, vmem_up = pv.up_geometry(a, m, ldims)
    return (npre == 1 and H <= lz * s
            and vmem_dn * 4 <= pv._VMEM_CAP_BYTES,
            hp <= 2 and hp <= lcoarse[0] and hp * 2 * s <= lz * s
            and vmem_up * 4 <= pv._VMEM_CAP_BYTES)


def test_s1_framed_choice_matches_the_reference_gates():
    """On S1's geometry (poisson3d(128) over four shards: slabs of
    (32, 128, 128) and (16, 64, 64)) the port frames both legs at both
    sharded levels, and the reference's gates do too. The levels'
    stencils are poisson3d(32)'s over four shards, whose grids hold every
    offset, placed on S1's grids. On poisson3d(32)'s own L1 (planes of
    256 rows) the two part: the port frames it, the reference does not."""
    from amgcl_tpu_torch.ops.stencil import _decompose_offsets, _flat
    from amgcl_tpu_torch.parallel.dist_stencil import framed_geometry
    A, _ = T.poisson3d(32)
    hier, _ = dist_stencil_build(A, make_mesh(4, device="cpu"),
                                 T.AMGParams())
    s1 = [(128, (32, 128, 128), (16, 64, 64)), (64, (16, 64, 64),
                                                  (8, 32, 32))]
    for lv, (g, ld, lc) in zip(hier.levels, s1):
        dims = (4 * lv.ldims[0],) + lv.ldims[1:]
        o3 = _decompose_offsets(sorted(set(lv.a_flats + lv.m_flats
                                           + lv.mt_flats)), dims)
        a, m, mt = ([_flat(o3[f], (g, g, g)) for f in fl] for fl in
                    (lv.a_flats, lv.m_flats, lv.mt_flats))
        assert framed_geometry(a, m, mt, ld, lc, lv.blocks)[:2] \
            == _reference_gates(a, m, mt, ld, lc) == (True, True)
    lv = hier.levels[1]
    assert framed_geometry(lv.a_flats, lv.m_flats, lv.mt_flats, lv.ldims,
                           lv.lcoarse, lv.blocks)[:2] == (True, True)
    assert _reference_gates(lv.a_flats, lv.m_flats, lv.mt_flats, lv.ldims,
                            lv.lcoarse) == (False, False)


@pytest.mark.parametrize("npre,npost,legs", [(1, 1, (True, True)),
                                              (2, 1, (False, True)),
                                              (1, 0, (True, False))])
def test_framed_legs_follow_the_cycle_shape(npre, npost, legs):
    """The down leg runs framed only with npre == 1, the up leg only with
    npost ≥ 1; a level keeps M's and Mᵀ's slabs only for a leg that it
    composes. Each cycle shape solves as the JAX solver does."""
    A_ref, rhs = ref_poisson3d(16)
    A, _ = T.poisson3d(16)
    s = DistStencilSolver(A, make_mesh(4, device="cpu"),
                          T.AMGParams(npre=npre, npost=npost),
                          T.CG(maxiter=100, tol=1e-6))
    lv = s.hier.levels[0]
    assert (lv.fused.down_ok, lv.fused.up_ok) == legs
    assert (lv.mtdata is None, lv.mdata is None) == legs
    x, info = s(rhs)
    ref = RefSolver(A_ref, ref_mesh(4), RefParams(dtype=jnp.float32,
                                                  npre=npre, npost=npost),
                    RefCG(maxiter=100, tol=1e-6))
    x_ref, info_ref = ref(rhs)
    assert info.iters == info_ref.iters
    x_ref = np.asarray(x_ref, np.float64)
    assert np.linalg.norm(x.double().numpy() - x_ref) \
        <= 1e-4 * np.linalg.norm(x_ref)


def test_zero_rhs_and_wrong_size(p32):
    _, A, rhs = p32
    s = DistStencilSolver(A, make_mesh(4, device="cpu"), T.AMGParams(),
                          T.CG(maxiter=100, tol=1e-6))
    x, info = s(np.zeros_like(rhs))
    assert info.iters == 0 and not torch.any(x)
    with pytest.raises(ValueError, match="unknowns"):
        s(rhs[:-1])


def test_refusals():
    from amgcl_tpu_torch.ops.unstructured import fe_like_problem
    mesh = make_mesh(_NSH, device="cpu")
    A12, _ = T.poisson3d(12)                      # 12 % 16 != 0
    with pytest.raises(ValueError, match="sharded stencil path"):
        DistStencilSolver(A12, mesh, T.AMGParams())
    Au, _ = fe_like_problem(n=2048, nnz_target=30_000, seed=7)
    assert dist_stencil_build(Au, mesh, T.AMGParams(), 600) is None
    with pytest.raises(ValueError, match="sharded stencil path"):
        DistStencilSolver(Au, mesh, T.AMGParams())
    A32, _ = T.poisson3d(32)
    with pytest.raises(ValueError, match="float32"):
        DistStencilSolver(A32, mesh, T.AMGParams(dtype=torch.float64))
    # Gauss-Seidel and bfloat16 decline as the JAX package's same calls
    # do; so does an object the port does not know as a smoother (the
    # JAX package's damped Jacobi)
    from amgcl_tpu.relaxation.gauss_seidel import GaussSeidel as RefGS
    A32_r = RefCSR(A32.ptr, A32.col, A32.val, A32.ncols)
    for prm, prm_r in ((T.AMGParams(relax=T.GaussSeidel()),
                        RefParams(relax=RefGS())),
                       (T.AMGParams(dtype=torch.bfloat16),
                        RefParams(dtype=jnp.bfloat16)),
                       (T.AMGParams(relax=DampedJacobi()), None)):
        assert dist_stencil_build(A32, mesh, prm, 600) is None
        with pytest.raises(ValueError, match="sharded stencil path"):
            DistStencilSolver(A32, mesh, prm)
        if prm_r is not None:
            with pytest.raises(ValueError,
                               match="sharded stencil fast path"):
                RefSolver(A32_r, ref_mesh(_NSH), prm_r)


def test_mesh():
    m = make_mesh(3, device="cpu")
    assert m.size == 3
    assert all(d.type == "cpu" for d in m.devices)
    a = np.arange(24, dtype=np.float32).reshape(2, 12)
    slabs = put_sharded(a, m, axis=1)
    assert [tuple(s.shape) for s in slabs] == [(2, 4)] * 3
    assert np.array_equal(host_full(slabs, axis=1), a)
    slabs[0][0, 0] = -1.0                 # the slabs share no memory with a
    assert a[0, 0] == 0
    with pytest.raises(ValueError):
        put_sharded(np.arange(10), m)
    if torch.cuda.is_available():
        assert make_mesh(2).devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(2)
