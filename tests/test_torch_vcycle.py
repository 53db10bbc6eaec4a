"""The port's fused V-cycle legs (``amgcl_tpu_torch/ops/vcycle.py`` and
``ops/vcycle_kernels.py``) against the JAX package's Pallas kernels
``fused_down_sweep`` / ``fused_up_sweep`` run in interpret mode, at that
package's own small fixtures (``tests/test_pallas_vcycle.py``): 4×8×128
grids, odd z, packed lanes, a two-plane halo and asymmetric offsets. On
the CPU the port's wrappers run their plain versions, on the JAX level's
own operators carried across with ``convert.level_from_arrays``. Then the
whole slice, fused legs attached, against the JAX package.

Tolerances: rtol 2e-5 / atol 2e-5 in float32, as the reference's own
tests of these kernels use; the two sides sum in different orders."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.solver.cg import CG as RefCG

import amgcl_tpu_torch as T
from amgcl_tpu_torch.convert import level_from_arrays
from amgcl_tpu_torch.ops import vcycle_kernels as vk


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS, OpenMP and torch thread while this module runs: its
    small problems gain nothing from threads, and the test suite's
    parallel workers would oversubscribe the cores (a dense coarse
    inverse or product in several workers at once then runs many times
    slower)."""
    from threadpoolctl import threadpool_limits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


_TOL = dict(rtol=2e-5, atol=2e-5)


def grid_laplacian(d2, d1, d0):
    """7-point Laplacian on a (d2, d1, d0) C-order grid, as scipy CSR."""
    def lap(n):
        e = np.ones(n)
        return sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1], format="csr")
    eye = sp.identity
    A = (sp.kron(eye(d2), sp.kron(eye(d1), lap(d0)))
         + sp.kron(eye(d2), sp.kron(lap(d1), eye(d0)))
         + sp.kron(lap(d2), sp.kron(eye(d1), eye(d0)))).tocsr()
    A.sort_indices()
    return A


def _np(a):
    return np.asarray(a, dtype=np.float32)


def port_level(ref_lv):
    """The JAX level's operators as numpy, rebuilt as the port's Level
    with the port's own fused handles."""
    row = {"A": (ref_lv.A.offsets, _np(ref_lv.A.data)),
           "M": (ref_lv.P.M.offsets, _np(ref_lv.P.M.data)),
           "Mt": (ref_lv.R.Mt.offsets, _np(ref_lv.R.Mt.data)),
           "fine": ref_lv.P.T.fine, "block": ref_lv.P.T.block,
           "scale": _np(ref_lv.relax.scale)}
    return level_from_arrays(row, torch.float32, "cpu")


# (fine dims, level, coarse_enough): the reference's fixtures
_FIXTURES = {
    "4x8x128": ((4, 8, 128), 0, 200),
    "odd_z": ((5, 8, 128), 0, 200),
    "packed_4x8x64": ((4, 8, 64), 0, 100),
    "packed_4x32x32": ((4, 32, 32), 0, 100),
    "two_plane_halo": ((8, 32, 64), 1, 100),
}


@pytest.fixture(scope="module", params=sorted(_FIXTURES))
def levels(request):
    """(name, JAX level with its interpret-mode handles, the port's)."""
    dims, level, coarse_enough = _FIXTURES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AMGCL_TPU_PALLAS_INTERPRET", "1")
        amg = RefAMG(RefCSR.from_scipy(grid_laplacian(*dims)),
                     RefParams(dtype=jnp.float32,
                               coarse_enough=coarse_enough))
    ref = amg.hierarchy.levels[level]
    assert ref.down is not None, "reference built no fused down handle"
    return request.param, ref, port_level(ref)


def _vectors(ref, seed):
    rng = np.random.RandomState(seed)
    n, nc = ref.A.shape[0], ref.R.shape[0]
    return (rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32),
            rng.rand(nc).astype(np.float32))


def test_fused_down_matches_jax(levels):
    name, ref, lv = levels
    f, u, _ = _vectors(ref, 0)
    assert lv.down is not None and lv.down.w is not None
    calls = vk.fused_down_sweep_plain.calls
    got = lv.down(torch.as_tensor(f), torch.as_tensor(u))
    assert vk.fused_down_sweep_plain.calls == calls + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.down(
        jnp.asarray(f), jnp.asarray(u))), **_TOL)


def test_fused_down_zero_guess_matches_jax(levels):
    name, ref, lv = levels
    f, _, _ = _vectors(ref, 1)
    u_ref, fc_ref = ref.down.zero(jnp.asarray(f))
    u, fc = lv.down.zero(torch.as_tensor(f))
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), **_TOL)
    np.testing.assert_allclose(fc.numpy(), np.asarray(fc_ref), **_TOL)


def test_fused_up_matches_jax(levels):
    name, ref, lv = levels
    f, u, uc = _vectors(ref, 2)
    if name == "odd_z":
        # odd f2: neither package builds the up leg
        assert ref.up is None and lv.up is None
        return
    assert ref.up is not None and lv.up is not None
    assert lv.up.halo_planes == ref.up.halo_planes
    if name == "two_plane_halo":
        assert lv.up.halo_planes == 2
    got = lv.up(torch.as_tensor(f), torch.as_tensor(u), torch.as_tensor(uc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.up(
        jnp.asarray(f), jnp.asarray(u), jnp.asarray(uc))), **_TOL)


_ASYMMETRIC = [
    ((-1024, -128, -1, 0), (-1024, 0, 1, 128)),       # one-sided reach
    ((0, 1, 128, 1024), (-1024, -128, -1, 0, 1)),     # opposite skews
    ((-2048, 0, 2048), (-1024, 0, 1024)),             # |dz| = 2 coupling
]


def _asymmetric_operands(offs_a, offs_m, seed):
    dims = (4, 8, 128)
    n = int(np.prod(dims))
    rng = np.random.RandomState(seed)
    Ad = rng.rand(len(offs_a), n).astype(np.float32)
    Md = rng.rand(len(offs_m), n).astype(np.float32)
    f, u, w = (rng.rand(n).astype(np.float32) for _ in range(3))
    uc = rng.rand(n // 8).astype(np.float32)
    return dims, Ad, Md, f, u, w, uc


def _t(offsets, *arrays):
    return (torch.tensor(offsets, dtype=torch.int32),) \
        + tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("offs_a,offs_m", _ASYMMETRIC)
def test_fused_down_asymmetric_offsets_match_jax(offs_a, offs_m):
    """The reference's direct kernel call on asymmetric diagonal sets,
    which the symmetric Laplacian fixtures never stress."""
    from amgcl_tpu.ops.pallas_vcycle import (_pair_sum, down_geometry,
                                             fused_down_sweep)
    dims, Ad, Md, f, u, _, _ = _asymmetric_operands(offs_a, offs_m, 11)
    f2, f1, f0 = dims
    coarse = (f2 // 2, f1 // 2, f0 // 2)
    s, n = f1 * f0, f2 * f1 * f0
    H, _, _ = down_geometry(offs_a, offs_m, dims)
    L = 2 * coarse[0] * s + 2 * H
    frame = lambda D: jnp.asarray(np.concatenate(
        [np.pad(D[k], (H, L - H - n)) for k in range(len(D))]))
    want = np.asarray(fused_down_sweep(
        frame(Ad), frame(Md), _pair_sum(coarse[1], f1, jnp.float32),
        _pair_sum(coarse[2], f0, jnp.float32).T, jnp.asarray(f),
        jnp.asarray(u), tuple(offs_a), tuple(offs_m), dims, coarse, H,
        interpret=True)).ravel()
    oa, ad = _t(offs_a, Ad)
    om, md = _t(offs_m, Md)
    got = vk.fused_down_sweep(oa, ad, om, md, torch.as_tensor(f),
                              torch.as_tensor(u), dims)
    np.testing.assert_allclose(got.numpy(), want, **_TOL)


@pytest.mark.parametrize("offs_a,offs_m", _ASYMMETRIC)
def test_fused_up_asymmetric_offsets_match_jax(offs_a, offs_m):
    from amgcl_tpu.ops.pallas_vcycle import (_pair_sum, fused_up_sweep,
                                             up_geometry)
    dims, Ad, Md, f, u, w, uc = _asymmetric_operands(offs_a, offs_m, 12)
    f2, f1, f0 = dims
    coarse = (f2 // 2, f1 // 2, f0 // 2)
    s, n = f1 * f0, f2 * f1 * f0
    hp, _, _ = up_geometry(offs_a, offs_m, dims)
    m_flat = jnp.asarray(np.pad(Md, ((0, 0), (2 * hp * s, 2 * hp * s)))
                         .reshape(-1))
    rc3p = jnp.asarray(np.pad(uc.reshape(coarse), ((hp, hp), (0, 0),
                                                   (0, 0))))
    want = np.asarray(fused_up_sweep(
        jnp.asarray(Ad), m_flat, _pair_sum(coarse[1], f1, jnp.float32).T,
        _pair_sum(coarse[2], f0, jnp.float32), rc3p, jnp.asarray(f),
        jnp.asarray(w), jnp.asarray(u), tuple(offs_a), tuple(offs_m), dims,
        coarse, halo_planes=hp, interpret=True))
    oa, ad = _t(offs_a, Ad)
    om, md = _t(offs_m, Md)
    got = vk.fused_up_sweep(oa, ad, om, md, torch.as_tensor(w),
                            torch.as_tensor(f), torch.as_tensor(u),
                            torch.as_tensor(uc), dims)
    np.testing.assert_allclose(got.numpy(), want, **_TOL)


def test_fused_handles_skip_float64_and_attach_to_float32():
    """Float64 hierarchies keep the composed legs, as in the reference;
    a float32 one gets both handles at its stencil levels."""
    A = T.CSR.from_scipy(grid_laplacian(4, 8, 16))
    for dtype, attached in ((torch.float64, False), (torch.float32, True)):
        amg = T.AMG(A, T.AMGParams(dtype=dtype, coarse_enough=50),
                    device="cpu")
        lv = amg.hierarchy.levels[0]
        assert (lv.down is not None) == (lv.up is not None) == attached


def test_whole_slice_with_fused_legs_matches_jax(monkeypatch):
    """The port's make_solver on the CPU, fused legs attached, against the
    JAX package with its fused legs in interpret mode: equal level shapes
    and CG iteration counts, true residual within the tolerance."""
    monkeypatch.setenv("AMGCL_TPU_PALLAS_INTERPRET", "1")
    A = grid_laplacian(4, 8, 128)
    rhs = np.ones(A.shape[0])
    ref = ref_make_solver(RefCSR.from_scipy(A),
                          RefParams(dtype=jnp.float32, coarse_enough=200),
                          RefCG(tol=1e-6, maxiter=40))
    assert ref.precond.hierarchy.levels[0].up is not None
    _, info_r = ref(rhs)
    solve = T.make_solver(T.CSR.from_scipy(A),
                          T.AMGParams(dtype=torch.float32,
                                      coarse_enough=200),
                          T.CG(tol=1e-6, maxiter=40), device="cpu")
    lv0 = solve.precond.hierarchy.levels[0]
    assert lv0.down is not None and lv0.up is not None
    assert [h[0].nrows for h in solve.precond.host_levels] \
        == [h[0].nrows for h in ref.precond.host_levels]
    calls = (vk.fused_down_sweep_plain.calls, vk.fused_up_sweep_plain.calls)
    x, info = solve(rhs)
    assert vk.fused_down_sweep_plain.calls > calls[0]
    assert vk.fused_up_sweep_plain.calls > calls[1]
    assert info.iters == info_r.iters
    x = x.double().numpy()
    assert np.linalg.norm(rhs - A @ x) / np.linalg.norm(rhs) < 1e-5


@pytest.mark.parametrize("n", [24, 32])
def test_fused_and_composed_cycles_take_the_same_iterations(n):
    A, rhs = T.poisson3d(n)
    prm = T.AMGParams(dtype=torch.float32)
    fused = T.make_solver(A, prm, T.CG(tol=1e-6), device="cpu")
    composed = T.make_solver(A, prm, T.CG(tol=1e-6), device="cpu")
    assert fused.precond.hierarchy.levels[0].down is not None
    for lv in composed.precond.hierarchy.levels:
        lv.down = lv.up = None
    _, i1 = fused(rhs)
    _, i2 = composed(rhs)
    assert i1.iters == i2.iters
