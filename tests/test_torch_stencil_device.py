"""The port's device-resident stencil setup (``ops/stencil_device.py``,
``AMG(..., device_setup=True)``) against the JAX package's
``device_build`` (``AMGCL_TPU_DEVICE_SETUP=1``), on the CPU at small
sizes: level shapes and offsets, the level operators A, M, Mᵀ and the
SPAI-0 scale, the hybrid hand-off to the host loop, semicoarsening under
anisotropy, the float64 refusal, a smoothed coarsest level, and the
port's device build against its own host build.

The two packages sum the diagonal-pair products in different orders in
float32, so operators agree within 2e-5 scaled by the largest entry of
the reference's operator (as ``tests/test_stencil_device.py`` compares
the device build with the host build), not bit for bit."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.utils.sample_problem import poisson3d as ref_poisson3d

import amgcl_tpu_torch as T


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


_RTOL = 2e-5


@pytest.fixture
def ref_device_setup(monkeypatch):
    monkeypatch.setenv("AMGCL_TPU_DEVICE_SETUP", "1")


def _builds(n, anisotropy=1.0, **kw):
    """(JAX device-built AMG, the port's device-built AMG, port CSR)."""
    A_ref, _ = ref_poisson3d(n, anisotropy=anisotropy)
    ref = RefAMG(A_ref, RefParams(dtype=jnp.float32, **kw))
    A, _ = T.poisson3d(n, anisotropy=anisotropy)
    port = T.AMG(A, T.AMGParams(dtype=torch.float32, **kw), device="cpu",
                 device_setup=True)
    return ref, port, A


def _close_dia(got, want):
    """Same offsets; entries within 2e-5 of the largest reference entry."""
    assert got.offsets == want.offsets
    want = np.asarray(want.data, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got.data.double().numpy() - want).max() <= _RTOL * scale


@pytest.mark.parametrize("n", [20, 24])
def test_device_build_matches_jax(ref_device_setup, n):
    ref, port, A = _builds(n)
    assert ref._device_built and port.device_built
    assert port.host_levels[0][0] is A
    assert [h[0].nrows for h in port.host_levels] \
        == [h[0].nrows for h in ref.host_levels]
    assert [h[0].nnz for h in port.host_levels] \
        == [h[0].nnz for h in ref.host_levels]
    levels, ref_levels = port.hierarchy.levels, ref.hierarchy.levels
    assert len(levels) == len(ref_levels) >= 2
    for lv, rl in zip(levels[:-1], ref_levels[:-1]):
        _close_dia(lv.A, rl.A)
        _close_dia(lv.P.M, rl.P.M)
        _close_dia(lv.R.Mt, rl.R.Mt)
        assert lv.P.T.fine == rl.P.T.fine and lv.P.T.block == rl.P.T.block
        want = np.asarray(rl.relax.scale, np.float64)
        assert np.abs(lv.relax.scale.double().numpy() - want).max() \
            <= _RTOL * np.abs(want).max()
        assert lv.down is not None and lv.up is not None
    _close_dia(levels[-1].A, ref_levels[-1].A)
    inv, ref_inv = port.hierarchy.coarse.inv, ref.hierarchy.coarse.inv
    np.testing.assert_allclose(inv.double().numpy(), np.asarray(ref_inv),
                               rtol=0, atol=1e-4 * np.abs(ref_inv).max())


def test_hybrid_continuation_matches_jax(ref_device_setup):
    """40³ coarsens 40 → 20 → 10 → 5: the level-2 stencil has more than 34
    diagonals, so both packages hand it to the host loop, carrying its
    grid dims and the decayed eps_strong."""
    ref, port, _ = _builds(40, coarse_enough=50)
    assert len(port._dev_prefix) == len(ref._dev_prefix) == 2
    assert len(port.hierarchy.levels) == len(ref.hierarchy.levels)
    assert [h[0].nrows for h in port.host_levels] \
        == [h[0].nrows for h in ref.host_levels]
    leftover = port.host_levels[2][0]
    assert leftover._grid_dims == (10, 10, 10)
    for lv, rl in zip(port.hierarchy.levels[2:-1],
                      ref.hierarchy.levels[2:-1]):
        assert type(lv.A).__name__ == type(rl.A).__name__
        assert lv.A.shape == rl.A.shape
    split = port.setup_split
    assert split["device_build_s"] > 0 and split["host_s"] > 0
    assert "Number of levels:    5" in repr(port)


@pytest.mark.parametrize("aniso", [0.1, 1e-3])
def test_anisotropic_semicoarsening_matches_jax(ref_device_setup, aniso):
    """The speculation check reruns a level with the measured strong axes:
    the device build stays on the device and gives the reference's level
    sizes and the port's host-build iteration count."""
    ref, port, A = _builds(16, anisotropy=aniso)
    assert ref._device_built and port.device_built
    assert [h[0].nrows for h in port.host_levels] \
        == [h[0].nrows for h in ref.host_levels]
    assert port.hierarchy.levels[0].P.T.block \
        == ref.hierarchy.levels[0].P.T.block
    _, rhs = T.poisson3d(16, anisotropy=aniso)
    iters = []
    for device_setup in (True, False):
        solve = T.make_solver(A, T.AMGParams(dtype=torch.float32),
                              T.CG(maxiter=100, tol=1e-6), device="cpu",
                              device_setup=device_setup)
        assert solve.precond.device_built == device_setup
        x, info = solve(rhs)
        iters.append(info.iters)
        r = rhs - A.spmv(x.double().numpy())
        assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-5
    assert iters[0] == iters[1] < 60


def test_float64_declines_the_device_build(ref_device_setup):
    A_ref, _ = ref_poisson3d(12)
    assert not RefAMG(A_ref, RefParams(dtype=jnp.float64))._device_built
    A, _ = T.poisson3d(12)
    amg = T.AMG(A, T.AMGParams(dtype=torch.float64), device="cpu",
                device_setup=True)
    assert not amg.device_built
    assert amg.setup_split["device_build_s"] == 0.0
    # on the CPU the default is the host build
    assert not T.AMG(A, T.AMGParams(), device="cpu").device_built


@pytest.mark.parametrize("n,kw", [(24, {}), (40, {"coarse_enough": 50})])
def test_device_and_host_builds_take_the_same_iterations(n, kw):
    A, rhs = T.poisson3d(n)
    runs = []
    for device_setup in (True, False):
        solve = T.make_solver(A, T.AMGParams(dtype=torch.float32, **kw),
                              T.CG(maxiter=100, tol=1e-6), refine=3,
                              device="cpu", device_setup=device_setup)
        assert solve.precond.device_built == device_setup
        x, info = solve(rhs)
        runs.append((info.iters,
                     [h[0].nrows for h in solve.precond.host_levels]))
        r = rhs - A.spmv(x.numpy())
        assert np.linalg.norm(r) / np.linalg.norm(rhs) <= 1e-6
    assert runs[0] == runs[1]


def test_smoothed_coarsest_level_matches_jax(ref_device_setup):
    """direct_coarse=False: the coarsest level gets an SPAI-0 smoother
    computed from the fetched data instead of a direct solver."""
    ref, port, A = _builds(16, direct_coarse=False)
    assert port.device_built and port.hierarchy.coarse is None
    last, ref_last = port.hierarchy.levels[-1], ref.hierarchy.levels[-1]
    _close_dia(last.A, ref_last.A)
    want = np.asarray(ref_last.relax.scale, np.float64)
    np.testing.assert_allclose(last.relax.scale.double().numpy(), want,
                               rtol=_RTOL)
    _, rhs = T.poisson3d(16)
    solve = T.make_solver(A, T.AMGParams(direct_coarse=False),
                          T.CG(maxiter=300, tol=1e-6), device="cpu",
                          device_setup=True)
    x, info = solve(rhs)
    r = rhs - A.spmv(x.double().numpy())
    assert info.iters < 300 and np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-5
