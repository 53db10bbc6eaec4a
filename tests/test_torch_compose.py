"""The compositions of A.9 against the JAX package: make_solver's
solver_dtype, matrix_format, prebuilt preconditioner and df32
refinement, CG's ns_search and verbose, AMG.rebuild and
make_solver.rebuild, the Schur pressure correction, CPR, deflation and
the block solver; and phase 11 of chip_smoke.py at small sizes."""

import importlib.util
import pathlib
import re
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from amgcl_tpu.models import cpr as ref_cpr
from amgcl_tpu.models import schur as ref_schur
from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.block_solver import make_block_solver as ref_block
from amgcl_tpu.models.deflated import deflated_solver as ref_deflated
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops import dfloat as ref_df
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.solver.bicgstab import BiCGStab as RefBiCGStab
from amgcl_tpu.solver.cg import CG as RefCG
from amgcl_tpu.solver.gmres import FGMRES as RefFGMRES
from tests.test_coupled import wells_reservoir

import amgcl_tpu_torch as T
from amgcl_tpu_torch.ops import device as tdev
from amgcl_tpu_torch.ops import dfloat as df
from amgcl_tpu_torch.ops.device import DiaMatrix, EllMatrix
from amgcl_tpu_torch.ops.unstructured import WindowedEllMatrix


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


F64 = dict(dtype=torch.float64)
CPU = dict(device="cpu")


def _ref(A):
    return RefCSR(A.ptr, A.col, A.val, A.ncols)


def _true(A, rhs, x):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


# -- make_solver's arguments -------------------------------------------------

def test_solver_dtype_float64_matches_jax():
    """A float32 hierarchy inside a float64 CG loop (tests/test_amg.py:86,
    examples/mixed_precision.cpp): the JAX package's count, and a float64
    Krylov operator apart from the hierarchy's."""
    A, rhs = T.poisson3d(16)
    _, info_r = ref_make_solver(_ref(A), RefParams(dtype=jnp.float32),
                                RefCG(maxiter=200, tol=1e-8),
                                solver_dtype=jnp.float64)(rhs)
    solve = T.make_solver(A, T.AMGParams(), T.CG(maxiter=200, tol=1e-8),
                          solver_dtype=torch.float64, **CPU)
    x, info = solve(rhs)
    assert info.iters == info_r.iters
    assert x.dtype == torch.float64 and info.resid < 1e-8
    assert _true(A, rhs, x.numpy()) < 1e-7
    assert isinstance(solve.A_dev, DiaMatrix)
    assert solve.A_dev.dtype == torch.float64
    assert solve.A_dev is not solve.precond.hierarchy.system_matrix


@pytest.mark.parametrize("fmt,cls", [("ell", EllMatrix),
                                     ("well", WindowedEllMatrix)])
def test_matrix_format_converts_the_krylov_operator(fmt, cls):
    """matrix_format other than auto converts A (no alias) and leaves
    the iterations as they are."""
    A, rhs = T.poisson3d(12)
    prm = T.AMGParams(coarse_enough=300, **F64)
    _, info0 = T.make_solver(A, prm, T.CG(tol=1e-8), **CPU)(rhs)
    solve = T.make_solver(A, prm, T.CG(tol=1e-8), matrix_format=fmt, **CPU)
    x, info = solve(rhs)
    assert isinstance(solve.A_dev, cls)
    assert solve.A_dev is not solve.precond.hierarchy.system_matrix
    assert info.iters == info0.iters
    np.testing.assert_allclose(info.resid, info0.resid, rtol=1e-8)


def test_prebuilt_amg_gives_the_same_count():
    A, rhs = T.poisson3d(12)
    prm = T.AMGParams(coarse_enough=300, **F64)
    _, info0 = T.make_solver(A, prm, T.CG(tol=1e-8), **CPU)(rhs)
    amg = T.AMG(A, prm, **CPU)
    solve = T.make_solver(A, amg, T.CG(tol=1e-8), **CPU)
    x, info = solve(rhs)
    assert solve.precond is amg and info.iters == info0.iters
    assert solve.A_dev is not amg.hierarchy.system_matrix
    assert info.resid < 1e-8


@pytest.mark.parametrize("kw,exc,match", [
    (dict(batch=-1), ValueError, "batch"),
    (dict(recovery=True), NotImplementedError, "A.13"),
    (dict(refine_dtype="float16"), ValueError, "refine_dtype"),
    (dict(solver_dtype=torch.float16), NotImplementedError, "A.15"),
    (dict(solver_dtype=torch.complex64), NotImplementedError, "complex"),
])
def test_make_solver_refusals(kw, exc, match):
    A, _ = T.poisson3d(6)
    with pytest.raises(exc, match=match):
        T.make_solver(A, T.AMGParams(**F64), T.CG(), **kw, **CPU)


def test_prebuilt_preconditioner_on_another_device_raises():
    A, _ = T.poisson3d(6)
    amg = T.AMG(A, T.AMGParams(**F64), **CPU)
    with pytest.raises(ValueError, match="lives on cpu"):
        T.make_solver(A, amg, T.CG(), device="meta")
    with pytest.raises(TypeError, match="hierarchy"):
        T.make_solver(A, object(), T.CG(), **CPU)


# -- df32 refinement ---------------------------------------------------------

def test_error_free_transforms_match_jax():
    """two_sum, two_prod and df_add_vec give the JAX package's bits and
    are exact: the pair sums to the float64 result."""
    rng = np.random.RandomState(0)
    a = (rng.randn(4000) * 10.0 ** rng.randint(-8, 8, 4000)) \
        .astype(np.float32)
    b = (rng.randn(4000) * 10.0 ** rng.randint(-8, 8, 4000)) \
        .astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name, exact in (("two_sum", a.astype(np.float64) + b),
                        ("two_prod", a.astype(np.float64) * b)):
        got = getattr(df, name)(ta, tb)
        ref = getattr(ref_df, name)(ja, jb)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        s, e = (g.numpy().astype(np.float64) for g in got)
        np.testing.assert_array_equal(s + e, exact)
    lo = (a * np.float32(1e-9)).astype(np.float32)
    got = df.df_add_vec(ta, torch.as_tensor(lo), tb)
    ref = ref_df.df_add_vec(ja, jnp.asarray(lo), jb)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    hi, low = df.df_decompose(a.astype(np.float64) / 3.0)
    np.testing.assert_allclose(hi.astype(np.float64) + low,
                               a.astype(np.float64) / 3.0, rtol=1e-14)


def test_dia_residual_df_matches_jax_and_beats_float32():
    """The compensated residual equals the JAX package's bit for bit and
    recovers a totally cancelled residual that plain float32 misses."""
    A, _ = T.poisson3d(16)
    solve = T.make_solver(A, T.AMGParams(), T.CG(), refine=1,
                          refine_dtype="df32", **CPU)
    hi, lo = solve.A_dev, solve.A_dev64
    x32 = np.random.RandomState(1).rand(A.nrows).astype(np.float32)
    ax = A.spmv(x32.astype(np.float64))
    b32 = ax.astype(np.float32)
    r64 = b32 - ax
    zeros = np.zeros(A.nrows, np.float32)
    got = df.dia_residual_df(hi.offsets, hi.data, lo.data,
                             torch.as_tensor(b32), torch.as_tensor(zeros),
                             torch.as_tensor(x32), torch.as_tensor(zeros))
    ref = ref_df.dia_residual_df(
        hi.offsets, jnp.asarray(hi.data.numpy()), jnp.asarray(lo.data.numpy()),
        jnp.asarray(b32), jnp.asarray(zeros), jnp.asarray(x32),
        jnp.asarray(zeros))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    plain = T.ops.device.residual(torch.as_tensor(b32), hi,
                                  torch.as_tensor(x32))
    err_df = np.linalg.norm(got.numpy() - r64)
    err_f32 = np.linalg.norm(plain.numpy() - r64)
    assert err_df < 1e-2 * err_f32


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_df32_refinement_matches_jax(solver):
    A, rhs = T.poisson3d(16)
    mk_ref = {"cg": RefCG, "bicgstab": RefBiCGStab}[solver]
    mk = {"cg": T.CG, "bicgstab": T.BiCGStab}[solver]
    ref = ref_make_solver(_ref(A), RefParams(dtype=jnp.float32),
                          mk_ref(maxiter=100, tol=1e-6), refine=3,
                          refine_dtype="df32")
    _, info_r = ref(rhs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        solve = T.make_solver(A, T.AMGParams(), mk(maxiter=100, tol=1e-6),
                              refine=3, refine_dtype="df32", **CPU)
        x, info = solve(rhs)
    assert ref.refine_mode == solve.refine_mode == "df32"
    assert info.iters == info_r.iters
    assert x.dtype == torch.float64 and _true(A, rhs, x.numpy()) <= 1e-6
    # the reported residual is the compensated one: the host float64
    # residual's to a relative 1e-3, or to df32's reach near 1e-12
    np.testing.assert_allclose(info.resid, _true(A, rhs, x.numpy()),
                               rtol=1e-3, atol=1e-13)


def test_df32_refuses_what_it_cannot_pair():
    A, _ = T.poisson3d(8)
    for kw in (dict(matrix_format="ell"), dict(solver_dtype=torch.float64)):
        with pytest.raises(ValueError, match="float32 DIA"):
            T.make_solver(A, T.AMGParams(), T.CG(), refine=1,
                          refine_dtype="df32", **kw, **CPU)


# -- CG's ns_search and verbose ----------------------------------------------

def _neumann(n=64):
    T1 = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                  [-1, 0, 1]).tolil()
    T1[0, 0] = 1.0
    T1[-1, -1] = 1.0
    return sp.csr_matrix(T1)


def test_cg_ns_search_matches_jax():
    """ns_search keeps iterating on a zero rhs from a nonzero x0 into the
    null space (tests/test_runtime_io.py:299; reference cg.hpp:90,163)."""
    M = _neumann()
    A = T.CSR.from_scipy(M)
    x0 = np.random.RandomState(0).rand(M.shape[0])
    _, info_r = ref_make_solver(
        RefCSR.from_scipy(M), RefParams(dtype=jnp.float64, coarse_enough=32),
        RefCG(maxiter=200, tol=1e-10, ns_search=True))(np.zeros(64), x0=x0)
    solve = T.make_solver(A, T.AMGParams(coarse_enough=32, **F64),
                          T.CG(maxiter=200, tol=1e-10, ns_search=True), **CPU)
    x, info = solve(np.zeros(64), x0=x0)
    x = x.numpy()
    assert info.iters == info_r.iters and info.health == []
    assert np.linalg.norm(x) > 1e-8
    v = x / np.linalg.norm(x)
    assert np.std(v) < 1e-4 * np.abs(v).mean() + 1e-6
    # without ns_search a zero rhs gives x = 0
    plain = T.make_solver(A, T.AMGParams(coarse_enough=32, **F64),
                          T.CG(maxiter=200, tol=1e-10), **CPU)
    assert not plain(np.zeros(64), x0=x0)[0].any()


def test_cg_verbose_prints_at_the_jax_iterations(capfd):
    A, rhs = T.poisson3d(10)
    ref_make_solver(_ref(A), RefParams(dtype=jnp.float64, coarse_enough=100),
                    RefCG(maxiter=100, tol=1e-12, verbose=True))(rhs)
    ref_out = capfd.readouterr().out
    _, info = T.make_solver(A, T.AMGParams(coarse_enough=100, **F64),
                            T.CG(maxiter=100, tol=1e-12, verbose=True),
                            **CPU)(rhs)
    out = capfd.readouterr().out
    its = [int(m) for m in re.findall(r"iter (\d+): resid", out)]
    assert its == list(range(5, info.iters + 1, 5)) and its
    assert its == [int(m) for m in re.findall(r"iter (\d+): resid",
                                              ref_out)]


# -- rebuild -----------------------------------------------------------------

def _unstructured(n=900, density=0.01, seed=5):
    rng = np.random.RandomState(seed)
    M = sp.random(n, n, density=density, random_state=rng).tocsr()
    M = M + M.T + 10.0 * sp.identity(n)
    return T.CSR.from_scipy(sp.csr_matrix(M))


def _tensors(obj, depth=0):
    """Every tensor an object holds, in attribute order, a few levels
    down (device matrices, transfer operators, smoother states)."""
    out = []
    if torch.is_tensor(obj):
        return [obj]
    if depth > 3 or not hasattr(obj, "__dict__"):
        return out
    for _, v in sorted(vars(obj).items()):
        if isinstance(v, (list, tuple)):
            for w in v:
                out += _tensors(w, depth + 1)
        else:
            out += _tensors(v, depth + 1)
    return out


def _level_tensors(amg):
    out = []
    for lv in amg.hierarchy.levels:
        for part in (lv.A, lv.P, lv.R, lv.relax):
            out += _tensors(part)
    if amg.hierarchy.coarse is not None:
        out.append(amg.hierarchy.coarse.inv)
    return out


REBUILD_CASES = {
    "stencil host": (lambda: T.poisson3d(12)[0], F64, False),
    "stencil device": (lambda: T.poisson3d(16)[0], {}, True),
    "unstructured SA": (_unstructured, F64, False),
    "unstructured stored P": (_unstructured, dict(
        coarsening=T.Aggregation(), **F64), False),
}


@pytest.mark.parametrize("case", sorted(REBUILD_CASES))
def test_rebuild_is_a_fresh_build_bit_for_bit(case):
    """rebuild(2A) equals a fresh build of 2A, host levels and device
    tensors bit for bit (tests/test_device_setup.py:255-322); the host
    route keeps the device transfer operators."""
    make, prm, device_setup = REBUILD_CASES[case]
    A = make()
    amg = T.AMG(A, T.AMGParams(coarse_enough=80, **prm), device_setup=
                device_setup, **CPU)
    assert amg.device_built == device_setup
    kept = [(lv.P, lv.R) for lv in amg.hierarchy.levels[:-1]]
    A2 = T.CSR(A.ptr, A.col, 2.0 * A.val, A.ncols)
    amg.rebuild(A2)
    prm = dict(prm, coarsening=type(prm["coarsening"])()) \
        if "coarsening" in prm else prm
    fresh = T.AMG(A2, T.AMGParams(coarse_enough=80, **prm),
                  device_setup=device_setup, **CPU)
    assert len(amg.host_levels) == len(fresh.host_levels) >= 2
    for (Ai, _, _), (Bi, _, _) in zip(amg.host_levels, fresh.host_levels):
        if hasattr(Bi, "val"):    # device-built levels keep only metadata
            assert np.array_equal(Ai.val, Bi.val)
            assert np.array_equal(Ai.col, Bi.col)
    a, b = _level_tensors(amg), _level_tensors(fresh)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    if not device_setup:
        assert all(lv.P is P and lv.R is R for lv, (P, R) in zip(
            amg.hierarchy.levels, kept))


@pytest.mark.parametrize("case", ["stencil", "unstructured"])
def test_rebuild_host_levels_match_jax(case):
    A = T.poisson3d(12)[0] if case == "stencil" else _unstructured()
    scale = 1.0 + 0.05 * np.cos(np.arange(A.nnz))
    amg = T.AMG(A, T.AMGParams(coarse_enough=80, **F64), device_setup=False,
                **CPU)
    ref = RefAMG(_ref(A), RefParams(dtype=jnp.float64, coarse_enough=80))
    amg.rebuild(A.val * scale)
    ref.rebuild(A.val * scale)
    assert len(amg.host_levels) == len(ref.host_levels)
    for (Ai, _, _), (Bi, _, _) in zip(amg.host_levels, ref.host_levels):
        d = Ai.to_scipy() - Bi.to_scipy()
        assert sp.linalg.norm(d) <= 1e-12 * sp.linalg.norm(Bi.to_scipy())


@pytest.mark.parametrize("device_setup", [False, True])
def test_rebuild_carries_the_pattern_caches(device_setup):
    """A same-pattern rebuild hands the old matrix's pattern caches (the
    expanded rows, the DIA offsets, the grid) to the new one on either
    route, so a device rebuild does not pay the pattern analysis a new
    matrix would."""
    A, _ = T.poisson3d(16)
    amg = T.AMG(A, T.AMGParams(coarse_enough=80), device_setup=device_setup,
                **CPU)
    assert amg.device_built == device_setup
    A2 = T.CSR(A.ptr.copy(), A.col.copy(), 2.0 * A.val, A.ncols)
    amg.rebuild(A2)
    assert amg.host_levels[0][0] is A2
    # the native DIA passes need no expanded rows, so a device build
    # makes none: every cache the build made carries over
    made = [attr for attr in ("_rows_cache", "_dia_offsets_cache",
                              "_grid_dims") if hasattr(A, attr)]
    assert {"_dia_offsets_cache", "_grid_dims"} <= set(made)
    assert device_setup or "_rows_cache" in made
    for attr in made:
        assert getattr(A2, attr) is getattr(A, attr)


def test_rebuild_values_only_and_refusals():
    A, _ = T.poisson3d(10)
    prm = T.AMGParams(coarse_enough=80, **F64)
    amg = T.AMG(A, prm, **CPU)
    amg.rebuild(2.0 * A.val)
    ref = T.AMG(T.CSR(A.ptr, A.col, 2.0 * A.val, A.ncols), prm, **CPU)
    assert np.array_equal(amg.host_levels[1][0].val,
                          ref.host_levels[1][0].val)
    with pytest.raises(ValueError, match="value array shape"):
        amg.rebuild(np.ones(3))
    B = A.to_scipy().tolil()
    B[0, A.nrows - 1] = 1e-3
    with pytest.raises(ValueError, match="same sparsity"):
        amg.rebuild(T.CSR.from_scipy(B.tocsr()))
    with pytest.raises(ValueError, match="same matrix dimensions"):
        amg.rebuild(T.poisson3d(9)[0])


@pytest.mark.parametrize("device_setup", [False, True])
@pytest.mark.parametrize("refine_dtype", ["float64", "df32"])
def test_make_solver_rebuild_refreshes_the_operators(device_setup,
                                                     refine_dtype):
    """After rebuild(2A) with refine=2 the solution halves: the Krylov
    operator and the refinement's (float64 or df32 low) operator follow
    the new matrix (tests/test_amg.py:147-160)."""
    A, rhs = T.poisson3d(14)
    solve = T.make_solver(A, T.AMGParams(coarse_enough=300),
                          T.CG(maxiter=100, tol=1e-8), refine=2,
                          refine_dtype=refine_dtype,
                          device_setup=device_setup, **CPU)
    x1, _ = solve(rhs)
    A2 = T.CSR(A.ptr.copy(), A.col.copy(), 2.0 * A.val, A.ncols)
    solve.rebuild(A2)
    x2, info = solve(rhs)
    assert solve.refine_mode == refine_dtype
    assert solve.A_dev is solve.precond.hierarchy.system_matrix
    assert _true(A2, rhs, x2.numpy()) < 1e-7
    np.testing.assert_allclose(x2.numpy(), x1.numpy() / 2.0, atol=1e-6)


def test_rebuild_needs_a_rebuildable_preconditioner():
    A, rhs = T.poisson3d(6)
    solve = T.make_solver(A, T.DummyPreconditioner(A, **F64, **CPU),
                          T.CG(), **CPU)
    with pytest.raises(TypeError, match="does not support rebuild"):
        solve.rebuild(A)


# -- Schur pressure correction -----------------------------------------------

SCHUR_VARIANTS = [(True, 0), (True, 1), (True, 2), (False, 1), (False, 2)]


@pytest.mark.parametrize("approx_schur,adjust_p", SCHUR_VARIANTS)
def test_schur_matches_jax(approx_schur, adjust_p):
    """Every (approx_schur, adjust_p) of tests/test_coupled.py:72-93 on
    stokes_like(12): the JAX package's FGMRES count, and its dinv, Ld and
    pressure build matrix within 1e-12."""
    A, pmask = T.stokes_like(12)
    rhs = np.ones(A.nrows)
    kw = dict(approx_schur=approx_schur, adjust_p=adjust_p)
    ref_pre = ref_schur.SchurPressureCorrection(
        _ref(A), pmask,
        usolver_prm=RefParams(dtype=jnp.float64, coarse_enough=100),
        psolver_prm=RefParams(dtype=jnp.float64, coarse_enough=100),
        psolver=RefFGMRES(maxiter=8, tol=1e-2), dtype=jnp.float64, **kw)
    _, info_r = ref_make_solver(_ref(A), ref_pre,
                                RefFGMRES(maxiter=300, tol=1e-8))(rhs)
    pre = T.SchurPressureCorrection(
        A, pmask, usolver_prm=T.AMGParams(coarse_enough=100, **F64),
        psolver_prm=T.AMGParams(coarse_enough=100, **F64),
        psolver=T.FGMRES(maxiter=8, tol=1e-2), dtype=torch.float64,
        **kw, **CPU)
    x, info = T.make_solver(A, pre, T.FGMRES(maxiter=300, tol=1e-8),
                            **CPU)(rhs)
    assert info.iters == info_r.iters and info.resid < 1e-8
    assert _true(A, rhs, x.numpy()) < 1e-6
    assert "schur" in repr(pre)
    h, hr = pre.hierarchy, ref_pre.hierarchy
    assert _rel(h.S.M.numpy(), hr.S.M) <= 1e-12
    if adjust_p == 1:
        assert _rel(h.S.Ld.numpy(), hr.S.Ld) <= 1e-12
    else:
        assert h.S.Ld is None and hr.S.Ld is None
    P, Pr = pre.p_amg.host_levels[0][0].to_scipy(), \
        ref_pre.p_amg.host_levels[0][0]
    assert sp.linalg.norm(P - Pr.to_scipy()) \
        <= 1e-12 * sp.linalg.norm(Pr.to_scipy())


def test_schur_moves_its_full_system_only_for_a_nested_solver():
    """make_solver converts A itself for a prebuilt Schur correction, so
    the hierarchy's device copy of the full system is made only when a
    nested preconditioner iterates on it; the u-solves run on the
    velocity AMG's own Kuu. Nested over Schur takes the JAX package's
    FGMRES count."""
    from amgcl_tpu.models.preconditioner import \
        NestedPreconditioner as RefNested
    A, pmask = T.stokes_like(8)
    rhs = np.ones(A.nrows)
    sub = dict(usolver_prm=T.AMGParams(coarse_enough=100, **F64),
               psolver_prm=T.AMGParams(coarse_enough=100, **F64),
               dtype=torch.float64)
    pre = T.SchurPressureCorrection(A, pmask, **sub, **CPU)
    _, info = T.make_solver(A, pre, T.FGMRES(maxiter=300, tol=1e-8),
                            **CPU)(rhs)
    assert info.resid < 1e-8 and pre.hierarchy._A_dev is None
    assert not hasattr(pre.hierarchy, "Kuu")
    nested = T.NestedPreconditioner(A, pre, T.FGMRES(maxiter=3, tol=1e-2))
    S = pre.hierarchy.system_matrix
    assert nested.hierarchy.A is S and S.dtype == torch.float64
    x = np.random.RandomState(4).rand(A.nrows)
    np.testing.assert_allclose(
        tdev.spmv(S, torch.as_tensor(x)).numpy(), A.spmv(x), rtol=1e-13)
    ref_pre = ref_schur.SchurPressureCorrection(
        _ref(A), pmask,
        usolver_prm=RefParams(dtype=jnp.float64, coarse_enough=100),
        psolver_prm=RefParams(dtype=jnp.float64, coarse_enough=100),
        dtype=jnp.float64)
    ref_nested = RefNested(_ref(A), ref_pre, RefFGMRES(maxiter=3, tol=1e-2))
    _, info_r = ref_make_solver(_ref(A), ref_nested,
                                RefFGMRES(maxiter=100, tol=1e-8))(rhs)
    x, info = T.make_solver(A, nested, T.FGMRES(maxiter=100, tol=1e-8),
                            **CPU)(rhs)
    assert info.iters == info_r.iters and info.resid < 1e-8
    assert _true(A, rhs, x.numpy()) < 1e-6


def test_schur_refusals():
    A, pmask = T.stokes_like(6)
    with pytest.raises(ValueError, match="adjust_p"):
        T.SchurPressureCorrection(A, pmask, adjust_p=3, **CPU)
    with pytest.raises(ValueError, match="one entry per row"):
        T.SchurPressureCorrection(A, pmask[:-1], **CPU)
    with pytest.raises(ValueError, match="2x2 split"):
        T.SchurPressureCorrection(A, np.zeros_like(pmask), **CPU)


# -- CPR ---------------------------------------------------------------------

def _cpr_pair(cls_name, A, **kw):
    ref = getattr(ref_cpr, cls_name)(
        _ref(A), pressure_prm=RefParams(dtype=jnp.float64,
                                        coarse_enough=100),
        dtype=jnp.float64, **kw)
    pre = getattr(T, cls_name)(
        A, pressure_prm=T.AMGParams(coarse_enough=100, **F64),
        dtype=torch.float64, **kw, **CPU)
    return ref, pre


def _cpr_counts(A, rhs, ref, pre):
    _, info_r = ref_make_solver(_ref(A), ref,
                                RefBiCGStab(maxiter=300, tol=1e-8))(rhs)
    x, info = T.make_solver(A, pre, T.BiCGStab(maxiter=300, tol=1e-8),
                            **CPU)(rhs)
    assert _true(A, rhs, x.numpy()) < 1e-6
    return info.iters, info_r.iters


@pytest.mark.parametrize("cls_name", ["CPR", "CPRDRS"])
def test_cpr_matches_jax(cls_name):
    """reservoir_like(8, 3): the JAX package's BiCGStab count, its
    weights and its pressure matrix within 1e-12."""
    A, rhs = T.reservoir_like(8, 3)
    ref, pre = _cpr_pair(cls_name, A)
    it, it_r = _cpr_counts(A, rhs, ref, pre)
    assert it == it_r
    assert _rel(pre.hierarchy.W.numpy(), ref.hierarchy.W) <= 1e-12
    App = pre.p_amg.host_levels[0][0].to_scipy()
    App_r = ref.p_amg.host_levels[0][0].to_scipy()
    assert sp.linalg.norm(App - App_r) <= 1e-12 * sp.linalg.norm(App_r)
    assert pre.weighting in repr(pre)


@pytest.mark.parametrize("singular", [False, True])
@pytest.mark.parametrize("cls_name", ["CPR", "CPRDRS"])
def test_cpr_active_rows_matches_jax(cls_name, singular):
    """active_rows over appended well cells, their blocks made singular
    in one case (tests/test_coupled.py:221-292): the pressure system
    covers the reservoir cells only, and the count is the JAX
    package's."""
    A, rhs, N = wells_reservoir(6, 3)
    A = T.CSR(A.ptr, A.col, A.val, A.ncols)
    if singular:
        rows = A.expanded_rows()
        sel = (rows == A.col) & (rows >= N // 3)
        vals = A.val.copy()
        blocks = vals[sel]
        blocks[:, 2, :] = blocks[:, 1, :]
        vals[sel] = blocks
        A = T.CSR(A.ptr, A.col, vals, A.ncols)
    ref, pre = _cpr_pair(cls_name, A, active_rows=N)
    assert pre.p_amg.host_levels[0][0].nrows == N // 3
    if not singular:
        it, it_r = _cpr_counts(A, rhs, ref, pre)
        assert it == it_r


@pytest.mark.parametrize("update", [True, False])
def test_cpr_partial_update_matches_jax(update):
    """partial_update on a non-uniform congruence D·A·D, with and
    without update_transfer_ops (tests/test_coupled.py:295-325): the
    JAX package's count after the same update."""
    A, rhs = T.reservoir_like(8, 3)
    ref, pre = _cpr_pair("CPRDRS", A)
    d = 1.0 + 0.4 * np.cos(np.arange(A.nrows * 3))
    rows = A.expanded_rows()
    val2 = A.val * np.einsum("ei,ej->eij", d.reshape(-1, 3)[rows],
                             d.reshape(-1, 3)[A.col])
    A2 = T.CSR(A.ptr.copy(), A.col.copy(), val2, A.ncols)
    ref.partial_update(_ref(A2), update_transfer_ops=update)
    pre.partial_update(A2, update_transfer_ops=update)
    it, it_r = _cpr_counts(A2, rhs, ref, pre)
    assert it == it_r
    with pytest.raises(ValueError, match="same structure"):
        pre.partial_update(T.reservoir_like(7, 3)[0])


def test_cpr_rebuild_through_make_solver():
    """make_solver.rebuild reaches CPR.partial_update and refreshes the
    Krylov operator (tests/test_coupled.py:337-351)."""
    A, rhs = T.reservoir_like(8, 3)
    _, pre = _cpr_pair("CPR", A)
    solve = T.make_solver(A, pre, T.BiCGStab(maxiter=200, tol=1e-8), **CPU)
    _, info1 = solve(rhs)
    A2 = T.CSR(A.ptr.copy(), A.col.copy(), A.val * 2.0, A.ncols)
    solve.rebuild(A2)
    x, info = solve(rhs)
    assert _true(A2, rhs, x.numpy()) < 1e-6
    with pytest.raises(ValueError, match="block"):
        T.CPR(T.poisson3d(6)[0], **CPU)


# -- deflation and the block solver ------------------------------------------

def test_deflated_solver_matches_jax_and_keeps_the_caller_precond():
    A, rhs = T.poisson3d(10)
    i = np.arange(A.nrows)
    Z = np.stack([np.ones(A.nrows), i % 10, (i // 10) % 10], axis=1)
    ref = ref_deflated(_ref(A), Z, RefParams(dtype=jnp.float64),
                       RefCG(maxiter=100, tol=1e-8))
    _, info_r = ref(rhs)
    amg = T.AMG(A, T.AMGParams(**F64), **CPU)
    h0 = amg.hierarchy
    solve = T.deflated_solver(A, Z, amg, T.CG(maxiter=100, tol=1e-8), **CPU)
    assert amg.hierarchy is h0
    x, info = solve(rhs)
    assert info.iters == info_r.iters and info.resid < 1e-8
    assert _rel(solve.inner.precond.hierarchy.Einv.numpy(),
                ref.inner.precond.hierarchy.Einv) <= 1e-12
    assert "deflated" in repr(solve)


def test_block_solver_matches_jax():
    A, rhs = T.poisson3d(8)
    _, info_r = ref_block(_ref(A), 2, RefParams(dtype=jnp.float64),
                          RefCG(maxiter=200, tol=1e-8))(rhs)
    solve = T.make_block_solver(A, 2, T.AMGParams(**F64),
                                T.CG(maxiter=200, tol=1e-8), **CPU)
    x, info = solve(rhs)
    assert info.iters == info_r.iters and x.shape == (A.nrows,)
    assert _true(A, rhs, x.numpy()) < 1e-6
    with pytest.raises(ValueError, match="multiple"):
        T.make_block_solver(T.poisson3d(5)[0], 2, **CPU)


# -- phase 11 of chip_smoke.py on the CPU ------------------------------------

def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small(system):
    if system == "poisson":
        A, rhs = T.poisson3d(24)
        return A, rhs, _chip_smoke().a9_deflation_vectors(24)
    if system == "fe":
        return T.fe_like_problem(1500, nnz_target=28 * 1500, seed=1) \
            + (None,)
    if system == "stokes":
        A, pmask = T.stokes_like(64)
        return A, np.ones(A.nrows), pmask
    if system == "reservoir":
        return T.reservoir_like(16, 3) + (None,)
    A, rhs = T.poisson3d_block(16, 3)
    return A.unblock(), rhs, None


def test_chip_smoke_counts_paused_restores_every_count():
    """chip_smoke.py's comparison builds inside a path's counting window
    run under counts_paused(): what they launch or call is not counted."""
    cs = _chip_smoke()
    A, rhs = T.poisson3d(8)
    cs.reset_counts()
    T.make_solver(A, T.AMGParams(), T.CG(), **CPU)(rhs)
    before = cs.read_counts()
    assert sum(before[1].values()) > 0
    with cs.counts_paused():
        T.make_solver(A, T.AMGParams(), T.CG(), **CPU)(rhs)
        inside = cs.read_counts()
    assert inside != before
    assert cs.read_counts() == before


@pytest.mark.parametrize("label", ["MX1", "DF1", "RB1", "RB1h", "DL1",
                                   "NS1", "DM1", "AP1", "SC1", "CP1",
                                   "BK1"])
def test_chip_smoke_phase11_paths_reach_their_kernels(label):
    """Each phase-11 configuration of chip_smoke.py, at a small size on
    the CPU with the device build asked for, puts where a9_reach requires
    what reaches its kernels (MX1's Krylov operator a float64 DIA apart
    from the hierarchy's; DF1 in df32 mode; RB1 device-built and RB1h
    not; SC1's pressure hierarchy multilevel under adjust_p=2; CP1's
    pressure AMG built on the device and its Krylov operator a 3×3 block
    windowed ELL; BK1's level 0 one too) and converges within
    chip_smoke.py's bound."""
    cs = _chip_smoke()
    system, _, refine = cs.A9_PATHS[label]
    A, rhs, extra = _small(system)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        solve = cs.a9_make(label, A, extra, device="cpu", device_setup=True)
        lines, faults = cs.a9_reach(label, solve)
        assert faults == [] and len(lines) >= 1
        x, info = solve(rhs)
    assert info.iters < (1 + refine) * getattr(solve, "inner",
                                               solve).solver.maxiter
    assert info.resid <= 1e-6
    assert _true(A, rhs, x.numpy()) <= (1e-6 if refine or label == "MX1"
                                        else 1e-5)
