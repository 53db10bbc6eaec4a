"""The port's native set-up library (``amgcl_tpu_torch/native.py``,
``amgcl_tpu_torch/csrc/setup_kernels.cpp``) against the JAX package's
(``amgcl_tpu/native.py``) and against the port's own numpy passes, on
the CPU with ``g++``.

Tolerances: every wrapper bit for bit with the JAX package's (the same
C source and flags); against the numpy pass, integer outputs equal,
float64 values within 1e-13 of the largest entry, float32 within 1e-5;
whole set-ups with identical level shapes and float64 iteration counts
on both routes and in the JAX package.

The module runs with one OpenMP thread (its ``_one_thread`` fixture),
where both packages decline the native SpGEMM by their thread gate; the
tests that need it take it through ``native.force_spgemm`` and the JAX
package's ``AMGCL_TPU_FORCE_NATIVE_SPGEMM``.
"""

import os
import stat

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from amgcl_tpu import native as rnative
from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.coarsening.ruge_stuben import RugeStuben as RefRS
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.solver.bicgstab import BiCGStab as RefBiCGStab
from amgcl_tpu.solver.cg import CG as RefCG

import amgcl_tpu_torch as T
from amgcl_tpu_torch import native
from amgcl_tpu_torch.coarsening import aggregates as agg_mod
from amgcl_tpu_torch.coarsening.ruge_stuben import cf_splitting_classic
from amgcl_tpu_torch.coarsening.smoothed_aggregation import _filtered
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import stencil as st
from amgcl_tpu_torch.relaxation.ilu0 import iluk_pattern
from amgcl_tpu_torch.relaxation.spai0 import Spai0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS, OpenMP and torch thread while this module runs. Both
    libraries load first, so that the limit reaches their OpenMP."""
    from threadpoolctl import threadpool_limits
    assert native.available() and rnative.lib() is not None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def force_spgemm(monkeypatch):
    monkeypatch.setattr(native, "force_spgemm", True)
    monkeypatch.setenv("AMGCL_TPU_FORCE_NATIVE_SPGEMM", "1")


def _ref(A):
    return RefCSR(A.ptr, A.col, A.val, A.ncols)


def _spd(n=400, density=0.02, seed=5, dtype=np.float64):
    """A random sparse symmetric diagonally dominant matrix with sorted
    rows and a full diagonal, as the port's CSR."""
    rng = np.random.RandomState(seed)
    M = sp.random(n, n, density=density, random_state=rng)
    M = -(M + M.T)
    M = M + sp.diags(np.asarray(abs(M).sum(axis=1)).ravel() + 0.5
                     + rng.rand(n))
    M = M.tocsr().astype(dtype)
    M.sort_indices()
    return T.CSR.from_scipy(M)


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


def _tol(dtype):
    return 1e-5 if np.dtype(dtype) == np.float32 else 1e-13


def _same(got, want):
    """Bit for bit: each array (or tuple of arrays) equal, dtype too."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if np.isscalar(want) or isinstance(want, (int, bool)):
        assert got == want
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


# -- each wrapper ---------------------------------------------------------------


def _fnma_case(dtype, seed=2):
    """A Galerkin stage's pairs on a 12³ grid stencil (the plan's own
    lists), with random values."""
    A, _ = T.poisson3d(12)
    from amgcl_tpu_torch.ops.structured import detect_grid_csr
    grid = detect_grid_csr(A)
    P, _ = st.stencil_transfer_operators(A, grid, 0.08, 1.0, 0, dtype)
    M = P._implicit_spec["M"]
    Ad = st.host_dia_from_csr(A, grid, dtype)
    plan = st.StencilGalerkinPlan(Ad.offsets3, M.offsets3, Ad.dims,
                                  P._implicit_spec["block"],
                                  P._implicit_spec["coarse"], dtype)
    rng = np.random.RandomState(seed)
    a = rng.standard_normal(Ad.data.shape).astype(dtype)
    m = rng.standard_normal(M.data.shape).astype(dtype)
    X = rng.standard_normal((len(plan.x_offs), plan.n)).astype(dtype)
    return a, m, X, plan.pairs_x


def _run_fnma(lib_fn, dtype):
    a, m, X, (pa, pb, ps, po) = _fnma_case(dtype)
    out = X.copy()
    assert lib_fn(a, pa, m, pb, ps, out, po)
    return out


def _numpy_fnma(dtype):
    a, m, X, pairs = _fnma_case(dtype)
    out = X.copy()
    for ka, kb, s, ko in zip(*pairs):
        out[ko] -= a[ka] * st._shift(m[kb], s)
    return out


def _rs_inputs():
    A = _spd(500, seed=11)
    rows = A.expanded_rows()
    # the reference's strength: −a_ij ≥ eps · max_k(−a_ik)
    neg = np.where(rows != A.col, -A.val, 0.0)
    rmax = np.zeros(A.nrows)
    np.maximum.at(rmax, rows, neg)
    strong = (rows != A.col) & (neg >= 0.25 * rmax[rows]) & (neg > 0)
    Sd = sp.csr_matrix((strong.astype(np.int8), A.col.copy(), A.ptr.copy()),
                       shape=A.shape)
    Sd.eliminate_zeros()
    ST = Sd.T.tocsr()
    cf = np.zeros(A.nrows, dtype=np.int8)
    has = np.zeros(A.nrows, dtype=bool)
    np.logical_or.at(has, rows, strong)
    cf[~has] = 2
    return A, strong, rows, (A.ptr, A.col, strong, ST.indptr, ST.indices,
                             cf)


def _masked_inputs():
    A = _spd(300, seed=7)
    B = _spd(300, seed=8)
    n = A.nrows
    return (n, A.ptr, A.col, A.val, B.ptr, B.col, B.val, A.ptr, A.col), \
        (A, B)


def _case(name):
    """(port call, JAX call, numpy-pass call, tolerance dtype or None for
    integer outputs[, the port's result as the numpy pass gives it]) of
    one wrapper case."""
    A = _spd()
    A32 = _spd(dtype=np.float32)
    Ab = T.CSR.from_scipy(_spd(300).to_scipy()).to_block(3)
    Bb = T.CSR.from_scipy(_spd(300, seed=6).to_scipy()).to_block(3)
    if name == "aggregates":
        return (lambda m: m.native_aggregates(A, 0.08),
                lambda: rnative.native_aggregates(_ref(A), 0.08),
                lambda: agg_mod.greedy_aggregates(
                    agg_mod.strength_graph(A, 0.08)), None)
    if name in ("spgemm", "spgemm_f32", "spgemm_block"):
        X, Y = {"spgemm": (A, _spd(seed=9)),
                "spgemm_f32": (A32, _spd(seed=9, dtype=np.float32)),
                "spgemm_block": (Ab, Bb)}[name]

        def dense(got):
            # the hash product keeps a structural block whose values
            # cancel to zero, scipy's drops it: compare the dense values
            ptr, col, val = got
            C = T.CSR(ptr, col, val, Y.ncols)
            return (C.unblock() if C.is_block else C).to_dense()

        def numpy_pass():
            un = lambda M: M.unblock() if M.is_block else M
            return (un(X).to_scipy() @ un(Y).to_scipy()).toarray()
        return (lambda m: m.native_spgemm(X, Y),
                lambda: rnative.native_spgemm(_ref(X), _ref(Y)),
                numpy_pass, X.val.dtype, dense)
    if name == "spgemm_masked":
        args, (Am, Bm) = _masked_inputs()

        def numpy_pass():
            C = (Am.to_scipy() @ Bm.to_scipy()).tocsr()
            rows = Am.expanded_rows()
            return np.asarray(C[rows, Am.col]).ravel()
        return (lambda m: m.native_spgemm_masked(*args),
                lambda: rnative.native_spgemm_masked(*args), numpy_pass,
                np.float64)
    if name in ("filtered", "filtered_f32"):
        X = A if name == "filtered" else A32

        def numpy_pass():
            import unittest.mock as um
            with um.patch.object(native, "lib", lambda: None):
                Af, dinv = _filtered(X, 0.08)
            return Af.ptr, Af.col, Af.val, dinv
        return (lambda m: m.native_filtered(X, 0.08),
                lambda: rnative.native_filtered(_ref(X), 0.08), numpy_pass,
                X.val.dtype)
    if name in ("ell_pack", "ell_pack_f32", "ell_pack_block"):
        X = Ab if name == "ell_pack_block" else A
        odt = np.float32 if name == "ell_pack_f32" else np.float64

        def numpy_pass():
            import unittest.mock as um
            with um.patch.object(native, "lib", lambda: None):
                E = dev.csr_to_ell(X, torch.from_numpy(
                    np.zeros(0, odt)).dtype)
            return E.cols.numpy().astype(np.int32), E.vals.numpy()
        K = int(X.row_nnz().max())
        K = max(dev._ELL_PAD, -(-K // dev._ELL_PAD) * dev._ELL_PAD)
        return (lambda m: m.native_ell_pack(X, K, odt),
                lambda: rnative.native_ell_pack(_ref(X), K, odt),
                numpy_pass, odt)
    if name == "spai0_diag":
        def numpy_pass():
            import unittest.mock as um
            with um.patch.object(native, "lib", lambda: None):
                s = Spai0().build(A, torch.float64, "cpu").scale
            return s.numpy()
        return (lambda m: m.native_spai0_diag(A),
                lambda: rnative.native_spai0_diag(_ref(A)), numpy_pass,
                np.float64)
    if name in ("iluk_k1", "iluk_k2"):
        k = int(name[-1])
        Ai = _spd(250, density=0.015, seed=4)

        def numpy_pass():
            import unittest.mock as um
            with um.patch.object(native, "lib", lambda: None):
                return iluk_pattern(Ai.ptr, Ai.col, Ai.nrows, k)
        return (lambda m: m.native_iluk_pattern(Ai, k),
                lambda: rnative.native_iluk_pattern(_ref(Ai), k),
                numpy_pass, None)
    if name == "dia_offsets":
        def numpy_pass():
            import unittest.mock as um
            B = T.CSR(A.ptr, A.col, A.val, A.ncols)
            with um.patch.object(native, "lib", lambda: None):
                return dev.dia_offsets(B)
        return (lambda m: m.native_dia_offsets(A),
                lambda: rnative.native_dia_offsets(_ref(A)), numpy_pass,
                None)
    if name in ("dia_pack_f64_f32", "dia_pack_f64_f64", "dia_pack_f32_f32"):
        X = A32 if name.startswith("dia_pack_f32") else A
        odt = np.float32 if name.endswith("f32") else np.float64
        o = dev.dia_offsets(T.CSR(X.ptr, X.col, X.val, X.ncols))
        return (lambda m: m.native_dia_pack(X, o, odt),
                lambda: rnative.native_dia_pack(_ref(X), o, odt),
                lambda: st._numpy_dia_pack(X, o).astype(odt), odt)
    if name in ("dia_fnma_batch_f64", "dia_fnma_batch_f32"):
        dt = np.float32 if name.endswith("f32") else np.float64
        return (lambda m: _run_fnma(m.native_dia_fnma_batch, dt),
                lambda: _run_fnma(rnative.native_dia_fnma_batch, dt),
                lambda: _numpy_fnma(dt), dt)
    if name == "rs_cfsplit":
        Ar, strong, rows, args = _rs_inputs()

        def numpy_pass():
            import unittest.mock as um
            with um.patch.object(native, "lib", lambda: None):
                is_c = cf_splitting_classic(Ar, strong, rows)
            return np.where(is_c, 1, 2).astype(np.int8)
        return (lambda m: m.native_rs_cfsplit(*args),
                lambda: rnative.native_rs_cfsplit(*args), numpy_pass, None)
    raise KeyError(name)


WRAPPERS = ["aggregates", "spgemm", "spgemm_f32", "spgemm_block",
            "spgemm_masked", "filtered", "filtered_f32", "ell_pack",
            "ell_pack_f32", "ell_pack_block", "spai0_diag", "iluk_k1",
            "iluk_k2", "dia_offsets", "dia_pack_f64_f32", "dia_pack_f64_f64",
            "dia_pack_f32_f32", "dia_fnma_batch_f64", "dia_fnma_batch_f32",
            "rs_cfsplit"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_bit_for_bit_with_jax(name, force_spgemm):
    """The same C source and flags: each wrapper's outputs are the JAX
    package's to the bit."""
    port, ref = _case(name)[:2]
    got, want = port(native), ref()
    assert got is not None and want is not None
    _same(tuple(got) if isinstance(got, tuple) else got,
          tuple(want) if isinstance(want, tuple) else want)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_matches_numpy_pass(name, force_spgemm):
    """Integer outputs equal the numpy pass's; float64 values within
    1e-13 of the largest entry, float32 within 1e-5."""
    port, _, numpy_pass, dt, *post = _case(name)
    native.calls.clear()
    got, want = port(native), numpy_pass()
    if post:
        got = post[0](got)
    assert sum(native.calls.values()) > 0
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if name == "rs_cfsplit":
        # the numpy pass returns C/F, the native one also the decided F
        got = (np.where(got[0] == 1, 1, 2).astype(np.int8),)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype.kind in "iub":
            assert np.array_equal(g, w)
        else:
            _close(g, w, _tol(dt))


def test_fnma_batch_bit_for_bit_with_numpy():
    """No contraction into a fused multiply-add: each product rounds
    before its subtraction, as numpy's does."""
    for dt in (np.float64, np.float32):
        _same(_run_fnma(native.native_dia_fnma_batch, dt), _numpy_fnma(dt))


def test_gates_as_the_jax_package():
    """None where the JAX package declines: the SpGEMM on one thread,
    complex values, mixed block and scalar operands; interleaved pairs
    of one output row raise."""
    A = _spd(100)
    assert native.omp_max_threads() == 1
    assert native.native_spgemm(A, A) is None
    assert rnative.native_spgemm(_ref(A), _ref(A)) is None
    Z = T.CSR(A.ptr, A.col, A.val.astype(np.complex128), A.ncols)
    assert native.native_aggregates(Z, 0.08) is None
    assert native.native_filtered(Z, 0.08) is None
    assert native.native_spai0_diag(Z) is None
    B = T.CSR.from_scipy(_spd(99).to_scipy()).to_block(3)
    assert native.native_dia_pack(B, [0], np.float64) is None
    a = np.ones((2, 8))
    with pytest.raises(ValueError):
        native.native_dia_fnma_batch(a, [0, 1, 0], a, [0, 0, 0], [0, 0, 0],
                                     a.copy(), [0, 1, 0])


@pytest.mark.parametrize("system", ["spd20", "spd21", "spd22", "u1"])
def test_greedy_aggregates_match_native(system):
    """The numpy greedy pass mirrors ``aggregate_d2`` exactly: on random
    SPD graphs and on U1's system (poisson3Db's profile) at 12,000
    rows."""
    if system == "u1":
        A, _ = T.fe_like_problem(12000, nnz_target=28 * 12000)
    else:
        A = _spd(2000, density=0.004, seed=int(system[3:]))
    got = native.native_aggregates(A, 0.08)
    want = agg_mod.greedy_aggregates(agg_mod.strength_graph(A, 0.08))
    assert got[1] == want[1] > 0
    assert np.array_equal(got[0], want[0])


# -- whole set-ups ----------------------------------------------------------------


def _setup_case(name):
    if name == "poisson":
        A, rhs = T.poisson3d(16)
        return A, rhs, {}, T.CG, RefCG, {}
    if name == "fe":
        A, rhs = T.fe_like_problem(6000, nnz_target=31 * 6000, seed=1)
        return A, rhs, {}, T.BiCGStab, RefBiCGStab, {}
    if name == "block":
        A, rhs = T.poisson3d_block(12, 2)
        return A, rhs, {}, T.BiCGStab, RefBiCGStab, {}
    A, rhs = T.fe_like_problem(6000, nnz_target=31 * 6000, seed=1)
    return (A, rhs, {"coarsening": T.RugeStuben()}, T.BiCGStab,
            RefBiCGStab, {"coarsening": RefRS()})


@pytest.mark.parametrize("name", ["poisson", "fe", "block", "rs"])
def test_setup_native_against_numpy_and_jax(name, force_spgemm, monkeypatch):
    """Host set-ups with the native passes and with the numpy passes:
    identical level shapes and float64 counts, and the JAX package's
    (its native route) counts and shapes."""
    A, rhs, prm, solver, ref_solver, ref_prm = _setup_case(name)
    native.calls.clear()
    solve = T.make_solver(A, T.AMGParams(dtype=torch.float64, **prm),
                          solver(tol=1e-8, maxiter=100), device="cpu")
    _, info = solve(rhs)
    ran = set(native.calls)
    with monkeypatch.context() as m:
        m.setattr(native, "lib", lambda: None)
        native.calls.clear()
        solve0 = T.make_solver(A, T.AMGParams(dtype=torch.float64, **prm),
                               solver(tol=1e-8, maxiter=100), device="cpu")
        _, info0 = solve0(rhs)
        assert not native.calls
    ref = RefAMG(_ref(A), RefParams(dtype=jnp.float64, **ref_prm))
    _, info_r = ref_make_solver(_ref(A), ref,
                                ref_solver(tol=1e-8, maxiter=100))(rhs)

    def shapes(levels):
        return [(h[0].nrows, h[0].nnz) for h in levels]

    assert len(solve.precond.host_levels) >= 2
    assert shapes(solve.precond.host_levels) \
        == shapes(solve0.precond.host_levels) == shapes(ref.host_levels)
    assert info.iters == info0.iters == info_r.iters < 100
    want = {"poisson": {"dia_fnma_batch_f64", "spai0_diag", "dia_mark"},
            "fe": {"filter_fill", "aggregate_d2", "spgemm_numeric"},
            "block": {"spgemm_numeric_block"},
            "rs": {"rs_cfsplit", "spgemm_numeric"}}[name]
    assert want <= ran, want - ran


# -- the build ------------------------------------------------------------------------


def test_build_failure_raises_with_the_compilers_message(tmp_path,
                                                         monkeypatch):
    """A ``g++`` on PATH whose build fails raises with its stderr: no
    quiet fallback to the numpy passes."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "g++"
    fake.write_text("#!/bin/sh\necho 'fatal: made to fail' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep
                       + os.environ.get("PATH", ""))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="made to fail"):
        native.lib()
    assert not list((tmp_path / "build").glob("*.so"))
    # without any g++ the numpy passes run, and available() says so
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setattr(native, "_lib", None)
    assert native.lib() is None and not native.available()
    assert native.native_aggregates(_spd(50), 0.08) is None
