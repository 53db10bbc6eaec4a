"""The block-valued slice on the CPU against the JAX package: block CSR
algebra, ``poisson3d_block``, block windowed-ELL packing, each block
kernel's plain version against the JAX Pallas kernel in interpret mode,
the hierarchy of a small ``poisson3d_block`` (levels, block shapes,
formats), BiCGStab on a hierarchy carried across from the JAX package,
the headline call through ``make_solver``, the format ``to_device``
picks for block matrices and the CPU dispatch to the plain versions.

Tolerances, each with its reason:

- CSR algebra, ``poisson3d_block`` and the packing are compared exactly:
  both packages do the same host arithmetic.
- Kernel outputs: per output entry |Δ| ≤ rtol · Σ|terms| (the sum of the
  absolute values of the terms that entry adds up), rtol 1e-5 in float32
  and 1e-12 in float64: the two sides sum the same terms in another
  order. A dot is held to rtol times the sum of the absolute products it
  adds (each y entry's own error is bounded by its terms).
- One preconditioner application on an identical float64 hierarchy:
  1e-10 of its largest entry (a V-cycle of a few sums in another order).
- BiCGStab: the same iteration count in float64; in float32 the reported
  residuals within a factor 2 of each other (BiCGStab amplifies the
  summation order, up to 6% on the unstructured slice), both under tol.
- The true residual of a float32 solution without refinement is held to
  tol + 2u · ‖|A| |x|‖ / ‖b‖ with u = 2⁻²⁴: rounding x to float32 alone
  moves the residual by up to u · ‖|A| |x|‖ / ‖b‖, and the float32
  recurrence drifts by as much again; at the chip's size the rounded
  exact solution misses tol (``test_block_path_constants_at_full_size``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops import unstructured as ref_u
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.ops.csr import pointwise_matrix as ref_pointwise_matrix
from amgcl_tpu.solver.bicgstab import BiCGStab as RefBiCGStab
from amgcl_tpu.utils.sample_problem import poisson3d_block as ref_p3b

from amgcl_tpu_torch import (AMG, AMGParams, BiCGStab, CSR, make_solver,
                             poisson3d_block)
from amgcl_tpu_torch.convert import hierarchy_from_arrays
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.ops import unstructured as U
from amgcl_tpu_torch.ops import well_block_kernels as wbk
from amgcl_tpu_torch.ops.csr import pointwise_matrix


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


DTYPES = (np.float32, np.float64)
_RTOL = {np.float32: 1e-5, np.float64: 1e-12}
_TORCH = {np.float32: torch.float32, np.float64: torch.float64}
_U32 = 2.0 ** -24
_COARSE = 500      # coarse_enough that gives three levels at n = 16


def _same_csr(a, b):
    assert a.shape == b.shape and a.block_size == b.block_size
    np.testing.assert_array_equal(a.ptr, b.ptr)
    np.testing.assert_array_equal(a.col, b.col)
    np.testing.assert_array_equal(a.val, b.val)


def _random_block(nb, mb, b, density, seed):
    """A random nb×mb BCSR of b×b blocks (port and reference CSR)."""
    rng = np.random.RandomState(seed)
    S = sp.random(nb, mb, density=density, random_state=rng, format="csr")
    S.sort_indices()
    val = rng.standard_normal((S.nnz, b, b))
    return (CSR(S.indptr, S.indices, val, mb),
            RefCSR(S.indptr, S.indices, val, mb))


# -- block CSR algebra ------------------------------------------------------

@pytest.mark.parametrize("b", [2, 3])
def test_block_csr_algebra_matches_reference(b):
    A, A_r = _random_block(60, 50, b, 0.1, b)
    B, B_r = _random_block(50, 40, b, 0.1, b + 10)
    assert A.is_block and A.block_size == (b, b) and "block=" in repr(A)
    _same_csr(A.unblock(), A_r.unblock())
    _same_csr(A.unblock().to_block(b), A_r.unblock().to_block(b))
    _same_csr(A.transpose(), A_r.transpose())
    _same_csr(A @ B, A_r @ B_r)
    _same_csr(A.transpose() + A.transpose(), A_r.transpose()
              + A_r.transpose())
    np.testing.assert_array_equal(A.to_dense(), A_r.to_dense())
    C, C_r = _random_block(40, 40, b, 0.15, b + 20)
    diag = sp.identity(40, format="csr") * 1.0
    D, D_r = CSR.from_scipy(C.to_scipy() + sp.kron(diag, 5 * np.eye(b))), \
        RefCSR.from_scipy(C_r.to_scipy() + sp.kron(diag, 5 * np.eye(b)))
    D, D_r = D.to_block(b), D_r.to_block(b)
    np.testing.assert_array_equal(D.diagonal(), D_r.diagonal())
    np.testing.assert_array_equal(D.diagonal(invert=True),
                                  D_r.diagonal(invert=True))
    _same_csr(pointwise_matrix(D, b), ref_pointwise_matrix(D_r, b))
    _same_csr(pointwise_matrix(D.unblock(), b),
              ref_pointwise_matrix(D_r.unblock(), b))
    x = np.random.RandomState(1).standard_normal(50 * b)
    np.testing.assert_allclose(A.spmv(x), A_r.spmv(x), rtol=1e-12,
                               atol=1e-12 * np.abs(A.val).max())
    with pytest.raises(ValueError):
        A.to_block(b)
    with pytest.raises(ValueError):
        A.unblock().unblock()


@pytest.mark.parametrize("n,b", [(5, 2), (6, 3), (4, 4)])
def test_poisson3d_block_matches_reference(n, b):
    A, rhs = poisson3d_block(n, b)
    A_r, rhs_r = ref_p3b(n, b)
    _same_csr(A, A_r)
    np.testing.assert_array_equal(rhs, rhs_r)
    assert A.nrows == n ** 3 and rhs.shape == (n ** 3 * b,)


@pytest.mark.parametrize("n,b", [(8, 2), (10, 3)])
def test_pointwise_aggregates_match_reference(n, b):
    from amgcl_tpu.coarsening.aggregates import \
        pointwise_aggregates as ref_pointwise_aggregates
    from amgcl_tpu_torch.coarsening.aggregates import pointwise_aggregates
    A, A_r = _p3b(n, b)
    for eps in (0.08, 0.02):
        agg, n_agg = pointwise_aggregates(A, eps)
        agg_r, n_agg_r = ref_pointwise_aggregates(A_r, eps, b)
        assert n_agg == n_agg_r and 1 < n_agg < A.nrows
        np.testing.assert_array_equal(agg, agg_r)


# -- block windowed-ELL packing ---------------------------------------------

def _empty_tile_b2():
    """3,072 nodes of 2×2 blocks whose middle tile (nodes 1,024-2,047)
    holds no entry; the block-column count is a multiple of 1,024, so
    that tile's padding addresses one past x."""
    rng = np.random.RandomState(5)
    n = 3072
    rows, cols = [], []
    for i in list(range(1024)) + list(range(2048, n)):
        for d in (-2, -1, 0, 1, 40):
            j = i + d
            if 0 <= j < n:
                rows.append(i)
                cols.append(j)
    S = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    val = rng.standard_normal((S.nnz, 2, 2))
    return (CSR(S.indptr, S.indices, val, n),
            RefCSR(S.indptr, S.indices, val, n))


def _rect_b3():
    """A 2,500 × 5,000-node banded rectangular BCSR of 3×3 blocks (a
    restriction's shape), rows of 1 to 6 blocks, a ragged last tile,
    differing window starts."""
    rng = np.random.RandomState(7)
    n, m = 2500, 5000
    rows, cols = [], []
    for i in range(n):
        c = int(i * m / n)
        for d in rng.choice(np.arange(-20, 21), rng.randint(1, 7),
                            replace=False):
            if 0 <= c + d < m:
                rows.append(i)
                cols.append(c + d)
    S = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, m))
    S.sort_indices()
    val = rng.standard_normal((S.nnz, 3, 3))
    return (CSR(S.indptr, S.indices, val, m),
            RefCSR(S.indptr, S.indices, val, m))


def _p3b(n, b):
    A, _ = poisson3d_block(n, b)
    return A, ref_p3b(n, b)[0]


_MATRICES = {
    "p3b_16_b3": lambda: _p3b(16, 3),      # four tiles, starts 0/0/1k/2k
    "p3b_12_b2": lambda: _p3b(12, 2),
    "empty_tile_b2": _empty_tile_b2,
    "rect_b3": _rect_b3,
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(_MATRICES))
def test_block_packing_matches_reference(name, dtype):
    A, A_r = _MATRICES[name]()
    W = U.csr_to_windowed_ell(A, _TORCH[dtype])
    W_r = ref_u.csr_to_windowed_ell(A_r, jnp.dtype(dtype))
    assert (W.win, W.shape, W.block) == (W_r.win, W_r.shape, W_r.block)
    assert W.block == A.block_size != (1, 1)
    np.testing.assert_array_equal(W.window_starts.numpy(),
                                  np.asarray(W_r.window_starts))
    np.testing.assert_array_equal(W.cols_local.numpy(),
                                  np.asarray(W_r.cols_local))
    np.testing.assert_array_equal(W.vals.numpy(), np.asarray(W_r.vals))
    assert W.vals.dtype == _TORCH[dtype] and W.vals.dim() == 5


def test_block_packing_cases_cover_what_they_claim():
    """Differing window starts, an empty tile pointing at the block-column
    count, a ragged rectangular operator; the window budget counts
    bc scalar columns per block column, as the reference's does."""
    W = U.csr_to_windowed_ell(_p3b(16, 3)[0])
    assert W.window_starts.tolist() == [0, 0, 1024, 2048]
    W = U.csr_to_windowed_ell(_empty_tile_b2()[0])
    assert W.window_starts.tolist()[1] == 3072
    A, A_r = _rect_b3()
    assert A.nrows % U._TILE and A.nrows != A.ncols
    W = U.csr_to_windowed_ell(A)
    assert len(set(W.window_starts.tolist())) > 1
    for budget in (W.win * 4, W.win * 3 * 4, 4 << 20):
        why, why_r = {}, {}
        got = U.csr_to_windowed_ell(A, max_win_bytes=budget, why=why)
        want = ref_u.csr_to_windowed_ell(A_r, max_win_bytes=budget,
                                         why=why_r)
        assert (got is None) == (want is None) and why == why_r
    assert U.csr_to_windowed_ell(A, max_win_bytes=W.win * 4) is None


# -- each plain version against the JAX kernel in interpret mode -----------

def _operands(name, dtype, seed):
    A, A_r = _MATRICES[name]()
    W = U.csr_to_windowed_ell(A, _TORCH[dtype])
    W_r = ref_u.csr_to_windowed_ell(A_r, jnp.dtype(dtype))
    b = A.block_size[0]
    rng = np.random.RandomState(seed)
    n, m = A.nrows * b, A.ncols * b
    vecs = {"x": rng.standard_normal(m), "f": rng.standard_normal(n),
            "w": rng.rand(n),
            "S": rng.standard_normal((A.nrows, b, b)) * 0.1}
    vecs = {k: v.astype(dtype) for k, v in vecs.items()}
    terms = abs(A.to_scipy()) @ np.abs(vecs["x"].astype(np.float64))
    return W, W_r, vecs, terms


def _t(v):
    return torch.as_tensor(v)


def _within(got, want, terms, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= _RTOL[dtype] * terms + 1e-300)


def _dot_within(got, want, a, b, dtype):
    mag = float(np.abs(np.asarray(a, np.float64)
                       * np.asarray(b, np.float64)).sum())
    assert abs(float(got) - float(want)) <= _RTOL[dtype] * mag


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(_MATRICES))
def test_block_spmv_plain_matches_pallas(name, dtype):
    W, W_r, v, terms = _operands(name, dtype, 11)
    y = wbk.windowed_ell_block_spmv_plain(W.window_starts, W.cols_local,
                                          W.vals, _t(v["x"]), W.shape[0])
    y_r = ref_u.windowed_ell_block_spmv(
        W_r.window_starts, W_r.cols_local, W_r.vals, jnp.asarray(v["x"]),
        W_r.win, W_r.shape[0], interpret=True)
    assert y.dtype == _TORCH[dtype]
    _within(y.numpy(), y_r, terms, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(_MATRICES))
def test_block_residual_and_correction_plain_match_pallas(name, dtype):
    W, W_r, v, terms = _operands(name, dtype, 12)
    x, f, S = v["x"], v["f"], v["S"]
    args = (W.window_starts, W.cols_local, W.vals)
    ref_args = (W_r.window_starts, W_r.cols_local, W_r.vals)
    r = wbk.windowed_ell_block_residual_plain(*args, _t(f), _t(x),
                                              W.shape[0])
    r_ref = ref_u.windowed_ell_block_residual(
        *ref_args, jnp.asarray(f), jnp.asarray(x), W_r.win, W_r.shape[0],
        interpret=True)
    res_terms = terms + np.abs(f)
    _within(r.numpy(), r_ref, res_terms, dtype)
    if W.shape[0] != W.shape[1]:
        return
    c = wbk.windowed_ell_block_scaled_correction_plain(
        *args, _t(S), _t(f), _t(x), W.shape[0])
    c_ref = ref_u.windowed_ell_block_scaled_correction(
        *ref_args, jnp.asarray(S), jnp.asarray(f), jnp.asarray(x), W_r.win,
        W_r.shape[0], interpret=True)
    b = W.block[0]
    corr_terms = np.einsum("nij,nj->ni", np.abs(S).astype(np.float64),
                           res_terms.reshape(-1, b)).reshape(-1)
    _within(c.numpy(), c_ref, np.abs(x) + corr_terms, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("name", ["empty_tile_b2", "p3b_12_b2",
                                  "p3b_16_b3"])
def test_block_spmv_dots_plain_matches_pallas(name, with_w, dtype):
    W, W_r, v, terms = _operands(name, dtype, 13)
    x, w = v["x"], (v["w"] if with_w else None)
    y, yy, yx, yw = wbk.windowed_ell_block_spmv_dots_plain(
        W.window_starts, W.cols_local, W.vals, _t(x),
        None if w is None else _t(w), W.shape[0])
    y_r, yy_r, yx_r, yw_r = ref_u.windowed_ell_block_spmv_dots(
        W_r.window_starts, W_r.cols_local, W_r.vals, jnp.asarray(x),
        None if w is None else jnp.asarray(w), win=W_r.win,
        n_out=W_r.shape[0], interpret=True)
    _within(y.numpy(), y_r, terms, dtype)
    _dot_within(yy, yy_r, terms, 2 * terms, dtype)
    _dot_within(yx, yx_r, terms, x, dtype)
    assert all(d.dim() == 0 and d.dtype == y.dtype for d in (yy, yx))
    if w is None:
        assert yw is None and yw_r is None
    else:
        _dot_within(yw, yw_r, terms, w, dtype)


# -- the hierarchy and the solve ----------------------------------------------

@pytest.fixture(scope="module")
def block16():
    """poisson3d_block(16, 3) and the JAX package's float64 hierarchy."""
    A, rhs = poisson3d_block(16, 3)
    A_r, _ = ref_p3b(16, 3)
    ref = RefAMG(A_r, RefParams(dtype=jnp.float64, coarse_enough=_COARSE))
    return A, A_r, rhs, ref


def test_hierarchy_matches_reference(block16, monkeypatch):
    """Same level count and block shapes; every operator and transfer a
    block windowed ELL of 3×3 blocks with the reference's K and window;
    the transfers stored (no implicit spec, no fused legs); the smoother
    scale per node; the coarse inverse over scalar unknowns. The port's
    device setup (block systems decline the stencil build, and aggregate
    with the device MIS) against the JAX package's
    (``AMGCL_TPU_DEVICE_SETUP=1``)."""
    A, A_r, _, _ = block16
    monkeypatch.setenv("AMGCL_TPU_DEVICE_SETUP", "1")
    ref = RefAMG(A_r, RefParams(dtype=jnp.float64, coarse_enough=_COARSE))
    port = AMG(A, AMGParams(dtype=torch.float64, coarse_enough=_COARSE),
               device="cpu", device_setup=True)
    levels, levels_r = port.hierarchy.levels, ref.hierarchy.levels
    assert len(levels) == len(levels_r) >= 3
    for i, (lv, lv_r) in enumerate(zip(levels, levels_r)):
        parts = [(lv.A, lv_r.A)]
        if lv.P is not None:
            parts += [(lv.P, lv_r.P), (lv.R, lv_r.R)]
            assert lv.down is None and lv.up is None
            assert tuple(lv.relax.scale.shape) == (lv.A.shape[0], 3, 3)
            assert lv.relax.scale.is_contiguous()
            np.testing.assert_allclose(lv.relax.scale.numpy(),
                                       np.asarray(lv_r.relax.scale),
                                       rtol=1e-12, atol=1e-15)
        for got, want in parts:
            assert type(got).__name__ == type(want).__name__ \
                == "WindowedEllMatrix"
            assert (got.shape, got.block, got.K, got.win) == (
                want.shape, want.block, want.cols_local.shape[2], want.win)
    for (Ai, P, R), (Ai_r, P_r, _) in zip(port.host_levels, ref.host_levels):
        assert Ai.block_size == Ai_r.block_size == (3, 3)
        assert Ai.shape == Ai_r.shape
        if P is not None:
            assert P.is_block and R.is_block
            assert getattr(P, "_implicit_spec", None) is None
            _same_csr(P, P_r)
    n_last = levels[-1].A.shape[0] * 3
    assert tuple(port.hierarchy.coarse.inv.shape) == (n_last, n_last)
    st = port.hierarchy_stats()
    assert not port.device_built
    assert [lv["unknowns"] for lv in st["levels"]] \
        == [lv.A.shape[0] * 3 for lv in levels]
    assert st["levels"][0]["block"] == [3, 3]
    assert "Block size:          3x3" in repr(port)
    assert "%12d" % (A.nrows * 3) in repr(port)


def test_coarse_enough_counts_scalar_unknowns(block16):
    """4,096 block rows are 12,288 unknowns: coarse_enough = 5,000 (above
    the block rows, below the unknowns) still coarsens, as in the
    reference, and the JAX package's level count follows."""
    A, A_r, _, _ = block16
    port = AMG(A, AMGParams(dtype=torch.float64, coarse_enough=5000),
               device="cpu")
    ref = RefAMG(A_r, RefParams(dtype=jnp.float64, coarse_enough=5000))
    assert len(port.hierarchy.levels) == len(ref.hierarchy.levels) >= 2


def _well(W):
    return {"window_starts": np.asarray(W.window_starts),
            "cols_local": np.asarray(W.cols_local),
            "vals": np.asarray(W.vals), "shape": W.shape, "win": W.win,
            "block": W.block}


def _arrays(ref):
    """The JAX hierarchy as the plain arrays hierarchy_from_arrays takes."""
    levels = []
    for lv in ref.hierarchy.levels:
        row = {"A": _well(lv.A)}
        if lv.P is not None:
            row.update(P=_well(lv.P), R=_well(lv.R),
                       scale=np.asarray(lv.relax.scale))
        levels.append(row)
    return levels, np.asarray(ref.hierarchy.coarse.inv)


def test_bicgstab_on_carried_hierarchy_matches_reference(block16):
    """One preconditioner application agrees to 1e-10 of its largest
    entry; BiCGStab in float64 takes the JAX package's iteration count,
    and both meet the tolerance with residuals within 1e-4 relative."""
    _, A_r, rhs, ref = block16
    levels, inv = _arrays(ref)
    hier = hierarchy_from_arrays(levels, inv,
                                 AMGParams(dtype=torch.float64), "cpu")
    r = np.random.RandomState(11).standard_normal(A_r.nrows * 3)
    z_ref = np.asarray(ref.hierarchy.apply(jnp.asarray(r)))
    z = hier.apply(torch.as_tensor(r)).numpy()
    assert np.max(np.abs(z - z_ref)) <= 1e-10 * np.abs(z_ref).max()
    _, info_r = ref_make_solver(A_r, ref, RefBiCGStab(tol=1e-8))(rhs)
    x, iters, resid, hs = BiCGStab(tol=1e-8).solve(
        hier.system_matrix, hier.apply, torch.as_tensor(rhs))
    assert iters == info_r.iters and hs.flags == 0
    assert max(resid, info_r.resid) <= 1e-8
    np.testing.assert_allclose(resid, info_r.resid, rtol=1e-4)


def test_bicgstab_on_carried_float32_hierarchy(block16):
    """The same hierarchy in float32 on both sides: each reported residual
    under tol, within a factor 2 of the other, and iteration counts within
    one."""
    A, A_r, rhs, _ = block16
    ref = RefAMG(A_r, RefParams(dtype=jnp.float32, coarse_enough=_COARSE))
    levels, inv = _arrays(ref)
    hier = hierarchy_from_arrays(levels, inv,
                                 AMGParams(dtype=torch.float32), "cpu")
    b32 = rhs.astype(np.float32)
    _, info_r = ref_make_solver(A_r, ref, RefBiCGStab(tol=1e-6))(
        jnp.asarray(b32))
    x, iters, resid, _ = BiCGStab(tol=1e-6).solve(
        hier.system_matrix, hier.apply, torch.as_tensor(b32))
    assert abs(iters - info_r.iters) <= 1
    assert max(resid, info_r.resid) <= 1e-6
    assert 0.5 <= resid / info_r.resid <= 2.0


def _floor(A, rhs, x):
    """u · ‖|A| |x|‖ / ‖b‖: how far rounding x to float32 moves the true
    relative residual."""
    return _U32 * np.linalg.norm(abs(A.to_scipy()) @ np.abs(x)) \
        / np.linalg.norm(rhs)


def test_headline_call_matches_reference(block16):
    """The block configuration of the benchmark at n = 16: float32
    hierarchy, BiCGStab(maxiter=200, tol=1e-6), no refinement. The JAX
    package's iteration count, the reported residual under tol, the
    true one within tol plus the float32 rounding floor; with refine=3
    the float64 outer residual runs on a float64 block windowed ELL and
    the true residual meets tol."""
    A, A_r, rhs, _ = block16
    kw = dict(maxiter=200, tol=1e-6)
    _, info_r = ref_make_solver(A_r, RefParams(dtype=jnp.float32),
                                RefBiCGStab(**kw))(
        jnp.asarray(rhs, jnp.float32))
    solve = make_solver(A, AMGParams(dtype=torch.float32), BiCGStab(**kw),
                        device="cpu")
    x, info = solve(rhs)
    assert x.dtype == torch.float32 and info.health == []
    assert info.iters == info_r.iters and info.resid <= 1e-6
    x = x.double().numpy()
    tr = np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs)
    assert tr <= 1e-6 + 2 * _floor(A, rhs, x)
    refined = make_solver(A, AMGParams(dtype=torch.float32), BiCGStab(**kw),
                          refine=3, device="cpu")
    assert isinstance(refined.A_dev64, U.WindowedEllMatrix)
    assert refined.A_dev64.block == (3, 3)
    assert refined.A_dev64.dtype == torch.float64
    x, info = refined(rhs)
    assert x.dtype == torch.float64
    tr = np.linalg.norm(rhs - A.spmv(x.numpy())) / np.linalg.norm(rhs)
    assert tr <= 1e-6 and abs(tr - info.resid) <= 1e-12


def _chip_smoke_constants():
    import ast
    from pathlib import Path
    tree = ast.parse((Path(__file__).resolve().parent.parent
                      / "chip_smoke.py").read_text())
    return {t.id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) for t in node.targets
            if isinstance(t, ast.Name)
            and t.id in ("B_LEVELS", "B_ITERS", "B_ITERS_REFINED")}


def test_block_path_constants_at_full_size():
    """The constants ``chip_smoke.py`` holds path B1 to, at its full size
    on the CPU: ``poisson3d_block(48, 3)``, float32 hierarchy,
    BiCGStab(maxiter=200, tol=1e-6). The JAX package's level rows and
    iteration counts without and with refine=3, and the port's the same;
    and why B1 without refinement holds its true residual to 1e-6 plus
    the float32 floor: the float64 solution rounded to float32 already
    misses 1e-6, by less than u · ‖|A| |x|‖ / ‖b‖."""
    want = _chip_smoke_constants()
    A, rhs = poisson3d_block(48, 3)
    A_r, _ = ref_p3b(48, 3)
    kw = dict(maxiter=200, tol=1e-6)
    got_r, got = {}, {}
    for refine in (0, 3):
        ref = ref_make_solver(A_r, RefParams(dtype=jnp.float32),
                              RefBiCGStab(**kw), refine=refine)
        _, info_r = ref(rhs if refine else jnp.asarray(rhs, jnp.float32))
        got_r[refine] = ([lv.A.shape[0] for lv in
                          ref.precond.hierarchy.levels], info_r.iters)
        solve = make_solver(A, AMGParams(dtype=torch.float32),
                            BiCGStab(**kw), refine=refine, device="cpu")
        _, info = solve(rhs)
        got[refine] = ([lv.A.shape[0] for lv in
                        solve.precond.hierarchy.levels], info.iters)
    assert got_r == got == {0: (want["B_LEVELS"], want["B_ITERS"]),
                            3: (want["B_LEVELS"], want["B_ITERS_REFINED"])}
    exact = make_solver(A, AMGParams(dtype=torch.float64),
                        BiCGStab(maxiter=200, tol=1e-12), device="cpu")
    x = exact(rhs)[0].numpy()
    x32 = x.astype(np.float32).astype(np.float64)
    floor_res = np.linalg.norm(rhs - A.spmv(x32)) / np.linalg.norm(rhs)
    assert 1e-6 < floor_res <= _floor(A, rhs, x)


def test_wrong_size_rhs_names_the_unknowns():
    A, rhs = poisson3d_block(6, 3)
    solve = make_solver(A, AMGParams(dtype=torch.float64), BiCGStab(),
                        device="cpu")
    with pytest.raises(ValueError, match="648 unknowns"):
        solve(np.ones(A.nrows))
    with pytest.raises(ValueError, match="648 unknowns"):
        solve(rhs, x0=np.ones(A.nrows + 1))


# -- format choice and dispatch ---------------------------------------------

def test_auto_never_picks_dense_or_dia_for_block_matrices():
    """A 64-node block matrix (dense as a scalar matrix of its size and
    fill) and a 7-diagonal one (DIA as a scalar matrix) both take windowed
    ELL; a block matrix whose window is over the budget takes block ELL,
    whose product matches the host's; DIA is refused outright."""
    A, _ = poisson3d_block(4, 3)
    S = A.unblock()
    assert type(dev.to_device(S, "auto", torch.float64, "cpu")).__name__ \
        == "DenseMatrix"
    W = dev.to_device(A, "auto", torch.float64, "cpu")
    assert isinstance(W, U.WindowedEllMatrix) and W.block == (3, 3)
    A, _ = poisson3d_block(12, 3)
    assert type(dev.to_device(A.unblock(), "auto", torch.float64,
                              "cpu")).__name__ == "DiaMatrix"
    assert isinstance(dev.to_device(A, "auto", torch.float64, "cpu"),
                      U.WindowedEllMatrix)
    with pytest.raises(ValueError, match="scalar matrices"):
        dev.to_device(A, "dia", torch.float64, "cpu")
    rng = np.random.RandomState(3)
    S = sp.csr_matrix((np.ones(3000), (np.arange(3000),
                                       rng.randint(0, 600000, 3000))),
                      shape=(3000, 600000))
    wide = CSR(S.indptr, S.indices, rng.standard_normal((3000, 2, 2)),
               600000)
    E = dev.to_device(wide, "auto", torch.float64, "cpu")
    assert isinstance(E, dev.EllMatrix) and E.block == (2, 2)
    x = np.random.RandomState(2).standard_normal(wide.ncols * 2)
    np.testing.assert_allclose(E.mv(torch.as_tensor(x)).numpy(),
                               wide.spmv(x), rtol=1e-12, atol=1e-12)


def test_cpu_tensors_take_the_plain_versions():
    A, _ = poisson3d_block(10, 3)
    W = dev.to_device(A, "auto", torch.float32, "cpu")
    rng = np.random.RandomState(4)
    n = A.nrows * 3
    x, f, w = (torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
               for _ in range(3))
    S = torch.as_tensor(rng.standard_normal((A.nrows, 3, 3)),
                        dtype=torch.float32)
    wrappers = (wbk.windowed_ell_block_spmv, wbk.windowed_ell_block_residual,
                wbk.windowed_ell_block_scaled_correction,
                wbk.windowed_ell_block_spmv_dots)
    plains = (wbk.windowed_ell_block_spmv_plain,
              wbk.windowed_ell_block_residual_plain,
              wbk.windowed_ell_block_scaled_correction_plain,
              wbk.windowed_ell_block_spmv_dots_plain)
    launches = [k.launches for k in wrappers]
    calls = [p.calls for p in plains]
    dev.spmv(W, x)
    r = dev.residual(f, W, x)
    assert torch.equal(fv.residual_dot(f, W, x)[0], r)
    assert dev.scaled_correction(W, S, f, x) is not None
    assert dev.scaled_correction(W, w, f, x) is None    # scalar scale
    dev.spmv_dots(W, x, w)
    assert [k.launches for k in wrappers] == launches
    assert [p.calls for p in plains] == [calls[0] + 1, calls[1] + 2,
                                         calls[2] + 1, calls[3] + 1]
