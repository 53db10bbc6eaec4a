"""The port's hierarchy setup against the JAX package's in float64: at
poisson3d(32) (grid route) and on a permuted 2-D Laplacian (greedy
aggregation route), the same levels, device operators, smoother and
coarse inverse."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.utils.sample_problem import poisson3d as ref_poisson3d

from amgcl_tpu_torch import AMG, AMGParams, poisson3d


@pytest.fixture(scope="module")
def pair():
    A_ref, _ = ref_poisson3d(32)
    A, _ = poisson3d(32)
    ref = RefAMG(A_ref, RefParams(dtype=jnp.float64))
    got = AMG(A, AMGParams(dtype=torch.float64), device="cpu")
    return ref, got


def test_levels_match(pair):
    ref, got = pair
    assert ref._reorder is None          # no executed reorder to mirror
    assert len(got.host_levels) == len(ref.host_levels) == 3
    for (Ar, _, _), (Ag, _, _) in zip(ref.host_levels, got.host_levels):
        assert (Ag.nrows, Ag.nnz) == (Ar.nrows, Ar.nnz)
    assert [h[0].nrows for h in got.host_levels] == [32768, 4096, 512]
    for lr, lg in zip(ref.hierarchy.levels, got.hierarchy.levels):
        assert type(lg.A).__name__ == type(lr.A).__name__


def _dia_pairs(lv):
    return {"A": lv.A, "M": lv.P.M, "Mt": lv.R.Mt}


@pytest.mark.parametrize("level", [0, 1])
def test_dia_operators_and_grid_match(pair, level):
    ref, got = pair
    lr, lg = ref.hierarchy.levels[level], got.hierarchy.levels[level]
    for name, Mr in _dia_pairs(lr).items():
        Mg = _dia_pairs(lg)[name]
        assert Mg.offsets == tuple(Mr.offsets), name
        assert Mg.shape == tuple(Mr.shape), name
        np.testing.assert_allclose(Mg.data.numpy(), np.asarray(Mr.data),
                                   rtol=1e-12, atol=0, err_msg=name)
    Tr, Tg = lr.P.T, lg.P.T
    assert (Tg.fine, Tg.block, Tg.coarse) == (Tr.fine, Tr.block, Tr.coarse)
    np.testing.assert_allclose(lg.relax.scale.numpy(),
                               np.asarray(lr.relax.scale), rtol=1e-12)


def test_coarse_level_matches(pair):
    ref, got = pair
    np.testing.assert_allclose(got.hierarchy.levels[-1].A.a.numpy(),
                               np.asarray(ref.hierarchy.levels[-1].A.a),
                               rtol=1e-12)
    inv_r = np.asarray(ref.hierarchy.coarse.inv)
    inv_g = got.hierarchy.coarse.inv.numpy()
    assert np.max(np.abs(inv_g - inv_r)) <= 1e-10 * np.abs(inv_r).max()


def test_stats_and_repr(pair):
    _, got = pair
    st = got.hierarchy_stats()
    assert st["n_levels"] == 3
    assert [lv["format"] for lv in st["levels"]] \
        == ["DiaMatrix", "DiaMatrix", "DenseMatrix"]
    assert st["bytes"] > 0 and st["operator_complexity"] > 1
    assert "Number of levels:    3" in repr(got)


def _greedy_loop(S):
    """Row-by-row transcription of the greedy distance-2 pass
    (csrc/setup_kernels.cpp::aggregate_d2) — the loop reference."""
    n = S.shape[0]
    ptr, col = S.indptr, S.indices
    agg = [-3 if ptr[i + 1] > ptr[i] else -1 for i in range(n)]
    owner = [-3] * n
    count = 0
    for i in range(n):
        if agg[i] != -3 or owner[i] != -3:
            continue
        agg[i] = count
        for c in col[ptr[i]:ptr[i + 1]]:
            if agg[c] == -3:
                agg[c] = count
                for cc in col[ptr[c]:ptr[c + 1]]:
                    if agg[cc] == -3 and owner[cc] == -3:
                        owner[cc] = count
        count += 1
    return [a if a != -3 else (owner[i] if owner[i] != -3 else -1)
            for i, a in enumerate(agg)], count


def _diag_dominant(M):
    import scipy.sparse as sp
    return sp.csr_matrix(M + sp.diags(np.asarray(abs(M).sum(axis=1)).ravel()
                                      + 1.0))


def _permuted_laplacian2d(n=40, seed=5):
    """5-point Laplacian on an n×n grid under a random symmetric
    permutation: no grid is detectable, so every level aggregates with
    the greedy pass."""
    import scipy.sparse as sp
    T = sp.diags([-np.ones(n - 1), -np.ones(n - 1)], [-1, 1])
    L = (sp.kron(sp.identity(n), T) + sp.kron(T, sp.identity(n))).tocsr()
    p = np.random.RandomState(seed).permutation(n * n)
    return _diag_dominant(L[p][:, p])


def _native_or_skip():
    from amgcl_tpu import native
    if native.lib() is None:
        pytest.skip("the JAX package's native setup library did not build: "
                    "its greedy aggregation pass is the reference here")


@pytest.mark.parametrize("fixture", ["stencil27", "unstructured"])
def test_greedy_aggregates_match_reference_pass(fixture):
    """The port's numpy aggregation equals the JAX package's native
    greedy pass, and a row-by-row transcription of it, on the JAX
    package's own strength graph."""
    import scipy.sparse as sp
    from amgcl_tpu import native
    from amgcl_tpu.coarsening.aggregates import \
        strength_graph as ref_strength_graph
    from amgcl_tpu.ops.csr import CSR as RefCSR
    from amgcl_tpu_torch.coarsening.aggregates import (greedy_aggregates,
                                                       plain_aggregates,
                                                       strength_graph)
    from amgcl_tpu_torch.ops.csr import CSR
    _native_or_skip()
    rng = np.random.RandomState(5)
    if fixture == "stencil27":
        n = 12
        T = sp.diags([np.ones(n - 1), np.ones(n), np.ones(n - 1)],
                     [-1, 0, 1])
        K = sp.kron(T, sp.kron(T, T)).tocsr()
        K.data = -np.abs(rng.standard_normal(K.nnz))
        M = K + K.T
    else:
        R = sp.random(3000, 3000, density=0.002, random_state=5)
        M = -(abs(R) + abs(R).T)
    M = _diag_dominant(M)
    A = CSR.from_scipy(M)
    A_ref = RefCSR.from_scipy(M)
    S_ref = ref_strength_graph(A_ref, 0.08)
    S = strength_graph(A, 0.08)
    assert (S != S_ref).nnz == 0
    agg, n_agg = plain_aggregates(A, 0.08)
    want, n_want = native.native_aggregates(A_ref, 0.08)
    assert n_agg == n_want and np.array_equal(agg, want)
    assert 1 < n_agg < A.nrows
    loop, n_loop = _greedy_loop(S_ref.tocsr())
    assert n_loop == n_agg and loop == agg.tolist()
    agg_s, n_s = greedy_aggregates(S_ref.tocsr())
    assert n_s == n_agg and np.array_equal(agg_s, agg)


@pytest.fixture(scope="module")
def greedy_pair():
    _native_or_skip()
    M = _permuted_laplacian2d()
    ref = RefAMG(M, RefParams(dtype=jnp.float64, coarse_enough=200))
    got = AMG(M, AMGParams(dtype=torch.float64, coarse_enough=200),
              device="cpu")
    return ref, got


def test_greedy_route_hierarchy_matches(greedy_pair):
    """End to end on the greedy route (JAX AMG with its native pass):
    same levels, aggregates, host operators and device transfers."""
    ref, got = greedy_pair
    assert ref._reorder is None
    assert [h[0].nrows for h in got.host_levels] \
        == [h[0].nrows for h in ref.host_levels] == [1600, 232, 18]
    for (Ar, Pr, _), (Ag, Pg, _) in zip(ref.host_levels, got.host_levels):
        assert Ag.nnz == Ar.nnz
        assert abs(Ag.to_scipy() - Ar.to_scipy()).max() \
            <= 1e-12 * abs(Ar.to_scipy()).max()
        if Pr is not None:
            assert Pg.nnz == Pr.nnz
            assert abs(Pg.to_scipy() - Pr.to_scipy()).max() \
                <= 1e-12 * abs(Pr.to_scipy()).max()
    rng = np.random.RandomState(11)
    for lr, lg in zip(ref.hierarchy.levels[:-1], got.hierarchy.levels[:-1]):
        assert type(lg.P.T).__name__ == type(lr.P.T).__name__ \
            == "AggTentative"
        np.testing.assert_array_equal(lg.P.T.agg.numpy(),
                                      np.asarray(lr.P.T.agg))
        nf, nc = lg.P.T.shape
        uc, uf = rng.standard_normal(nc), rng.standard_normal(nf)
        np.testing.assert_allclose(
            lg.P.mv(torch.as_tensor(uc)).numpy(),
            np.asarray(lr.P.mv(jnp.asarray(uc))), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            lg.R.mv(torch.as_tensor(uf)).numpy(),
            np.asarray(lr.R.mv(jnp.asarray(uf))), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(lg.relax.scale.numpy(),
                                   np.asarray(lr.relax.scale), rtol=1e-12)
    inv_r = np.asarray(ref.hierarchy.coarse.inv)
    inv_g = got.hierarchy.coarse.inv.numpy()
    assert np.max(np.abs(inv_g - inv_r)) <= 1e-10 * np.abs(inv_r).max()
    r = rng.standard_normal(1600)
    np.testing.assert_allclose(
        got.hierarchy.apply(torch.as_tensor(r)).numpy(),
        np.asarray(ref.hierarchy.apply(jnp.asarray(r))),
        rtol=1e-10, atol=1e-12)
