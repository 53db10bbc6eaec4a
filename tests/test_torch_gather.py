"""The port's gather SpMV against the JAX package: ``gather_spmv_plain``
against the Pallas kernel ``gather_spmv`` in interpret mode and against
its take-along reference ``gather_spmv_xla``, for K = 4, 8, 12 and 16 in
float32 and float64, on operators whose window starts differ from tile
to tile and on one with a tile without entries; and the dispatch of
``WindowedEllMatrix.mv`` (gather for scalar operators with K ≤ 16, the
windowed-ELL kernel above, the block kernel for block values) against
the reference's own choice in ``maybe_gather_spmv``.

Tolerances: per output entry |Δ| ≤ rtol · Σ|terms| with rtol 1e-5 in
float32 and 1e-12 in float64: the sides sum the same K products in
another order (and may contract to FMA).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from amgcl_tpu.ops import pallas_gather as ref_pg
from amgcl_tpu.ops import unstructured as ref_u
from amgcl_tpu.ops.csr import CSR as RefCSR

from amgcl_tpu_torch import CSR, fe_like_problem
from amgcl_tpu_torch.ops import gather_kernels as gk
from amgcl_tpu_torch.ops import unstructured as U
from amgcl_tpu_torch.ops import well_block_kernels as wbk
from amgcl_tpu_torch.ops import well_kernels as wk


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


def _arrays(K, dtype, seed, empty=None, n_out=3000, ncols=9000):
    """Random scalar windowed-ELL arrays: tiles of 1,024 rows (the last
    ragged), windows of 2,048 columns at starts that differ from tile to
    tile, about a quarter of the slots padding (column 0, value 0). Tile
    ``empty`` holds no entry and starts at ncols, as tile_windows packs
    such a tile, so its padding addresses one past x."""
    rng = np.random.RandomState(seed)
    tile, win = 1024, 2048
    n_tiles = -(-n_out // tile)
    starts = rng.permutation(np.arange(0, ncols - win + 1, 1024))[:n_tiles]
    cols = (rng.rand(n_tiles, tile, K) * win).astype(np.int32)
    vals = rng.standard_normal((n_tiles, tile, K)).astype(dtype)
    pad = rng.rand(n_tiles, tile, K) < 0.25
    cols[pad], vals[pad] = 0, 0
    if empty is not None:
        starts[empty] = ncols
        cols[empty], vals[empty] = 0, 0
    x = rng.standard_normal(ncols).astype(dtype)
    return starts.astype(np.int32), cols, vals, x, win, n_out


def _terms(starts, cols, vals, x, n_out):
    """Σ_k |vals · x| per row, the size of what each row sums."""
    ac = cols.astype(np.int64) + starts[:, None, None]
    xa = np.where(ac < len(x), np.abs(x.astype(np.float64))[
        np.minimum(ac, len(x) - 1)], 0.0)
    return (np.abs(vals.astype(np.float64)) * xa).sum(2).reshape(-1)[:n_out]


def _plain(starts, cols, vals, x, n_out):
    return gk.gather_spmv_plain(torch.as_tensor(starts),
                                torch.as_tensor(cols),
                                torch.as_tensor(vals), torch.as_tensor(x),
                                n_out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", gk.KS)
def test_plain_matches_pallas_and_xla(K, dtype):
    """Differing starts: the plain version, the Pallas kernel in
    interpret mode and gather_spmv_xla agree."""
    starts, cols, vals, x, win, n_out = _arrays(K, dtype, seed=K)
    assert len(set(starts.tolist())) == len(starts) > 2
    before = gk.gather_spmv_plain.calls
    y = _plain(starts, cols, vals, x, n_out)
    assert gk.gather_spmv_plain.calls == before + 1
    assert y.dtype == _TORCH[dtype] and y.shape == (n_out,)
    args = tuple(jnp.asarray(a) for a in (starts, cols, vals, x))
    y_pallas = ref_pg.gather_spmv(*args, win, n_out, interpret=True)
    y_xla = ref_pg.gather_spmv_xla(*args, n_out)
    terms = _terms(starts, cols, vals, x, n_out)
    for want in (y_pallas, y_xla):
        want = np.asarray(want, np.float64)
        assert np.all(np.abs(y.numpy() - want)
                      <= _RTOL[dtype] * terms + 1e-300)


@pytest.mark.parametrize("K,dtype", [(4, np.float32), (16, np.float64)])
def test_plain_matches_pallas_with_an_empty_tile(K, dtype):
    """A tile without entries reads past x: zero in the plain version and
    in the Pallas kernel's zero-padded window (gather_spmv_xla's
    ``jnp.take`` fills such reads with NaN, so it is not held here)."""
    starts, cols, vals, x, win, n_out = _arrays(K, dtype, seed=30 + K,
                                                empty=1)
    y = _plain(starts, cols, vals, x, n_out)
    y_pallas = np.asarray(ref_pg.gather_spmv(
        *(jnp.asarray(a) for a in (starts, cols, vals, x)), win, n_out,
        interpret=True), np.float64)
    assert np.all(y.numpy()[1024:2048] == 0)
    terms = _terms(starts, cols, vals, x, n_out)
    assert np.all(np.abs(y.numpy() - y_pallas)
                  <= _RTOL[dtype] * terms + 1e-300)


# -- the dispatch of WindowedEllMatrix.mv -----------------------------------

def _k20():
    """A banded 3,000-row matrix of 20 entries a row: K = 20 > 16."""
    n = 3000
    offsets = list(range(-10, 10))
    M = sp.diags([np.full(n - abs(d), 1.0 + 0.1 * i)
                  for i, d in enumerate(offsets)], offsets, format="csr")
    return CSR.from_scipy(M), RefCSR.from_scipy(M)


def _g1_like():
    """A small G1-like system (five nearest neighbours): K = 16."""
    A, _ = fe_like_problem(n=3000, nnz_target=6 * 3000, seed=2)
    return A, RefCSR.from_scipy(A.to_scipy())


def _counts():
    return (gk.gather_spmv_plain.calls, wk.windowed_ell_spmv_plain.calls,
            wbk.windowed_ell_block_spmv_plain.calls)


@pytest.mark.parametrize("case,want", [("g1_like", (1, 0, 0)),
                                       ("k20", (0, 1, 0)),
                                       ("block", (0, 0, 1))])
def test_mv_dispatch_matches_reference(case, want, monkeypatch):
    """The port's mv picks gather for a scalar operator with K ≤ 16, the
    windowed-ELL kernel for K > 16 and the block kernel for block values;
    the reference's maybe_gather_spmv (under its interpret hook) takes
    and declines the same operators, and where it takes one the two
    products agree."""
    if case == "block":
        S = sp.kron(_g1_like()[0].to_scipy(), np.ones((2, 2)), format="csr")
        A, A_ref = CSR.from_scipy(S).to_block(2), None
    else:
        A, A_ref = _g1_like() if case == "g1_like" else _k20()
        S = A.to_scipy()
    W = U.csr_to_windowed_ell(A, torch.float32)
    assert W is not None
    if case == "g1_like":
        assert W.K == 16 and W.block == (1, 1)
    elif case == "k20":
        assert W.K == 20
    else:
        assert W.block == (2, 2) and W.K <= 16
    x = np.random.RandomState(4).standard_normal(
        W.shape[1] * W.block[1]).astype(np.float32)
    before = _counts()
    y = W.mv(torch.as_tensor(x))
    assert tuple(a - b for a, b in zip(_counts(), before)) == want
    terms = abs(S) @ np.abs(x.astype(np.float64))
    y64 = S @ x.astype(np.float64)
    assert np.all(np.abs(y.numpy() - y64) <= 1e-5 * terms)
    if A_ref is None:
        return
    # the reference's kernels take float32 (its interpret hook gates on it)
    monkeypatch.setenv("AMGCL_TPU_PALLAS_INTERPRET", "1")
    W_ref = ref_u.csr_to_windowed_ell(A_ref, jnp.float32)
    y_ref = ref_pg.maybe_gather_spmv(W_ref, jnp.asarray(x))
    assert (y_ref is not None) == (case == "g1_like")
    if y_ref is not None:
        assert np.all(np.abs(y.numpy() - np.asarray(y_ref, np.float64))
                      <= 1e-5 * terms)


def test_g1_like_hierarchy_runs_gather_at_l0_only():
    """On a small G1-like hierarchy only L0 has K ≤ 16 (as at 85,623 rows,
    where the levels are K 16 / 40 / dense): a GMRES operator product at
    L0 goes to gather, one at L1 to the windowed-ELL kernel."""
    from amgcl_tpu_torch import AMG, AMGParams
    A, _ = fe_like_problem(n=6000, nnz_target=6 * 6000, seed=2)
    amg = AMG(A, AMGParams(dtype=torch.float32, coarse_enough=300),
              device="cpu")
    L = amg.hierarchy.levels
    assert isinstance(L[0].A, U.WindowedEllMatrix) and L[0].A.K == 16
    assert isinstance(L[1].A, U.WindowedEllMatrix) and L[1].A.K > 16
    before = _counts()
    L[0].A.mv(torch.ones(A.ncols))
    L[1].A.mv(torch.ones(L[1].A.shape[1]))
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 1, 0)
