"""The port's windowed-ELL format against the JAX package: packing entry
for entry, each kernel's plain version against the JAX Pallas kernel in
interpret mode (and the BiCGStab tail against ``_fused_pass``), the
format ``to_device('auto')`` picks at every level and transfer of small
unstructured hierarchies, and the CPU dispatch to the plain versions.

Tolerances: per output entry |Δ| ≤ rtol · Σ|terms| (the sum of the
absolute values of the terms that entry adds up), with rtol 1e-5 in
float32 and 1e-12 in float64: the two sides sum the same terms in
another order (and may contract to FMA), so the error scales with the
terms, not with the result. A dot is held to the same rtol times the sum
of the absolute products it adds.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.ops import device as ref_dev
from amgcl_tpu.ops import fused_vec as ref_fv
from amgcl_tpu.ops import unstructured as ref_u
from amgcl_tpu.ops.csr import CSR as RefCSR

from amgcl_tpu_torch import AMG, AMGParams, CSR
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.ops import unstructured as U
from amgcl_tpu_torch.ops import well_kernels as wk
from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute


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


def _fe(n, order, seed=1):
    """A small fe_like_problem (port and reference CSR of the same
    matrix), in identity or RCM order."""
    A, _ = U.fe_like_problem(n=n, nnz_target=n * 18, seed=seed)
    if order == "rcm":
        A = permute(A, cuthill_mckee(A))
    return A, RefCSR.from_scipy(A.to_scipy())


def _empty_tile():
    """3,072 rows whose middle tile (rows 1,024-2,047) holds no entry; the
    column count is a multiple of 1,024, so that tile's padding addresses
    one past the end of x."""
    rng = np.random.RandomState(5)
    n = 3072
    rows, cols = [], []
    for i in list(range(1024)) + list(range(2048, n)):
        for d in (-2, -1, 0, 1, 40):
            j = i + d
            if 0 <= j < n:
                rows.append(i)
                cols.append(j)
    M = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(n, n))
    return CSR.from_scipy(M), RefCSR.from_scipy(M)


def _ragged():
    """2,500 rows (a ragged last tile), banded with varying row length."""
    rng = np.random.RandomState(6)
    n = 2500
    M = sp.random(n, n, density=0.004, random_state=rng, format="csr") \
        + sp.diags([rng.rand(n) + 4, np.ones(n - 700)], [0, 700])
    return CSR.from_scipy(M), RefCSR.from_scipy(M)


_MATRICES = {
    "fe_identity": lambda: _fe(3000, "identity"),
    "fe_rcm": lambda: _fe(3000, "rcm"),
    "empty_tile": _empty_tile,
    "ragged": _ragged,
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(_MATRICES))
def test_packing_matches_reference(name, dtype):
    A, A_ref = _MATRICES[name]()
    W = U.csr_to_windowed_ell(A, _TORCH[dtype])
    W_ref = ref_u.csr_to_windowed_ell(A_ref, jnp.dtype(dtype))
    assert W.win == W_ref.win and W.shape == W_ref.shape
    assert W.K == W_ref.cols_local.shape[2] and W.tile == U._TILE
    np.testing.assert_array_equal(W.window_starts.numpy(),
                                  np.asarray(W_ref.window_starts))
    np.testing.assert_array_equal(W.cols_local.numpy(),
                                  np.asarray(W_ref.cols_local))
    np.testing.assert_array_equal(W.vals.numpy(), np.asarray(W_ref.vals))
    assert W.vals.dtype == _TORCH[dtype]
    assert W.window_starts.dtype == W.cols_local.dtype == torch.int32


def test_packing_cases_cover_what_they_claim():
    """RCM order gives differing window starts; the empty tile points at
    the column count; the ragged matrix's last tile is partial."""
    W = U.csr_to_windowed_ell(_fe(3000, "rcm")[0])
    assert len(set(W.window_starts.tolist())) > 1
    W = U.csr_to_windowed_ell(_empty_tile()[0])
    assert W.window_starts.tolist()[1] == 3072
    A = _ragged()[0]
    assert A.nrows % U._TILE and U.csr_to_windowed_ell(A) is not None


@pytest.mark.parametrize("name", sorted(_MATRICES))
def test_both_decline_the_same_matrices(name):
    A, A_ref = _MATRICES[name]()
    for budget in (4096, 8192, 4 << 20):
        why, why_ref = {}, {}
        W = U.csr_to_windowed_ell(A, max_win_bytes=budget, why=why)
        W_ref = ref_u.csr_to_windowed_ell(A_ref, max_win_bytes=budget,
                                          why=why_ref)
        assert (W is None) == (W_ref is None)
        assert why == why_ref


# -- each plain version against the JAX kernel in interpret mode ----------

def _operands(name, dtype, seed):
    A, A_ref = _MATRICES[name]()
    W = U.csr_to_windowed_ell(A, _TORCH[dtype])
    W_ref = ref_u.csr_to_windowed_ell(A_ref, jnp.dtype(dtype))
    rng = np.random.RandomState(seed)
    n, m = A.shape
    vecs = {"x": rng.standard_normal(m), "f": rng.standard_normal(n),
            "w": rng.rand(n)}
    vecs = {k: v.astype(dtype) for k, v in vecs.items()}
    absA = abs(A.to_scipy())
    terms = absA @ np.abs(vecs["x"].astype(np.float64))
    return W, W_ref, vecs, terms


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


_KERNEL_CASES = ["fe_rcm", "empty_tile", "ragged"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", _KERNEL_CASES)
def test_spmv_plain_matches_pallas(name, dtype):
    W, W_ref, v, terms = _operands(name, dtype, 11)
    y = wk.windowed_ell_spmv_plain(W.window_starts, W.cols_local, W.vals,
                                   _t(v["x"]), W.shape[0])
    y_ref = ref_u.windowed_ell_spmv(
        W_ref.window_starts, W_ref.cols_local, W_ref.vals,
        jnp.asarray(v["x"]), W_ref.win, W_ref.shape[0], interpret=True)
    assert y.dtype == _TORCH[dtype]
    _within(y.numpy(), y_ref, terms, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", _KERNEL_CASES)
def test_fused_residual_and_correction_plain_match_pallas(name, dtype):
    W, W_ref, v, terms = _operands(name, dtype, 12)
    x, f, w = v["x"], v["f"], v["w"]
    args = (W.window_starts, W.cols_local, W.vals)
    ref_args = (W_ref.window_starts, W_ref.cols_local, W_ref.vals)
    r = wk.windowed_ell_residual_plain(*args, _t(f), _t(x), W.shape[0])
    r_ref = ref_u.windowed_ell_residual(*ref_args, jnp.asarray(f),
                                        jnp.asarray(x), W_ref.win,
                                        W_ref.shape[0], interpret=True)
    res_terms = terms + np.abs(f)
    _within(r.numpy(), r_ref, res_terms, dtype)
    if W.shape[0] != W.shape[1]:
        return
    c = wk.windowed_ell_scaled_correction_plain(
        *args, _t(w), _t(f), _t(x), W.shape[0])
    c_ref = ref_u.windowed_ell_scaled_correction(
        *ref_args, jnp.asarray(w), jnp.asarray(f), jnp.asarray(x),
        W_ref.win, W_ref.shape[0], interpret=True)
    _within(c.numpy(), c_ref, np.abs(x) + np.abs(w) * res_terms, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("name", _KERNEL_CASES)
def test_spmv_dots_plain_matches_pallas(name, with_w, dtype):
    W, W_ref, v, terms = _operands(name, dtype, 13)
    x, w = v["x"], (v["w"] if with_w else None)
    y, yy, yx, yw = wk.windowed_ell_spmv_dots_plain(
        W.window_starts, W.cols_local, W.vals, _t(x),
        None if w is None else _t(w), W.shape[0])
    y_r, yy_r, yx_r, yw_r = ref_u.windowed_ell_spmv_dots(
        W_ref.window_starts, W_ref.cols_local, W_ref.vals, jnp.asarray(x),
        None if w is None else jnp.asarray(w), win=W_ref.win,
        n_out=W_ref.shape[0], interpret=True)
    _within(y.numpy(), y_r, terms, dtype)
    # |Δ⟨y,·⟩| also carries each y entry's own error, bounded by terms
    _dot_within(yy, yy_r, terms, 2 * terms, dtype)
    _dot_within(yx, yx_r, terms, x, dtype)
    assert all(d.dim() == 0 and d.dtype == y.dtype for d in (yy, yx))
    if w is None:
        assert yw is None and yw_r is None
    else:
        _dot_within(yw, yw_r, terms, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [5000, 20000])
def test_bicgstab_tail_plain_matches_pallas(n, dtype):
    rng = np.random.RandomState(n)
    phat, shat, s, t, x, rhat = (rng.standard_normal(n).astype(dtype)
                                 for _ in range(6))
    alpha, omega = dtype(0.37), dtype(-1.3)
    got = fv.bicgstab_tail_plain(torch.tensor(alpha), *map(_t, (phat,)),
                                 torch.tensor(omega),
                                 *map(_t, (shat, s, t, x, rhat)))
    want = ref_fv._fused_pass(
        "bicg_tail", (alpha, omega),
        tuple(jnp.asarray(a) for a in (phat, shat, s, t, x, rhat)),
        interpret=True)
    xn_terms = np.abs(x) + abs(alpha) * np.abs(phat) \
        + abs(omega) * np.abs(shat)
    rn_terms = np.abs(s) + abs(omega) * np.abs(t)
    _within(got[0].numpy(), want[0], xn_terms, dtype)
    _within(got[1].numpy(), want[1], rn_terms, dtype)
    # r' = s − ω t may cancel: its error, and the dots', scale with
    # |s| + |ω t|
    _dot_within(got[2], want[2], rn_terms, 2 * rn_terms, dtype)
    _dot_within(got[3], want[3], rhat, rn_terms, dtype)
    assert got[2].dim() == got[3].dim() == 0


# -- format choice ----------------------------------------------------------

def _port_dia(A):
    nd, fill = dev.dia_efficiency(A)
    return nd <= dev.MAX_DIAGS and fill <= dev.MAX_FILL


def _ref_dia(A):
    nd, fill = ref_dev.dia_efficiency(A)
    return nd <= 40 and fill <= 1.5       # the reference's off-TPU limits


@pytest.mark.parametrize("order", ["identity", "rcm"])
def test_auto_picks_the_reference_format_at_every_level(order):
    """Every level operator and both transfer operators of each level get
    the JAX package's format. Where the port's DIA limits (512 diagonals,
    fill 16, the reference's TPU values) and the reference's off-TPU ones
    (40, 1.5) disagree, the port is pinned to DIA and the difference is
    counted; on these hierarchies there is none."""
    A, A_ref = _fe(4000, order, seed=2)
    port = AMG(A, AMGParams(dtype=torch.float32, coarse_enough=500),
               device="cpu")
    ref = RefAMG(A_ref, RefParams(dtype=jnp.float32, coarse_enough=500))
    assert [h[0].nrows for h in port.host_levels] \
        == [lv.A.shape[0] for lv in ref.hierarchy.levels]
    disagree = 0
    pairs = []
    for (Ai, P, _), lv, lv_r in zip(port.host_levels, port.hierarchy.levels,
                                    ref.hierarchy.levels):
        pairs.append((Ai, lv.A, lv_r.A))
        if P is not None:
            M = P._implicit_spec["M"]
            pairs.append((M, lv.P.M, lv_r.P.M))
            pairs.append((M.transpose(), lv.R.Mt, lv_r.R.Mt))
    for Ai, got, want in pairs:
        name, want_name = type(got).__name__, type(want).__name__
        if want_name != "DenseMatrix" and _port_dia(Ai) != _ref_dia(
                RefCSR.from_scipy(Ai.to_scipy())):
            disagree += 1
            assert name == "DiaMatrix"
            continue
        assert name == want_name
        if name == "WindowedEllMatrix":
            assert (got.K, got.win) == (want.cols_local.shape[2], want.win)
    assert disagree == 0
    assert type(port.hierarchy.levels[0].A).__name__ == "WindowedEllMatrix"


@pytest.mark.parametrize("order", ["identity", "rcm"])
def test_reference_tpu_ranking_also_puts_well_first(order):
    """The port's ``auto`` follows the reference's off-TPU order, which
    never tries dense-window. On a TPU the reference ranks its candidates
    by predicted bytes per product (``_ranked_formats``); with ``on_tpu``
    forced, windowed ELL still comes first at every square level the port
    packs so, and dense-window, where eligible, ranks behind it."""
    from amgcl_tpu.telemetry.structure import candidate_table
    A, A_ref = _fe(4000, order, seed=2)
    port = AMG(A, AMGParams(dtype=torch.float32, coarse_enough=500),
               device="cpu")
    ref = RefAMG(A_ref, RefParams(dtype=jnp.float32, coarse_enough=500))
    checked = 0
    for lv, (Ai, _, _) in zip(port.hierarchy.levels, ref.host_levels):
        if not isinstance(lv.A, U.WindowedEllMatrix):
            continue
        cands = candidate_table(Ai, 4, on_tpu=True)
        eligible = {c["format"] for c in cands if c["eligible"]}
        ranked = [f for f in ref_dev._ranked_formats(cands) if f in eligible]
        assert ranked[0] == "well"
        checked += 1
    assert checked >= 1


def test_explicit_well_format_and_its_refusal():
    A, _ = _fe(3000, "rcm")
    W = dev.to_device(A, "well", torch.float64, "cpu")
    assert isinstance(W, U.WindowedEllMatrix) and W.dtype == torch.float64
    x = np.random.RandomState(3).standard_normal(A.ncols)
    np.testing.assert_allclose(W.mv(torch.as_tensor(x)).numpy(), A.spmv(x),
                               rtol=1e-12, atol=1e-12 * np.abs(A.val).max())
    with pytest.raises(ValueError, match="unknown device format"):
        dev.to_device(A, "bogus", torch.float32, "cpu")
    # the dense window is a format by name
    # (tests/test_torch_densewin.py)
    assert type(dev.to_device(A, "dwin", torch.float32, "cpu")).__name__ \
        == "DenseWindowMatrix"


# -- dispatch on the CPU ----------------------------------------------------

def test_cpu_tensors_take_the_plain_versions():
    A, _ = _fe(3000, "rcm")
    W = dev.to_device(A, "auto", torch.float32, "cpu")
    assert isinstance(W, U.WindowedEllMatrix)
    rng = np.random.RandomState(4)
    x, f, w = (torch.as_tensor(rng.standard_normal(A.nrows),
                               dtype=torch.float32) for _ in range(3))
    wrappers = (wk.windowed_ell_spmv, wk.windowed_ell_residual,
                wk.windowed_ell_scaled_correction, wk.windowed_ell_spmv_dots,
                fv.bicgstab_tail)
    plains = (wk.windowed_ell_spmv_plain, wk.windowed_ell_residual_plain,
              wk.windowed_ell_scaled_correction_plain,
              wk.windowed_ell_spmv_dots_plain, fv.bicgstab_tail_plain)
    launches = [k.launches for k in wrappers]
    calls = [p.calls for p in plains]
    dev.spmv(W, x)
    dev.residual(f, W, x)
    assert dev.scaled_correction(W, w, f, x) is not None
    dev.spmv_dots(W, x, w)
    fv.bicgstab_tail(torch.tensor(0.5), x, torch.tensor(0.25), f, w, x, f, w)
    assert [k.launches for k in wrappers] == launches
    assert [p.calls for p in plains] == [c + 1 for c in calls]
