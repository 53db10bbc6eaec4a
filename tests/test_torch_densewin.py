"""The port's dense-window format against the JAX package: the row-tile
windows, the packing bit for bit, every decline reason, the shared
budget, each kernel's plain version against the JAX Pallas kernel in
interpret mode, a dense-window hierarchy (``matrix_format="dwin"``) in
both packages and BiCGStab on it, and the device rule.

Tolerances: per output entry |Δ| ≤ rtol · Σ|terms| (the sum of the
absolute values of the terms that entry adds up), with rtol 1e-5 in
float32 and 1e-12 in float64: the two sides sum the same products in
another order.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops import densewin as ref_dw
from amgcl_tpu.ops import device as ref_dev
from amgcl_tpu.ops import unstructured as ref_u
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.solver.bicgstab import BiCGStab as RefBiCGStab
from amgcl_tpu.telemetry.ledger import DeviceMemoryBudget as RefBudget

from amgcl_tpu_torch import AMG, AMGParams, BiCGStab, CSR, make_solver
from amgcl_tpu_torch.convert import hierarchy_from_arrays
from amgcl_tpu_torch.ops import densewin as dw
from amgcl_tpu_torch.ops import densewin_kernels as dwk
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import unstructured as U
from amgcl_tpu_torch.ops.densewin import DenseWindowMatrix
from amgcl_tpu_torch.telemetry.ledger import DeviceMemoryBudget
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
_COARSE = 200          # coarse_enough that gives three levels at n = 1500


def _fe_rcm(n, seed, nnz_target=None):
    """An RCM-ordered fe_like_problem (port and reference CSR of the same
    matrix) and its rhs."""
    A, rhs = U.fe_like_problem(n=n, nnz_target=nnz_target or n * 18,
                               seed=seed)
    perm = cuthill_mckee(A)
    A = permute(A, perm)
    return A, RefCSR.from_scipy(A.to_scipy()), rhs[perm]


def _empty_tile():
    """The reference's fixture (tests/test_densewin.py): 130 rows whose
    second 64-row tile holds no entry."""
    n = 130
    rows = np.arange(64)
    M = sp.csr_matrix((np.linspace(1.0, 2.0, 64), (rows, rows)),
                      shape=(n, n))
    return CSR.from_scipy(M), RefCSR.from_scipy(M)


def _past_ncols():
    """1,100 rows, banded with a far entry per row, so that the last
    tiles' windows (start 1,024, win 1,024) reach past the 1,100
    columns."""
    rng = np.random.RandomState(8)
    n = 1100
    M = sp.diags([rng.rand(n) + 4, rng.standard_normal(n - 1),
                  rng.standard_normal(n - 1), rng.standard_normal(n - 300)],
                 [0, -1, 1, 300], format="csr")
    return CSR.from_scipy(M), RefCSR.from_scipy(M)


_MATRICES = {
    "fe_rcm": lambda: _fe_rcm(2000, 3, 36000)[:2],
    "empty_tile": _empty_tile,
    "past_ncols": _past_ncols,
}


@pytest.mark.parametrize("tile", [64, 1024])
def test_tile_windows_match_reference(tile):
    A, A_ref = _MATRICES["fe_rcm"]()
    got = U.tile_windows(A, tile)
    want = ref_u.tile_windows(A_ref, tile)
    assert got[0] == want[0] and got[4] == want[4]
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g, w)
    if tile == U._TILE:
        # windowed ELL keeps its 1,024-row tiles
        assert U.tile_windows(A)[4] == got[4]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(_MATRICES))
def test_packing_matches_reference_bit_for_bit(name, dtype):
    A, A_ref = _MATRICES[name]()
    D = dw.csr_to_dense_window(A, _TORCH[dtype], device="cpu")
    D_ref = ref_dw.csr_to_dense_window(A_ref, jnp.dtype(dtype))
    assert D.win == D_ref.win and D.shape == D_ref.shape
    np.testing.assert_array_equal(D.window_starts.numpy(),
                                  np.asarray(D_ref.window_starts))
    np.testing.assert_array_equal(D.blocks.numpy(), np.asarray(D_ref.blocks))
    assert D.blocks.dtype == _TORCH[dtype]
    assert D.window_starts.dtype == torch.int32
    assert D.bytes() == D_ref.bytes()


def test_packing_cases_cover_what_they_claim():
    """RCM order gives differing window starts; the empty tile points at
    the column count floored to 1,024; some window reaches past the last
    column; the row counts are no multiple of 64."""
    for name, A_of in _MATRICES.items():
        A = A_of()[0]
        D = dw.csr_to_dense_window(A, device="cpu")
        starts = D.window_starts.numpy()
        assert int(starts.max()) + D.win > A.ncols, name
        assert A.nrows % 64, name
    A = _MATRICES["fe_rcm"]()[0]
    assert len(set(dw.csr_to_dense_window(
        A, device="cpu").window_starts.tolist())) > 1
    D = dw.csr_to_dense_window(_empty_tile()[0], device="cpu")
    # tiles 1 and 2 are empty: their start is 130 floored to 1,024
    assert D.window_starts.tolist() == [0, 0, 0]
    assert not D.blocks[1:].any()


def _block_matrix():
    M = sp.random(8, 8, density=0.5, random_state=1, format="csr") \
        + sp.identity(8)
    return CSR.from_scipy(M).to_block(2), RefCSR(
        np.array([0, 1]), np.array([0]), np.ones((1, 2, 2)), 1)


def _wide(n=12000):
    """A window of 12,288 columns: within the byte caps, past the
    reference's VMEM rule in float64."""
    M = sp.diags([np.full(n, 4.0), np.ones(n - 11999)], [0, 11999],
                 format="csr")
    return CSR.from_scipy(M), RefCSR.from_scipy(M)


def _empty():
    M = sp.csr_matrix((100, 100))
    return CSR.from_scipy(M), RefCSR.from_scipy(M)


@pytest.mark.parametrize("case,dtype,pool", [
    ("fe_rcm", np.float32, None), ("fe_rcm", np.float32, 1024),
    ("fe_rcm", np.complex64, None), ("block", np.float32, None),
    ("empty", np.float32, None), ("wide", np.float64, None)])
def test_declines_match_reference(case, dtype, pool):
    """Every decline gives the JAX package's reason (and need), and
    to_device('dwin') raises where the JAX package's raises; ``pool``
    is the size of a fresh DeviceMemoryBudget given to both packages."""
    A, A_ref = {"fe_rcm": _MATRICES["fe_rcm"], "block": _block_matrix,
                "empty": _empty, "wide": _wide}[case]()
    tdt = {np.float32: torch.float32, np.float64: torch.float64,
           np.complex64: torch.complex64}[dtype]
    why, why_ref = {}, {}
    D = dw.csr_to_dense_window(
        A, tdt, budget=pool and DeviceMemoryBudget(pool), why=why,
        device="cpu")
    D_ref = ref_dw.csr_to_dense_window(
        A_ref, jnp.dtype(dtype), budget=pool and RefBudget(pool),
        why=why_ref)
    assert (D is None) == (D_ref is None)
    assert why == why_ref
    fails = D_ref is None
    for convert, arg, dt, Budget in (
            (dev.to_device, A, tdt, DeviceMemoryBudget),
            (ref_dev.to_device, A_ref, jnp.dtype(dtype), RefBudget)):
        kw = {"device": "cpu"} if convert is dev.to_device else {}
        kw["budget"] = pool and Budget(pool)
        if fails:
            with pytest.raises(ValueError, match="dense-window"):
                convert(arg, "dwin", dt, **kw)
        else:
            assert type(convert(arg, "dwin", dt, **kw)).__name__ \
                == "DenseWindowMatrix"


def test_declines_cover_every_reason():
    reasons = set()
    for case, dtype, pool in [
            ("fe_rcm", torch.float32, 1024), ("fe_rcm", torch.complex64,
                                              None),
            ("block", torch.float32, None), ("empty", torch.float32, None),
            ("wide", torch.float64, None)]:
        A = {"fe_rcm": _MATRICES["fe_rcm"], "block": _block_matrix,
             "empty": _empty, "wide": _wide}[case]()[0]
        why = {}
        assert dw.csr_to_dense_window(
            A, dtype, budget=pool and DeviceMemoryBudget(pool), why=why,
            device="cpu") is None
        reasons.add(why["why"])
    assert reasons == {"window", "complex dtype", "block values", "empty",
                       "vmem"}


def test_shared_budget_drains_then_declines_budget():
    """A budget that holds one conversion: the second declines with
    "budget" (it fits the pool's total, not what is left) in both
    packages, and a matrix wider than the whole pool with "window"."""
    A, A_ref = _MATRICES["fe_rcm"]()
    need = dw.csr_to_dense_window(A, device="cpu").bytes() - 4 * 32
    for budget, Budget, convert, arg, kw in (
            (None, DeviceMemoryBudget, dw.csr_to_dense_window, A,
             {"device": "cpu"}),
            (None, RefBudget, ref_dw.csr_to_dense_window, A_ref, {})):
        budget = Budget(need + need // 2)
        why = {}
        assert convert(arg, budget=budget, why=why, **kw) is not None
        assert budget.used == need and budget.remaining() == need // 2
        assert convert(arg, budget=budget, why=why, **kw) is None
        assert why["why"] == "budget" and budget.used == need
        why = {}
        assert convert(arg, budget=Budget(need - 1), why=why, **kw) is None
        assert why["why"] == "window"


# -- each plain version against the JAX kernel in interpret mode ----------

def _operands(name, dtype, seed):
    A, A_ref = _MATRICES[name]()
    D = dw.csr_to_dense_window(A, _TORCH[dtype], device="cpu")
    D_ref = ref_dw.csr_to_dense_window(A_ref, jnp.dtype(dtype))
    rng = np.random.RandomState(seed)
    n, m = A.shape
    v = {"x": rng.standard_normal(m), "f": rng.standard_normal(n),
         "w": rng.rand(n)}
    v = {k: a.astype(dtype) for k, a in v.items()}
    terms = abs(A.to_scipy()) @ np.abs(v["x"].astype(np.float64))
    return D, D_ref, v, terms


def _within(got, want, terms, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= _RTOL[dtype] * terms + 1e-300)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(_MATRICES))
def test_plain_versions_match_pallas(name, dtype):
    D, D_ref, v, terms = _operands(name, dtype, 21)
    x, f, w = (torch.as_tensor(v[k]) for k in "xfw")
    jx, jf, jw = (jnp.asarray(v[k]) for k in "xfw")
    geo = (D.window_starts, D.blocks)
    ref_geo = (D_ref.window_starts, D_ref.blocks)
    n = D.shape[0]
    y = dwk.dense_window_spmv_plain(*geo, x, n)
    assert y.dtype == _TORCH[dtype]
    _within(y.numpy(), ref_dw.dense_window_spmv(
        *ref_geo, jx, D_ref.win, n, interpret=True), terms, dtype)
    r = dwk.dense_window_residual_plain(*geo, f, x, n)
    res_terms = terms + np.abs(v["f"])
    _within(r.numpy(), ref_dw.dense_window_residual(
        *ref_geo, jf, jx, D_ref.win, n, interpret=True), res_terms, dtype)
    c = dwk.dense_window_scaled_correction_plain(*geo, w, f, x, n)
    _within(c.numpy(), ref_dw.dense_window_scaled_correction(
        *ref_geo, jw, jf, jx, D_ref.win, n, interpret=True),
        np.abs(v["x"]) + np.abs(v["w"]) * res_terms, dtype)


def test_cpu_dispatch_takes_the_plain_versions():
    """On CPU tensors mv, residual and scaled_correction reach the plain
    versions, spmv_dots composes from mv, and no kernel launches."""
    D, _, v, _ = _operands("fe_rcm", np.float32, 22)
    x, f, w = (torch.as_tensor(v[k]) for k in "xfw")
    plains = (dwk.dense_window_spmv_plain, dwk.dense_window_residual_plain,
              dwk.dense_window_scaled_correction_plain)
    kernels = (dwk.dense_window_spmv, dwk.dense_window_residual,
               dwk.dense_window_scaled_correction)
    before = [p.calls for p in plains]
    launched = [k.launches for k in kernels]
    y = D.mv(x)
    torch.testing.assert_close(dev.residual(f, D, x), f - y)
    got = dev.scaled_correction(D, w, f, x)
    torch.testing.assert_close(got, x + w * (f - y))
    y2, yy, yx, yw = dev.spmv_dots(D, x, w)
    torch.testing.assert_close(y2, y)
    torch.testing.assert_close(yw, torch.dot(y, w))
    assert [p.calls - b for p, b in zip(plains, before)] == [2, 1, 1]
    assert [k.launches for k in kernels] == launched


# -- the dense-window hierarchy in both packages ----------------------------

@pytest.fixture(scope="module")
def dwin_problem():
    A, A_ref, rhs = _fe_rcm(1500, 6)
    ref = RefAMG(A_ref, RefParams(dtype=jnp.float64, matrix_format="dwin",
                                  coarse_enough=_COARSE))
    return A, A_ref, rhs, ref


def _dwin(D):
    return {"window_starts": np.asarray(D.window_starts),
            "blocks": np.asarray(D.blocks), "shape": D.shape, "win": D.win}


def test_hierarchy_levels_and_formats_match_jax(dwin_problem):
    """Same level count, shapes and format classes: every A a dense window
    (the coarsest level's too, as the explicit format asks), and the
    smoothed transfers' M and Mᵀ dense windows as well, because both
    packages convert them in the hierarchy's matrix_format."""
    A, _, _, ref = dwin_problem
    port = AMG(A, AMGParams(dtype=torch.float64, matrix_format="dwin",
                            coarse_enough=_COARSE), device="cpu")

    def formats(levels):
        return [(lv.A.shape, type(lv.A).__name__, lv.A.win,
                 None if lv.P is None else (type(lv.P.M).__name__,
                                            type(lv.R.Mt).__name__))
                for lv in levels]

    got, want = formats(port.hierarchy.levels), formats(ref.hierarchy.levels)
    assert got == want and len(got) == 3
    assert all(f[1] == "DenseWindowMatrix" for f in got)
    assert all(f[3] == ("DenseWindowMatrix",) * 2 for f in got[:-1])
    for lv, lv_ref in zip(port.hierarchy.levels, ref.hierarchy.levels):
        np.testing.assert_array_equal(lv.A.window_starts.numpy(),
                                      np.asarray(lv_ref.A.window_starts))
    # the shared budget paid for the level operators alone
    assert port._dwin_budget.used == sum(
        lv.A.blocks.numel() * 8 for lv in port.hierarchy.levels)
    st = port.hierarchy_stats()
    assert st["bytes"] == port.hierarchy.bytes()
    assert st["bytes"] > sum(lv.A.bytes() for lv in port.hierarchy.levels)
    lv0 = st["levels"][0]
    assert lv0["win"] == 2048 and lv0["format_bytes"] \
        == port.hierarchy.levels[0].A.bytes()
    assert "DenseWindowMatrix (window 2048, " in repr(port)


@pytest.mark.parametrize("side", ["left", "right"])
def test_bicgstab_on_identical_dense_window_hierarchy(dwin_problem, side):
    """The JAX package's float64 dense-window hierarchy carried over as
    plain arrays: one preconditioner application agrees to 1e-10 of its
    largest entry, and BiCGStab takes the JAX package's iteration count
    on both sides."""
    _, A_ref, rhs, ref = dwin_problem
    levels = []
    for lv in ref.hierarchy.levels:
        row = {"A": _dwin(lv.A)}
        if lv.P is not None:
            row.update(M=_dwin(lv.P.M), Mt=_dwin(lv.R.Mt),
                       agg=np.asarray(lv.P.T.agg), n_agg=lv.P.T.shape[1],
                       scale=np.asarray(lv.relax.scale))
        levels.append(row)
    hier = hierarchy_from_arrays(levels, np.asarray(ref.hierarchy.coarse.inv),
                                 AMGParams(dtype=torch.float64), "cpu")
    assert all(isinstance(lv.A, DenseWindowMatrix) for lv in hier.levels)
    r = np.random.RandomState(11).standard_normal(A_ref.nrows)
    z_ref = np.asarray(ref.hierarchy.apply(jnp.asarray(r)))
    z = hier.apply(torch.as_tensor(r)).numpy()
    assert np.max(np.abs(z - z_ref)) <= 1e-10 * np.abs(z_ref).max()
    _, info_r = ref_make_solver(
        A_ref, ref, RefBiCGStab(tol=1e-8, precond_side=side))(rhs)
    x, iters, resid, hs = BiCGStab(tol=1e-8, precond_side=side).solve(
        hier.system_matrix, hier.apply, torch.as_tensor(rhs))
    assert iters == info_r.iters and hs.flags == 0
    assert max(resid, info_r.resid) <= 1e-8


def test_d2_call_matches_jax():
    """D2's call at small size: a float32 dense-window hierarchy, left
    BiCGStab, float64 refinement through auto (windowed ELL). Iterations
    within 10% of the JAX package's (at least one) and the true residual
    at most tol."""
    A, A_ref, rhs = _fe_rcm(1500, 6)
    kw = dict(maxiter=100, tol=1e-6, precond_side="left")
    _, info_r = ref_make_solver(
        A_ref, RefParams(dtype=jnp.float32, matrix_format="dwin",
                         coarse_enough=_COARSE), RefBiCGStab(**kw),
        refine=3)(rhs)
    solve = make_solver(A, AMGParams(dtype=torch.float32,
                                     matrix_format="dwin",
                                     coarse_enough=_COARSE),
                        BiCGStab(**kw), refine=3, device="cpu")
    assert isinstance(solve.A_dev, DenseWindowMatrix)
    assert solve.A_dev is solve.precond.hierarchy.levels[0].A
    assert isinstance(solve.A_dev64, U.WindowedEllMatrix)
    x, info = solve(rhs)
    assert info.health == []
    assert abs(info.iters - info_r.iters) <= max(1, 0.1 * info_r.iters)
    tr = np.linalg.norm(rhs - A.spmv(x.numpy())) / np.linalg.norm(rhs)
    assert tr <= 1e-6


def test_dense_window_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = _MATRICES["fe_rcm"]()[0]
    for build in (lambda: dev.to_device(A, "dwin"),
                  lambda: dw.csr_to_dense_window(A)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
