"""The port's executed reorder (``telemetry/structure.py``,
``models/amg.py``, ``models/make_solver.py``), its ranked device formats
(``ops/device.py``) and its adapters (``utils/adapters.py``) against the
JAX package's on the CPU.

Tolerances: fingerprints, plans (perm, val_perm, variant, gain) and
format choices identical; hierarchies within 1e-12 of the largest
reference entry with identical patterns; float64 counts exactly;
solutions in the original order within 1e-10; a rebuild bit for bit
against a fresh build.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops import device as r_dev
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.solver.cg import CG as RefCG
from amgcl_tpu.telemetry import structure as r_st
from amgcl_tpu.utils import adapters as r_adapters

import amgcl_tpu_torch as T
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.telemetry import structure as st
from amgcl_tpu_torch.utils import adapters

CPU = dict(device="cpu")


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


def _ref(A):
    return RefCSR(A.ptr, A.col, A.val, A.ncols)


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


def _strong(A):
    """A's pattern with strongly coupled values (−1 off the diagonal,
    diagonally dominant), so that aggregation coarsens it."""
    rows = A.expanded_rows()
    return T.CSR(A.ptr, A.col, np.where(rows == A.col, 8.5, -1.0), A.ncols)


_SYSTEMS = {
    "banded_permuted": lambda: _strong(
        st.permuted_banded(6000, bw=4, seed=2)[0]),
    "banded": lambda: _strong(st.permuted_banded(6000, bw=4, seed=2)[1]),
    "poisson": lambda: T.poisson3d(10)[0],
    "fe": lambda: T.fe_like_problem(3000, nnz_target=31 * 3000, seed=1)[0],
    "block": lambda: T.poisson3d_block(4, 3)[0],
}
_CACHE = {}


def _system(name):
    if name not in _CACHE:
        _CACHE[name] = _SYSTEMS[name]()
    return _CACHE[name]


@pytest.mark.parametrize("name", sorted(_SYSTEMS))
def test_fingerprint_is_byte_identical_to_jax(name):
    A = _system(name)
    assert A.ptr.dtype == np.int64 and A.col.dtype == np.int32
    assert st.fingerprint(A) == r_st.fingerprint(
        RefCSR(A.ptr, A.col, A.val, A.ncols))


def test_permuted_banded_fixture_matches_jax():
    A, A0, perm = st.permuted_banded(512, bw=3, seed=4, local=64)
    A_r, A0_r, perm_r = r_st.permuted_banded(512, bw=3, seed=4, local=64)
    assert np.array_equal(perm, perm_r)
    for got, want in ((A, A_r), (A0, A0_r)):
        assert np.array_equal(got.ptr, want.ptr)
        assert np.array_equal(got.col, want.col)
        assert np.array_equal(got.val, want.val)


@pytest.mark.parametrize("name,mode", [
    ("banded_permuted", "auto"), ("banded", "auto"), ("poisson", "auto"),
    ("fe", "auto"), ("fe", "rcm"), ("fe", "cm"), ("banded_permuted", "off"),
    ("block", "rcm")])
def test_reorder_plan_matches_jax(name, mode):
    """auto fires on a scrambled band (DIA becomes eligible), declines a
    band in order, a stencil (the pre-filter) and a random mesh (no
    format's bytes shrink); rcm and cm are forced; block values and off
    never reorder."""
    A = _system(name)
    plan = st.reorder_plan(A, mode)
    ref = r_st.reorder_plan(_ref(A), on_tpu=False, mode=mode)
    assert (plan is None) == (ref is None)
    assert (plan is not None) == ((name, mode) in (
        ("banded_permuted", "auto"), ("fe", "rcm"), ("fe", "cm")))
    if plan is None:
        return
    for key in ("perm", "iperm", "val_perm"):
        assert np.array_equal(plan[key], ref[key]), key
    for key in ("variant", "fingerprint", "predicted_gain", "n"):
        assert plan[key] == ref[key], key
    # val_perm takes the original values into the permuted frame
    B = adapters.permute(A, plan["perm"])
    assert np.array_equal(B.val, A.val[plan["val_perm"]])
    if mode == "auto":
        assert plan["predicted_gain"] >= st.GAIN_FLOOR


@pytest.mark.parametrize("name", ["banded_permuted", "banded", "poisson",
                                  "fe"])
def test_structure_metrics_and_advice_match_jax(name):
    A = _system(name)
    assert st.structure_metrics(A) == r_st.structure_metrics(_ref(A))
    got, want = st.advise(A), r_st.advise(_ref(A))
    assert got.get("best") == want.get("best")
    assert got["identity"] == want["identity"]
    assert [v["gain"] for v in got["variants"]] \
        == [v["gain"] for v in want["variants"]]


def _perm_of(name):
    A = _system(name)
    return adapters.permute(A, st._rcm_perm(A))


_FORMAT_FIXTURES = {
    "banded_permuted": lambda: _system("banded_permuted"),
    "banded_rcm": lambda: _perm_of("banded_permuted"),
    "poisson": lambda: _system("poisson"),
    "fe": lambda: _system("fe"),
    "fe_rcm": lambda: _perm_of("fe"),
    "block": lambda: _system("block"),
}


@pytest.mark.parametrize("name", sorted(_FORMAT_FIXTURES))
def test_auto_format_choice_matches_jax(name):
    """to_device('auto') tries its formats cheapest predicted bytes
    first: the same choice as the JAX package's under the port's DIA
    thresholds (512 diagonals, fill 16), off a TPU."""
    A = _FORMAT_FIXTURES[name]()
    M = dev.to_device(A, "auto", torch.float32, "cpu")
    M_r = r_dev.to_device(_ref(A), "auto", jnp.float32,
                          max_diags=dev.MAX_DIAGS, max_fill=dev.MAX_FILL)
    assert type(M).__name__ == type(M_r).__name__
    cands = dev._decision_candidates(A, 4, None)
    assert dev.ranked_formats(cands) == r_dev._ranked_formats(cands)


@pytest.fixture(scope="module")
def reordered():
    """The scrambled band through make_solver in both packages, float64
    hierarchies: the port's and the JAX package's bundle."""
    A = _system("banded_permuted")
    prm = dict(coarse_enough=300)
    port = T.make_solver(A, T.AMGParams(dtype=torch.float64, **prm),
                         T.CG(maxiter=100, tol=1e-10), reorder="auto",
                         **CPU)
    ref = ref_make_solver(_ref(A), RefParams(dtype=jnp.float64, **prm),
                          RefCG(maxiter=100, tol=1e-10))
    return A, port, ref


def test_reordered_hierarchy_and_solution_match_jax(reordered):
    A, port, ref = reordered
    plan = port.precond.reorder_plan
    assert plan is not None and ref.precond._reorder is not None
    assert np.array_equal(plan["perm"], ref.precond._reorder["perm"])
    hl, hl_r = port.precond.host_levels, ref.precond.host_levels
    assert len(hl) == len(hl_r) >= 2
    for (Ai, _, _), (Ai_r, _, _) in zip(hl, hl_r):
        assert np.array_equal(Ai.ptr, Ai_r.ptr)
        assert np.array_equal(Ai.col, Ai_r.col)
        _close(Ai.val, Ai_r.val, 1e-12)
    assert type(port.precond.hierarchy.levels[0].A).__name__ \
        == type(ref.precond.hierarchy.levels[0].A).__name__ == "DiaMatrix"
    rhs = np.random.RandomState(7).rand(A.nrows)
    x, info = port(rhs)
    x_r, info_r = ref(rhs)
    assert info.iters == info_r.iters
    x = x.numpy()
    _close(x, np.asarray(x_r), 1e-10)
    assert np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs) <= 1e-10
    # x0 in the original order too: a warm start from x
    assert port(rhs, x0=x)[1].iters <= 1


def test_prebuilt_reordered_preconditioner(reordered):
    A, port, _ = reordered
    solve = T.make_solver(A, port.precond, T.CG(maxiter=100, tol=1e-10),
                          **CPU)
    rhs = np.ones(A.nrows)
    _close(solve(rhs)[0].numpy(), port(rhs)[0].numpy(), 1e-12)
    other = _system("banded")
    with pytest.raises(ValueError, match="another sparsity pattern"):
        T.make_solver(other, port.precond, T.CG(), **CPU)


def test_rebuild_with_original_order_values(reordered):
    """rebuild takes values in the caller's (original) order, as a CSR
    or a value array, through val_perm: equal bit for bit to a fresh
    build of those values; the solve follows."""
    A, _, _ = reordered
    prm = T.AMGParams(dtype=torch.float64, coarse_enough=300)
    solve = T.make_solver(A, prm, T.CG(maxiter=100, tol=1e-10),
                          reorder="auto", **CPU)
    rhs = np.ones(A.nrows)
    for step, s in enumerate((2.0, 0.25)):
        As = T.CSR(A.ptr, A.col, A.val * s, A.ncols)
        if step == 0:
            solve.rebuild(As)
        else:
            solve.precond.rebuild(As.val)
            solve.rebuild(As)
        fresh = T.make_solver(As, prm, T.CG(maxiter=100, tol=1e-10),
                              reorder="auto", **CPU)
        for (Ai, _, _), (Bi, _, _) in zip(solve.precond.host_levels,
                                          fresh.precond.host_levels):
            assert np.array_equal(Ai.val, Bi.val)
        for lv, lw in zip(solve.precond.hierarchy.levels,
                          fresh.precond.hierarchy.levels):
            assert torch.equal(lv.A.data if hasattr(lv.A, "data")
                               else lv.A.a,
                               lw.A.data if hasattr(lw.A, "data")
                               else lw.A.a)
        x, info = solve(rhs)
        x_f, info_f = fresh(rhs)
        assert info.iters == info_f.iters
        assert torch.equal(x, x_f)


def test_reorder_off_and_forced():
    """"off", the default, keeps the order even where "auto" fires."""
    A = _system("banded_permuted")
    for kw in ({"reorder": "off"}, {}):
        off = T.AMG(A, T.AMGParams(dtype=torch.float64, coarse_enough=300),
                    **kw, **CPU)
        assert off.reorder_plan is None and off.host_levels[0][0] is A
    forced = T.AMG(_system("fe"), T.AMGParams(dtype=torch.float64,
                                               coarse_enough=300),
                   reorder="rcm", **CPU)
    assert forced.reorder_plan["variant"] == "rcm"
    assert forced.reorder_plan["predicted_gain"] is None
    with pytest.raises(ValueError, match="reorder must be"):
        T.AMG(A, T.AMGParams(), reorder="bogus", **CPU)


def test_plan_cache_is_bounded_and_keeps_no_pattern():
    """The plans are cached by (fingerprint, mode), the PERM_CACHE_SIZE
    used last; a plan holds no reference to the caller's pattern."""
    st._PERM_CACHE.clear()
    A = _system("fe")
    plan = st.reorder_plan(A, "rcm")
    assert "ptr" not in plan and "col" not in plan
    assert st.reorder_plan(A, "rcm") is plan
    for bw in range(2, 2 + st.PERM_CACHE_SIZE):
        B = T.CSR(*st.banded_pattern(400, bw), 400)
        st.reorder_plan(B, "rcm")
    assert len(st._PERM_CACHE) == st.PERM_CACHE_SIZE
    assert (st.fingerprint(A), "rcm") not in st._PERM_CACHE
    assert st.reorder_plan(A, "rcm") is not plan


def test_reordered_and_scaled_adapters_match_jax():
    A = _system("fe")
    rhs = np.random.RandomState(11).rand(A.nrows)

    def port_factory(M):
        return T.make_solver(M, T.AMGParams(dtype=torch.float64,
                                            coarse_enough=300),
                             T.CG(maxiter=100, tol=1e-10), **CPU)

    def ref_factory(M):
        return ref_make_solver(M, RefParams(dtype=jnp.float64,
                                            coarse_enough=300),
                               RefCG(maxiter=100, tol=1e-10))

    for cls, rcls in ((adapters.Reordered, r_adapters.Reordered),
                      (adapters.Scaled, r_adapters.Scaled)):
        got = cls(A, port_factory)
        want = rcls(_ref(A), ref_factory)
        x, info = got(rhs)
        x_r, info_r = want(rhs)
        assert info.iters == info_r.iters
        _close(x.numpy(), np.asarray(x_r), 1e-10)
        # a tensor in gives a tensor out, in the caller's order
        xt, _ = got(torch.as_tensor(rhs))
        assert torch.is_tensor(xt)
        _close(xt.numpy(), x.numpy(), 1e-12)
