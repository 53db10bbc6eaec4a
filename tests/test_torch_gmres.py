"""The port's GMRES family and the other Krylov solvers of the slice —
GMRES (both sides), FGMRES, LGMRES (both sides), IDR(s), Richardson and
PreOnly — against the JAX package, with ``stack_dots``,
``record_history`` for every solver, and path G1's call
``make_solver(A, AMGParams(dtype=float32), GMRES(...), refine=3)`` at a
small size.

Solver parity runs on identical float64 hierarchies (poisson3d's DIA
levels and an RCM-ordered fe_like_problem's windowed-ELL levels, handed
across with ``hierarchy_from_arrays``): identical iteration counts, x
within 1e-10 relative and the same history; IDR(s) on the JAX package's
own shadow block, carried across with ``idrs_with_shadow``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops import device as ref_dev
from amgcl_tpu.ops import fused_vec as ref_fv
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.solver import bicgstab as ref_bicgstab
from amgcl_tpu.solver import bicgstabl as ref_bicgstabl
from amgcl_tpu.solver import cg as ref_cg
from amgcl_tpu.solver import gmres as ref_gmres
from amgcl_tpu.solver import idrs as ref_idrs
from amgcl_tpu.solver import lgmres as ref_lgmres
from amgcl_tpu.solver import preonly as ref_preonly
from amgcl_tpu.solver import richardson as ref_richardson

import amgcl_tpu_torch as T
from amgcl_tpu_torch.convert import hierarchy_from_arrays, idrs_with_shadow
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.ops import gather_kernels as gk
from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute

_REF = {"CG": ref_cg.CG, "BiCGStab": ref_bicgstab.BiCGStab,
        "BiCGStabL": ref_bicgstabl.BiCGStabL, "GMRES": ref_gmres.GMRES,
        "FGMRES": ref_gmres.FGMRES, "LGMRES": ref_lgmres.LGMRES,
        "IDRs": ref_idrs.IDRs, "Richardson": ref_richardson.Richardson,
        "PreOnly": ref_preonly.PreOnly}


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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stack_dots_matches_jax(dtype):
    rng = np.random.RandomState(7)
    V = rng.standard_normal((31, 5000)).astype(dtype)
    w = rng.standard_normal(5000).astype(dtype)
    got = fv.stack_dots(torch.as_tensor(V), torch.as_tensor(w)).numpy()
    want = np.asarray(ref_fv.stack_dots(jnp.asarray(V), jnp.asarray(w)))
    mag = np.abs(V).astype(np.float64) @ np.abs(w).astype(np.float64)
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    assert got.shape == (31,) and np.all(np.abs(got - want) <= rtol * mag)


# -- the solvers on identical hierarchies ------------------------------------

def _dia_levels(ref):
    levels = []
    for lv in ref.hierarchy.levels:
        A = lv.A
        row = {"A": (A.offsets, np.asarray(A.data)) if hasattr(A, "offsets")
               else np.asarray(A.a)}
        if lv.P is not None:
            row.update(M=(lv.P.M.offsets, np.asarray(lv.P.M.data)),
                       Mt=(lv.R.Mt.offsets, np.asarray(lv.R.Mt.data)),
                       fine=lv.P.T.fine, block=lv.P.T.block,
                       scale=np.asarray(lv.relax.scale))
        levels.append(row)
    return levels


def _well(W):
    return {"window_starts": np.asarray(W.window_starts),
            "cols_local": np.asarray(W.cols_local),
            "vals": np.asarray(W.vals), "shape": W.shape, "win": W.win}


def _well_levels(ref):
    levels = []
    for lv in ref.hierarchy.levels:
        A = lv.A
        row = {"A": _well(A) if hasattr(A, "window_starts")
               else np.asarray(A.a)}
        if lv.P is not None:
            row.update(M=_well(lv.P.M), Mt=_well(lv.R.Mt),
                       agg=np.asarray(lv.P.T.agg), n_agg=lv.P.T.shape[1],
                       scale=np.asarray(lv.relax.scale))
        levels.append(row)
    return levels


_HIERARCHIES = {}


def _cached(name, dtype):
    """(A, A_ref, rhs, JAX AMG, the port's copy of its hierarchy) for
    poisson3d(16) (DIA levels) or an RCM-ordered G1-like fe_like_problem
    (five nearest neighbours, L0 a windowed ELL of K = 16)."""
    if (name, dtype) not in _HIERARCHIES:
        if name == "poisson":
            A, rhs = T.poisson3d(16)
            prm, to_arrays = {}, _dia_levels
        else:
            A, rhs = T.fe_like_problem(n=4000, nnz_target=6 * 4000, seed=3)
            perm = cuthill_mckee(A)
            A, rhs = permute(A, perm), rhs[perm]
            prm, to_arrays = {"coarse_enough": 300}, _well_levels
        A_ref = RefCSR.from_scipy(A.to_scipy())
        ref = RefAMG(A_ref, RefParams(dtype=getattr(jnp, dtype), **prm))
        hier = hierarchy_from_arrays(
            to_arrays(ref), np.asarray(ref.hierarchy.coarse.inv),
            T.AMGParams(dtype=getattr(torch, dtype)), "cpu")
        _HIERARCHIES[name, dtype] = A, A_ref, rhs, ref, hier
    return _HIERARCHIES[name, dtype]


def _shadow(s, n, dtype):
    return np.asarray(ref_idrs._shadow_block(
        s, jnp.arange(n), None, getattr(jnp, dtype), ref_dev.inner_product))


def _pair(solver, kw, n, dtype="float64"):
    """The JAX solver and the port's, with the same fields; the port's
    IDR(s) carries the JAX package's shadow block."""
    ref = _REF[solver](**kw)
    port = getattr(T, solver)(**kw)
    if solver == "IDRs":
        port = idrs_with_shadow(port, _shadow(port.s, n, dtype))
    return ref, port


_CASES = [
    # (problem, solver, fields): every solver, both sides where it has two
    ("poisson", "GMRES", {}), ("poisson", "GMRES", {"pside": "right"}),
    ("poisson", "FGMRES", {"M": 4}), ("poisson", "LGMRES", {"M": 6}),
    ("poisson", "IDRs", {}), ("poisson", "Richardson", {"maxiter": 60}),
    ("poisson", "PreOnly", {}), ("poisson", "CG", {}),
    ("poisson", "BiCGStab", {}), ("poisson", "BiCGStabL", {}),
    ("fe_rcm", "GMRES", {}), ("fe_rcm", "FGMRES", {}),
    ("fe_rcm", "LGMRES", {"pside": "right", "M": 8, "K": 2}),
    ("fe_rcm", "IDRs", {"s": 2}), ("fe_rcm", "Richardson", {"maxiter": 40}),
]


@pytest.mark.parametrize("name,solver,kw", _CASES)
def test_float64_matches_jax_with_history(name, solver, kw):
    """On an identical float64 hierarchy: the JAX package's iteration
    count, x within 1e-10 relative, the same reported residual and the
    same per-iteration history (one entry an iteration)."""
    A, A_ref, rhs, ref, hier = _cached(name, "float64")
    kw = dict(kw, record_history=True)
    if solver != "PreOnly":
        kw["tol"] = 1e-8
    ref_solver, port = _pair(solver, kw, A.nrows)
    x_r, info_r = ref_make_solver(A_ref, ref, ref_solver)(rhs)
    x, iters, resid, hs, hist = port.solve(
        hier.system_matrix, hier.apply, torch.as_tensor(rhs))
    x_r = np.asarray(x_r, np.float64)
    assert iters == info_r.iters and hs.flags == 0
    assert np.linalg.norm(x.numpy() - x_r) <= 1e-10 * np.linalg.norm(x_r)
    assert resid == pytest.approx(info_r.resid, rel=1e-6, abs=1e-14)
    want = np.asarray(info_r.history, np.float64)
    assert len(hist) == iters == len(want)
    np.testing.assert_allclose(hist, want, rtol=1e-6, atol=1e-14)


@pytest.mark.parametrize("name,solver", [("poisson", "GMRES")])
def test_float32_matches_jax(name, solver):
    """On an identical float32 hierarchy: within one iteration of the JAX
    package and both reported residuals within tol."""
    A, A_ref, rhs, ref, hier = _cached(name, "float32")
    kw = dict(tol=1e-5)
    ref_solver, port = _pair(solver, kw, A.nrows, "float32")
    _, info_r = ref_make_solver(A_ref, ref, ref_solver)(rhs)
    x, iters, resid, hs = port.solve(
        hier.system_matrix, hier.apply,
        torch.as_tensor(rhs, dtype=torch.float32))
    assert abs(iters - info_r.iters) <= 1 and hs.flags == 0
    assert max(resid, info_r.resid) <= kw["tol"]


def test_idrs_replacement_field_as_in_jax():
    """IDR(s)'s ``replacement`` field, kept unused for interface parity as
    the JAX package keeps it (amgcl_tpu/solver/idrs.py:54): the same
    field list in the same order (the port's shadow last), and
    ``IDRs(replacement=True)`` solves as the JAX package's does on an
    identical float64 hierarchy and shadow block."""
    import dataclasses
    ref_fields = [f.name for f in dataclasses.fields(ref_idrs.IDRs)]
    port_fields = [f.name for f in dataclasses.fields(T.IDRs)]
    assert port_fields == ref_fields + ["shadow"]
    A, A_ref, rhs, ref, hier = _cached("poisson", "float64")
    kw = dict(tol=1e-8, replacement=True)
    ref_solver, port = _pair("IDRs", kw, A.nrows)
    assert port.replacement is True
    x_r, info_r = ref_make_solver(A_ref, ref, ref_solver)(rhs)
    x, iters, resid, hs = port.solve(hier.system_matrix, hier.apply,
                                     torch.as_tensor(rhs))
    x_r = np.asarray(x_r, np.float64)
    assert iters == info_r.iters and hs.flags == 0
    assert np.linalg.norm(x.numpy() - x_r) <= 1e-10 * np.linalg.norm(x_r)


def test_maxiter_cap_mid_cycle_matches_jax():
    """maxiter is tested between restart cycles only: GMRES(5) with
    maxiter 12 starts a third cycle at 10 and ends at 15, as the JAX
    package does."""
    A, A_ref, rhs, ref, hier = _cached("poisson", "float64")
    kw = dict(M=5, maxiter=12, tol=1e-14)
    ref_solver, port = _pair("GMRES", kw, A.nrows)
    _, info_r = ref_make_solver(A_ref, ref, ref_solver)(rhs)
    _, iters, resid, _ = port.solve(hier.system_matrix, hier.apply,
                                    torch.as_tensor(rhs))
    assert iters == info_r.iters == 15
    assert resid == pytest.approx(info_r.resid, rel=1e-8)


def _neumann(n):
    """Singular 1-D Neumann Laplacian; the ones rhs is its null space."""
    main = 2.0 * np.ones(n)
    main[0] = main[-1] = 1.0
    return sp.diags([-np.ones(n - 1), main, -np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()


@pytest.mark.parametrize("solver", ["GMRES", "LGMRES"])
def test_hessenberg_breakdown_matches_jax(solver):
    """On the null-space rhs the zero-column Givens rotation annihilates
    the projected residual: both packages trip the Hessenberg breakdown
    at the same step, commit nothing and return a finite x and an honest
    residual (the JAX package's own guard case)."""
    L = _neumann(8)
    A = dev.to_device(T.CSR.from_scipy(L), "ell", torch.float64, "cpu")
    A_ref = ref_dev.to_device(RefCSR.from_scipy(L), "ell", jnp.float64)
    kw = dict(M=10, maxiter=50, tol=1e-8, record_history=True)
    x, it, res, hs, hist = getattr(T, solver)(**kw).solve(
        A, lambda r: r, torch.ones(8, dtype=torch.float64))
    x_r, it_r, res_r, hist_r, hs_r = _REF[solver](**kw).solve(
        A_ref, lambda r: r, jnp.ones(8, jnp.float64))
    assert hs.flags == int(hs_r.flags)
    assert "breakdown_hessenberg" in hs.names()
    assert hs.first_it == [int(v) for v in hs_r.first_it]
    assert it == int(it_r) and hist == list(np.asarray(hist_r)[:it])
    assert torch.all(torch.isfinite(x)) and res > 1e-8
    assert res == pytest.approx(float(res_r), rel=1e-12)


def test_zero_rhs_and_refusals():
    A, _, rhs, _, hier = _cached("poisson", "float64")
    b0 = torch.zeros(A.nrows, dtype=torch.float64)
    for solver in (T.GMRES(), T.FGMRES(), T.LGMRES(), T.IDRs(),
                   T.Richardson()):
        x, iters, resid, hs = solver.solve(hier.system_matrix, hier.apply,
                                           b0)
        assert iters == 0 and resid == 0 and not torch.any(x)
    b = torch.as_tensor(rhs)
    with pytest.raises(ValueError, match="pside"):
        T.GMRES(pside="both").solve(hier.system_matrix, hier.apply, b)
    with pytest.raises(ValueError, match="K < M"):
        T.LGMRES(M=3, K=3).solve(hier.system_matrix, hier.apply, b)
    with pytest.raises(ValueError, match="shadow"):
        T.IDRs(shadow=np.zeros((4, 5))).solve(hier.system_matrix,
                                              hier.apply, b)
    # a stacked rhs (refused before the serving slice) solves each column
    # as its 1-D solve does
    x2, it2 = T.GMRES().solve(hier.system_matrix, hier.apply,
                              torch.stack([b, b], dim=1))[:2]
    x1, it1 = T.GMRES().solve(hier.system_matrix, hier.apply, b)[:2]
    assert it2 == [it1, it1]
    np.testing.assert_allclose(x2[:, 0].numpy(), x1.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_port_shadow_space_is_orthonormal_and_seeded():
    """The port's own shadow block: orthonormal rows, the same on every
    call; IDR(s) on it converges on the RCM problem within a few
    iterations of its count on the JAX package's block."""
    from amgcl_tpu_torch.solver.idrs import shadow_block
    P = shadow_block(4, 3000, torch.float64, "cpu")
    assert torch.allclose(P @ P.T, torch.eye(4, dtype=torch.float64),
                          atol=1e-12)
    assert torch.equal(P, shadow_block(4, 3000, torch.float64, "cpu"))
    A, A_ref, rhs, ref, hier = _cached("fe_rcm", "float64")
    b = torch.as_tensor(rhs)
    _, iters_jax, _, _ = idrs_with_shadow(
        T.IDRs(tol=1e-8), _shadow(4, A.nrows, "float64")).solve(
            hier.system_matrix, hier.apply, b)
    _, iters, resid, hs = T.IDRs(tol=1e-8).solve(hier.system_matrix,
                                                 hier.apply, b)
    assert abs(iters - iters_jax) <= 5 + 0.2 * iters_jax
    assert resid <= 1e-8 and hs.flags == 0


# -- the slice end to end ----------------------------------------------------

def test_g1_call_matches_jax():
    """G1's call at a small size: a G1-like fe_like_problem in identity
    order, a float32 hierarchy built by each package, left GMRES, float64
    refinement. The same levels and formats (L0 a windowed ELL of
    K = 16, which runs the gather kernel's plain version here), the
    iterations within 10% of the JAX package's, both true residuals
    ≤ tol, the port's reported residual its true one, and the history
    the initial solve's."""
    A, rhs = T.fe_like_problem(n=6000, nnz_target=6 * 6000, seed=1)
    A_ref = RefCSR.from_scipy(A.to_scipy())
    kw = dict(maxiter=100, tol=1e-6)
    ref_solve = ref_make_solver(
        A_ref, RefParams(dtype=jnp.float32, coarse_enough=300),
        ref_gmres.GMRES(**kw), refine=3)
    x_r, info_r = ref_solve(rhs)
    solve = T.make_solver(A, T.AMGParams(dtype=torch.float32,
                                         coarse_enough=300),
                          T.GMRES(record_history=True, **kw), refine=3,
                          device="cpu")
    calls = gk.gather_spmv_plain.calls
    x, info = solve(rhs)
    assert gk.gather_spmv_plain.calls - calls >= info.iters > 0
    levels = [(lv.A.shape[0], type(lv.A).__name__)
              for lv in solve.precond.hierarchy.levels]
    assert levels == [(lv.A.shape[0], type(lv.A).__name__)
                      for lv in ref_solve.precond.hierarchy.levels]
    assert solve.precond.hierarchy.levels[0].A.K == 16
    assert x.dtype == torch.float64 and info.health == []
    assert abs(info.iters - info_r.iters) <= max(1, 0.1 * info_r.iters)
    S, nb = A.to_scipy(), np.linalg.norm(rhs)
    tr = np.linalg.norm(rhs - S @ x.numpy()) / nb
    tr_r = np.linalg.norm(rhs - S @ np.asarray(x_r, np.float64)) / nb
    assert max(tr, tr_r) <= 1e-6 and abs(tr - info.resid) <= 1e-12
    assert 0 < len(info.history) < info.iters
    assert info.history[-1] <= 1e-6



@pytest.mark.parametrize("solver", sorted(_REF))
def test_make_solver_history_covers_the_initial_solve(solver):
    """SolveReport.history through make_solver: one entry an iteration
    without refinement; with refinement, the initial solve's entries only
    (as in the JAX package), while iters also counts the corrections."""
    A, rhs = T.poisson3d(10)
    kw = {} if solver == "PreOnly" else {"tol": 1e-6}
    for refine in (0, 2):
        solve = T.make_solver(A, T.AMGParams(dtype=torch.float32),
                              getattr(T, solver)(record_history=True, **kw),
                              refine=refine, device="cpu")
        _, info = solve(rhs)
        n0 = solve.solver.solve(
            solve.A_dev, solve.precond.hierarchy.apply,
            torch.as_tensor(rhs, dtype=torch.float32))[1]
        assert len(info.history) == n0 > 0
        assert info.iters == n0 if refine == 0 else info.iters >= n0
        assert all(np.isfinite(info.history))
    _, info = T.make_solver(A, T.AMGParams(dtype=torch.float32),
                            getattr(T, solver)(**kw),
                            device="cpu")(rhs)
    assert info.history is None
