"""The port's BiCGStab(L) and its fused vector primitive against the JAX
package: ``axpby_dot`` against the Pallas kernel ``_fused_pass`` in mode
``axpby_dot`` (interpret mode), ``block_dots``, the solver on identical
hierarchies (poisson3d's DIA levels and an RCM-ordered unstructured
problem's windowed-ELL levels) for L = 1, 2, 4, both sides, with and
without reliable updates, its edge cases and guard flags, and K1's call
``make_solver(A, AMGParams(dtype=float32), BiCGStabL(...), refine=3)``
at a small size.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops import fused_vec as ref_fv
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.solver.bicgstabl import BiCGStabL as RefBiCGStabL

from amgcl_tpu_torch import (AMGParams, BiCGStabL, fe_like_problem,
                             make_solver, poisson3d)
from amgcl_tpu_torch.convert import hierarchy_from_arrays
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.telemetry import health as H
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 1000, 8193, 20000])
def test_axpby_dot_plain_matches_pallas(n, dtype):
    rng = np.random.RandomState(n)
    x, y = (rng.standard_normal(n).astype(dtype) for _ in range(2))
    a, b = dtype(-0.37), dtype(1.0)
    before = fv.axpby_dot_plain.calls
    z, zz = fv.axpby_dot(torch.tensor(a), torch.as_tensor(x),
                         torch.tensor(b), torch.as_tensor(y))
    assert fv.axpby_dot_plain.calls == before + 1
    z_r, zz_r = ref_fv._fused_pass("axpby_dot", (a, b),
                                   (jnp.asarray(x), jnp.asarray(y)),
                                   interpret=True)
    # elementwise: two roundings either side (FMA contraction may differ)
    terms = np.abs(a * x.astype(np.float64)) + np.abs(y)
    assert np.all(np.abs(z.numpy() - np.asarray(z_r)) <= _RTOL[dtype] * terms)
    # the dot: summation order differs
    assert zz.dim() == 0 and zz.dtype == z.dtype
    assert abs(float(zz) - float(zz_r)) <= _RTOL[dtype] * float(
        (terms * terms).sum())


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_dots_matches_jax(dtype):
    rng = np.random.RandomState(3)
    X = rng.standard_normal((2, 5000)).astype(dtype)
    Y = rng.standard_normal((3, 5000)).astype(dtype)
    got = fv.block_dots(torch.as_tensor(X), torch.as_tensor(Y)).numpy()
    want = np.asarray(ref_fv.block_dots(jnp.asarray(X), jnp.asarray(Y)))
    mag = np.abs(X).astype(np.float64) @ np.abs(Y).astype(np.float64).T
    assert got.shape == (2, 3)
    assert np.all(np.abs(got - want) <= _RTOL[dtype] * mag)


# -- the solver on identical hierarchies ------------------------------------

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


def _problem(name, dtype):
    """(A_ref, rhs, JAX hierarchy, the port's copy of it) for poisson3d(16)
    (DIA levels) or an RCM-ordered fe_like_problem(n=2000) (windowed-ELL
    levels)."""
    if name == "poisson":
        A, rhs = poisson3d(16)
        prm, to_arrays = {}, _dia_levels
    else:
        A, rhs = fe_like_problem(n=2000, nnz_target=36000, seed=3)
        perm = cuthill_mckee(A)
        A, rhs = permute(A, perm), rhs[perm]
        prm, to_arrays = {"coarse_enough": 300}, _well_levels
    A_ref = RefCSR.from_scipy(A.to_scipy())
    ref = RefAMG(A_ref, RefParams(dtype=getattr(jnp, dtype), **prm))
    hier = hierarchy_from_arrays(
        to_arrays(ref), np.asarray(ref.hierarchy.coarse.inv),
        AMGParams(dtype=getattr(torch, dtype)), "cpu")
    return A, A_ref, rhs, ref, hier


_HIERARCHIES = {}


def _cached(name, dtype):
    if (name, dtype) not in _HIERARCHIES:
        _HIERARCHIES[name, dtype] = _problem(name, dtype)
    return _HIERARCHIES[name, dtype]


_CASES = [
    # (problem, L, side, delta): every L, both sides and both delta values
    ("poisson", 1, "left", 0.1), ("poisson", 2, "left", 0.0),
    ("poisson", 4, "left", 0.0), ("poisson", 4, "right", 0.1),
    ("fe_rcm", 1, "right", 0.1), ("fe_rcm", 2, "right", 0.0),
    ("fe_rcm", 4, "right", 0.0), ("fe_rcm", 2, "right", 0.1),
]


@pytest.mark.parametrize("name,L,side,delta", _CASES)
def test_float64_matches_jax(name, L, side, delta):
    """On an identical float64 hierarchy: the JAX package's iteration
    count, x within 1e-8 of its x, no guard flag. The left side runs on
    poisson3d only: on the RCM problem the JAX package's own left-side
    count moves by one when its rhs moves by 1e-15 relative (11 or 12 at
    L = 1, 10 or 11 at L = 2), while every case here keeps its count
    under such a change."""
    A, A_ref, rhs, ref, hier = _cached(name, "float64")
    kw = dict(L=L, tol=1e-8, pside=side, delta=delta)
    x_r, info_r = ref_make_solver(A_ref, ref, RefBiCGStabL(**kw))(rhs)
    x, iters, resid, hs = BiCGStabL(**kw).solve(
        hier.system_matrix, hier.apply, torch.as_tensor(rhs))
    x_r = np.asarray(x_r, np.float64)
    assert iters == info_r.iters and hs.flags == 0
    assert np.linalg.norm(x.numpy() - x_r) <= 1e-8 * np.linalg.norm(x_r)
    assert max(resid, info_r.resid) <= 1e-8


@pytest.mark.parametrize("name,L,side", [("poisson", 2, "right"),
                                         ("fe_rcm", 4, "left")])
def test_float32_matches_jax(name, L, side):
    """On an identical float32 hierarchy: within one iteration of the JAX
    package, the reported residual within tol, and the true residual
    within tol plus twice the float32 floor of evaluating it
    (u·‖|A||x|‖/‖b‖, u = 2⁻²⁴), which dominates here, in both packages."""
    A, A_ref, rhs, ref, hier = _cached(name, "float32")
    kw = dict(L=L, tol=1e-5, pside=side)
    x_r, info_r = ref_make_solver(A_ref, ref, RefBiCGStabL(**kw))(rhs)
    x, iters, resid, hs = BiCGStabL(**kw).solve(
        hier.system_matrix, hier.apply,
        torch.as_tensor(rhs, dtype=torch.float32))
    assert abs(iters - info_r.iters) <= 1 and hs.flags == 0
    assert max(resid, info_r.resid) <= kw["tol"]
    S, nb = A.to_scipy(), np.linalg.norm(rhs)
    for xx in (x.numpy(), np.asarray(x_r)):
        xx = xx.astype(np.float64)
        floor = 2.0 ** -24 * np.linalg.norm(abs(S) @ np.abs(xx)) / nb
        true = np.linalg.norm(rhs - S @ xx) / nb
        assert true <= kw["tol"] + 2 * floor


# -- edge cases ---------------------------------------------------------------

def test_zero_rhs_and_maxiter_match_jax():
    """A zero rhs takes no iteration and returns x = 0; a small maxiter is
    reached as the JAX loop reaches it (a cycle commits L steps, so the
    count can pass maxiter), with the same residual to 1e-10."""
    A, A_ref, rhs, ref, hier = _cached("poisson", "float64")
    b0 = torch.zeros(A.nrows, dtype=torch.float64)
    x, iters, resid, hs = BiCGStabL().solve(hier.system_matrix, hier.apply,
                                            b0)
    assert iters == 0 and not torch.any(x) and hs.flags == 0
    for L, maxiter in ((2, 3), (4, 2)):
        kw = dict(L=L, maxiter=maxiter, tol=1e-14)
        _, info_r = ref_make_solver(A_ref, ref, RefBiCGStabL(**kw))(rhs)
        _, iters, resid, _ = BiCGStabL(**kw).solve(
            hier.system_matrix, hier.apply, torch.as_tensor(rhs))
        assert iters == info_r.iters >= maxiter
        assert resid == pytest.approx(info_r.resid, rel=1e-10)


def test_breakdown_gives_the_jax_guard_flags():
    """A right preconditioner that returns zeros makes ⟨r̂, op u⟩ = 0:
    both solvers trip the same flags at the same iterations and commit
    the same number of steps."""
    A, A_ref, rhs, ref, hier = _cached("poisson", "float64")
    x, iters, resid, hs = BiCGStabL().solve(
        hier.system_matrix, torch.zeros_like, torch.as_tensor(rhs))
    out = RefBiCGStabL().solve(
        ref.hierarchy.system_matrix, jnp.zeros_like, jnp.asarray(rhs))
    hs_r = out[-1]
    assert hs.flags == int(hs_r.flags) != 0
    assert hs.first_it == [int(v) for v in hs_r.first_it]
    assert iters == int(out[1])


def test_refusals():
    A, _, rhs, _, hier = _cached("poisson", "float64")
    b = torch.as_tensor(rhs)
    # a stacked rhs (refused before the serving slice) solves each column
    # as its 1-D solve does
    x2, it2 = BiCGStabL().solve(hier.system_matrix, hier.apply,
                                torch.stack([b, b], dim=1))[:2]
    x1, it1 = BiCGStabL().solve(hier.system_matrix, hier.apply, b)[:2]
    assert it2 == [it1, it1]
    np.testing.assert_allclose(x2[:, 1].numpy(), x1.numpy(), rtol=1e-9,
                               atol=1e-12)
    # the residual history is ported: one entry an iteration, the last
    # the returned residual
    _, iters, resid, _, hist = BiCGStabL(record_history=True).solve(
        hier.system_matrix, hier.apply, b)
    assert len(hist) == iters and hist[-1] == resid
    with pytest.raises(ValueError, match="pside"):
        BiCGStabL(pside="both").solve(hier.system_matrix, hier.apply, b)


def test_k1_call_matches_jax():
    """K1's call at a small size: identity-ordered fe_like_problem, a
    float32 hierarchy, right-preconditioned BiCGStab(2), float64
    refinement. Iterations within 10% of the JAX package's (at least one)
    and the true residual at most tol. The size and seed are ones where
    the JAX package's own count holds (19 or 20) when its rhs moves by
    1e-7 relative; at n = 3000, seed 1 it moves between 19 and 23."""
    A, rhs = fe_like_problem(n=4000, nnz_target=4000 * 18, seed=2)
    A_ref = RefCSR.from_scipy(A.to_scipy())
    kw = dict(L=2, maxiter=100, tol=1e-6)
    _, info_r = ref_make_solver(
        A_ref, RefParams(dtype=jnp.float32, coarse_enough=500),
        RefBiCGStabL(**kw), refine=3)(rhs)
    solve = make_solver(A, AMGParams(dtype=torch.float32, coarse_enough=500),
                        BiCGStabL(**kw), refine=3, device="cpu")
    x, info = solve(rhs)
    assert x.dtype == torch.float64 and info.health == []
    assert abs(info.iters - info_r.iters) <= max(1, 0.1 * info_r.iters)
    tr = np.linalg.norm(rhs - A.spmv(x.numpy())) / np.linalg.norm(rhs)
    assert tr <= 1e-6
    assert abs(tr - info.resid) <= 1e-12
