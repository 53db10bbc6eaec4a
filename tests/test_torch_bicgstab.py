"""The unstructured slice as a whole on the CPU — a small fe_like_problem
in identity and RCM order, SA + SPAI-0 on windowed-ELL operators, and
BiCGStab — against the JAX package: level shapes, the iteration count on
an identical hierarchy in float64 (both preconditioning sides), and the
headline call ``make_solver(A, AMGParams(dtype=float32), BiCGStab(...),
refine=3)`` within 10% of the JAX package's iterations."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.solver.bicgstab import BiCGStab as RefBiCGStab

from amgcl_tpu_torch import (AMG, AMGParams, BiCGStab, fe_like_problem,
                             make_solver)
from amgcl_tpu_torch.convert import hierarchy_from_arrays
from amgcl_tpu_torch.ops.structured import AggTentative
from amgcl_tpu_torch.ops.unstructured import WindowedEllMatrix
from amgcl_tpu_torch.telemetry import health as H
from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute

_COARSE = 500          # coarse_enough that gives three levels at n = 6000


def _problem(order):
    A, rhs = fe_like_problem(n=6000, nnz_target=6000 * 18, seed=1)
    if order == "rcm":
        perm = cuthill_mckee(A)
        A, rhs = permute(A, perm), rhs[perm]
    return A, RefCSR.from_scipy(A.to_scipy()), rhs


def _true_resid(A, rhs, x):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs)


@pytest.fixture(scope="module", params=["identity", "rcm"])
def jax_hierarchy(request):
    A, A_ref, rhs = _problem(request.param)
    ref = RefAMG(A_ref, RefParams(dtype=jnp.float64, coarse_enough=_COARSE))
    return request.param, A, A_ref, rhs, ref


def _well(W):
    return {"window_starts": np.asarray(W.window_starts),
            "cols_local": np.asarray(W.cols_local),
            "vals": np.asarray(W.vals), "shape": W.shape, "win": W.win}


def _arrays(ref):
    """The JAX hierarchy as the plain arrays hierarchy_from_arrays takes."""
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
    return levels, np.asarray(ref.hierarchy.coarse.inv)


def test_level_shapes_and_formats_match_jax(jax_hierarchy):
    _, A, _, _, ref = jax_hierarchy
    port = AMG(A, AMGParams(dtype=torch.float64, coarse_enough=_COARSE),
               device="cpu")
    want = [(lv.A.shape, type(lv.A).__name__) for lv in ref.hierarchy.levels]
    got = [(lv.A.shape, type(lv.A).__name__) for lv in port.hierarchy.levels]
    assert got == want
    assert [t for _, t in got] == ["WindowedEllMatrix", "WindowedEllMatrix",
                                   "DenseMatrix"]
    for lv in port.hierarchy.levels[:-1]:
        assert isinstance(lv.P.T, AggTentative)
        assert isinstance(lv.P.M, WindowedEllMatrix)
        assert lv.down is None and lv.up is None
    st = port.hierarchy_stats()["levels"][0]
    assert (st["K"], st["win"]) == (port.hierarchy.levels[0].A.K,
                                    port.hierarchy.levels[0].A.win)
    assert "WindowedEllMatrix (K %d, window %d)" % (st["K"], st["win"]) \
        in repr(port)


@pytest.mark.parametrize("side", ["right", "left"])
def test_bicgstab_on_identical_hierarchy_matches_jax(jax_hierarchy, side):
    """One preconditioner application agrees to 1e-10 of its largest
    entry; BiCGStab in float64 takes the JAX package's iteration count
    and both meet the tolerance. The final residuals agree to relative
    1e-4 on the right side; on the left side, where every vector passes
    through the preconditioner, BiCGStab amplifies rounding about tenfold
    per iteration (the JAX package's own solve moves its final residual
    by 6% when its rhs is perturbed by 1e-15 relative), so they agree to
    25% there."""
    _, _, A_ref, rhs, ref = jax_hierarchy
    levels, inv = _arrays(ref)
    hier = hierarchy_from_arrays(
        levels, inv, AMGParams(dtype=torch.float64), "cpu")
    r = np.random.RandomState(11).standard_normal(A_ref.nrows)
    z_ref = np.asarray(ref.hierarchy.apply(jnp.asarray(r)))
    z = hier.apply(torch.as_tensor(r)).numpy()
    assert np.max(np.abs(z - z_ref)) <= 1e-10 * np.abs(z_ref).max()

    _, info_r = ref_make_solver(
        A_ref, ref, RefBiCGStab(tol=1e-8, precond_side=side))(rhs)
    x, iters, resid, hs = BiCGStab(tol=1e-8, precond_side=side).solve(
        hier.system_matrix, hier.apply, torch.as_tensor(rhs))
    assert iters == info_r.iters
    assert hs.flags == 0
    assert max(resid, info_r.resid) <= 1e-8
    np.testing.assert_allclose(resid, info_r.resid,
                               rtol=1e-4 if side == "right" else 0.25)


@pytest.mark.parametrize("order,side", [("identity", "right"),
                                        ("rcm", "left")])
def test_headline_call_matches_jax(order, side):
    """The tutorial's call at small size: float32 hierarchy, BiCGStab,
    float64 refinement. Iterations within 10% of the JAX package's (at
    least one), the true residual at most tol, and the reported residual
    is the float64 one: both evaluate b − A x in float64, in another
    order, so they differ by about eps64 · ‖|A| |x|‖ / ‖b‖, far below
    1e-12 here."""
    A, A_ref, rhs = _problem(order)
    kw = dict(maxiter=100, tol=1e-6, precond_side=side)
    _, info_r = ref_make_solver(
        A_ref, RefParams(dtype=jnp.float32, coarse_enough=_COARSE),
        RefBiCGStab(**kw), refine=3)(rhs)
    solve = make_solver(A, AMGParams(dtype=torch.float32,
                                     coarse_enough=_COARSE),
                        BiCGStab(**kw), refine=3, device="cpu")
    x, info = solve(rhs)
    assert x.dtype == torch.float64 and info.health == []
    assert isinstance(solve.A_dev64, WindowedEllMatrix)
    assert solve.A_dev64.dtype == torch.float64
    assert abs(info.iters - info_r.iters) <= max(1, 0.1 * info_r.iters)
    tr = _true_resid(A, rhs, x.numpy())
    assert tr <= 1e-6
    assert abs(tr - info.resid) <= 1e-12


def test_zero_rhs_and_bad_side():
    A, _, _ = _problem("identity")
    solve = make_solver(A, AMGParams(dtype=torch.float64,
                                     coarse_enough=_COARSE),
                        BiCGStab(tol=1e-8), device="cpu")
    x, info = solve(np.zeros(A.nrows))
    assert info.iters == 0 and not torch.any(x)
    with pytest.raises(ValueError, match="precond_side"):
        BiCGStab(precond_side="both").solve(
            solve.A_dev, lambda r: r, torch.ones(A.nrows, dtype=torch.float64))


def test_breakdown_guard_freezes_the_iterate():
    """A preconditioner that returns zeros makes ⟨r̂, A p̂⟩ = 0: the alpha
    breakdown trips at the first iteration, the step is discarded and the
    loop ends with the initial guess."""
    A, _, rhs = _problem("identity")
    solve = make_solver(A, AMGParams(dtype=torch.float64,
                                     coarse_enough=_COARSE),
                        BiCGStab(tol=1e-8), device="cpu")
    b = torch.as_tensor(rhs)
    x, iters, resid, hs = BiCGStab(tol=1e-8).solve(
        solve.A_dev, torch.zeros_like, b)
    assert iters == 0 and not torch.any(x)
    assert hs.flags & H.BREAKDOWN_ALPHA and hs.first_it[3] == 0
    assert resid == pytest.approx(1.0)
