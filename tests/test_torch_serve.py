"""The serving slice (stacked (n, B) solves, block CG, the resident
SolverService) against the JAX package's ``amgcl_tpu/serve``.

Inputs come from a numpy seed and go through both packages on the CPU in
float64. The parity contract is the JAX package's (tests/test_serve.py):
per-column iteration counts equal to the JAX package's stacked solve and
x within rtol 1e-9, atol 1e-12 of it; within the port, a B = 1 stacked
solve equals the 1-D solve and B > 1 columns equal independent solves.
The bucket's CUDA graph runs only on the card (tests/test_torch_cuda.py);
here every stacked apply runs column by column.
"""

import json
import queue
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import amgcl_tpu.solver as RS
from amgcl_tpu.models.amg import AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops import device as ref_dev
from amgcl_tpu.ops import fused_vec as ref_fv
from amgcl_tpu.serve import BlockCG as RefBlockCG
from amgcl_tpu.serve import decode_batched_health as ref_decode
from amgcl_tpu.solver import idrs as ref_idrs
from amgcl_tpu.telemetry.ledger import \
    krylov_iteration_model as ref_iteration_model
from amgcl_tpu.utils.sample_problem import poisson3d as ref_poisson3d

import amgcl_tpu_torch as T
from amgcl_tpu_torch import faults
from amgcl_tpu_torch.convert import idrs_with_shadow
from amgcl_tpu_torch.models import runtime as P
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.solver import stacked as S
from amgcl_tpu_torch.serve import (BlockCG, SolverService, StackedPrecond,
                                   decode_batched_health, lowering_kind,
                                   stacked_solve)
from amgcl_tpu_torch.telemetry import health as H
from amgcl_tpu_torch.telemetry import sink
from amgcl_tpu_torch.telemetry.ledger import krylov_iteration_model

CPU = dict(device="cpu")
F64 = dict(dtype=torch.float64)
_B = 3


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


# -- the nine solvers on poisson3d(6) with Jacobi -----------------------------

_SOLVERS = [
    ("CG", dict(maxiter=200, tol=1e-8)),
    ("BiCGStab", dict(maxiter=200, tol=1e-8)),
    ("BiCGStabL", dict(maxiter=200, tol=1e-8)),
    ("GMRES", dict(maxiter=200, tol=1e-8)),
    ("FGMRES", dict(maxiter=200, tol=1e-8)),
    ("LGMRES", dict(maxiter=200, tol=1e-8)),
    ("IDRs", dict(maxiter=200, tol=1e-8)),
    ("Richardson", dict(maxiter=500, tol=1e-8)),
    ("PreOnly", dict()),
]

_CACHE = {}


def _problem():
    """poisson3d(6) as a float64 DIA operator in both packages, the
    Jacobi preconditioner of tests/test_serve.py in both, and B = 3
    seeded right-hand sides."""
    if "problem" not in _CACHE:
        A, _ = T.poisson3d(6)
        A_ref, _ = ref_poisson3d(6)
        Ad = dev.to_device(A, "dia", torch.float64, "cpu")
        Ad_ref = ref_dev.to_device(A_ref, "dia", jnp.float64)
        d = 1.0 / A.diagonal()
        dinv = torch.as_tensor(d)
        dinv_ref = jnp.asarray(d)

        def pc(r):
            return dinv[:, None] * r if r.dim() == 2 else dinv * r

        def pc_ref(r):
            return dinv_ref[:, None] * r if r.ndim == 2 else dinv_ref * r

        Rh = np.random.RandomState(7).rand(A.nrows, _B)
        _CACHE["problem"] = (A, Ad, pc, Ad_ref, pc_ref, Rh)
    return _CACHE["problem"]


def _port_solver(name, kw, n):
    sl = getattr(T, name)(**kw)
    if name == "IDRs":
        sl = idrs_with_shadow(sl, np.asarray(ref_idrs._shadow_block(
            sl.s, jnp.arange(n), None, jnp.float64,
            ref_dev.inner_product)))
    return sl


def _ref_stacked(name, kw):
    """The JAX package's stacked solve of the B seeded columns (cached:
    one compile a solver for the module)."""
    key = ("ref", name)
    if key not in _CACHE:
        A, _, _, Ad_ref, pc_ref, Rh = _problem()
        got = getattr(RS, name)(**kw).solve(Ad_ref, pc_ref, jnp.asarray(Rh))
        _CACHE[key] = (np.asarray(got[0]), np.asarray(got[1]),
                       np.asarray(got[2]))
    return _CACHE[key]


@pytest.mark.parametrize("name,kw", _SOLVERS, ids=[n for n, _ in _SOLVERS])
def test_stacked_solve_matches_jax(name, kw):
    """Per-column iterations equal the JAX package's stacked solve, x
    within rtol 1e-9, atol 1e-12; the residuals agree."""
    A, Ad, pc, _, _, Rh = _problem()
    x_r, it_r, res_r = _ref_stacked(name, kw)
    x, its, res, hs = _port_solver(name, kw, A.nrows).solve(
        Ad, pc, torch.as_tensor(Rh))[:4]
    assert tuple(x.shape) == Rh.shape and len(its) == _B
    assert its == [int(v) for v in it_r]
    np.testing.assert_allclose(x.numpy(), x_r, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res, res_r, rtol=1e-6, atol=1e-14)
    assert hs.flags.shape == (_B,) and not hs.flags.any()
    assert hs.first_it.shape == (_B, H.N_FLAGS)


# the nine solvers and the variants whose stacked bodies branch: each
# column against its own 1-D solve, and B = 1 against the 1-D entry
_VARIANTS = _SOLVERS + [
    ("CG", dict(maxiter=200, tol=1e-8, record_history=True)),
    ("CG", dict(maxiter=7, tol=1e-8, guard=False)),
    ("BiCGStab", dict(maxiter=200, tol=1e-8, precond_side="left")),
    ("BiCGStabL", dict(L=3, maxiter=200, tol=1e-8, pside="left")),
    ("BiCGStabL", dict(L=2, maxiter=200, tol=1e-8, delta=0.1)),
    ("BiCGStabL", dict(maxiter=200, tol=1e-8, record_history=True)),
    ("GMRES", dict(M=5, maxiter=200, tol=1e-8)),
    ("GMRES", dict(M=4, maxiter=200, tol=1e-8, pside="right",
                   record_history=True)),
    ("GMRES", dict(M=5, maxiter=12, tol=1e-8)),
    ("FGMRES", dict(M=6, maxiter=200, tol=1e-8)),
    ("LGMRES", dict(M=6, K=2, maxiter=200, tol=1e-8)),
    ("LGMRES", dict(M=6, K=2, maxiter=200, tol=1e-8, pside="right")),
    ("IDRs", dict(s=2, maxiter=200, tol=1e-8, record_history=True)),
    ("IDRs", dict(s=3, maxiter=200, tol=1e-8, guard=False)),
    ("Richardson", dict(maxiter=40, tol=1e-8, damping=0.9,
                        record_history=True)),
]


@pytest.mark.parametrize("name,kw", _VARIANTS,
                         ids=["%s-%d" % (n, i)
                              for i, (n, _) in enumerate(_VARIANTS)])
def test_stacked_columns_equal_independent_solves(name, kw):
    """Each column of a stacked solve (one column zero) gives its own
    1-D solve's iterations, residual, history and x; B = 1 gives the
    1-D solve; the block keeps its (B, n) layout through the loop."""
    A, Ad, pc, _, _, Rh = _problem()
    sl = _port_solver(name, kw, A.nrows)
    R = torch.as_tensor(Rh.T.copy()).T        # (n, B) view of (B, n)
    R[:, 1] = 0.0
    got = sl.solve(Ad, pc, R)                 # dev.columns asserts the layout
    x, its, res = got[:3]
    assert x.T.is_contiguous()
    for b in range(_B):
        one = sl.solve(Ad, pc, R[:, b].contiguous())
        assert its[b] == one[1], b
        np.testing.assert_allclose(res[b], one[2], rtol=1e-7, atol=1e-14)
        np.testing.assert_allclose(x[:, b].numpy(), one[0].numpy(),
                                   rtol=1e-9, atol=1e-12)
        if sl.guard:
            assert got[3].columns[b].flags == one[3].flags
        if sl.record_history:
            np.testing.assert_allclose(got[4][b], one[4], rtol=1e-7,
                                       atol=1e-14)
    assert its[1] == (1 if name == "PreOnly" else 0)
    g1 = sl.solve(Ad, pc, R[:, :1])
    one = sl.solve(Ad, pc, R[:, 0].contiguous())
    assert g1[1] == [one[1]]
    np.testing.assert_allclose(g1[0][:, 0].numpy(), one[0].numpy(),
                               rtol=1e-9, atol=1e-12)


def test_stacked_solve_returns_arrays():
    A, Ad, pc, _, _, Rh = _problem()
    x, its, res, hs = stacked_solve(T.CG(tol=1e-8), Ad, pc,
                                    torch.as_tensor(Rh))
    assert its.shape == (_B,) and res.shape == (_B,) and x.shape == Rh.shape


def test_poisoned_column_trips_its_own_guard():
    """A column whose x0 overflows at its first step trips NaN at
    iteration 0 and commits nothing; the healthy columns converge as the
    JAX package's do, and the decode is the JAX package's dict."""
    A, Ad, pc, Ad_ref, pc_ref, Rh = _problem()
    x0 = np.zeros(Rh.shape)
    x0[:, 1] = 1e200
    x, its, res, hs = T.CG(maxiter=100, tol=1e-8).solve(
        Ad, pc, torch.as_tensor(Rh), torch.as_tensor(x0))
    ref = RS.CG(maxiter=100, tol=1e-8).solve(Ad_ref, pc_ref,
                                             jnp.asarray(Rh),
                                             jnp.asarray(x0))
    flags = hs.flags
    assert flags[1] & H.NAN and flags[0] == 0 and flags[2] == 0
    assert its[1] == 0
    assert its == [int(v) for v in ref[1]]
    np.testing.assert_array_equal(flags, np.asarray(ref[-1].flags))
    np.testing.assert_array_equal(hs.first_it, np.asarray(ref[-1].first_it))
    for b in (0, 2):
        np.testing.assert_allclose(x[:, b].numpy(), np.asarray(ref[0][:, b]),
                                   rtol=1e-9, atol=1e-12)
    dec = decode_batched_health(flags, hs.first_it)
    assert dec == ref_decode(np.asarray(ref[-1].flags),
                             np.asarray(ref[-1].first_it))
    assert not dec["ok"] and dec["nan"] and dec["unhealthy_rhs"] == [1]


def test_blockcg_matches_jax():
    """BlockCG gives the JAX package's iterations and X; its count is no
    greater than the worst independent CG column; a 1-D rhs runs as
    B = 1 with the plain slots."""
    A, Ad, pc, Ad_ref, pc_ref, Rh = _problem()
    x, its, res, hs = BlockCG(maxiter=200, tol=1e-8).solve(
        Ad, pc, torch.as_tensor(Rh))
    ref = RefBlockCG(maxiter=200, tol=1e-8).solve(Ad_ref, pc_ref,
                                                  jnp.asarray(Rh))
    assert its == [int(v) for v in ref[1]]
    np.testing.assert_allclose(x.numpy(), np.asarray(ref[0]), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(res, np.asarray(ref[2]), rtol=1e-6)
    assert not hs.flags.any()
    cg = [T.CG(maxiter=200, tol=1e-8).solve(
        Ad, pc, torch.as_tensor(Rh[:, b].copy()))[1] for b in range(_B)]
    assert max(its) <= max(cg)
    g1 = BlockCG(maxiter=200, tol=1e-8, record_history=True).solve(
        Ad, pc, torch.as_tensor(Rh[:, 0].copy()))
    assert g1[0].dim() == 1 and isinstance(g1[1], int)
    assert len(g1[4]) == g1[1] and g1[3].flags == 0


def test_fused_vec_stacked_primitives_match_jax():
    """The (n, B) tier gives the JAX package's stacked primitives and the
    port's per-column 1-D results."""
    rng = np.random.RandomState(11)
    p, q, x, r = (rng.rand(64, 4) for _ in range(4))
    al, om = rng.rand(4), rng.rand(4)
    # (n, B) operands as the stacked solvers hold them: views of (B, n)
    t = lambda a: S.block(torch.as_tensor(a)) if np.ndim(a) == 2 \
        else torch.as_tensor(a)
    j = lambda a: jnp.asarray(a)
    got = fv.xr_update(t(al), t(p), t(q), t(x), t(r))
    want = ref_fv.xr_update(j(al), j(p), j(q), j(x), j(r))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    for b in range(4):
        one = fv.xr_update(float(al[b]), t(p[:, b].copy()), t(q[:, b].copy()),
                           t(x[:, b].copy()), t(r[:, b].copy()))
        np.testing.assert_allclose(got[2][b].item(), one[2].item(),
                                   rtol=1e-12)
    got = fv.bicgstab_tail(t(al), t(p), t(om), t(q), t(x), t(r), t(p * 0),
                           t(q))
    want = ref_fv.bicgstab_tail(j(al), j(p), j(om), j(q), j(x), j(r),
                                j(p * 0), j(q))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    got = fv.axpby_dot(t(al), t(p), 0.5, t(x))
    want = ref_fv.axpby_dot(j(al), j(p), 0.5, j(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    np.testing.assert_allclose(fv.col_dots(t(p), t(q)).numpy(),
                               np.asarray(ref_fv.col_dots(j(p), j(q))),
                               rtol=1e-12)
    A, _ = T.poisson3d(5)
    A_ref, _ = ref_poisson3d(5)
    F, X = rng.rand(A.nrows, 4), rng.rand(A.nrows, 4)
    got = fv.residual_dot(t(F), dev.to_device(A, "dia", torch.float64,
                                              "cpu"), t(X))
    want = ref_fv.residual_dot(j(F), ref_dev.to_device(A_ref, "dia",
                                                       jnp.float64), j(X))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)
    V, w = rng.rand(5, 64, 4), rng.rand(64, 4)
    sd = fv.stack_dots(t(V), t(w))
    assert sd.shape == (5, 4)
    for b in range(4):
        np.testing.assert_allclose(
            sd[:, b].numpy(), np.asarray(ref_fv.stack_dots(
                j(V[:, :, b]), j(w[:, b]))), rtol=1e-12)
    G = fv.block_dots(t(V[:3]), t(V))
    assert G.shape == (4, 3, 5)
    np.testing.assert_allclose(G[2].numpy(), np.asarray(ref_fv.block_dots(
        j(V[:3, :, 2]), j(V[:, :, 2]))), rtol=1e-12)


def test_stacked_operator_products_run_column_by_column():
    """spmv, residual and spmv_dots on (n, B) run the 1-D path a column;
    a row-major block is refused (no copy on the hot path), the (n, B)
    view of a (B, n) block laid out at a solve's entry is taken as it
    is, and the results keep that layout."""
    A, Ad, _, _, _, Rh = _problem()
    with pytest.raises(AssertionError, match="contiguous"):
        dev.spmv(Ad, torch.as_tensor(Rh))
    X = S.block(torch.as_tensor(Rh))
    assert X.T.is_contiguous() and X.T.data_ptr() == S.block(X).T.data_ptr()
    y = dev.spmv(Ad, X)
    assert y.T.is_contiguous()
    y2, yy, yx, yw = dev.spmv_dots(Ad, y, y)
    assert y2.T.is_contiguous()
    for b in range(_B):
        col = X[:, b].contiguous()
        np.testing.assert_array_equal(y[:, b].numpy(),
                                      dev.spmv(Ad, col).numpy())
        one = dev.spmv_dots(Ad, y[:, b], y[:, b])
        assert yy[b] == one[1] and yx[b] == one[2] and yw[b] == one[3]
    r = dev.residual(X, Ad, y)
    np.testing.assert_array_equal(r[:, 2].numpy(), dev.residual(
        X[:, 2].contiguous(), Ad, y[:, 2]).numpy())


# -- make_solver ---------------------------------------------------------------

def _sa_problem():
    if "sa" not in _CACHE:
        A, rhs = T.poisson3d(12)
        R = np.random.RandomState(3).rand(A.nrows, 4)
        R[:, 0] = rhs
        _CACHE["sa"] = (A, rhs, R)
    return _CACHE["sa"]


def test_make_solver_stacked_matches_jax():
    """make_solver(batch=4) on an SA hierarchy at poisson3d(12): the
    stacked call's per-column counts equal the JAX package's; the report
    holds the batch maxima, per-column detail and the health dict."""
    A, rhs, R = _sa_problem()
    A_ref, _ = ref_poisson3d(12)
    ref = ref_make_solver(A_ref, RefParams(dtype=jnp.float64),
                          RS.CG(maxiter=100, tol=1e-8), batch=4)
    x_r, info_r = ref(R)
    solve = T.make_solver(A, T.AMGParams(**F64), T.CG(maxiter=100, tol=1e-8),
                          batch=4, **CPU)
    assert solve.batch == 4
    x, info = solve(R)
    per = info.extra["per_rhs"]
    assert per["iters"] == info_r.extra["per_rhs"]["iters"]
    assert info.iters == max(per["iters"]) and info.extra["batch"] == 4
    np.testing.assert_allclose(x.numpy(), np.asarray(x_r), rtol=1e-7,
                               atol=1e-10)
    assert info.health["ok"] and len(info.health["per_rhs"]) == 4
    assert info.extra["lowering"] == "per-column"
    assert info.solves_per_sec > 0
    x1, info1 = solve(rhs)
    assert info1.iters == per["iters"][0]
    np.testing.assert_allclose(x[:, 0].numpy(), x1.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_make_solver_stacked_refine_gate_and_shapes():
    A, rhs, R = _sa_problem()
    prm = T.AMGParams(**F64)
    with pytest.raises(ValueError, match="refinement"):
        T.make_solver(A, prm, T.CG(tol=1e-8), refine=2, **CPU)(R)
    solve = T.make_solver(A, prm, T.CG(tol=1e-8), **CPU)
    with pytest.raises(ValueError, match="x0"):
        solve(R, x0=rhs)
    with pytest.raises(ValueError, match="rhs"):
        solve(R[:-1])
    with pytest.raises(ValueError, match="batch"):
        T.make_solver(A, prm, T.CG(), batch=-2, **CPU)
    # an x0 per column is taken, in the (n, B) frame
    x, info = solve(R[:, :2], x0=np.ones((A.nrows, 2)))
    assert max(info.extra["per_rhs"]["resid"]) <= 1e-8


def test_make_solver_stacked_in_the_reorder_frame():
    """With an RCM-reordered hierarchy, rhs and x0 are permuted into its
    frame along dim 0 and x back: each column equals the 1-D call, and
    the columns are true solutions of the caller's system."""
    A, rhs, R = _sa_problem()
    solve = T.make_solver(A, T.AMGParams(**F64), T.CG(tol=1e-8),
                          reorder="rcm", **CPU)
    assert solve._perm is not None
    X0 = np.random.RandomState(4).rand(A.nrows, 4) * 1e-3
    x, info = solve(R, x0=X0)
    for b in range(4):
        xb, ib = solve(R[:, b], x0=X0[:, b])
        assert ib.iters == info.extra["per_rhs"]["iters"][b]
        np.testing.assert_allclose(x[:, b].numpy(), xb.numpy(), rtol=1e-9,
                                   atol=1e-12)
        rel = np.linalg.norm(R[:, b] - A.spmv(x[:, b].numpy())) \
            / np.linalg.norm(R[:, b])
        assert rel < 1e-7


def test_runtime_blockcg_builds_and_solves():
    A, rhs, R = _sa_problem()
    solve = P.make_solver_from_config(
        A, {"solver.type": "blockcg", "solver.tol": 1e-8,
            "solver.maxiter": 100, "precond.dtype": "float64"}, **CPU)
    assert isinstance(solve.solver, BlockCG) and P.SOLVERS["blockcg"] \
        is BlockCG
    x, info = solve(R[:, :3])
    assert info.solver == "BlockCG" and info.resid <= 1e-8
    x1, info1 = solve(rhs)
    assert info1.resid <= 1e-8


def test_every_preconditioner_takes_a_stacked_residual():
    """The per-column apply of every hierarchy kind equals its 1-D apply
    column by column (the counterpart of vmapping apply)."""
    A, rhs, R = _sa_problem()
    Rt = S.block(torch.as_tensor(R))
    precs = [T.AMG(A, T.AMGParams(**F64), **CPU),
             T.AsPreconditioner(A, T.Spai0(), **F64, **CPU),
             T.DummyPreconditioner(A, **F64, **CPU)]
    nested = P.precond_from_config(
        A, {"class": "nested", "solver.type": "cg", "solver.maxiter": 3,
            "precond.class": "amg", "precond.dtype": "float64"}, **CPU)
    for pre in precs + [nested]:
        Z = pre.hierarchy.apply(Rt)
        for b in range(4):
            np.testing.assert_array_equal(
                Z[:, b].numpy(),
                pre.hierarchy.apply(Rt[:, b].contiguous()).numpy())
    from amgcl_tpu_torch.models.amg import host_sync_reason
    assert host_sync_reason(precs[0].hierarchy) is None
    assert "NestedHierarchy" in host_sync_reason(nested.hierarchy)


def test_stacked_precond_and_lowering_tags():
    A, rhs, R = _sa_problem()
    solve = T.make_solver(A, T.AMGParams(**F64), T.CG(tol=1e-8), **CPU)
    pre = solve.stacked_precond()
    assert isinstance(pre, StackedPrecond) and pre is solve.stacked_precond()
    assert pre.lowering == "per-column" and pre.captures == {}
    Rb = S.block(torch.as_tensor(R))
    Z = pre(Rb)
    np.testing.assert_array_equal(Z.numpy(), pre.eager(Rb).numpy())
    assert pre.captures == {} and pre.replays == {}
    assert lowering_kind("cpu") == "per-column"
    assert lowering_kind("cpu", solve.precond.hierarchy) == "per-column"
    assert lowering_kind("cuda", solve.precond.hierarchy) \
        == "per-column-graph"
    nested = P.precond_from_config(
        A, {"class": "nested", "solver.type": "cg", "solver.maxiter": 3,
            "precond.class": "amg", "precond.dtype": "float64"}, **CPU)
    assert lowering_kind("cuda", nested.hierarchy) \
        == "per-column-uncaptured"
    solve.rebuild(A)
    assert solve.stacked_precond() is not pre


# -- the iteration model -------------------------------------------------------

def test_krylov_iteration_model_batch_and_padding():
    """One column gives the JAX package's model; B columns give its
    FLOPs and padding split, and B times one column's bytes (the port
    reads each operator once a column, the JAX model once a batch)."""
    A, _ = T.poisson3d(8)
    A_ref, _ = ref_poisson3d(8)
    Ad = dev.to_device(A, "dia", torch.float32, "cpu")
    Ad_ref = ref_dev.to_device(A_ref, "dia", jnp.float32)
    for name in ("CG", "BiCGStab", "GMRES", "PreOnly"):
        one = krylov_iteration_model(name, Ad)
        want = ref_iteration_model(name, Ad_ref)
        assert (one["flops"], one["bytes"]) == (want["flops"], want["bytes"])
        for b, eff in ((8, None), (8, 3), (4, 0)):
            got = krylov_iteration_model(name, Ad, batch=b,
                                         effective_batch=eff)
            want = ref_iteration_model(name, Ad_ref, batch=b,
                                       effective_batch=eff)
            assert got["bytes"] == b * one["bytes"]
            for key in ("flops", "padding_waste_flops", "batch_fill",
                        "effective_batch"):
                assert got.get(key) == want.get(key), (name, b, key)
            if eff is not None:
                assert got["padding_waste_bytes"] == round(
                    got["bytes"] * (1 - eff / b))


def test_faults_backoff_is_seeded_and_typed():
    assert faults.backoff_s(1, key=5) == faults.backoff_s(1, key=5)
    assert 0.05 <= faults.backoff_s(1, key=5) <= 0.055
    assert 0.1 <= faults.backoff_s(2, key=5) <= 0.11
    assert issubclass(faults.WorkerDiedError, RuntimeError)
    assert faults.is_resource_exhausted(RuntimeError("CUDA out of memory"))
    assert not faults.is_resource_exhausted(ValueError("shape"))


# -- the service ---------------------------------------------------------------

def _bundle(m=8, **kw):
    key = ("bundle", m, tuple(sorted(kw.items())))
    if key not in _CACHE:
        A, rhs = T.poisson3d(m)
        _CACHE[key] = (A, rhs, T.make_solver(
            A, T.AMGParams(**F64, coarse_enough=50),
            kw.pop("solver", None) or T.CG(maxiter=50, tol=1e-8), **CPU))
    return _CACHE[key]


def test_service_queue_and_stats(tmp_path):
    """Submits resolve to the direct solves' columns; the buckets split
    the requests; stats carry solves/s, latency percentiles, spans and
    the lowering; the sink gets per-batch and per-request events."""
    A, rhs, solve = _bundle()
    x_direct, info = solve(rhs)
    out = tmp_path / "serve.jsonl"
    sink.set_default_sink(sink.JsonlSink(str(out)))
    try:
        with SolverService(solve, batch=4, flush_ms=25) as svc:
            futs = [svc.submit(rhs * (1.0 + k)) for k in range(6)]
            results = [f.result(timeout=120) for f in futs]
            stats = svc.stats()
    finally:
        sink.set_default_sink(None)
    for k, (xk, rep) in enumerate(results):
        np.testing.assert_allclose(xk.numpy(), (1.0 + k) * x_direct.numpy(),
                                   rtol=1e-7, atol=1e-10)
        assert rep.iters == info.iters and rep.health["ok"]
        assert rep.serve["lowering"] == "per-column"
    assert stats["requests"] == 6 and stats["batches"] >= 2
    assert stats["latency_s"]["p50"] <= stats["latency_s"]["p99"]
    assert stats["solves_per_sec"] > 0 and stats["lowering"] == "per-column"
    assert stats["graphs"]["captures"] == {}
    recs = [json.loads(ln) for ln in open(out)]
    assert any(r.get("final") for r in recs if r.get("event") == "serve")
    assert sum(r.get("event") == "serve_request" for r in recs) == 6


def test_service_spans_sum_to_latency_and_buckets():
    """queue + pad + compile + solve + sync = latency for every request;
    3 requests under batch 4 take a bucket of 4 with one zero column
    (booked as padding waste), one request a bucket of 1."""
    A, rhs, solve = _bundle()
    svc = SolverService(solve, batch=4, flush_ms=200)
    assert [svc._bucket(k) for k in (1, 2, 3, 4, 5)] == [1, 2, 4, 4, 4]
    with svc:
        futs = [svc.submit(rhs * (k + 1)) for k in range(3)]
        reps = [f.result(timeout=120)[1] for f in futs]
        time.sleep(0.05)
        one = svc.submit(rhs).result(timeout=120)[1]
        stats = svc.stats()
    for rep in reps + [one]:
        s = rep.serve
        total = s["queue_ms"] + s["pad_ms"] + s["compile_ms"] \
            + s["solve_ms"] + s["sync_ms"]
        assert abs(total - s["latency_ms"]) < 0.01, s
    assert {r.serve["bucket_B"] for r in reps} == {4}
    assert reps[0].serve["batch_fill"] == 0.75
    assert one.serve["bucket_B"] == 1
    assert stats["padded_slots"] == 1
    assert stats["padding_waste"]["padded_col_iters"] == reps[0].iters
    trace = svc.to_chrome_trace(tid_name="serve")
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"queue", "pad", "solve", "sync"} <= names


def test_service_solve_batch_matches_the_stacked_call():
    A, rhs, solve = _bundle()
    R = np.random.RandomState(5).rand(A.nrows, 3)
    x, rep = SolverService(solve, batch=4).solve_batch(R)
    xs, info = solve(R)
    np.testing.assert_array_equal(x.numpy(), xs.numpy())
    assert rep.extra["per_rhs"] == info.extra["per_rhs"]
    assert rep.health["ok"] and rep.solves_per_sec > 0
    x1, rep1 = SolverService(solve).solve_batch(R[:, 0])
    assert x1.shape == (A.nrows, 1)


def test_service_timeout_refine_gate_and_close():
    A, rhs, solve = _bundle(6)
    with SolverService(solve, batch=2, flush_ms=5) as svc:
        fut = svc.submit(rhs, timeout_s=-1.0)     # already expired
        with pytest.raises(TimeoutError):
            fut.result(timeout=60)
        assert svc.stats()["timeouts"] == 1
        with pytest.raises(ValueError, match="unknowns"):
            svc.submit(rhs[:-1])
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(rhs)
    ref = T.make_solver(A, T.AMGParams(**F64), T.CG(), refine=1, **CPU)
    with pytest.raises(ValueError, match="refine"):
        SolverService(ref)
    with pytest.raises(TypeError):
        SolverService(object())
    with pytest.raises(NotImplementedError, match="A.11b"):
        svc.release_device()
    with pytest.raises(NotImplementedError, match="A.11b"):
        svc.readmit()


def test_service_supervisor_fails_futures_and_restarts():
    """A worker that dies fails its in-flight future with WorkerDiedError
    and restarts; the next request is served."""
    A, rhs, solve = _bundle(6)
    svc = SolverService(solve, batch=2, flush_ms=5)
    real = svc._run_batch
    calls = []

    def dying(batch):
        calls.append(len(batch))
        if len(calls) == 1:
            raise faults.WorkerDiedError("worker lost")
        return real(batch)

    svc._run_batch = dying
    svc._handle_batch_failure = lambda batch, e: (_ for _ in ()).throw(e)
    with svc:
        with pytest.raises(faults.WorkerDiedError):
            svc.submit(rhs).result(timeout=60)
        x, rep = svc.submit(rhs).result(timeout=60)
        st = svc.stats()
    assert rep.iters > 0
    assert st["recovery"]["worker_deaths"] == 1
    assert st["recovery"]["worker_restarts"] == 1
    assert svc.live.get("serve_worker_deaths_total") == 1


def test_service_bisection_isolates_a_poison_request():
    """With retry_max > 0 a failing batch is bisected: the healthy
    requests are served and the poison one fails with its error after
    its retries."""
    A, rhs, solve = _bundle(6)
    svc = SolverService(solve, batch=4, flush_ms=100, retry_max=1,
                        retry_backoff_ms=1)
    real = svc._run_batch
    poison = rhs * 7.0

    def run(batch):
        if any(torch.equal(r.rhs, torch.as_tensor(poison)) for r in batch):
            raise faults.PoisonRequestError("poison in %s"
                                            % [r.rid for r in batch])
        return real(batch)

    svc._run_batch = run
    with svc:
        futs = [svc.submit(rhs * (k + 1)) for k in range(6)] \
            + [svc.submit(poison)]
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=60)[1].iters)
            except faults.PoisonRequestError:
                out.append("poison")
        st = svc.stats()
    assert out[-1] == "poison" and out[6] == "poison"
    assert all(isinstance(v, int) for v in out[:6])
    assert st["recovery"]["retries"] >= 1 and st["unhealthy"] == 1


def test_service_slo_watchdog_and_metrics_endpoint():
    """An unhealthy-rate trip fires once (an slo event with the serving
    findings); /metrics and /healthz answer on an ephemeral local
    port."""
    A, rhs, solve = _bundle(6)
    events = []

    class _Rec:
        def emit(self, record=None, **f):
            events.append(dict(record or {}, **f))

    sink.set_default_sink(_Rec())
    try:
        with SolverService(solve, batch=2, flush_ms=5, metrics_port=0,
                           slo_unhealthy_rate=0.0, slo_p99_ms=1e-6) as svc:
            # an x0 whose first step overflows: the NaN guard trips
            svc.submit(rhs, x0=np.full(A.nrows, 1e200)).result(timeout=60)
            svc.submit(rhs).result(timeout=60)
            body = urllib.request.urlopen(svc.metrics_url, timeout=10) \
                .read().decode()
            health = json.loads(urllib.request.urlopen(
                svc.metrics_url.replace("/metrics", "/healthz"),
                timeout=10).read())
            st = svc.stats()
    finally:
        sink.set_default_sink(None)
    assert "amgcl_torch_serve_requests_total 2" in body
    assert health["requests"] == 2 and health["ok"]
    slo = [e for e in events if e.get("event") == "slo"]
    assert len(slo) == 1 and set(slo[0]["new_trips"]) == {"p99",
                                                           "unhealthy_rate"}
    codes = {f["code"] for f in slo[0]["findings"]}
    assert {"slo_p99", "slo_unhealthy_rate"} <= codes
    assert st["slo_trips"] == 2 and st["unhealthy"] == 1
    assert st["metrics_port"] > 0


def test_service_blocking_submit_and_full_queue():
    A, rhs, solve = _bundle(6)
    svc = SolverService(solve, batch=1, queue_max=1, flush_ms=1)
    gate = threading.Event()
    real = svc._run_batch

    def slow(batch):
        gate.wait(10)
        return real(batch)

    svc._run_batch = slow
    with svc:
        f1 = svc.submit(rhs)
        time.sleep(0.3)                    # the worker holds f1
        f2 = svc.submit(rhs)               # fills the queue
        with pytest.raises(queue.Full):
            svc.submit(rhs)
        gate.set()
        f3 = svc.submit(rhs, block=True)
        assert all(f.result(timeout=60)[1].iters > 0 for f in (f1, f2, f3))


def test_serve_findings_and_live_registry_contract():
    from amgcl_tpu.telemetry.health import serve_findings as ref_findings
    from amgcl_tpu_torch.telemetry.live import LiveRegistry
    summary = {"trips": ["p99", "timeout_rate"], "window": 10,
               "p99_ms": 50.0, "timeout_rate": 0.2,
               "slo": {"p99_ms": 10.0, "timeout_rate": 0.01},
               "spans_ms": {"queue": 40.0, "solve": 5.0}, "batch_fill": 0.25}
    got = H.serve_findings(summary)
    want = ref_findings(summary)
    assert [f["code"] for f in got] == [f["code"] for f in want]
    assert [f["severity"] for f in got] == [f["severity"] for f in want]
    assert "queue_ms" in got[0]["message"]
    reg = LiveRegistry()
    with pytest.raises(KeyError):
        reg.inc("no_such_metric")
    with pytest.raises(TypeError):
        reg.set_gauge("serve_requests_total", 1)
    with pytest.raises(KeyError):
        reg.inc("serve_requests_total", tenant="a")
    reg.observe("serve_latency_ms", 3.0)
    assert reg.snapshot()["histograms"]["serve_latency_ms"]["count"] == 1
