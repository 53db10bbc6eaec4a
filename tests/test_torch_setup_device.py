"""The port's accelerator setup against the JAX package's on the CPU: the
device MIS (``coarsening/device_mis.py``), the segment-sum plans
(``ops/segment_spgemm.py``), hierarchies built with the setup on the
device (``device_setup=True`` against ``AMGCL_TPU_DEVICE_SETUP=1``), the
numeric rebuild and the device coarse inverse's gate.

Tolerances: aggregates, plan index arrays and level patterns identical;
host-pass values bit for bit; device-route values within 1e-12 of the
largest reference entry in float64; float64 iteration counts exactly; a
rebuild bit for bit against a fresh build of the same values.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from amgcl_tpu.coarsening import device_mis as r_mis
from amgcl_tpu.coarsening.aggregation import Aggregation as RefAggregation
from amgcl_tpu.coarsening.smoothed_aggregation import \
    SmoothedAggregation as RefSA
from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops import segment_spgemm as r_seg
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.solver.bicgstab import BiCGStab as RefBiCGStab
from amgcl_tpu.solver import direct as r_direct
from amgcl_tpu.utils.sample_problem import poisson3d_block as ref_p3b

import amgcl_tpu_torch as T
from amgcl_tpu_torch.coarsening import device_mis as mis
from amgcl_tpu_torch.coarsening import plain_aggregates
from amgcl_tpu_torch.coarsening.galerkin import galerkin
from amgcl_tpu_torch.coarsening.smoothed_aggregation import _filtered
from amgcl_tpu_torch.coarsening.tentative import tentative_prolongation
from amgcl_tpu_torch.models.amg import device_mis_declined
from amgcl_tpu_torch.ops import segment_spgemm as seg
from amgcl_tpu_torch.solver import direct

CPU = torch.device("cpu")


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


@pytest.fixture
def ref_device_setup(monkeypatch):
    monkeypatch.setenv("AMGCL_TPU_DEVICE_SETUP", "1")


def _ref(A):
    return RefCSR(A.ptr, A.col, A.val, A.ncols)


def _lap2d_permuted(n=40, seed=3):
    T1 = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                  [-1, 0, 1])
    L = (sp.kron(sp.identity(n), T1) + sp.kron(T1, sp.identity(n))).tocsr()
    p = np.random.RandomState(seed).permutation(n * n)
    return T.CSR.from_scipy(L[p][:, p])


_SYSTEMS = {
    "poisson": lambda: T.poisson3d(16)[0],
    "fe": lambda: T.fe_like_problem(3000, nnz_target=31 * 3000, seed=1)[0],
    "lap2d_permuted": _lap2d_permuted,
}
_CACHE = {}


def _system(name):
    if name not in _CACHE:
        _CACHE[name] = _SYSTEMS[name]()
    return _CACHE[name]


def _close(got, want, rtol=1e-12):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


# -- the device MIS -----------------------------------------------------

@pytest.mark.parametrize("name", sorted(_SYSTEMS))
def test_device_mis_matches_jax(name):
    A = _system(name)
    agg, n_agg = mis.aggregates_on_device(A, 0.08, CPU)
    agg_r, n_agg_r = r_mis.aggregates_on_device(_ref(A), 0.08)
    assert n_agg == n_agg_r and np.array_equal(agg, agg_r)
    # and plain_aggregates takes it when a setup device is named
    got, n = plain_aggregates(A, 0.08, CPU)
    assert n == n_agg and np.array_equal(got, agg)


def test_device_mis_keys_match_jax_on_the_raw_adjacency():
    """The rounds themselves on one ELL adjacency (the JAX package pads
    to its shape buckets; the real rows' keys agree)."""
    from amgcl_tpu_torch.coarsening.aggregates import (_priority,
                                                       strength_graph)
    A = _system("fe")
    cols, valid = mis.strength_ell(strength_graph(A, 0.08))
    prio = _priority(A.nrows).astype(np.int32)
    key, assigned = mis.device_aggregates(
        torch.as_tensor(cols, dtype=torch.int64), torch.as_tensor(valid),
        torch.as_tensor(prio))
    key_r, assigned_r = r_mis.device_aggregates(
        jnp.asarray(cols), jnp.asarray(valid), jnp.asarray(prio))
    assert np.array_equal(key.numpy(), np.asarray(key_r))
    assert np.array_equal(assigned.numpy(), np.asarray(assigned_r))


# -- the plans ----------------------------------------------------------

@pytest.fixture(scope="module")
def level():
    """fe's fine level: A, its device-MIS aggregates, A_f and D_f⁻¹, and
    the smoothed P and R the host smoothing plan gives."""
    A = _system("fe")
    agg, n_agg = mis.aggregates_on_device(A, 0.08, CPU)
    Af, dinv = _filtered(A, 0.08)
    omega = 0.61
    P = seg.SmoothPlan(Af, agg, n_agg).prolongation(Af, dinv, omega)
    return A, agg, n_agg, Af, dinv, omega, P, P.transpose()


def _same_arrays(plan, ref, names):
    for nm in names:
        assert np.array_equal(getattr(plan, nm), getattr(ref, nm)), nm


def test_triple_product_plan_matches_jax(level):
    A, agg, n_agg = level[:3]
    plan = seg.TripleProductPlan(A, agg, agg, n_agg, n_agg)
    ref = r_seg.TripleProductPlan(_ref(A), agg, agg, n_agg, n_agg)
    _same_arrays(plan, ref, ("take", "seg", "ptr", "col"))
    host = plan.coarse_values(A.val, 1.5)
    assert np.array_equal(host, ref.coarse_values(A.val, 1.5, device=False))
    _close(plan.coarse_values(A.val, 1.5, CPU),
           ref.coarse_values(A.val, 1.5, device=True))


def test_smooth_plan_matches_jax(level):
    A, agg, n_agg, Af, dinv, omega = level[:6]
    plan = seg.SmoothPlan(Af, agg, n_agg)
    ref = r_seg.SmoothPlan(_ref(Af), agg, n_agg)
    _same_arrays(plan, ref, ("take", "rows_kept", "seg", "ptr", "col"))
    assert plan.n_iden == ref.n_iden and plan.nnz_p == ref.nnz_p
    P = plan.prolongation(Af, dinv, omega)
    P_r = ref.prolongation(_ref(Af), dinv, omega, device=False)
    assert np.array_equal(P.val, P_r.val)
    P_d = plan.prolongation(Af, dinv, omega, CPU)
    _close(P_d.val, ref.prolongation(_ref(Af), dinv, omega,
                                     device=True).val)
    # on float64 the device route adds in the host pass's order
    assert np.array_equal(P_d.val, P.val)


def test_spgemm_and_galerkin_plans_match_jax(level):
    A, agg, n_agg, _, _, _, P, R = level
    plan = seg.SpGEMMPlan.build(A, P)
    ref = r_seg.SpGEMMPlan.build(_ref(A), _ref(P))
    _same_arrays(plan, ref, ("ia", "ib", "seg", "ptr", "col"))
    host = plan.values(A.val, P.val)
    assert np.array_equal(host, ref.values(A.val, P.val, device=False))
    _close(plan.values(A.val, P.val, CPU),
           ref.values(A.val, P.val, device=True))
    g = seg.GalerkinPlan(A, P, R)
    g_r = r_seg.GalerkinPlan(_ref(A), _ref(P), _ref(R))
    assert g.kind == g_r.kind == "general"
    for dev_, knob in ((None, "0"), (CPU, "1")):
        Ac = g.coarse(A, 0.75, dev_)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("AMGCL_TPU_DEVICE_SETUP", knob)
            Ac_r = g_r.coarse(_ref(A), 0.75)
        assert np.array_equal(Ac.ptr, Ac_r.ptr)
        assert np.array_equal(Ac.col, Ac_r.col)
        if dev_ is None:
            assert np.array_equal(Ac.val, Ac_r.val)
        else:
            _close(Ac.val, Ac_r.val)


def test_plan_opt_outs_match_jax(level, monkeypatch):
    """Selection P always plans; a smoothed P plans on a device build or
    when forced; block values never; past the flop guard the level keeps
    scipy's product and remembers that it opted out."""
    A, agg, n_agg, _, _, _, P, R = level
    Pt, _ = tentative_prolongation(A.nrows, agg, n_agg, None, 1)
    assert seg.selection_aggregates(P) is None
    assert np.array_equal(seg.selection_aggregates(Pt), agg)
    assert seg.ensure_plan(A, Pt, Pt.transpose()).kind == "selection"
    assert seg.ensure_plan(A, P.copy(), R) is None
    assert seg.ensure_plan(A, P.copy(), R, device=CPU).kind == "general"
    assert seg.ensure_plan(A, P.copy(), R, force=True).kind == "general"
    B = T.poisson3d_block(4, 3)[0]
    assert seg.ensure_plan(B, B, B, device=CPU) is None
    monkeypatch.setattr(seg, "PLAN_MAX_FLOPS", 10)
    Pc = P.copy()
    assert seg.SpGEMMPlan.build(A, Pc) is None
    assert r_seg.SpGEMMPlan.build(_ref(A), _ref(P), max_flops=10) is None
    assert seg.ensure_plan(A, Pc, R, device=CPU) is None
    assert Pc._seg_plan_oversize == seg._pattern_tag(A)
    Ac = galerkin(A, Pc, R, CPU)
    want = R @ (A @ Pc)
    assert np.array_equal(Ac.val, want.val)


# -- hierarchies with the setup on the device ---------------------------

def _ref_coarsening(kind):
    return {"sa": RefSA(), "aggregation": RefAggregation()}[kind]


def _port_coarsening(kind):
    return {"sa": T.SmoothedAggregation(),
            "aggregation": T.Aggregation()}[kind]


@pytest.mark.parametrize("kind", ["sa", "aggregation"])
def test_device_setup_hierarchy_matches_jax(ref_device_setup, kind):
    """fe at 3,000 rows: identical level shapes and patterns, values
    within 1e-12, and BiCGStab's float64 count exactly."""
    A = _system("fe")
    rhs = np.ones(A.nrows)
    kw = dict(coarse_enough=300)
    ref = ref_make_solver(_ref(A), RefParams(
        dtype=jnp.float64, coarsening=_ref_coarsening(kind), **kw),
        RefBiCGStab(maxiter=100, tol=1e-8))
    port = T.make_solver(A, T.AMGParams(
        dtype=torch.float64, coarsening=_port_coarsening(kind), **kw),
        T.BiCGStab(maxiter=100, tol=1e-8), device="cpu", device_setup=True)
    hl, hl_r = port.precond.host_levels, ref.precond.host_levels
    assert len(hl) == len(hl_r) >= 3
    for (Ai, P, _), (Ai_r, P_r, _) in zip(hl, hl_r):
        assert np.array_equal(Ai.ptr, Ai_r.ptr)
        assert np.array_equal(Ai.col, Ai_r.col)
        _close(Ai.val, Ai_r.val)
        if P is not None and kind == "aggregation":
            assert np.array_equal(P.col, P_r.col)
    x, info = port(rhs)
    x_r, info_r = ref(rhs)
    assert info.iters == info_r.iters
    _close(x.numpy(), np.asarray(x_r), 1e-8)


def test_device_setup_block_hierarchy_matches_jax(ref_device_setup):
    A, rhs = T.poisson3d_block(8, 3)
    A_r, _ = ref_p3b(8, 3)
    ref = ref_make_solver(A_r, RefParams(dtype=jnp.float64,
                                         coarse_enough=200),
                          RefBiCGStab(maxiter=100, tol=1e-8))
    port = T.make_solver(A, T.AMGParams(dtype=torch.float64,
                                        coarse_enough=200),
                         T.BiCGStab(maxiter=100, tol=1e-8), device="cpu",
                         device_setup=True)
    assert [h[0].shape for h in port.precond.host_levels] \
        == [h[0].shape for h in ref.precond.host_levels]
    assert len(port.precond.host_levels) >= 2
    assert port(rhs)[1].iters == ref(rhs)[1].iters


def test_device_mis_declines_a_several_vector_nullspace(ref_device_setup):
    """The device MIS leaves one-node aggregates, which the QR of a
    three-vector rigid-body nullspace refuses: under it the JAX package
    stops at one level. The port declines the device MIS for such a
    configuration (``mis_declined``) and builds its host loop with the
    host setup: the same levels as ``device_setup=False``."""
    from amgcl_tpu.coarsening.smoothed_aggregation import \
        SmoothedAggregation as RSA
    A, _, coords = T.q1_elasticity2d(24)
    B = T.rigid_body_modes(coords)
    ref = RefAMG(_ref(A), RefParams(coarse_enough=500,
                                    coarsening=RSA(nullspace=B)))
    assert len(ref.host_levels) == 1
    got = {}
    for device_setup in (True, False):
        got[device_setup] = T.AMG(A, T.AMGParams(
            coarse_enough=500, coarsening=T.SmoothedAggregation(
                nullspace=B)), device="cpu", device_setup=device_setup)
    assert "3 vectors" in got[True].mis_declined
    assert got[False].mis_declined is None
    assert len(got[True].host_levels) >= 2
    for (Ai, _, _), (Bi, _, _) in zip(got[True].host_levels,
                                      got[False].host_levels):
        assert np.array_equal(Ai.ptr, Bi.ptr)
        assert np.array_equal(Ai.col, Bi.col)
        assert np.array_equal(Ai.val, Bi.val)
    # AsScalar over such a base declines too; one vector does not
    wrapped = T.AMGParams(coarsening=T.AsScalar(
        T.SmoothedAggregation(nullspace=B)))
    one = T.AMGParams(coarsening=T.SmoothedAggregation(nullspace=B[:, :1]))
    assert device_mis_declined(wrapped) is not None
    assert device_mis_declined(one) is None


def test_device_mis_declines_the_dense_window():
    """``matrix_format="dwin"`` builds its host loop with the host setup
    under ``device_setup=True``: the levels and the device operators of
    ``device_setup=False``; the default format keeps the device MIS."""
    A = _system("fe")
    prm = T.AMGParams(dtype=torch.float32, coarse_enough=300,
                      matrix_format="dwin")
    dev = T.AMG(A, prm, device="cpu", device_setup=True)
    host = T.AMG(A, prm, device="cpu", device_setup=False)
    assert "dwin" in dev.mis_declined
    _same_hierarchy(dev, host)
    plain = T.AMG(A, T.AMGParams(dtype=torch.float32, coarse_enough=300),
                  device="cpu", device_setup=True)
    assert plain.mis_declined is None


# -- the numeric rebuild ------------------------------------------------

def _device_tensors(M):
    return [v for v in vars(M).values() if torch.is_tensor(v)]


def _same_hierarchy(a, b):
    """Host levels and device level operators equal bit for bit."""
    assert len(a.host_levels) == len(b.host_levels)
    for (Ai, _, _), (Bi, _, _) in zip(a.host_levels, b.host_levels):
        assert np.array_equal(Ai.ptr, Bi.ptr)
        assert np.array_equal(Ai.col, Bi.col)
        assert np.array_equal(Ai.val, Bi.val)
    for lv, lw in zip(a.hierarchy.levels, b.hierarchy.levels):
        assert type(lv.A) is type(lw.A)
        for t, u in zip(_device_tensors(lv.A), _device_tensors(lw.A)):
            assert torch.equal(t, u)
        if lv.relax is not None:
            for t, u in zip(_device_tensors(lv.relax),
                            _device_tensors(lw.relax)):
                assert torch.equal(t, u)
    assert torch.equal(a.hierarchy.coarse.inv, b.hierarchy.coarse.inv)


@pytest.mark.parametrize("device_setup", [False, True])
def test_rebuild_equals_a_fresh_build(device_setup):
    """Three rebuilds with exactly scaled values (the transfers, frozen
    by the rebuild contract, come out the same in a fresh build) through
    the cached plans: each equal to a fresh build bit for bit, through a
    CSR and through a value array."""
    A = _system("fe")
    prm = T.AMGParams(dtype=torch.float32, coarse_enough=300)
    amg = T.AMG(A, prm, device="cpu", device_setup=device_setup)
    plans = [getattr(P, "_seg_plan", None)
             for _, P, _ in amg.host_levels[:-1]]
    assert all(p is not None for p in plans) == device_setup
    for step, s in enumerate((2.0, 0.5, 4.0)):
        As = T.CSR(A.ptr, A.col, A.val * s, A.ncols)
        amg.rebuild(As if step % 2 == 0 else As.val)
        fresh = T.AMG(As, prm, device="cpu", device_setup=device_setup)
        _same_hierarchy(amg, fresh)
    if device_setup:
        # the plans were kept, not built again
        assert [P._seg_plan for _, P, _ in amg.host_levels[:-1]] == plans


# -- the device coarse inverse ------------------------------------------

def test_device_inverse_gate():
    assert direct.device_inv_accepted(5e-4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not direct.device_inv_accepted(5e-2)
        assert not direct.device_inv_accepted(float("nan"))
    with pytest.warns(RuntimeWarning, match="rejected near the gate"):
        assert not direct.device_inv_accepted(5e-3)


def _coarse_matrices():
    rng = np.random.RandomState(5)
    n = 60
    L = np.diag(2.0 * np.ones(n)) - np.diag(np.ones(n - 1), 1) \
        - np.diag(np.ones(n - 1), -1)
    Q, _ = np.linalg.qr(rng.rand(n, n))
    ill = Q @ np.diag(np.logspace(0, 9, n)) @ Q.T
    singular = L.copy()
    singular[0, 0] = singular[-1, -1] = 1.0     # Neumann: constants
    return {"spd": L + 0.1 * np.eye(n), "ill": ill, "singular": singular}


@pytest.mark.parametrize("name", ["spd", "ill", "singular"])
def test_device_inverse_decision_matches_jax(name):
    dense = _coarse_matrices()[name]
    X, rnorm = direct.device_inverse(torch.as_tensor(dense,
                                                     dtype=torch.float32))
    _, rnorm_r = r_direct._device_inv(jnp.asarray(dense, jnp.float32))
    rnorm_r = float(rnorm_r)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        kept = direct.device_inv_accepted(rnorm)
        kept_r = np.isfinite(rnorm_r) and rnorm_r < 1e-3
        assert kept == kept_r
        A = T.CSR.from_scipy(sp.csr_matrix(dense))
        s = direct.DenseDirectSolver.build(A, torch.float32, CPU,
                                           device_inv=True)
    if kept:
        assert torch.equal(s.inv, X)
    else:
        assert name != "spd"
        assert not torch.equal(s.inv, X)
