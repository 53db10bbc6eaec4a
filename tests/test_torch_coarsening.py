"""The port's coarsenings (``amgcl_tpu_torch/coarsening/``) against the
JAX package's (``amgcl_tpu/coarsening/``) on the CPU in float64: each
policy's P, R and coarse operator on the same level, the tentative QR
with a near-nullspace, the C/F splits and MIS machinery, the spectral
radius, whole hierarchies and solves, and the refusals.

Tolerances: P, R and the coarse operators within 1e-12 of their largest
reference entry, with identical patterns and shapes; splits, aggregates
and colourings identical; float64 iteration counts exactly.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amgcl_tpu.coarsening import aggregates as r_agg
from amgcl_tpu.coarsening import ruge_stuben as r_rs
from amgcl_tpu.coarsening import tentative as r_tent
from amgcl_tpu.coarsening.aggregation import Aggregation as RefAggregation
from amgcl_tpu.coarsening.as_scalar import AsScalar as RefAsScalar
from amgcl_tpu.coarsening.rigid_body_modes import \
    rigid_body_modes as ref_rigid_body_modes
from amgcl_tpu.coarsening.smoothed_aggr_emin import \
    SmoothedAggrEMin as RefEMin
from amgcl_tpu.coarsening.smoothed_aggregation import \
    SmoothedAggregation as RefSA
from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.ops.csr import spectral_radius as ref_spectral_radius
from amgcl_tpu.solver.bicgstab import BiCGStab as RefBiCGStab
from amgcl_tpu.solver.cg import CG as RefCG

import amgcl_tpu_torch as T
from amgcl_tpu_torch.coarsening import aggregates as agg
from amgcl_tpu_torch.coarsening import ruge_stuben as rs
from amgcl_tpu_torch.coarsening.tentative import tentative_prolongation
from amgcl_tpu_torch.ops.csr import spectral_radius
from amgcl_tpu_torch.ops.structured import TentativeP, TentativeR


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


def _same_csr(got, want, rtol=1e-12):
    """Same block size, pattern and values within ``rtol``."""
    assert got.shape == want.shape
    assert tuple(got.block_size) == tuple(want.block_size)
    assert np.array_equal(got.ptr, want.ptr)
    assert np.array_equal(got.col, want.col)
    _close(got.val, want.val, rtol)


_SYSTEMS = {}


def _system(name):
    """(port CSR, rhs, coordinates or None), made once per module."""
    if name not in _SYSTEMS:
        if name == "poisson":
            A, rhs = T.poisson3d(12)
            _SYSTEMS[name] = (A, rhs, None)
        elif name == "fe":
            A, rhs = T.fe_like_problem(1500, nnz_target=28 * 1500, seed=3)
            _SYSTEMS[name] = (A, rhs, None)
        elif name == "block":
            A, rhs = T.poisson3d_block(8, 3)
            _SYSTEMS[name] = (A, rhs, None)
        else:
            A, rhs, coords = T.q1_elasticity2d(16)
            if name == "elastic_block":
                A = A.to_block(2)
            _SYSTEMS[name] = (A, rhs, coords)
    return _SYSTEMS[name]


def _policies(name, coords=None):
    """coarsening name -> (the JAX package's policy, the port's)."""
    if name == "sa_nullspace":
        return (RefSA(nullspace=ref_rigid_body_modes(coords)),
                T.SmoothedAggregation(nullspace=T.rigid_body_modes(coords)))
    if name == "aggregation_nullspace":
        return (RefAggregation(nullspace=ref_rigid_body_modes(coords)),
                T.Aggregation(nullspace=T.rigid_body_modes(coords)))
    if name == "emin_nullspace":
        return (RefEMin(nullspace=ref_rigid_body_modes(coords)),
                T.SmoothedAggrEMin(nullspace=T.rigid_body_modes(coords)))
    return {
        "sa": (RefSA(), T.SmoothedAggregation()),
        "sa_power": (RefSA(power_iters=5),
                     T.SmoothedAggregation(power_iters=5)),
        "sa_unstructured": (RefSA(structured=False),
                            T.SmoothedAggregation(structured=False)),
        "sa_stored": (RefSA(implicit_transfers=False),
                      T.SmoothedAggregation(implicit_transfers=False)),
        "sa_block_size": (RefSA(block_size=2),
                          T.SmoothedAggregation(block_size=2)),
        "aggregation": (RefAggregation(), T.Aggregation()),
        "rs": (r_rs.RugeStuben(), T.RugeStuben()),
        "rs_pmis": (r_rs.RugeStuben(splitting="pmis"),
                    T.RugeStuben(splitting="pmis")),
        "emin": (RefEMin(), T.SmoothedAggrEMin()),
        "as_scalar": (RefAsScalar(RefSA()), T.AsScalar(T.SmoothedAggregation())),
    }[name]


# -- one level ---------------------------------------------------------------

_LEVELS = [
    ("fe", "aggregation"), ("fe", "rs"), ("fe", "rs_pmis"), ("fe", "emin"),
    ("fe", "sa_power"), ("poisson", "sa_stored"),
    ("poisson", "sa_unstructured"), ("poisson", "rs"),
    ("elastic", "sa_block_size"), ("elastic", "sa_nullspace"),
    ("elastic", "aggregation_nullspace"), ("elastic", "emin_nullspace"),
    ("block", "aggregation"), ("block", "emin"),
    ("elastic_block", "as_scalar"),
]


@pytest.mark.parametrize("system,name", _LEVELS)
def test_level_transfers_match_jax(system, name):
    """P, R and the coarse operator of the first level, built from the
    same CSR with a fresh build context."""
    A, _, coords = _system(system)
    ref_pol, pol = _policies(name, coords)
    A_r = _ref(A)
    ctx_r, ctx = {}, {}
    Pr, Rr = ref_pol.transfer_operators(A_r, ctx_r)
    P, R = pol.transfer_operators(A, ctx)
    _same_csr(P, Pr)
    _same_csr(R, Rr)
    assert (getattr(P, "_implicit_spec", None) is None) \
        == (getattr(Pr, "_implicit_spec", None) is None)
    _same_csr(pol.coarse_operator(A, P, R, ctx),
              ref_pol.coarse_operator(A_r, Pr, Rr, ctx_r))
    if ctx_r.get("nullspace") is not None:
        _close(ctx["nullspace"], ctx_r["nullspace"], 1e-12)


@pytest.mark.parametrize("n", [12, 15])
def test_plain_aggregation_on_the_grid_matches_jax(n):
    """On a stencil, plain aggregation's P is T itself, matrix-free, and
    its scaled coarse operator is the parity collapse of A (even and odd
    grids, the odd one padded)."""
    A, _ = T.poisson3d(n)
    A_r = _ref(A)
    Pr, Rr = RefAggregation().transfer_operators(A_r, {})
    P, R = T.Aggregation().transfer_operators(A, {})
    spec, spec_r = P._implicit_spec, Pr._implicit_spec
    assert spec["M"] is None and spec_r["M"] is None
    assert (spec["block"], spec["coarse"]) == (spec_r["block"],
                                               spec_r["coarse"])
    _same_csr(T.Aggregation().coarse_operator(A, P, R, {}),
              RefAggregation().coarse_operator(A_r, Pr, Rr, {}))
    amg = T.AMG(A, T.AMGParams(dtype=torch.float64,
                               coarsening=T.Aggregation(),
                               coarse_enough=100), device="cpu")
    lv = amg.hierarchy.levels[0]
    assert isinstance(lv.P, TentativeP) and isinstance(lv.R, TentativeR)
    assert lv.down is None and lv.up is None   # the legs compose


def test_tentative_qr_matches_jax():
    """The QR per aggregate with its sign fix: P and the coarse
    nullspace; an aggregate smaller than the nullspace stalls."""
    A, _, coords = _system("elastic")
    Ap = T.CSR.from_scipy(A.to_scipy())
    a, n_agg = agg.pointwise_aggregates(Ap, 0.08, 2)
    a_r, n_agg_r = r_agg.pointwise_aggregates(_ref(A), 0.08, 2)
    assert n_agg == n_agg_r and np.array_equal(a, a_r)
    B = T.rigid_body_modes(coords)
    _close(B, ref_rigid_body_modes(coords), 1e-12)
    P, Bc = tentative_prolongation(A.nrows // 2, a, n_agg, B, 2)
    Pr, Bc_r = r_tent.tentative_prolongation(A.nrows // 2, a, n_agg, B, 2)
    _same_csr(P, Pr)
    _close(Bc, Bc_r, 1e-12)
    assert np.all(np.einsum("aii->ai", Bc.reshape(n_agg, 3, 3)) >= 0)
    tiny = np.arange(A.nrows // 2)               # one node an aggregate
    with pytest.raises(T.coarsening.stall.CoarseningStall):
        tentative_prolongation(A.nrows // 2, tiny, len(tiny), B, 2)


@pytest.mark.parametrize("splitting", ["classic", "pmis"])
@pytest.mark.parametrize("system", ["fe", "poisson"])
def test_cf_split_matches_jax(system, splitting):
    A, _, _ = _system(system)
    strong, rows = rs._strength_rs(A, 0.25)
    strong_r, _ = r_rs._strength_rs(_ref(A), 0.25)
    assert np.array_equal(strong, strong_r)
    fn = {"classic": "cf_splitting_classic", "pmis": "cf_splitting_pmis"}
    got = getattr(rs, fn[splitting])(A, strong, rows)
    want = getattr(r_rs, fn[splitting])(_ref(A), strong_r, rows)
    assert np.array_equal(got, want) and 0 < got.sum() < A.nrows


def test_mis_aggregates_match_jax():
    A, _, _ = _system("fe")
    S = agg.strength_graph(A, 0.08)
    assert (S != r_agg.strength_graph(_ref(A), 0.08)).nnz == 0
    got, n = agg.mis_aggregates(S)
    want, n_r = r_agg.mis_aggregates(S)
    assert n == n_r and np.array_equal(got, want)
    assert np.array_equal(agg._priority(50), r_agg._priority(50))


@pytest.mark.parametrize("power_iters", [0, 5])
@pytest.mark.parametrize("scale", [True, False])
def test_spectral_radius_matches_jax(power_iters, scale):
    A, _, _ = _system("block")
    got = spectral_radius(A, power_iters, scale)
    want = ref_spectral_radius(_ref(A), power_iters, scale)
    assert abs(got - want) <= 1e-12 * abs(want)


# -- hierarchies and solves -------------------------------------------------------

_SOLVES = [
    ("poisson", "aggregation"), ("poisson", "rs"), ("poisson", "rs_pmis"),
    ("poisson", "emin"), ("poisson", "sa_power"),
    ("poisson", "sa_unstructured"), ("poisson", "sa_stored"),
    ("fe", "aggregation"), ("fe", "rs"), ("fe", "rs_pmis"), ("fe", "emin"),
    ("fe", "sa_power"),
    ("block", "aggregation"), ("block", "emin"), ("block", "as_scalar"),
    ("elastic", "sa_nullspace"), ("elastic", "aggregation_nullspace"),
    ("elastic", "emin_nullspace"), ("elastic", "sa_block_size"),
    ("elastic_block", "as_scalar"),
]


@pytest.mark.parametrize("system,name", _SOLVES)
def test_solve_counts_match_jax(system, name):
    """make_solver with the coarsening, float64: identical level shapes
    and iteration counts."""
    A, rhs, coords = _system(system)
    ref_pol, pol = _policies(name, coords)
    cg = system in ("poisson", "elastic")
    ref_solver, solver = (RefCG, T.CG) if cg else (RefBiCGStab, T.BiCGStab)
    ce = 100 if system.startswith("elastic") else 300
    ref = RefAMG(_ref(A), RefParams(dtype=jnp.float64, coarsening=ref_pol,
                                    coarse_enough=ce))
    _, info_r = ref_make_solver(_ref(A), ref,
                                ref_solver(tol=1e-8, maxiter=200))(rhs)
    solve = T.make_solver(A, T.AMGParams(dtype=torch.float64,
                                         coarsening=pol, coarse_enough=ce),
                          solver(tol=1e-8, maxiter=200), device="cpu")
    _, info = solve(rhs)
    shapes = [(h[0].nrows, h[0].nnz) for h in solve.precond.host_levels]
    assert shapes == [(h[0].nrows, h[0].nnz) for h in ref.host_levels]
    assert len(shapes) >= 2
    assert info.iters == info_r.iters < 60


# -- refusals -------------------------------------------------------------------------

def test_ruge_stuben_refuses_block_values():
    A, _, _ = _system("block")
    with pytest.raises(NotImplementedError, match="scalar"):
        r_rs.RugeStuben().transfer_operators(_ref(A), {})
    with pytest.raises(NotImplementedError, match="scalar"):
        T.RugeStuben().transfer_operators(A, {})


@pytest.mark.parametrize("name", ["sa_nullspace", "aggregation_nullspace",
                                  "emin_nullspace"])
def test_nullspace_refuses_block_values(name):
    A, _, coords = _system("elastic_block")
    ref_pol, pol = _policies(name, coords)
    with pytest.raises(NotImplementedError, match="block value"):
        ref_pol.transfer_operators(_ref(A), {})
    with pytest.raises(NotImplementedError, match="block value"):
        pol.transfer_operators(A, {})


# -- chip_smoke.py's phase 10 on the CPU ---------------------------------------------

def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMALL = {
    "poisson": lambda: T.poisson3d(32) + (None,),
    "fe": lambda: T.fe_like_problem(1500, nnz_target=28 * 1500, seed=1)
    + (None,),
    "elastic": lambda: T.q1_elasticity2d(24),
    "block": lambda: T.poisson3d_block(8, 3) + (None,),
}


@pytest.mark.parametrize("label", ["J1", "C1", "A1", "P1", "GS1", "IL0",
                                   "ILT", "ILK", "ILP", "R1", "R1p", "E1",
                                   "A2", "N1", "N1b", "B1j"])
def test_chip_smoke_paths_reach_their_kernels(label):
    """Each phase-10 configuration of chip_smoke.py, at a small size on
    the CPU, puts on its levels what a8_reach requires (the device build
    with the Jacobi w on both fused legs for J1; the base down leg and a
    composed up leg for C1, whose Chebyshev state the up leg declines;
    colour masks the fused legs decline for GS1; plain grid transfers
    for A1; block windowed ELL for N1b and B1j) and converges within
    chip_smoke.py's bound: iterations summed over the 1 + refine solves
    below (1 + refine) times maxiter."""
    cs = _chip_smoke()
    system, _, _, refine = cs.A8_PATHS[label]
    A, rhs, coords = _SMALL["elastic" if system.startswith("elastic")
                            else system]()
    if system == "elastic_block":
        A = A.to_block(2)
    solver = cs.a8_solver(label)
    prm = dict(dtype=torch.float32, coarse_enough=500)
    prm.update(cs.a8_params(label, coords))
    solve = T.make_solver(A, T.AMGParams(**prm), solver, refine=refine,
                          device="cpu", device_setup=True)
    lines, faults = cs.a8_reach(label, solve)
    assert faults == [] and len(lines) >= 2
    x, info = solve(rhs)
    x64 = x.double().numpy()
    true = np.linalg.norm(rhs - A.to_scipy() @ x64) / np.linalg.norm(rhs)
    assert info.iters < (1 + refine) * solver.maxiter
    assert info.resid <= 1e-6 and true <= (1e-6 if refine else 1e-5)
