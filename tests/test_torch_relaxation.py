"""The port's smoothers (``amgcl_tpu_torch/relaxation/``) against the JAX
package's (``amgcl_tpu/relaxation/``) on the CPU in float64: each built
state on the same host CSR, each application on the same vectors, the
iteration counts of whole solves, ``Hierarchy.bytes``, hierarchies
rebuilt from the JAX package's arrays (``convert.py``), the damped
Jacobi device build and sharded build, and the refusals.

Tolerances: built values within 1e-12 of the largest reference entry
(Jacobi, SPAI-1, Chebyshev's θ and δ, the colour masks), the ILU factors
within 1e-10 (the JAX package may form (L + I)U natively, the port with
scipy), applications within 1e-12; float64 iteration counts exactly. The
device builds run in float32 and sum in other orders: within 2e-5 of
the largest entry, as ``tests/test_torch_stencil_device.py`` holds them.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from amgcl_tpu.coarsening.aggregation import Aggregation as RefAggregation
from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.native import native_iluk_pattern
from amgcl_tpu.ops import device as ref_dev
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.relaxation import as_block as r_ab
from amgcl_tpu.relaxation import chebyshev as r_ch
from amgcl_tpu.relaxation import gauss_seidel as r_gs
from amgcl_tpu.relaxation import ilu0 as r_ilu
from amgcl_tpu.relaxation import jacobi as r_j
from amgcl_tpu.relaxation import spai0 as r_s0
from amgcl_tpu.relaxation import spai1 as r_s1
from amgcl_tpu.solver.bicgstab import BiCGStab as RefBiCGStab
from amgcl_tpu.solver.cg import CG as RefCG

import amgcl_tpu_torch as T
from amgcl_tpu_torch.convert import hierarchy_from_arrays
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.relaxation.gauss_seidel import greedy_coloring
from amgcl_tpu_torch.relaxation.ilu0 import iluk_pattern


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


#: smoother name -> (the JAX package's policy, the port's)
SMOOTHERS = {
    "jacobi": (r_j.DampedJacobi(), T.DampedJacobi()),
    "chebyshev": (r_ch.Chebyshev(), T.Chebyshev()),
    "chebyshev_p5": (r_ch.Chebyshev(power_iters=5),
                     T.Chebyshev(power_iters=5)),
    "chebyshev_scaled": (r_ch.Chebyshev(scale=True),
                         T.Chebyshev(scale=True)),
    "spai1": (r_s1.Spai1(), T.Spai1()),
    "gauss_seidel": (r_gs.GaussSeidel(), T.GaussSeidel()),
    "ilu0": (r_ilu.ILU0(), T.ILU0()),
    "ilut": (r_ilu.ILUT(), T.ILUT()),
    "iluk": (r_ilu.ILUK(k=1), T.ILUK(k=1)),
    "ilup": (r_ilu.ILUP(), T.ILUP()),
}


def _ref(A):
    return RefCSR(A.ptr, A.col, A.val, A.ncols)


@pytest.fixture(scope="module")
def fe():
    """A small system of the unstructured paths' kind (1,500 rows)."""
    A, rhs = T.fe_like_problem(1500, nnz_target=28 * 1500, seed=3)
    return A, _ref(A), rhs


_BUILT = {}


def _built(fe, name, what):
    """Each package's smoother state (``what`` "state") or host factors
    ("host") on the fe system, built once per module."""
    key = (name, what)
    if key not in _BUILT:
        A, A_r, _ = fe
        ref_pol, pol = SMOOTHERS[name]
        if what == "state":
            _BUILT[key] = (ref_pol.build(A_r, jnp.float64),
                           pol.build(A, torch.float64, "cpu"))
        else:
            _BUILT[key] = (ref_pol.build_host(A_r), pol.build_host(A))
    return _BUILT[key]


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


def _dense(M):
    return M.to_scipy().toarray()


# -- built states -------------------------------------------------------------

@pytest.mark.parametrize("name", ["jacobi", "spai1", "chebyshev",
                                  "chebyshev_p5", "chebyshev_scaled",
                                  "gauss_seidel"])
def test_built_state_matches_jax(fe, name):
    A, A_r, _ = fe
    ref_pol, pol = SMOOTHERS[name]
    ref, got = _built(fe, name, "state")
    if name == "jacobi":
        _close(got.scale, ref.scale, 1e-12)
    elif name == "spai1":
        _close(_dense(pol.build_host(A)), _dense(ref_pol.build_host(A_r)),
               1e-12)
    elif name.startswith("chebyshev"):
        assert got.degree == ref.degree and got.scale == ref.scale
        _close([got.theta, got.delta], [ref.theta, ref.delta], 1e-12)
        if got.scale:
            _close(got.dinv, ref.dinv, 1e-12)
    else:
        ref_color = r_gs.greedy_coloring(A_r.to_scipy())
        assert np.array_equal(greedy_coloring(A.to_scipy()), ref_color)
        _close(got.masks, ref.masks, 1e-12)


@pytest.mark.parametrize("name", ["ilu0", "ilut", "iluk", "ilup"])
def test_ilu_factors_match_jax(fe, name):
    (Lr, Ur, udia_r), (L, U, udia) = _built(fe, name, "host")
    for got, want in ((L, Lr), (U, Ur)):
        assert np.array_equal(got.ptr, want.ptr)
        assert np.array_equal(got.col, want.col)
        _close(got.val, want.val, 1e-10)
    _close(1.0 / udia, 1.0 / udia_r, 1e-10)


@pytest.mark.parametrize("name", ["spai1", "ilu0", "ilut", "iluk", "ilup"])
def test_torch_setup_route_matches_host_route(fe, name):
    """The route a hierarchy on a CUDA device takes for its set-up's
    products and gathers (torch's sparse product and searchsorted, the
    batched solve in torch), run here on the CPU, against the host
    route: the same patterns, values within 1e-12."""
    A, _, _ = fe
    host = _built(fe, name, "host")[1]
    dev_ = SMOOTHERS[name][1].build_host(A, torch.device("cpu"))
    if name == "spai1":
        host, dev_ = [host], [dev_]
    else:
        _close(dev_[2], host[2], 1e-12)
    for got, want in zip(dev_[:2], host[:2]):
        assert np.array_equal(got.ptr, want.ptr)
        assert np.array_equal(got.col, want.col)
        _close(got.val, want.val, 1e-12)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_iluk_pattern_matches_native(fe, k):
    """The port's own level-of-fill pass gives the JAX package's native
    ILU(k) pattern; ILUK never falls back to ILUP's widened pattern."""
    A, A_r, _ = fe
    optr, ocol = native_iluk_pattern(A_r, k)
    ptr, col = iluk_pattern(A.ptr, A.col, A.nrows, k)
    assert np.array_equal(ptr, optr) and np.array_equal(col, ocol)
    if k == 1:
        m = A.to_scipy()
        widened = ((abs(m) + sp.identity(A.nrows)) ** 2).nnz
        assert len(col) < widened


# -- applications -------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SMOOTHERS))
def test_applications_match_jax(fe, name):
    """apply, apply_pre and apply_post on the same vectors, each state
    on its own package's device form of A."""
    A, A_r, _ = fe
    ref, got = _built(fe, name, "state")
    A_dev = dev.to_device(A, "auto", torch.float64, "cpu")
    A_ref = ref_dev.to_device(A_r, "auto", jnp.float64)
    rng = np.random.RandomState(5)
    f, x = rng.standard_normal((2, A.nrows))
    ft, xt = torch.as_tensor(f), torch.as_tensor(x)
    fj, xj = jnp.asarray(f), jnp.asarray(x)
    _close(got.apply(A_dev, ft), ref.apply(A_ref, fj), 1e-12)
    _close(got.apply_pre(A_dev, ft, xt), ref.apply_pre(A_ref, fj, xj), 1e-12)
    _close(got.apply_post(A_dev, ft, xt), ref.apply_post(A_ref, fj, xj),
           1e-12)


# -- whole solves ---------------------------------------------------------------

def _counts(A, rhs, ref_relax, relax, solver, **prm):
    ref_solver, port_solver = {"cg": (RefCG, T.CG),
                               "bicgstab": (RefBiCGStab, T.BiCGStab)}[solver]
    _, info_r = ref_make_solver(
        _ref(A), RefParams(dtype=jnp.float64, relax=ref_relax, **prm),
        ref_solver(tol=1e-8, maxiter=200))(rhs)
    solve = T.make_solver(A, T.AMGParams(dtype=torch.float64, relax=relax,
                                         **prm),
                          port_solver(tol=1e-8, maxiter=200), device="cpu")
    _, info = solve(rhs)
    return info.iters, info_r.iters


#: (system, smoother): the JAX package's count; ILU(k) and ILU(p) on the
#: unstructured system are left out of the count check: there
#: BiCGStab amplifies the two packages' 1e-15 differences in the
#: cycle (held to 1e-12 above) into 25 against 30 iterations
_SOLVES = [("poisson", n) for n in sorted(SMOOTHERS)
           if n != "chebyshev_p5"] \
    + [("fe", n) for n in ("jacobi", "chebyshev", "spai1", "gauss_seidel",
                           "ilu0", "ilut")]


@pytest.mark.parametrize("system,name", _SOLVES)
def test_solve_counts_match_jax(fe, system, name):
    ref_relax, relax = SMOOTHERS[name]
    if system == "poisson":
        A, rhs = T.poisson3d(12)
        got, want = _counts(A, rhs, ref_relax, relax, "cg",
                            coarse_enough=300)
    else:
        A, _, rhs = fe
        got, want = _counts(A, rhs, ref_relax, relax, "bicgstab",
                            coarse_enough=300)
    assert got == want < 60


@pytest.mark.parametrize("name", ["jacobi", "chebyshev", "as_block_spai1"])
def test_block_solve_counts_match_jax(name):
    """poisson3d_block(8, 3): damped Jacobi's inverted 3×3 blocks through
    the block correction, Chebyshev and as_block(SPAI-1) on the
    unblocked view."""
    A, rhs = T.poisson3d_block(8, 3)
    ref_relax, relax = {
        "jacobi": SMOOTHERS["jacobi"], "chebyshev": SMOOTHERS["chebyshev"],
        "as_block_spai1": (r_ab.AsBlock(r_s1.Spai1()),
                           T.AsBlock(T.Spai1()))}[name]
    got, want = _counts(A, rhs, ref_relax, relax, "bicgstab",
                        coarse_enough=300)
    assert got == want < 20


# -- Hierarchy.bytes --------------------------------------------------------------

@pytest.mark.parametrize("name", ["spai0"] + sorted(SMOOTHERS))
def test_hierarchy_bytes_counts_every_smoother(name):
    relax = T.Spai0() if name == "spai0" else SMOOTHERS[name][1]
    A, _ = T.poisson3d(12)
    amg = T.AMG(A, T.AMGParams(dtype=torch.float64, relax=relax,
                               coarse_enough=300), device="cpu")
    hier = amg.hierarchy
    parts = sum(p.bytes() for lv in hier.levels
                for p in (lv.A, lv.P, lv.R) if p is not None)
    inv = hier.coarse.inv.numel() * 8
    states = [lv.relax for lv in hier.levels if lv.relax is not None]
    assert hier.bytes() == parts + inv + sum(s.bytes() for s in states)
    if name == "spai0":
        # the figure before smoother states had bytes(): the scale alone
        assert sum(s.bytes() for s in states) \
            == sum(s.scale.numel() * 8 for s in states)
    # Chebyshev without scaling keeps no arrays on the device
    assert all(s.bytes() > 0 for s in states
               if not name.startswith("chebyshev"))


# -- hierarchies rebuilt from the JAX package's arrays ---------------------------

def _op(M):
    """A JAX device matrix as the plain arrays of ``convert``."""
    if hasattr(M, "offsets"):
        return (M.offsets, np.asarray(M.data))
    if hasattr(M, "window_starts"):
        return {"window_starts": np.asarray(M.window_starts),
                "cols_local": np.asarray(M.cols_local),
                "vals": np.asarray(M.vals), "shape": M.shape, "win": M.win}
    return np.asarray(M.a)


def _relax_arrays(st):
    if hasattr(st, "theta"):
        return {"chebyshev": (None if st.dinv is None
                              else np.asarray(st.dinv), st.degree, st.theta,
                              st.delta, st.scale)}
    if hasattr(st, "masks"):
        return {"masks": np.asarray(st.masks)}
    return {"L": _op(st.Ls), "U": _op(st.Us), "uinv": np.asarray(st.uinv),
            "iters": st.jacobi_iters}


@pytest.mark.parametrize("name", ["chebyshev", "gauss_seidel", "ilu0"])
def test_cycle_on_jax_arrays_matches_jax(name):
    """convert.hierarchy_from_arrays takes each smoother's arrays and
    plain aggregation's grid transfers: the port's V-cycle on the JAX
    package's hierarchy equals the JAX package's."""
    ref_relax, _ = SMOOTHERS[name]
    A, _ = T.poisson3d(12)
    ref = RefAMG(_ref(A), RefParams(
        dtype=jnp.float64, relax=ref_relax, coarse_enough=300,
        coarsening=RefAggregation()))
    levels = []
    for lv in ref.hierarchy.levels:
        row = {"A": _op(lv.A)}
        if lv.P is not None:
            assert type(lv.P).__name__ == "TentativeP"
            row.update(fine=lv.P.T.fine, block=lv.P.T.block,
                       relax=_relax_arrays(lv.relax))
        levels.append(row)
    hier = hierarchy_from_arrays(levels, np.asarray(ref.hierarchy.coarse.inv),
                                 T.AMGParams(dtype=torch.float64), "cpu")
    r = np.random.RandomState(2).standard_normal(A.nrows)
    _close(hier.apply(torch.as_tensor(r)),
           ref.hierarchy.apply(jnp.asarray(r)), 1e-12)


# -- the damped Jacobi device builds -------------------------------------------------

def test_jacobi_device_build_matches_jax(monkeypatch):
    monkeypatch.setenv("AMGCL_TPU_DEVICE_SETUP", "1")
    A, _ = T.poisson3d(24)
    ref = RefAMG(_ref(A), RefParams(dtype=jnp.float32, coarse_enough=500,
                                    relax=r_j.DampedJacobi()))
    port = T.AMG(A, T.AMGParams(dtype=torch.float32, coarse_enough=500,
                                relax=T.DampedJacobi()),
                 device="cpu", device_setup=True)
    assert ref._device_built and port.device_built
    assert len(port.hierarchy.levels) == len(ref.hierarchy.levels) >= 3
    for lv, rl in zip(port.hierarchy.levels[:-1], ref.hierarchy.levels[:-1]):
        _close(lv.relax.scale, rl.relax.scale, 2e-5)
        # the fused legs take the Jacobi scale as their w
        assert lv.down.w is lv.relax.scale and lv.up.w is lv.relax.scale
    # the Jacobi scale is damping / a_ii of the level operator
    a0 = A.diagonal()
    _close(port.hierarchy.levels[0].relax.scale, 0.72 / a0, 1e-6)


def test_jacobi_smoothed_coarsest_level_matches_jax(monkeypatch):
    monkeypatch.setenv("AMGCL_TPU_DEVICE_SETUP", "1")
    A, _ = T.poisson3d(16)
    kw = dict(coarse_enough=600, direct_coarse=False)
    ref = RefAMG(_ref(A), RefParams(dtype=jnp.float32,
                                    relax=r_j.DampedJacobi(), **kw))
    port = T.AMG(A, T.AMGParams(dtype=torch.float32, relax=T.DampedJacobi(),
                                **kw), device="cpu", device_setup=True)
    assert ref._device_built and port.device_built
    _close(port.hierarchy.levels[-1].relax.scale,
           ref.hierarchy.levels[-1].relax.scale, 2e-5)


_DECLINED = {
    "nullspace": dict(nullspace=np.ones((12 ** 3, 1))),
    "aggregator": dict(aggregator=lambda A, eps: None),
    "block_size": dict(block_size=2),
    "power_iters": dict(power_iters=3),
    "structured": dict(structured=False),
    "implicit_transfers": dict(implicit_transfers=False),
    "stencil_setup": dict(stencil_setup=False),
}


@pytest.mark.parametrize("field", sorted(_DECLINED))
def test_device_builds_decline_sa_fields(field):
    """Each SA field the JAX device build declines
    (amgcl_tpu/ops/stencil_device.py:412-415) sends the port's device
    build and its sharded build to their refusals too."""
    from amgcl_tpu.coarsening.smoothed_aggregation import \
        SmoothedAggregation as RefSA
    from amgcl_tpu.ops import stencil_device as ref_sdev
    from amgcl_tpu_torch.ops import stencil_device as sdev
    A, _ = T.poisson3d(12)
    kw = _DECLINED[field]
    assert ref_sdev.device_build(_ref(A), RefParams(
        dtype=jnp.float32, coarsening=RefSA(**kw))) is None
    prm = T.AMGParams(coarsening=T.SmoothedAggregation(**kw),
                      relax=T.DampedJacobi())
    assert sdev.device_build(A, prm, torch.device("cpu")) is None
    A16, _ = T.poisson3d(16)
    assert T.dist_stencil_build(A16, T.make_mesh(2, device="cpu"),
                                prm) is None


def test_device_build_declines_other_smoothers_and_float64():
    from amgcl_tpu_torch.ops import stencil_device as sdev
    A, _ = T.poisson3d(12)
    for relax in (T.Chebyshev(), T.GaussSeidel(), T.Spai1()):
        assert sdev.device_build(A, T.AMGParams(relax=relax),
                                 torch.device("cpu")) is None
    assert sdev.device_build(A, T.AMGParams(dtype=torch.float64,
                                            relax=T.DampedJacobi()),
                             torch.device("cpu")) is None
    amg = T.AMG(A, T.AMGParams(relax=T.Chebyshev(), coarse_enough=300),
                device="cpu", device_setup=True)
    assert not amg.device_built and amg.setup_split["device_build_s"] == 0


def test_sharded_jacobi_build_and_solve_match_jax():
    """The sharded build with damped Jacobi against the JAX package's on
    the conftest's virtual devices (4 shards): every smoother slab, and
    the solve's iterations and x."""
    from amgcl_tpu.parallel.dist_stencil import (
        DistStencilSolver as RefSolver, dist_stencil_build as ref_build)
    from amgcl_tpu.parallel.mesh import make_mesh as ref_mesh
    A, rhs = T.poisson3d(32)
    ref_prm = RefParams(dtype=jnp.float32, relax=r_j.DampedJacobi())
    prm = T.AMGParams(relax=T.DampedJacobi())
    ref_hier, ref_meta = ref_build(_ref(A), ref_mesh(4), ref_prm)
    hier, meta = T.dist_stencil_build(A, T.make_mesh(4, device="cpu"), prm)
    assert meta == ref_meta and len(hier.levels) == len(ref_hier.levels)
    for lv, rl in zip(hier.levels, ref_hier.levels):
        nl = int(np.prod(lv.ldims))
        want = np.asarray(rl.scale)
        for j, slab in enumerate(lv.scale):
            _close(slab, want[..., j * nl:(j + 1) * nl], 1e-5)
        assert lv.fused is not None and lv.fused.down_ok and lv.fused.up_ok
    x_ref, info_ref = RefSolver(_ref(A), ref_mesh(4), ref_prm,
                                RefCG(maxiter=100, tol=1e-6))(rhs)
    x, info = T.DistStencilSolver(A, T.make_mesh(4, device="cpu"), prm,
                                  T.CG(maxiter=100, tol=1e-6))(rhs)
    assert info.iters == info_ref.iters
    x_ref = np.asarray(x_ref, np.float64)
    assert np.linalg.norm(x.double().numpy() - x_ref) \
        <= 1e-4 * np.linalg.norm(x_ref)


def test_sharded_path_refuses_other_smoothers():
    """A smoother other than SPAI-0 and damped Jacobi lies outside the
    sharded stencil path: the build declines and DistStencilSolver
    raises ValueError, as the JAX package's do for the same smoothers."""
    from amgcl_tpu.parallel.dist_stencil import \
        dist_stencil_build as ref_build
    from amgcl_tpu.parallel.mesh import make_mesh as ref_mesh
    A, _ = T.poisson3d(16)
    A_r = RefCSR(A.ptr, A.col, A.val, A.ncols)
    mesh = T.make_mesh(2, device="cpu")
    for relax, relax_r in ((T.Chebyshev(), r_ch.Chebyshev()),
                           (T.GaussSeidel(), r_gs.GaussSeidel()),
                           (T.Spai1(), r_s1.Spai1()),
                           (T.ILU0(), r_ilu.ILU0())):
        assert T.dist_stencil_build(A, mesh,
                                    T.AMGParams(relax=relax)) is None
        assert ref_build(A_r, ref_mesh(2),
                         RefParams(relax=relax_r)) is None
        with pytest.raises(ValueError, match="sharded stencil path"):
            T.DistStencilSolver(A, mesh, T.AMGParams(relax=relax))
