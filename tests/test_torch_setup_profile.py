"""The set-up by stage and the device route of the stencil Galerkin plan,
against the JAX package on the CPU: ``AMG.setup_profile``'s scope paths
(``utils/profiler.py``, ``telemetry/tracing.setup_scope`` and
``setup_substage``) against ``amgcl_tpu/models/amg.py``'s for the same
builds, ``StencilGalerkinPlan.apply``'s device route against the JAX
package's jitted one (under its ``AMGCL_TPU_DEVICE_SETUP=1``) and the
host route, and SC1's levels against the JAX package's.

Tolerances: scope paths equal once the port's ``native/<function>``
stages (which the JAX package does not record; ROADMAP §C) are left
out; the device route within 1e-12 of the JAX package's in float64 and
bit for bit with the host route.
"""

import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amgcl_tpu.models import schur as ref_schur
from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.ops import stencil as r_st
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.utils import profiler as r_prof

import amgcl_tpu_torch as T
from amgcl_tpu_torch.ops import stencil as st
from amgcl_tpu_torch.telemetry.tracing import setup_scope, setup_substage
from amgcl_tpu_torch.utils import profiler as prof_mod
from amgcl_tpu_torch.utils.profiler import Profiler

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


def _ref(A):
    return RefCSR(A.ptr, A.col, A.val, A.ncols)


def _paths(tree, pre=""):
    out = []
    for name, node in tree.items():
        out.append(pre + name)
        out += _paths(node.get("children", {}), pre + name + "/")
    return out


def _port_paths(prof):
    """The profile's scope paths without the native library's stages."""
    return [p for p in _paths(prof.to_dict()["scopes"])
            if "native/" not in p]


# -- the device route of the stencil Galerkin plan ------------------------------


def _plans(with_m, dtype=np.float64, m=8):
    """The port's and the JAX package's plans, and their operands, for
    poisson3d(m) under SA's filtered M (tests/test_device_setup.py:
    369-393), or plain aggregation's collapse without M."""
    A, _ = T.poisson3d(m)
    grid = (m, m, m)
    coarse = tuple(-(-d // 2) for d in grid)
    out = []
    for mod, Am in ((st, A), (r_st, _ref(A))):
        Ad = mod.host_dia_from_csr(Am, grid, dtype)
        M = None
        if with_m:
            Af, Dinv = mod.filtered_dia(Ad, 0.08)
            M = mod.scale_rows(Af, Dinv)
            M.data = M.data * 0.57
            M = M.drop_empty()
        plan = mod.StencilGalerkinPlan(
            Ad.offsets3, None if M is None else M.offsets3, Ad.dims,
            (2, 2, 2), coarse, dtype)
        out.append((plan, Ad.data, None if M is None else M.data))
    return out


@pytest.mark.parametrize("with_m", [True, False])
def test_device_galerkin_matches_jax_jitted_route(with_m, monkeypatch):
    """The device route on ``device="cpu"`` against the JAX package's
    jitted route: the same coarse offsets, values within 1e-12."""
    monkeypatch.setenv("AMGCL_TPU_DEVICE_SETUP", "1")
    (plan, a, m), (rplan, ra, rm) = _plans(with_m)
    st.calls.clear()
    got = plan.apply(a, m, CPU)
    assert st.calls == {"device": 1}
    want = rplan.apply(ra, rm)             # device_numeric: the jit
    assert rplan._dev_fn is not None
    assert got.offsets3 == [tuple(o) for o in want.offsets3]
    np.testing.assert_allclose(got.data, want.data, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("with_m", [True, False])
def test_device_galerkin_bit_for_bit_with_host_route(with_m, dtype):
    """Each product rounds before its subtraction on both routes, in the
    same order: the device route gives the host route's bits."""
    (plan, a, m), _ = _plans(with_m, dtype, m=10)
    host = plan.apply(a, m)
    got = plan.apply(a, m, CPU)
    assert got.offsets3 == host.offsets3
    assert got.data.dtype == host.data.dtype == np.dtype(dtype)
    assert np.array_equal(got.data, host.data)


@pytest.mark.parametrize("label", ["C1", "A1"])
def test_device_setup_takes_the_device_galerkin_route(label):
    """C1 (Chebyshev: the device build declines, SA's stencil transfers
    remain) and A1 (plain aggregation on the grid) at a small size: a
    build with its set-up on the device takes the plan's device route,
    and each coarse operator is the host-route build's to the bit."""
    A, _ = T.poisson3d(16)
    prm = dict(relax=T.Chebyshev()) if label == "C1" \
        else dict(coarsening=T.Aggregation())
    st.calls.clear()
    dev_amg = T.AMG(A, T.AMGParams(coarse_enough=200, **prm), device=CPU,
                    device_setup=True)
    assert not dev_amg.device_built and st.calls["device"] >= 1
    assert st.calls["host"] == 0
    st.calls.clear()
    host_amg = T.AMG(A, T.AMGParams(coarse_enough=200, **prm), device=CPU,
                     device_setup=False)
    assert st.calls["device"] == 0 and st.calls["host"] >= 1
    # the coarse operators of the stencil transfers (a level past the
    # stencil's reach takes the device MIS and the segment plans, whose
    # values are not the host route's)
    lv_d, lv_h = dev_amg.host_levels, host_amg.host_levels
    stencil = [i for i, (_, P, _) in enumerate(lv_d[:-1])
               if isinstance(P, st.StencilTransfer)]
    assert stencil and stencil[0] == 0
    for i in stencil:
        assert isinstance(lv_h[i][1], st.StencilTransfer)
        Ad, Ah = lv_d[i + 1][0], lv_h[i + 1][0]
        assert np.array_equal(Ad.ptr, Ah.ptr)
        assert np.array_equal(Ad.col, Ah.col)
        assert Ad.val.dtype == Ah.val.dtype
        assert np.array_equal(Ad.val, Ah.val)
    paths = _paths(dev_amg.setup_profile.to_dict()["scopes"])
    assert "level0/galerkin/stencil_galerkin" in paths


# -- the set-up by stage ---------------------------------------------------------


def _system(name):
    if name == "poisson":
        return T.poisson3d(16)[0]
    if name == "fe":
        return T.fe_like_problem(6000, nnz_target=31 * 6000, seed=1)[0]
    return T.poisson3d_block(12, 2)[0]


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("name", ["poisson", "fe", "block"])
def test_setup_profile_paths_match_jax(name, route, monkeypatch):
    """``setup_profile``'s scope paths are the JAX package's for the same
    build: host set-up (``AMGCL_TPU_DEVICE_SETUP=0``) and set-up on the
    device (``=1``, the port's ``device_setup=True``)."""
    monkeypatch.setenv("AMGCL_TPU_DEVICE_SETUP",
                       "1" if route == "device" else "0")
    A = _system(name)
    amg = T.AMG(A, T.AMGParams(dtype=torch.float64), device=CPU,
                device_setup=route == "device")
    ref = RefAMG(_ref(A), RefParams(dtype=jnp.float64))
    got = _port_paths(amg.setup_profile)
    want = _paths(ref.setup_profile.to_dict()["scopes"])
    assert got == want
    assert "coarse_solver" in got
    st_ = amg.setup_profile.to_dict()
    total = sum(v["total_s"] for v in st_["scopes"].values())
    assert 0 < total <= amg.setup_seconds


def test_rebuild_profile_paths_match_jax():
    """A numeric rebuild of a host-built hierarchy: one galerkin scope a
    level, then the transfers, smoothers and coarse solver, as the JAX
    package's rebuild records."""
    A = _system("fe")
    amg = T.AMG(A, T.AMGParams(dtype=torch.float64), device=CPU)
    ref = RefAMG(_ref(A), RefParams(dtype=jnp.float64))
    amg.rebuild(A.val * 2.0)
    ref.rebuild(A.val * 2.0)
    got = _port_paths(amg.setup_profile)
    assert got == _paths(ref.setup_profile.to_dict()["scopes"])
    assert "level0/galerkin" in got and "level0/coarsening" not in got


def test_native_stages_nest_in_their_scopes():
    """Each native call of a host build is a stage of the scope it ran
    in: the greedy aggregates and the filter under coarsening, SPAI-0's
    diagonal under relax_setup."""
    A = _system("fe")
    amg = T.AMG(A, T.AMGParams(dtype=torch.float64), device=CPU)
    paths = _paths(amg.setup_profile.to_dict()["scopes"])
    for want in ("level0/coarsening/native/aggregate_d2",
                 "level0/coarsening/native/filter_fill",
                 "level0/relax_setup/native/spai0_diag"):
        assert want in paths, want
    node = amg.setup_profile.to_dict()["scopes"]["level0/coarsening"]
    inner = sum(c["total_s"] for c in node["children"].values())
    assert inner <= node["total_s"]


# -- the profiler ----------------------------------------------------------------


def _drive(P):
    with P.scope("setup"):
        with P.scope("coarsening"):
            pass
        P.tic("galerkin")
        P.toc("galerkin")
    with P.scope("solve"):
        pass
    return P


def test_profiler_tree_matches_jax():
    """The same tic/toc sequence gives the JAX profiler's tree, counts
    and event paths."""
    got, want = _drive(Profiler()), _drive(r_prof.Profiler())
    assert _paths(got.to_dict()["scopes"]) \
        == _paths(want.to_dict()["scopes"])
    assert [e[0] for e in got.events] == [e[0] for e in want.events]
    tr = got.to_chrome_trace(tid_name="setup",
                             counters={"GB/s": {"setup/galerkin": 2.0}})
    phs = [e["ph"] for e in tr["traceEvents"]]
    assert phs.count("X") == 4 and phs.count("C") == 2 and phs[0] == "M"
    assert set(prof_mod.aggregate([got, got])) \
        == set(r_prof.aggregate([want, want]))
    assert "setup/galerkin" in prof_mod.format_aggregate(
        prof_mod.aggregate([got]))
    assert "coarsening" in str(got)


def test_profiler_pairing_and_unwinding():
    """A toc of the wrong scope raises; an exception inside a scope
    closes what it left open."""
    P = Profiler()
    P.tic("a")
    with pytest.raises(RuntimeError, match="mismatch"):
        P.toc("b")
    P.toc("a")
    with pytest.raises(ValueError):
        with P.scope("outer"):
            P.tic("inner")
            raise ValueError
    assert len(P._stack) == 1
    assert P.to_dict()["scopes"]["outer"]["children"]["inner"]["count"] == 1


def test_profiler_event_cap(monkeypatch):
    monkeypatch.setattr(Profiler, "MAX_EVENTS", 3)
    P = Profiler()
    with pytest.warns(UserWarning, match="event cap"):
        for _ in range(5):
            with P.scope("s"):
                pass
    assert len(P.events) == 3 and P._events_dropped == 2
    tr = P.to_chrome_trace()
    assert tr["otherData"] == {"events_dropped": 2}
    assert P.to_dict()["scopes"]["s"]["count"] == 5


def test_setup_scope_publishes_the_profiler():
    """A substage outside a build records nothing; inside one it nests
    under the open scope; a None profiler records nothing."""
    P = Profiler.device(CPU)
    assert P._sync is None
    with setup_substage("outside"):
        pass
    with setup_scope(P, "level0/coarsening"):
        with setup_substage("strength_graph"):
            pass
    with setup_scope(None, "level1/coarsening"):
        with setup_substage("mis_pack"):
            pass
    assert _paths(P.to_dict()["scopes"]) \
        == ["level0/coarsening", "level0/coarsening/strength_graph"]


# -- SC1's levels (ROADMAP §C) -------------------------------------------------


@pytest.mark.parametrize("route", ["host", "device"])
def test_sc1_levels_transfer_and_block_match_jax(route, monkeypatch):
    """SC1's Schur correction (stokes_like, adjust_p=2) at 64² cells: each
    level of the velocity and the pressure AMG has the JAX package's
    operator and transfer types and aggregate block, and neither package
    builds a fused leg: the blocks are (1, 2, 2) and (1, 1, 2), not
    2×2×2, the legs' gate in both."""
    monkeypatch.setenv("AMGCL_TPU_DEVICE_SETUP",
                       "1" if route == "device" else "0")
    A, pmask = T.stokes_like(64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_schur.SchurPressureCorrection(_ref(A), pmask, adjust_p=2)
    pre = T.SchurPressureCorrection(A, pmask, adjust_p=2, device=CPU,
                                    device_setup=route == "device")

    def describe(h):
        return [(type(lv.A).__name__,
                 None if lv.P is None else type(lv.P).__name__,
                 getattr(getattr(lv.P, "T", None), "block", None),
                 lv.down is not None, lv.up is not None,
                 tuple(lv.A.shape)) for lv in h.levels]

    blocks = []
    for which in ("u_amg", "p_amg"):
        got = describe(getattr(pre, which).hierarchy)
        assert got == describe(getattr(ref, which).hierarchy), which
        assert len(got) >= 2
        assert not any(d or u for _, _, _, d, u, _ in got)
        blocks.append(got[0][2])
    assert blocks == [(1, 2, 2), (1, 1, 2)]
