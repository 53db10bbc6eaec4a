"""The multi-tenant solver farm, the operator registry, the LRU memory pool
and device eviction and readmission (``amgcl_tpu_torch/serve/farm.py``,
``serve/registry.py``, ``telemetry/ledger.py``) against the JAX package's
``amgcl_tpu/serve``.

Inputs come from numpy seeds and the port's sample problems; where both
packages run, they get the same matrices (through scipy) on the CPU.
Parity: the pool's ``coldest()``, ``resident()`` and refusals under one
call sequence, the registry's outcomes under one registration sequence,
equal fingerprint digests (both packages keep ``ptr`` as int64 and
``col`` as int32), and one farm run of three tenants under 0.75 of the
used bytes with equal per-tenant counts, x within 1e-10 (relative to its
largest entry) and 3 misses. The JAX farm's behaviour cases
(tests/test_farm.py) follow, ported; its C API, CLI, gate, pyamgcl and
``diagnose(farm=...)`` cases belong to ROADMAP A.13.

The JAX package is imported inside the tests that compare with it, so
that the card's run of the ``cuda`` cases (``python -m pytest
--noconftest -m cuda tests/test_torch_farm.py``), which has no JAX,
collects this file. Those cases (the memory a release returns, a bucket
captured while another thread runs a setup) skip without a card.
"""

import contextlib
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import amgcl_tpu_torch as T
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.serve import (OperatorRegistry, SolverFarm,
                                   SolverService, sparsity_fingerprint,
                                   stable_config_key)
from amgcl_tpu_torch.serve.registry import RegistryEntry
from amgcl_tpu_torch.telemetry.ledger import LruMemoryPool

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS, OpenMP and torch thread while this module runs: its
    small problems gain nothing from threads, and the test suite's
    parallel workers would oversubscribe the cores. The card's machine
    has no threadpoolctl; there torch's own limit is set alone."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1) if threadpool_limits \
                else contextlib.nullcontext():
            yield
    finally:
        torch.set_num_threads(threads)


def _prm(dtype=torch.float32):
    return T.AMGParams(dtype=dtype, coarse_enough=50)


def _cg(maxiter=80, tol=1e-7):
    return T.CG(maxiter=maxiter, tol=tol)


def _make_bundle():
    return lambda Ah: T.make_solver(Ah, _prm(), _cg(), **CPU)


def _farm(**kw):
    kw.setdefault("batch", 4)
    kw.setdefault("flush_ms", 10)
    kw.setdefault("metrics_port", -9)
    return SolverFarm(**kw)


def _reg(farm, tenant, A, **kw):
    kw.setdefault("solver", _cg(40))
    kw.setdefault("precond", _prm())
    return farm.register(tenant, A, device="cpu", **kw)


def _scaled(A, s):
    return CSR(A.ptr, A.col, s * A.val, A.ncols)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_sparsity_fingerprint_matches_jax():
    """Equal digests for the same scipy matrix in both packages (ptr int64,
    col int32 in each); the values do not enter it, and it is cached on
    the matrix."""
    from amgcl_tpu.ops.csr import CSR as RefCSR
    from amgcl_tpu.serve.registry import sparsity_fingerprint as ref_fp
    rng = np.random.default_rng(19)
    for m in (5, 7):
        A, _ = T.poisson3d(m)
        S = A.to_scipy().tocsr()
        S.data = rng.standard_normal(S.nnz)
        mine, ref = CSR.from_scipy(S), RefCSR.from_scipy(S)
        assert mine.ptr.dtype == ref.ptr.dtype == np.int64
        assert mine.col.dtype == ref.col.dtype == np.int32
        assert sparsity_fingerprint(mine) == ref_fp(ref)
        assert sparsity_fingerprint(_scaled(mine, 2.0)) == \
            sparsity_fingerprint(mine)
    assert mine._sparsity_fp == sparsity_fingerprint(mine)
    assert sparsity_fingerprint(T.poisson3d(6)[0]) != \
        sparsity_fingerprint(T.poisson3d(7)[0])


def _pool_sequence(pool):
    """One call sequence on an LRU pool; the observable trail. A refused
    charge evicts the coldest other key and charges again."""
    trail = []
    for k, n in [("a", 40), ("b", 30), ("c", 40), ("b", 50), ("d", 10),
                 ("a", 40), ("e", 70)]:
        ok = pool.charge(k, n)
        trail.append(("charge", k, n, ok, pool.used))
        if not ok:
            victim = pool.coldest(exclude=(k,))
            trail.append(("evict", victim, pool.release(victim)))
            trail.append(("retry", k, pool.charge(k, n), pool.used))
        trail.append(("coldest", pool.coldest(),
                      pool.coldest(exclude=("a",))))
        if k == "c":
            pool.touch("a")
            trail.append(("touched", pool.coldest()))
        trail.append(("resident", list(pool.resident().items())))
    pool.resize(60)
    trail.append(("resized", pool.unlimited, pool.charge("f", 1),
                  pool.release("zz")))
    pool.resize(0)
    trail.append(("unlimited", pool.unlimited, pool.charge("g", 10 ** 12),
                  pool.to_dict()["total_bytes"]))
    trail.append(("log", [tuple(c) for c in pool.charges]))
    return trail


def test_lru_pool_matches_jax():
    """The same coldest(), resident(), refusals, releases and charge log
    as the JAX package's pool under one call sequence."""
    from amgcl_tpu.telemetry.ledger import LruMemoryPool as RefPool
    assert _pool_sequence(LruMemoryPool(100)) == \
        _pool_sequence(RefPool(100))


def test_registry_outcomes_match_jax():
    """One registration sequence through both registries: the same hit,
    rebuild and miss outcomes and counters (the builds are stand-ins
    with a ``rebuild``; the outcomes depend on patterns, values and
    owners alone)."""
    from amgcl_tpu.ops.csr import CSR as RefCSR
    from amgcl_tpu.serve.registry import OperatorRegistry as RefRegistry

    class Stub:
        def __init__(self, A):
            self.A = A

        def rebuild(self, A):
            self.A = A

    A6 = T.poisson3d(6)[0].to_scipy()
    A7 = T.poisson3d(7)[0].to_scipy()
    steps = [("o", A6, 1.0, "k"), ("p", A6, 1.0, "k"), ("o", A6, 2.0, "k"),
             ("p", A6, 3.0, "k"), ("q", A7, 1.0, "k"), ("o", A6, 1.0, "j"),
             ("release", "p"), ("r", A6, 3.0, "k"), ("r", A6, 4.0, "k"),
             ("release", "o"), ("s", A6, 5.0, "k"), ("prune",),
             ("t", A6, 2.0, "k"), ("o", A6, 1.0, "k")]

    def run(reg, make):
        out = []
        for st in steps:
            if st[0] == "release":
                reg.release(st[1])
            elif st[0] == "prune":
                out.append(("pruned", reg.prune()))
            else:
                owner, S, s, key = st
                A = make(S * s)
                out.append(reg.acquire(owner, A, Stub, config_key=key)[1])
        return out, (reg.hits, reg.misses, reg.rebuilds,
                     len(reg.entries()))

    mine = run(OperatorRegistry(), lambda S: CSR.from_scipy(S.tocsr()))
    ref = run(RefRegistry(), lambda S: RefCSR.from_scipy(S.tocsr()))
    assert mine == ref
    assert set(mine[0]) >= {"hit", "rebuild", "miss"}


def test_farm_run_matches_jax_farm():
    """Three tenants poisson3d(6, 7, 8) in float64 under 0.75 of the used
    bytes, two rounds through both farms: equal per-tenant counts, x
    within 1e-10 of the JAX farm's, the port's rounds equal bit for bit,
    3 misses and a readmission in each."""
    import jax.numpy as jnp
    from amgcl_tpu.models.amg import AMGParams as RefParams
    from amgcl_tpu.ops.csr import CSR as RefCSR
    from amgcl_tpu.serve import SolverFarm as RefFarm
    from amgcl_tpu.solver.cg import CG as RefCG

    systems = {}
    for k, m in enumerate((6, 7, 8)):
        A, rhs = T.poisson3d(m)
        systems["t%d" % k] = (A, np.asarray(rhs, np.float64))

    def drive(farm, register, asarray):
        for t, (A, _) in systems.items():
            assert register(farm, t, A)["outcome"] == "miss"
        farm.set_max_bytes(int(farm.stats()["pool"]["used_bytes"] * 0.75))
        assert len(farm.pool.resident()) < 3
        rounds = []
        for _ in range(2):
            futs = [(t, farm.submit(t, rhs))
                    for t, (_, rhs) in systems.items()]
            rounds.append({t: (asarray(x), rep.iters, rep.resid)
                           for t, (x, rep) in
                           ((t, f.result(timeout=300)) for t, f in futs)})
        st = farm.stats()
        farm.close()
        return rounds, st

    mine, st = drive(
        _farm(),
        lambda f, t, A: f.register(t, A, solver=_cg(), device="cpu",
                                   precond=_prm(torch.float64)),
        lambda x: x.numpy())
    ref, ref_st = drive(
        RefFarm(batch=4, flush_ms=10, metrics_port=-9),
        lambda f, t, A: f.register(
            t, RefCSR.from_scipy(A.to_scipy()),
            solver=RefCG(maxiter=80, tol=1e-7),
            precond=RefParams(dtype=jnp.float64, coarse_enough=50)),
        np.asarray)
    for t in systems:
        x0, it0, r0 = mine[0][t]
        x1, it1, _ = mine[1][t]
        assert np.array_equal(x0, x1) and it0 == it1
        xr, itr, rr = ref[0][t]
        assert it0 == itr, (t, it0, itr)
        assert np.max(np.abs(x0 - xr)) <= 1e-10 * np.max(np.abs(xr))
        assert r0 < 1e-7
    for s in (st, ref_st):
        assert s["registry"]["misses"] == 3
        assert s["evictions"] >= 1 and s["readmissions"] >= 1
        assert s["registry"]["rebuilds"] >= s["readmissions"]
        assert s["pool"]["used_bytes"] <= s["pool"]["total_bytes"]


# ---------------------------------------------------------------------------
# the registry (tests/test_farm.py:53-230)
# ---------------------------------------------------------------------------

def test_registry_hit_rebuild_miss_paths():
    """The three outcomes and their counters; the rebuild is cheaper than
    the setup it replaces and solves as a fresh build of the new matrix,
    bit for bit."""
    A, rhs = T.poisson3d(8)
    reg = OperatorRegistry()
    key = stable_config_key(_cg(), _prm())
    e1, o1 = reg.acquire("owner", A, _make_bundle(), config_key=key)
    assert o1 == "miss" and reg.misses == 1
    A_same = CSR(A.ptr, A.col, A.val.copy(), A.ncols)
    e2, o2 = reg.acquire("other", A_same, _make_bundle(),
                         config_key=key)
    assert o2 == "hit" and e2 is e1 and reg.hits == 1
    reg.release("other")
    A2 = _scaled(A, 2.0)
    e3, o3 = reg.acquire("owner", A2, _make_bundle(), config_key=key)
    assert o3 == "rebuild" and e3 is e1 and reg.rebuilds == 1
    assert e3.rebuild_s is not None and e3.rebuild_s < e3.setup_s
    x_reg, _ = e3.obj(rhs)
    x_fresh, _ = T.make_solver(A2, _prm(), _cg(), **CPU)(rhs)
    assert torch.equal(x_reg, x_fresh)
    key2 = stable_config_key(T.CG(maxiter=50, tol=1e-5), _prm())
    assert reg.acquire("owner", A2, _make_bundle(),
                       config_key=key2)[1] == "miss"


def test_registry_snapshot_defeats_inplace_mutation():
    """Values mutated in place and registered again take the rebuild
    path: the entry compares against a snapshot of what was built."""
    A, rhs = T.poisson3d(6)
    reg = OperatorRegistry()
    e1, o1 = reg.acquire("o", A, _make_bundle())
    assert o1 == "miss"
    x_old, _ = e1.obj(rhs)
    A.val *= 2.0
    e2, o2 = reg.acquire("o", CSR(A.ptr, A.col, A.val, A.ncols),
                         _make_bundle())
    assert o2 == "rebuild" and e2 is e1
    x_new, _ = e2.obj(rhs)
    np.testing.assert_allclose(x_new.numpy(), x_old.numpy() / 2.0,
                               rtol=1e-4, atol=1e-6)


def test_config_key_sees_nested_policy_fields():
    from amgcl_tpu_torch.coarsening import SmoothedAggregation
    k1 = stable_config_key(T.AMGParams(
        coarsening=SmoothedAggregation(eps_strong=0.08)))
    k2 = stable_config_key(T.AMGParams(
        coarsening=SmoothedAggregation(eps_strong=0.25)))
    k3 = stable_config_key(T.AMGParams(
        coarsening=SmoothedAggregation(eps_strong=0.08)))
    assert k1 != k2 and k1 == k3
    assert "0x" not in k1          # no object addresses in the key


def test_registry_never_rebuilds_a_live_co_owner():
    A, rhs = T.poisson3d(6)
    reg = OperatorRegistry()
    e1, _ = reg.acquire("a", A, _make_bundle())
    e2, o2 = reg.acquire("b", _scaled(A, 3.0), _make_bundle())
    assert o2 == "miss" and e2 is not e1
    x1, _ = e1.obj(rhs)
    x2, _ = e2.obj(rhs)
    np.testing.assert_allclose(x2.numpy(), x1.numpy() / 3.0, rtol=1e-4,
                               atol=1e-6)


def test_registry_orphan_cap_and_probe():
    reg = OperatorRegistry(max_orphans=1)
    mats = [T.poisson3d(m)[0] for m in (5, 6, 7)]
    for k, A in enumerate(mats):
        assert reg.probe("o%d" % k, A) == "miss"
        reg.acquire("o%d" % k, A, _make_bundle())
    assert reg.probe("o0", mats[0]) == "hit"
    for k in range(3):
        reg.release("o%d" % k)
    assert len(reg.entries()) == 1
    assert reg.entries()[0].fingerprint == sparsity_fingerprint(mats[2])
    A2 = _scaled(mats[2], 2.0)
    assert reg.probe("new", A2) == "rebuild"
    assert reg.acquire("new", A2, _make_bundle())[1] == "rebuild"


def test_registry_release_keep_and_rebuild_guard():
    """release(keep=) drops the owner from every other entry at once; a
    rebuild_ok veto turns the rebuild path into a miss (probe predicts
    it), and without it the orphan is the rebuild target."""
    A, _ = T.poisson3d(6)
    B, _ = T.poisson3d(7)
    reg = OperatorRegistry()
    e1, _ = reg.acquire("o", A, _make_bundle())
    e2, _ = reg.acquire("o", B, _make_bundle())
    reg.release("o", keep=e2)
    assert not e1.owners and e2.owners == {"o"}
    veto = lambda _e: False          # noqa: E731
    A2 = _scaled(A, 2.0)
    assert reg.probe("p", A2, rebuild_ok=veto) == "miss"
    e3, o3 = reg.acquire("p", A2, _make_bundle(), rebuild_ok=veto)
    assert o3 == "miss" and e3 is not e1
    assert reg.probe("q", _scaled(A, 3.0)) == "rebuild"


def test_registry_uid_mint_is_atomic_across_threads():
    uids = []

    def mint():
        uids.extend(RegistryEntry("fp", "", object(), np.zeros(1), 0.0).uid
                    for _ in range(200))

    threads = [threading.Thread(target=mint) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert len(set(uids)) == len(uids) == 800


# ---------------------------------------------------------------------------
# the farm's request path and re-registration (tests/test_farm.py:233-390)
# ---------------------------------------------------------------------------

def test_submit_waiting_on_full_queue_survives_reregister():
    A6, rhs6 = T.poisson3d(6)
    A7, rhs7 = T.poisson3d(7)
    farm = _farm()
    try:
        _reg(farm, "t", A6, queue_max=1)
        farm._pick_tenant_locked = lambda: None    # park the dispatch
        f1 = farm.submit("t", rhs6, block=False)
        errs = []

        def waiter():
            try:
                farm.submit("t", rhs6, block=True, timeout_s=120)
            except RuntimeError as e:
                errs.append(e)

        th = threading.Thread(target=waiter)
        th.start()
        time.sleep(0.3)
        _reg(farm, "t", A7, queue_max=1)
        th.join(timeout=60)
        assert not th.is_alive()
        assert errs and "different system size" in str(errs[0])
        with pytest.raises(RuntimeError):
            f1.result(timeout=60)
        del farm._pick_tenant_locked
        _x, rep = farm.solve("t", rhs7)
        assert rep.resid < 1e-6
    finally:
        farm.close()


def test_reregister_waits_out_inflight_pin_keeps_rebuild_path():
    A, rhs = T.poisson3d(6)
    farm = _farm()
    release = threading.Event()
    try:
        _reg(farm, "t", A)
        e = farm.tenants["t"].entry
        svc = e.payload["service"]
        entered = threading.Event()
        orig = svc._run_batch

        def slow(batch):
            entered.set()
            release.wait(timeout=120)
            return orig(batch)

        svc._run_batch = slow
        fut = farm.submit("t", rhs)
        assert entered.wait(timeout=120)
        out = {}
        th = threading.Thread(target=lambda: out.update(
            _reg(farm, "t", _scaled(A, 2.0))))
        th.start()
        time.sleep(0.3)
        assert not out                 # parked on the pin
        release.set()
        th.join(timeout=300)
        svc._run_batch = orig
        assert out.get("outcome") == "rebuild", out
        assert out["uid"] == e.uid
        fut.result(timeout=300)
        _x, rep = farm.solve("t", rhs)
        assert rep.resid < 1e-6
    finally:
        release.set()
        farm.close()


def test_readmission_preevicts_before_materializing():
    farm = _farm()
    try:
        rhs_by = {}
        for k, m in enumerate((6, 7, 8)):
            A, rhs = T.poisson3d(m)
            _reg(farm, "t%d" % k, A)
            rhs_by["t%d" % k] = rhs
        farm.set_max_bytes(int(farm.stats()["pool"]["used_bytes"] * 0.75))
        overshoots = []
        for e in farm.registry.entries():
            svc = e.payload["service"]

            def wrapped(e=e, orig=svc.readmit):
                hint = farm._bytes_hint.get(e.uid, 0)
                if farm.pool.used + hint > farm.pool.total:
                    overshoots.append((e.uid, farm.pool.used, hint))
                return orig()

            svc.readmit = wrapped
        for _ in range(2):
            for t, rhs in rhs_by.items():
                assert farm.solve(t, rhs)[1].resid < 1e-6
        assert farm.stats()["readmissions"] >= 1
        assert not overshoots, overshoots
    finally:
        farm.close()


def test_farm_reregister_different_size_fails_stale_queue():
    A6, rhs6 = T.poisson3d(6)
    A7, rhs7 = T.poisson3d(7)
    farm = _farm()
    try:
        _reg(farm, "t", A6)
        with farm._mem_lock:
            futs = [farm.submit("t", rhs6 * (1 + k), block=True)
                    for k in range(6)]
            _reg(farm, "t", A7)
        outcomes = []
        for f in futs:
            try:
                f.result(timeout=300)
                outcomes.append("ok")
            except RuntimeError as e:
                assert "re-registered with a different" in str(e)
                outcomes.append("stranded")
        assert "stranded" in outcomes
        assert farm.solve("t", rhs7)[1].resid < 1e-6
    finally:
        farm.close()


# ---------------------------------------------------------------------------
# eviction and readmission (tests/test_farm.py:420-530)
# ---------------------------------------------------------------------------

def test_lru_pool_semantics():
    pool = LruMemoryPool(100)
    assert pool.charge("a", 40) and pool.charge("b", 40)
    assert not pool.charge("c", 40)
    assert pool.coldest() == "a"
    pool.touch("a")
    assert pool.coldest() == "b"
    assert pool.coldest(exclude=("b",)) == "a"
    assert pool.release("b") == 40 and pool.used == 40
    assert pool.charge("c", 40)
    assert sorted(pool.resident()) == ["a", "c"]
    # a re-charge that does not fit keeps the old charge
    assert not pool.charge("a", 90) and pool.resident()["a"] == 40
    pool.resize(0)
    assert pool.unlimited and pool.charge("d", 10 ** 12)
    unl = LruMemoryPool(0)
    assert unl.unlimited and unl.to_dict()["total_bytes"] == 0
    for k in range(300):
        unl.charge("k%d" % k, 1)
    assert len(unl.charges) == 256          # the log is bounded


@pytest.mark.parametrize("setup", ["host", "device"])
def test_service_release_device_returns_bytes(setup):
    """release_device() drops the bundle's device state (bytes() 0, no
    operator, the plans' device copies gone), refuses a running worker,
    and readmission solves bit for bit as before, through a rebuild."""
    A, rhs = T.poisson3d(8)
    ms = T.make_solver(A, _prm(), _cg(), device_setup=setup == "device",
                       **CPU)
    svc = SolverService(ms, batch=2, flush_ms=5, metrics_port=-9)
    x1, _ = svc.solve_batch(rhs)
    b0 = ms.precond.bytes()
    assert b0 > 0
    with pytest.raises(RuntimeError):
        svc.start().release_device()
    svc.close()
    svc.release_device()
    assert ms.precond.bytes() == 0 and not ms.precond.device_resident
    assert ms.A_dev is None and ms._stacked is None
    assert all(not seg._dev for seg in ms.precond._plan_segments())
    calls = []
    orig = ms.precond.rebuild
    ms.precond.rebuild = lambda A: calls.append(A) or orig(A)
    svc.readmit()
    assert len(calls) == 1
    assert ms.precond.bytes() == b0
    x2, _ = svc.solve_batch(rhs)
    assert torch.equal(x1, x2)


def test_amg_readmit_reordered_and_host_built():
    """AMG.readmit: a host-built hierarchy rebuilds from its values, a
    reordered one from its permuted CSR (no double permutation); each
    solves bit for bit as before the release."""
    rng = np.random.default_rng(5)
    A, rhs = T.poisson3d(9)
    perm = rng.permutation(A.nrows)
    S = A.to_scipy().tocsr()[perm][:, perm].tocsr()
    for mat, reorder in ((A, "off"), (CSR.from_scipy(S), "rcm")):
        ms = T.make_solver(mat, _prm(torch.float64), _cg(), reorder=reorder,
                           **CPU)
        x1, _ = ms(rhs)
        amg = ms.precond
        assert (amg.reorder_plan is not None) == (reorder == "rcm")
        seen = []
        orig = amg.rebuild
        amg.rebuild = lambda a: seen.append(type(a)) or orig(a)
        ms.release_device()
        assert amg.bytes() == 0
        amg.readmit()
        assert seen == [CSR if reorder == "rcm" else np.ndarray]
        ms.A_dev = None
        ms.readmit()
        x2, _ = ms(rhs)
        assert torch.equal(x1, x2)


def test_farm_eviction_readmission_determinism():
    farm = _farm()
    rhs_by = {}
    try:
        for k, m in enumerate((6, 7, 8)):
            A, rhs = T.poisson3d(m)
            assert _reg(farm, "t%d" % k, A, solver=_cg())["outcome"] == \
                "miss"
            rhs_by["t%d" % k] = rhs
        farm.set_max_bytes(int(farm.stats()["pool"]["used_bytes"] * 0.75))
        assert len(farm.pool.resident()) < 3
        first = {}
        for rnd in range(2):
            futs = [(t, farm.submit(t, rhs)) for t, rhs in rhs_by.items()]
            for t, fut in futs:
                x, rep = fut.result(timeout=300)
                assert rep.resid < 1e-6 and rep.iters > 0
                if rnd == 0:
                    first[t] = x
                else:
                    assert torch.equal(first[t], x)
        st = farm.stats()
        assert st["evictions"] >= 1 and st["readmissions"] >= 1
        assert st["registry"]["misses"] == 3
        assert st["registry"]["rebuilds"] >= st["readmissions"]
        assert all(r["requests"] == 2 for r in st["tenants"])
        assert st["pool"]["used_bytes"] <= st["pool"]["total_bytes"]
    finally:
        farm.close()


def test_farm_budget_too_small_for_one_operator():
    A, _ = T.poisson3d(6)
    farm = _farm(max_bytes=1024)
    try:
        with pytest.raises(RuntimeError, match="max_bytes"):
            _reg(farm, "t0", A, solver=T.CG(maxiter=10, tol=1e-5))
        ents = farm.registry.entries()
        assert ents and all(not e.owners for e in ents)
        assert all(e.obj.A_dev is None for e in ents)
        assert farm.pool.used == 0
    finally:
        farm.close()


def test_farm_headroom_and_knobs():
    """headroom="measured" needs the memory watch (ROADMAP A.13); the
    JAX package's environment knobs are keywords with its defaults."""
    with pytest.raises(NotImplementedError, match="A.13"):
        SolverFarm(headroom="measured")
    with pytest.raises(ValueError):
        SolverFarm(headroom="sometimes")
    farm = SolverFarm()
    assert farm.pool.unlimited and farm.batch == 8
    assert farm.queue_max == 256 and farm.timeout_s == 30.0
    assert farm.flush_s == 0.05 and farm.metrics_port is None
    assert farm.slo_defaults == {"p99_ms": 0.0, "timeout_rate": 0.01,
                                 "unhealthy_rate": 0.05}
    assert (farm._retry_max, farm._restart_max, farm._shed_breaches,
            farm._shed_cooldown) == (0, 2, 0, 5.0)
    farm.close()


# ---------------------------------------------------------------------------
# rollback, isolation, fairness, stress (tests/test_farm.py:528-710)
# ---------------------------------------------------------------------------

def test_failed_admission_rolls_back_inplace_rebuild():
    A, rhs = T.poisson3d(6)
    farm = _farm()
    try:
        _reg(farm, "t", A, solver=_cg())
        x1, _ = farm.solve("t", rhs)
        farm.set_max_bytes(1024)
        with pytest.raises(RuntimeError, match="max_bytes"):
            _reg(farm, "t", _scaled(A, 2.0), solver=_cg())
        with pytest.raises(RuntimeError, match="max_bytes"):
            _reg(farm, "t", CSR(A.ptr, A.col, A.val.copy(), A.ncols),
                 solver=_cg())
        assert farm.tenants["t"].entry.obj.A_dev is None
        assert farm.stats()["pool"]["used_bytes"] == 0
        farm.set_max_bytes(0)
        x2, rep = farm.solve("t", rhs)
        assert rep.resid < 1e-6 and torch.equal(x1, x2)
    finally:
        farm.close()


def test_failed_admission_rollback_inplace_mutation_idiom():
    A, rhs = T.poisson3d(6)
    farm = _farm()
    try:
        _reg(farm, "t", A, solver=_cg())
        x1, _ = farm.solve("t", rhs)
        farm.set_max_bytes(1024)
        A.val *= 2.0
        with pytest.raises(RuntimeError, match="max_bytes"):
            _reg(farm, "t", A, solver=_cg())
        farm.set_max_bytes(0)
        x2, rep = farm.solve("t", rhs)
        assert rep.resid < 1e-6 and torch.equal(x1, x2)
    finally:
        farm.close()


def test_cross_tenant_isolation():
    """One tenant's guard trips and SLO breach stay on its labels and
    window; the co-tenant's stay clean, and its window's serving
    findings name the breach."""
    from amgcl_tpu_torch.telemetry.health import serve_findings
    A, rhs = T.poisson3d(6)
    farm = _farm()
    try:
        tight = {"unhealthy_rate": 0.0}
        _reg(farm, "bad", A, slo=tight)
        _reg(farm, "good", A, slo=tight)
        _xb, rb = farm.solve("bad", rhs, x0=np.full(rhs.shape, 1e30))
        _xg, rg = farm.solve("good", rhs)
        assert rb.health is not None and not rb.health["ok"]
        assert rg.health is not None and rg.health["ok"]
        rows = {r["tenant"]: r for r in farm.stats()["tenants"]}
        assert rows["bad"]["unhealthy"] == 1
        assert rows["bad"]["slo_trips"] >= 1
        assert rows["good"]["unhealthy"] == 0
        assert rows["good"]["slo_trips"] == 0
        assert "unhealthy_rate" not in rows["good"]["slo_summary"]["trips"]
        assert farm.live.get("farm_tenant_unhealthy_total",
                             tenant="bad") == 1
        assert farm.live.get("farm_tenant_unhealthy_total",
                             tenant="good") is None
        codes = {f["code"] for f in
                 serve_findings(rows["bad"]["slo_summary"])}
        assert "slo_unhealthy_rate" in codes
        assert not serve_findings(rows["good"]["slo_summary"])
    finally:
        farm.close()


def test_load_shedding_after_sustained_breach():
    """With shed_breaches, a tenant whose window keeps tripping sheds
    load (a typed LoadShedError at submit) for the cooldown; the
    co-tenant keeps being served."""
    from amgcl_tpu_torch.faults import LoadShedError
    A, rhs = T.poisson3d(6)
    farm = _farm(shed_breaches=1, shed_cooldown_s=60.0)
    try:
        _reg(farm, "bad", A, slo={"unhealthy_rate": 0.0})
        _reg(farm, "good", A)
        farm.solve("bad", rhs, x0=np.full(rhs.shape, 1e30))
        with pytest.raises(LoadShedError):
            farm.submit("bad", rhs)
        assert farm.solve("good", rhs)[1].resid < 1e-6
        st = farm.stats()
        assert st["recovery"]["shed"] == 1
        assert {r["tenant"]: r["shedding"] for r in st["tenants"]} == \
            {"bad": True, "good": False}
        assert farm.live.get("farm_load_shed_total", tenant="bad") == 1
    finally:
        farm.close()


def test_fair_share_starvation_bound():
    A6, rhs6 = T.poisson3d(6)
    A7, rhs7 = T.poisson3d(7)
    order = []
    farm = _farm(batch=2, flush_ms=1)
    try:
        _reg(farm, "flood", A6)
        _reg(farm, "late", A7)
        floods = [farm.submit("flood", rhs6 * (1.0 + k), block=True)
                  for k in range(10)]
        late = farm.submit("late", rhs7, block=True)
        for tag, fut in [("flood%d" % k, f) for k, f in enumerate(floods)] \
                + [("late", late)]:
            fut.add_done_callback(lambda _f, tag=tag: order.append(tag))
        for f in floods + [late]:
            f.result(timeout=300)
        assert order.index("late") < order.index("flood9"), order
    finally:
        farm.close()


def test_concurrent_submit_stress():
    """Three tenants submitting from concurrent threads: every answer is
    its tenant's direct solve scaled, no request is lost."""
    farm = _farm(batch=4, flush_ms=5)
    tenants = {}
    try:
        for k, m in enumerate((6, 7, 8)):
            A, rhs = T.poisson3d(m)
            name = "t%d" % k
            _reg(farm, name, A, solver=_cg())
            xd, _ = T.make_solver(A, _prm(), _cg(), **CPU)(rhs)
            tenants[name] = (rhs, xd.numpy())
        reqs = 6
        results, errs = {}, []

        def feeder(name):
            rhs, _xd = tenants[name]
            try:
                futs = [farm.submit(name, rhs * (1.0 + 0.5 * k), block=True)
                        for k in range(reqs)]
                results[name] = [f.result(timeout=300) for f in futs]
            except Exception as e:      # noqa: BLE001 — surfaced below
                errs.append((name, e))

        threads = [threading.Thread(target=feeder, args=(n,))
                   for n in tenants]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        assert not errs, errs
        for name, (rhs, xd) in tenants.items():
            assert len(results[name]) == reqs
            for k, (x, rep) in enumerate(results[name]):
                np.testing.assert_allclose(x.numpy(), (1.0 + 0.5 * k) * xd,
                                           rtol=1e-4, atol=1e-5)
                assert rep.health is None or rep.health["ok"]
        assert farm.stats()["requests"] == 3 * reqs
    finally:
        farm.close()


def test_setup_never_runs_beside_a_capture():
    """make_solver's construction and rebuild hold the capture lock
    (torch refuses a pageable host-to-device copy in one thread while
    another captures a CUDA graph): a registration's setup in the
    caller's thread waits for a bucket capture in the dispatch thread to
    end, here stood for by the lock held in this thread."""
    from amgcl_tpu_torch.serve.batched import CAPTURE_LOCK
    A, _ = T.poisson3d(6)
    done = []
    for step in ("build", "rebuild"):
        with CAPTURE_LOCK:
            th = threading.Thread(target=lambda: done.append(
                T.make_solver(A, _prm(), _cg(), **CPU) if step == "build"
                else done[0].rebuild(_scaled(A, 2.0))))
            th.start()
            th.join(timeout=0.5)
            assert th.is_alive() and len(done) == (step == "rebuild")
        th.join(timeout=120)
        assert not th.is_alive() and len(done) == 1 + (step == "rebuild")


def test_worker_death_fails_futures_and_restarts():
    """The dispatch thread dying after it popped a batch (where the JAX
    package's worker fault seam fires) fails that batch's public futures
    with WorkerDiedError; the supervisor restarts the worker, which
    serves the next request."""
    from amgcl_tpu_torch.faults import WorkerDiedError
    A, rhs = T.poisson3d(6)
    farm = _farm()
    try:
        _reg(farm, "t", A)
        real = farm._next_batch
        calls = []

        def dying():
            batch, entry = real()
            calls.append(batch)
            if len(calls) == 1 and batch:
                farm._inflight_reqs = batch
                raise WorkerDiedError("dispatch lost")
            return batch, entry

        farm._next_batch = dying
        fut = farm.submit("t", rhs)
        with pytest.raises(WorkerDiedError):
            fut.result(timeout=120)
        assert farm.solve("t", rhs)[1].resid < 1e-6
        rec = farm.stats()["recovery"]
        assert rec["worker_deaths"] == 1 and rec["worker_restarts"] == 1
    finally:
        farm.close()


# ---------------------------------------------------------------------------
# observability (tests/test_farm.py:713-760)
# ---------------------------------------------------------------------------

def test_farm_metrics_endpoint_tenant_labels():
    A, rhs = T.poisson3d(6)
    farm = _farm(metrics_port=0)
    try:
        _reg(farm, "acct-a", A)
        farm.solve("acct-a", rhs)
        farm.start()
        url = farm.metrics_url
        assert url
        text = urllib.request.urlopen(url, timeout=10).read().decode()
        assert 'amgcl_torch_farm_tenant_requests_total{tenant="acct-a"} 1' \
            in text
        assert 'amgcl_torch_farm_tenant_resident{tenant="acct-a"} 1.0' \
            in text
        assert 'amgcl_torch_farm_tenant_bytes{tenant="acct-a"}' in text
        assert "amgcl_torch_farm_hbm_used_bytes" in text
        assert "amgcl_torch_farm_registry_misses_total 1" in text
        h = json.loads(urllib.request.urlopen(
            url.replace("/metrics", "/healthz"), timeout=10).read())
        assert h["ok"] and h["tenants"] == 1
        assert farm.stats()["metrics_port"] == farm.metrics_server.port
    finally:
        farm.close()


def test_labeled_gauges_declared_as_in_jax():
    """The farm's and the storm's metric rows and label keys are the JAX
    package's; the registry refuses an undeclared label key."""
    from amgcl_tpu.telemetry import live as ref_live
    from amgcl_tpu_torch.telemetry.live import (METRIC_LABELS, METRICS,
                                                LiveRegistry)
    farm_rows = {k for k in ref_live.METRICS
                 if k.startswith(("farm_", "storm_"))}
    assert farm_rows <= set(METRICS)
    assert all(METRICS[k][0] == ref_live.METRICS[k][0] for k in farm_rows)
    assert {k: v for k, v in ref_live.METRIC_LABELS.items()
            if k in farm_rows} == {k: v for k, v in METRIC_LABELS.items()
                                   if k in farm_rows}
    assert set(METRIC_LABELS) <= set(METRICS)
    reg = LiveRegistry()
    with pytest.raises(KeyError):
        reg.inc("farm_tenant_requests_total", shard="x")
    with pytest.raises(KeyError):
        reg.set_gauge("farm_hbm_used_bytes", 1, tenant="a")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the farm's buckets are CUDA graphs "
                    "of the hand-written kernels only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_release_returns_the_charge(cuda):
    """On the card a release frees at least 90% of the bytes the farm
    charged (the hierarchy, the plans' device copies, the bucket graph),
    and the readmitted operator with its graph recaptured comes back to
    within 10% of the memory it held; x is equal bit for bit."""
    A, rhs = T.poisson3d(32)
    farm = _farm(metrics_port=-9)
    try:
        farm.register("t", A, solver=_cg(), precond=_prm())
        x1, _ = farm.solve("t", rhs)
        charge = farm.pool.resident()[farm.tenants["t"].entry.uid]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        assert farm.evict("t")
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        assert before - after >= 0.9 * charge, (before, after, charge)
        x2, _ = farm.solve("t", rhs)
        torch.cuda.synchronize()
        back = torch.cuda.memory_allocated()
        assert abs(back - before) <= 0.1 * before, (back, before)
        assert torch.equal(x1, x2)
        st = farm.stats()
        assert st["readmissions"] == 1 and st["registry"]["misses"] == 1
    finally:
        farm.close()


@pytest.mark.cuda
def test_cuda_capture_beside_a_setup(cuda):
    """The dispatch thread captures bucket graphs (buckets 1, 2 and 4)
    while the caller's thread runs a fresh setup on the card: every
    answer equals the same request's answer with the card to itself."""
    A, rhs = T.poisson3d(24)
    B_, rhsB = T.poisson3d(40)
    R = np.random.default_rng(3).standard_normal((A.nrows, 7))
    want = T.make_solver(A, _prm(), _cg())
    ref = [want(R[:, k])[0] for k in range(7)]
    farm = _farm(batch=4, flush_ms=1, metrics_port=-9)
    try:
        farm.register("a", A, solver=_cg(), precond=_prm())
        futs = []
        done = threading.Event()

        def feed():
            for group in ((0,), (1, 2), (3, 4, 5, 6)):
                futs.extend(farm.submit("a", R[:, k]) for k in group)
                time.sleep(0.01)
            done.set()

        th = threading.Thread(target=feed)
        th.start()
        out = farm.register("b", B_, solver=_cg(), precond=_prm())
        th.join(timeout=300)
        assert done.is_set() and out["outcome"] == "miss"
        got = [f.result(timeout=300) for f in futs]
        for k, (x, rep) in enumerate(got):
            assert rep.resid < 1e-6
            np.testing.assert_allclose(x.cpu().numpy(),
                                       ref[k].cpu().numpy(), rtol=1e-4,
                                       atol=1e-6)
        assert farm.solve("b", rhsB)[1].resid < 1e-6
        pre = farm.tenants["a"].entry.obj.stacked_precond()
        assert pre.lowering == "per-column-graph" and pre.captures
    finally:
        farm.close()
