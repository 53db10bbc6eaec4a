"""Multi-tenant solver farm: many operators on one device, SLOs held
(counterpart of ``amgcl_tpu/serve/farm.py``).

A :class:`~amgcl_tpu_torch.serve.service.SolverService` serves one
operator; :class:`SolverFarm` multiplexes many tenants with different
matrices over one card out of four pieces:

* **the operator registry** (``serve/registry.py``) — hierarchies cached
  by sparsity fingerprint: a tenant registering a same-sparsity matrix
  gets the cached hierarchy refreshed by ``rebuild()`` (the kept plans,
  no aggregation, no symbolic pass) instead of a fresh setup, and a
  bit-identical matrix shares the resident hierarchy outright.
* **admission and eviction** — a farm-wide
  :class:`~amgcl_tpu_torch.telemetry.ledger.LruMemoryPool` over the
  resident hierarchies, ``AMG.bytes()`` the unit of a charge. Admission
  under ``max_bytes`` evicts the least recently dispatched operator first
  (``SolverService.release_device()``: the buckets' CUDA graphs with
  their buffers and pools, the device operators and the hierarchy; the
  host CSR and the plans are kept), so readmission is a rebuild, not a
  setup. Readmission makes room for the operator's last charged
  footprint before it rebuilds, and victim selection skips (waits out)
  operators pinned by an in-flight batch.
* **cross-tenant packing** — each operator keeps one unstarted
  ``SolverService`` whose ``_run_batch`` the farm's single dispatch
  thread drives: requests of every tenant sharing an operator pack into
  the same power-of-two (n, B) buckets (O(log B) graphs a shape, however
  many tenants), and a fair-share round robin over the bounded
  per-tenant queues bounds any tenant's wait at one batch per peer with
  work.
* **per-tenant observability** — tenant-labelled counters and gauges on
  the farm's :class:`~amgcl_tpu_torch.telemetry.live.LiveRegistry`
  (``/metrics`` and ``/healthz`` with ``metrics_port``), a per-tenant
  SLO window (the serve watchdog's thresholds, overridable per tenant at
  ``register()``) whose trips carry ``telemetry.health.serve_findings``,
  and per-tenant rows in :meth:`SolverFarm.stats`.

The JAX package's environment knobs are keywords here, with its
defaults: ``max_bytes`` (``AMGCL_TPU_FARM_MAX_BYTES``, 0 = unlimited),
``queue_max`` (``AMGCL_TPU_FARM_QUEUE_MAX``, 256), ``metrics_port``
(``AMGCL_TPU_FARM_METRICS_PORT``: None = no server, 0 = ephemeral,
negative = off), ``headroom`` (``AMGCL_TPU_FARM_HEADROOM``, "model"),
``shed_breaches`` (0) and ``shed_cooldown_s`` (5), ``retry_max`` (0),
``retry_backoff_ms`` (50) and ``retry_jitter`` (0.1),
``worker_restart_max`` (2), and the serve knobs ``batch`` (8),
``flush_ms`` (50), ``timeout_s`` (30), ``slo_p99_ms`` (0, off),
``slo_timeout_rate`` (0.01), ``slo_unhealthy_rate`` (0.05) and
``slo_window`` (256). ``headroom="measured"`` (charges checked against
the memory watch), the fault-injection seams, the flight recorder, the
memory snapshots and ``diagnose(farm=...)`` are ROADMAP A.13.
"""

from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from amgcl_tpu_torch import faults as _faults
from amgcl_tpu_torch.faults import (AdmissionError, AllocationError,
                                    LoadShedError, WorkerDiedError)
from amgcl_tpu_torch.serve.registry import (OperatorRegistry, RegistryEntry,
                                            sparsity_fingerprint,
                                            stable_config_key)
from amgcl_tpu_torch.serve.service import SolverService, _Request
from amgcl_tpu_torch.telemetry import health as _health
from amgcl_tpu_torch.telemetry import metrics as _metrics
from amgcl_tpu_torch.telemetry import sink as _sink
from amgcl_tpu_torch.telemetry.ledger import LruMemoryPool
from amgcl_tpu_torch.telemetry.live import LiveRegistry, MetricsServer


#: the declared lock order of the farm's control plane: an edge (A, B)
#: permits taking B while A is held. ``_mem_cond`` rides ``_mem_lock``
#: (the same RLock) and needs no edge. Admission and registration call
#: into the operator registry under ``_mem_lock``, and the registry calls
#: the farm's ``rebuild_ok`` guard (which reads the tenant table under
#: ``_cond``) while holding its own lock.
LOCK_ORDER = (
    ("_mem_lock", "_cond"),
    ("_mem_lock", "registry._lock"),
    ("registry._lock", "_cond"),
)

#: fields read outside their guard on purpose, and why each is safe
UNGUARDED_OK = {
    "_thread": "liveness reads (healthz, the submit revival check); "
               "every write runs under _cond",
    "_stop": "the dispatch thread polls the flag at its loop exits; "
             "every write runs under _cond, a stale read costs one "
             "0.1 s pick tick",
    "_n_evictions": "a monotonic int read by /healthz; increments run "
                    "under _mem_lock",
    "tenants": "point reads of a dict row replaced atomically on the "
               "dispatch and accounting path; a batch is validated again "
               "under _mem_lock (_validate_batch_locked), and every "
               "write runs under _cond",
}


class _NeedsBuild(Exception):
    """The registry took the miss path but the setup has not been paid
    yet: register() catches it, builds outside the farm's locks, and
    acquires again."""


class _FarmRequest(_Request):
    """A service request with its tenant and a public future.
    ``_run_batch`` resolves the inner ``future``; the farm moves its
    result onto ``public`` only after its per-tenant accounting, so a
    caller who sees its future done reads stats that include its batch."""
    __slots__ = ("tenant", "public")

    def __init__(self, rhs, timeout_s, x0=None, rid=0, tenant=""):
        super().__init__(rhs, timeout_s, x0=x0, rid=rid)
        self.tenant = tenant
        self.public = Future()


class _Tenant:
    """Per-tenant state: the registry entry it maps onto, its bounded
    request queue, lifetime counters and the rolling SLO window."""

    def __init__(self, name: str, entry: RegistryEntry, queue_max: int,
                 slo: Dict[str, float], slo_window: int):
        self.name = name
        self.entry = entry
        self.queue_max = int(queue_max)
        self.q: deque = deque()
        self.n_requests = 0
        self.n_timeouts = 0
        self.n_unhealthy = 0
        self.slo = dict(slo)
        self.slo_window = int(slo_window)
        self.win: deque = deque(maxlen=max(self.slo_window, 8))
        self.lat: deque = deque(maxlen=2048)
        self.slo_trips = 0
        self._slo_active: set = set()
        self.outcome = None           # the last register() outcome
        #: consecutive tripped evaluations: at ``shed_breaches`` the
        #: tenant sheds load (a typed reject) until the cooldown passes
        self.breaches = 0
        self.shed_until = 0.0         # monotonic deadline, 0 = serving


class SolverFarm:
    """N tenants, one device: registry-cached hierarchies, an LRU memory
    pool, cross-tenant bucket packing, per-tenant SLOs::

        farm = SolverFarm(max_bytes=2 << 30)
        farm.register("acct-1", A1)            # miss: fresh setup
        farm.register("acct-2", A1)            # hit: shared hierarchy
        farm.register("acct-1", A1_next_step)  # rebuild: plan reuse
        fut = farm.submit("acct-1", rhs)
        x, report = fut.result()
        farm.stats()["tenants"]                # per-tenant rows
        farm.close()                           # or a context manager

    (Another tenant registering same-sparsity data with other values is
    a deliberate miss: the registry never rebuilds a live co-owner's
    hierarchy under it.)"""

    def __init__(self, max_bytes: int = 0, batch: int = 8,
                 flush_ms: float = 50.0, timeout_s: float = 30.0,
                 queue_max: int = 256, metrics_port: Optional[int] = None,
                 registry: Optional[OperatorRegistry] = None,
                 slo_p99_ms: float = 0.0, slo_timeout_rate: float = 0.01,
                 slo_unhealthy_rate: float = 0.05, slo_window: int = 256,
                 headroom: str = "model", shed_breaches: int = 0,
                 shed_cooldown_s: float = 5.0, retry_max: int = 0,
                 retry_backoff_ms: float = 50.0, retry_jitter: float = 0.1,
                 worker_restart_max: int = 2):
        if headroom == "measured":
            raise NotImplementedError(
                "headroom='measured' checks each charge against the memory "
                "watch, which is not ported yet (ROADMAP A.13); use "
                "headroom='model'")
        if headroom != "model":
            raise ValueError("headroom must be 'model' or 'measured', got "
                             "%r" % (headroom,))
        self.headroom = headroom
        self.pool = LruMemoryPool(max_bytes or 0, name="farm_hbm")
        self.registry = registry or OperatorRegistry()
        self.batch = int(batch)
        self.flush_s = float(flush_ms) / 1e3
        self.timeout_s = float(timeout_s)
        self.queue_max = int(queue_max)
        #: the farm's SLO thresholds; per-tenant overrides at register()
        self.slo_defaults = {"p99_ms": float(slo_p99_ms),
                             "timeout_rate": float(slo_timeout_rate),
                             "unhealthy_rate": float(slo_unhealthy_rate)}
        self.slo_window = int(slo_window)
        self.tenants: Dict[str, _Tenant] = {}
        self.live = LiveRegistry()
        self.metrics_port = None if (metrics_port is not None
                                     and metrics_port < 0) else metrics_port
        self.metrics_server: Optional[MetricsServer] = None
        self._cond = threading.Condition()
        #: guards the pool, residency changes and the pin table. Solves
        #: do not run under it: the dispatch loop pins the entry under
        #: the lock, releases it and runs the batch; eviction,
        #: set_max_bytes and the registry's rebuild path all skip pinned
        #: entries, so the control plane never waits behind a solve and
        #: never frees or mutates the buffers a batch runs on
        self._mem_lock = threading.RLock()
        #: signalled at every unpin: admission waiting on a victim that
        #: is mid-batch waits here instead of failing
        self._mem_cond = threading.Condition(self._mem_lock)
        #: uid -> in-flight batch count (under _mem_lock)
        self._pins: Dict[str, int] = {}
        #: uid -> admissions in progress: an entry whose charge or
        #: readmission is mid-flight (its waits drop _mem_lock) is no
        #: eviction victim for a concurrent admission
        self._admitting: Dict[str, int] = {}
        #: uid -> bytes at the last charge: what readmission makes room
        #: for before it rebuilds, so a tight budget is not overshot by
        #: victim plus newcomer
        self._bytes_hint: Dict[str, int] = {}
        self._rid = itertools.count(1)
        self._rr = 0                  # the fair-share rotation cursor
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._closed = False
        self._n_batches = 0
        self._n_evictions = 0
        self._n_readmissions = 0
        self._retry_max = max(int(retry_max), 0)
        self._retry_backoff_ms = float(retry_backoff_ms)
        self._retry_jitter = float(retry_jitter)
        self._shed_breaches = int(shed_breaches)
        self._shed_cooldown = float(shed_cooldown_s)
        self._restart_max = int(worker_restart_max)
        self._worker_restarts = 0
        self._n_worker_deaths = 0
        self._n_shed = 0
        #: the batch popped off the queues but not yet accounted: what
        #: the supervisor fails if the dispatch thread dies
        self._inflight_reqs: List[_FarmRequest] = []

    # -- registration ---------------------------------------------------------

    def register(self, tenant: str, A, solver=None, precond=None,
                 slo: Optional[Dict[str, float]] = None,
                 slo_window: Optional[int] = None,
                 queue_max: Optional[int] = None,
                 device=None) -> Dict[str, Any]:
        """Register (or re-register) ``tenant`` with operator ``A`` (CSR
        or scipy). ``solver`` and ``precond`` default to
        ``CG(maxiter=200, tol=1e-8)`` and ``AMGParams()`` (float32);
        ``slo`` overrides the farm's watchdog thresholds for this tenant
        (partial dicts merge over them); ``device`` goes to
        ``make_solver`` (None: CUDA).

        Routed through the operator registry: a bit-identical matrix
        under the same config shares the resident hierarchy ("hit"), a
        same-sparsity value update by this tenant refreshes it through
        the numeric ``rebuild()`` ("rebuild"), anything else pays one
        fresh setup ("miss"), outside the farm's locks — then the
        hierarchy is admitted against the byte budget, evicting the
        coldest resident operators as needed. Returns {tenant, outcome,
        fingerprint, uid, bytes, setup_s[, rebuild_s]}."""
        from amgcl_tpu_torch.models.amg import AMGParams
        from amgcl_tpu_torch.models.make_solver import make_solver
        from amgcl_tpu_torch.ops.csr import CSR
        from amgcl_tpu_torch.solver.cg import CG
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        solver_obj = solver if solver is not None \
            else CG(maxiter=200, tol=1e-8)
        prm = precond if precond is not None else AMGParams()
        cfg_key = stable_config_key(solver_obj, prm)

        def build(Ah):
            return make_solver(Ah, prm, solver_obj, device=device)

        if self._closed:            # early, checked again under the lock
            raise RuntimeError("SolverFarm is closed")
        rebuild_ok = self._rebuild_guard(tenant)
        prebuilt: List[Any] = [None]     # a cell shared with build_fn

        def build_fn(Ah):
            # acquire calls this only on a miss: the first attempt raises,
            # register() pays the setup outside the farm's and the
            # registry's locks and acquires again with the bundle in hand,
            # so a large registration never stalls other tenants' dispatch
            # and a racing registration cannot turn it into a build under
            # the lock
            if prebuilt[0] is None:
                raise _NeedsBuild
            return prebuilt[0]

        #: (public future, exception) pairs the locked paths fail, resolved
        #: in the finally below once every lock is dropped (a done
        #: callback must never run under the control plane's locks)
        deferred: List[Any] = []
        try:
            return self._register_inner(tenant, A, cfg_key, build, build_fn,
                                        rebuild_ok, prebuilt, slo,
                                        slo_window, queue_max, deferred)
        finally:
            for fut, err in deferred:
                if not fut.done():
                    fut.set_exception(err)

    def _register_inner(self, tenant, A, cfg_key, build, build_fn,
                        rebuild_ok, prebuilt, slo, slo_window, queue_max,
                        deferred) -> Dict[str, Any]:
        """The lock-taking half of :meth:`register`: the acquire-retry
        loop. The miss path's build outside the locks publishes the
        bundle through ``prebuilt`` before acquiring again."""
        from amgcl_tpu_torch.ops.csr import CSR
        while True:
            with self._mem_lock:
                if self._closed:
                    raise RuntimeError("SolverFarm is closed")
                # a time-stepped re-register keeps the rebuild path while
                # its own batch is in flight: wait the pin out (one batch)
                # rather than let the guard veto it into a fresh setup
                self._await_rebuild_target_unpinned_locked(tenant, A,
                                                           cfg_key)
                # the would-be rebuild target's current matrix: acquire's
                # rebuild mutates the entry in place, and a failed
                # admission must revert it
                revert_csr = None
                with self._cond:
                    trow = self.tenants.get(tenant)
                if trow is not None \
                        and trow.entry.fingerprint == sparsity_fingerprint(A) \
                        and trow.entry.config_key == cfg_key:
                    host = getattr(trow.entry.obj, "A_host", None)
                    if host is not None:
                        # from the entry's value snapshot, never the host
                        # matrix's .val: under the in-place mutation idiom
                        # the host matrix is the caller's object and holds
                        # the new values already
                        revert_csr = CSR(host.ptr, host.col,
                                         trow.entry.A_val, host.ncols)
                    if trow.entry.uid not in self.pool.resident():
                        # a rebuild of an evicted entry materializes the
                        # hierarchy inside acquire: make room for its last
                        # footprint first, as readmission does
                        self._make_room_locked(
                            self._bytes_hint.get(trow.entry.uid, 0),
                            exclude=(trow.entry.uid,))
                # the tenant's previous ownership is released only after
                # the new entry is installed (release(keep=) under
                # _mem_lock): an ownerless entry is a rebuild target for
                # any concurrent same-pattern registration
                try:
                    entry, outcome = self.registry.acquire(
                        tenant, A, build_fn, config_key=cfg_key,
                        rebuild_ok=rebuild_ok)
                except _NeedsBuild:
                    pass             # built below, outside the locks
                else:
                    return self._install_tenant_locked(
                        tenant, entry, outcome, slo, slo_window, queue_max,
                        revert_csr, deferred)
            # the miss path's setup, outside the locks (the bundle is
            # private until the next acquire publishes it). A first-time
            # operator's footprint is unknown until it is built, so this
            # transient overshoot is accepted; readmission makes room
            # first instead (_readmit_locked)
            prebuilt[0] = build(A)

    def _install_tenant_locked(self, tenant: str, entry: RegistryEntry,
                               outcome: str,
                               slo: Optional[Dict[str, float]],
                               slo_window: Optional[int],
                               queue_max: Optional[int],
                               revert_csr, deferred: List[Any]
                               ) -> Dict[str, Any]:
        """The locked tail of :meth:`register`: admit the acquired entry
        against the budget, install the tenant row, release the previous
        entry's ownership and publish counters and gauges."""
        if "service" not in entry.payload:
            # the operator's resident program: the farm drives _run_batch
            # from its own dispatch thread, so the service is never
            # started, and its own watchdog never trips (the farm's
            # per-tenant windows are the only source)
            entry.payload["service"] = SolverService(
                entry.obj, batch=self.batch, flush_ms=self.flush_s * 1e3,
                timeout_s=self.timeout_s, metrics_port=-9,
                slo_p99_ms=0.0, slo_timeout_rate=1.0,
                slo_unhealthy_rate=1.0)
        try:
            if entry.obj.A_dev is None:
                # an evicted cache entry acquired ("hit" on equal values):
                # readmit it, making room for its last footprint first
                self._readmit_locked(entry)
            else:
                self._charge_locked(entry)
            if self._closed:
                # the admission waits drop _mem_lock: close() may have
                # finished meanwhile
                raise RuntimeError("SolverFarm is closed")
        except Exception:
            self._rollback_admission_locked(tenant, entry, outcome,
                                            revert_csr, deferred)
            raise
        merged_slo = dict(self.slo_defaults, **(slo or {}))
        t = _Tenant(tenant, entry, queue_max or self.queue_max, merged_slo,
                    slo_window or self.slo_window)
        t.outcome = outcome
        stranded: List[_FarmRequest] = []
        old_n = new_n = entry.payload["service"].n
        with self._cond:
            prev = self.tenants.get(tenant)
            if prev is not None:
                t.n_requests = prev.n_requests
                t.n_timeouts = prev.n_timeouts
                t.n_unhealthy = prev.n_unhealthy
                t.slo_trips = prev.slo_trips
                t.lat = prev.lat
                old_n = prev.entry.payload["service"].n
                if old_n == new_n:
                    t.q = prev.q        # queued work carries over
                else:
                    # queued rhs were checked against the old size
                    while prev.q:
                        stranded.append(prev.q.popleft())
            self.tenants[tenant] = t
            self._cond.notify_all()
        # only now drop the tenant's ownership of its previous entry
        self.registry.release(tenant, keep=entry)
        # entries the registry no longer holds (a max_orphans registry
        # prunes on release): drop their hints and their pool charges
        live_uids = {e.uid for e in self.registry.entries()}
        swept = False
        for uid in list(self._bytes_hint):
            if uid not in live_uids:
                self._bytes_hint.pop(uid, None)
                swept = self.pool.release(uid) > 0 or swept
        if swept:
            self.live.set_gauge("farm_hbm_used_bytes", self.pool.used)
            self.live.set_gauge("farm_resident_operators",
                                len(self.pool.resident()))
        for req in stranded:
            deferred.append((req.public, RuntimeError(
                "tenant %r re-registered with a different system size "
                "(%d -> %d) while this request was queued"
                % (tenant, old_n, new_n))))
        if outcome == "hit":
            self.live.inc("farm_registry_hits_total")
        elif outcome == "miss":
            self.live.inc("farm_registry_misses_total")
        else:
            self.live.inc("farm_registry_rebuilds_total")
        self.live.set_gauge("farm_tenants", len(self.tenants))
        self.live.set_gauge("farm_tenant_queue_depth", len(t.q),
                            tenant=tenant)
        self.live.set_gauge(
            "farm_tenant_resident",
            1.0 if entry.uid in self.pool.resident() else 0.0,
            tenant=tenant)
        self.live.set_gauge("farm_tenant_bytes",
                            self.pool.resident().get(entry.uid, 0),
                            tenant=tenant)
        out = {"tenant": tenant, "outcome": outcome,
               "fingerprint": entry.fingerprint, "uid": entry.uid,
               "bytes": self.pool.resident().get(entry.uid, 0),
               "setup_s": round(entry.setup_s, 4)}
        if entry.rebuild_s is not None:
            out["rebuild_s"] = round(entry.rebuild_s, 4)
        if _sink.sink_attached():
            _sink.emit(event="farm_register", **out)
        return out

    # -- admission and eviction -----------------------------------------------

    def _entry_bytes(self, entry: RegistryEntry) -> int:
        amg = getattr(entry.obj, "precond", None)
        fn = getattr(amg, "bytes", None)
        return int(fn()) if callable(fn) else 0

    def _await_rebuild_target_unpinned_locked(self, tenant: str, A,
                                              cfg_key: str) -> None:
        """Wait (under _mem_lock) until the tenant's current entry is
        unpinned, but only when the coming acquire would rebuild it (same
        pattern and config, other values); a hit or a miss needs no
        unpin. Resolves the entry again after every wait."""
        fp = sparsity_fingerprint(A)
        while True:
            if self._closed:
                raise RuntimeError("SolverFarm is closed")
            with self._cond:
                t = self.tenants.get(tenant)
                entry = t.entry if t is not None else None
            if entry is None or entry.uid not in self._pins \
                    or entry.fingerprint != fp \
                    or entry.config_key != cfg_key \
                    or not entry.owners <= {tenant} \
                    or np.array_equal(entry.A_val, np.asarray(A.val)):
                return
            self._mem_cond.wait(timeout=0.5)

    def _rebuild_guard(self, tenant: str):
        """The ``rebuild_ok`` predicate of this tenant's registry calls:
        vetoes rebuilding an entry an in-flight batch is pinned on, or
        that another live tenant still references."""
        def ok(entry: RegistryEntry) -> bool:
            if entry.uid in self._pins:
                return False
            with self._cond:
                return not any(t.entry is entry and name != tenant
                               for name, t in self.tenants.items())
        return ok

    def _evict_coldest_locked(self, exclude=()) -> bool:
        """One step of the evict-or-wait protocol of admission, making
        room and resizing: evict the coldest victim outside ``exclude``
        that is neither pinned nor mid-admission and return True; when
        only pinned victims remain, wait for an unpin and return True so
        the caller tries again; False when nothing is evictable
        (mid-admission victims are skipped, not waited on, so two tight
        admissions fail rather than wait on each other)."""
        victim = self.pool.coldest(
            exclude=tuple(exclude) + tuple(self._pins)
            + tuple(self._admitting))
        if victim is not None:
            self._evict_uid_locked(victim)
            return True
        if self._pins:
            self._mem_cond.wait(timeout=0.5)
            return True
        return False

    def _admit_begin_locked(self, uid: str) -> None:
        self._admitting[uid] = self._admitting.get(uid, 0) + 1

    def _admit_end_locked(self, uid: str) -> None:
        left = self._admitting.get(uid, 1) - 1
        if left > 0:
            self._admitting[uid] = left
        else:
            self._admitting.pop(uid, None)
        self._mem_cond.notify_all()

    def _charge_locked(self, entry: RegistryEntry) -> None:
        """Admit ``entry`` against the pool: evict the coldest victims
        while the charge is refused; when nothing is evictable, back off
        and try again up to ``retry_max`` times (a pinned victim may
        unpin meanwhile) before raising :class:`AdmissionError`."""
        nbytes = self._entry_bytes(entry)
        self._bytes_hint[entry.uid] = nbytes
        self._admit_begin_locked(entry.uid)
        tries = 0
        try:
            while not self.pool.charge(entry.uid, nbytes):
                if self._evict_coldest_locked(exclude=(entry.uid,)):
                    continue
                tries += 1
                if tries > self._retry_max:
                    raise AdmissionError(
                        "operator %s needs %d bytes but the farm budget is "
                        "%d and nothing else is evictable%s — raise the "
                        "farm's max_bytes" % (
                            entry.uid, nbytes, self.pool.total,
                            " after %d backoff retr%s" % (
                                tries - 1, "y" if tries == 2 else "ies")
                            if tries > 1 else ""))
                self.live.inc("recovery_retries_total")
                self._mem_cond.wait(timeout=_faults.backoff_s(
                    tries, base_ms=self._retry_backoff_ms,
                    jitter=self._retry_jitter))
        finally:
            self._admit_end_locked(entry.uid)
        self._residency_gauges_locked(entry, resident=True, nbytes=nbytes)

    def _make_room_locked(self, need: int, exclude=()) -> None:
        """Evict coldest victims until ``need`` bytes fit, before the
        caller materializes them. Best effort: the caller's charge loop
        decides when nothing unpinned is evictable."""
        if self.pool.unlimited or need <= 0:
            return
        while self.pool.used + need > self.pool.total:
            if not self._evict_coldest_locked(exclude=exclude):
                return

    def _rollback_admission_locked(self, tenant: str, entry: RegistryEntry,
                                   outcome: str, revert_csr,
                                   deferred: List[Any]) -> None:
        """Undo a register() whose admission failed (or that lost a race
        with close()): an entry acquire rebuilt in place goes back to the
        snapshotted matrix; otherwise the would-be ownership is dropped
        and, when nothing else references the entry, its charge and
        device state too. Never raises."""
        try:
            with self._cond:
                row = self.tenants.get(tenant)
            if row is not None and row.entry is entry:
                if outcome == "rebuild" and revert_csr is not None:
                    while entry.uid in self._pins:
                        self._mem_cond.wait(timeout=0.5)
                    try:
                        entry.obj.rebuild(revert_csr)
                        entry.A_val = np.array(revert_csr.val, copy=True)
                    except Exception:   # noqa: BLE001
                        # the revert failed too: the values are unknown,
                        # so strand the tenant rather than serve them
                        self._strand_tenant_locked(tenant, entry, deferred)
                        raise
                if entry.uid not in self.pool.resident() \
                        and getattr(entry.obj, "A_dev", None) is not None:
                    # device state the pool has no room for (a hit's
                    # readmission, or the revert above): drop it again;
                    # the next dispatch readmits by a rebuild
                    svc = entry.payload.get("service")
                    if svc is not None:
                        svc.release_device()
                return
            self.registry.disown(tenant, entry)
            with self._cond:
                referenced = any(t.entry is entry
                                 for t in self.tenants.values())
            if entry.owners or referenced or entry.uid in self._pins:
                return            # shared: its residency stays
            self.pool.release(entry.uid)
            svc = entry.payload.get("service")
            if svc is not None:
                svc.release_device()
            self._residency_gauges_locked(entry, resident=False, nbytes=0)
        except Exception:          # noqa: BLE001 — must not mask the error
            traceback.print_exc()

    def _strand_tenant_locked(self, tenant: str, entry: RegistryEntry,
                              deferred: List[Any]) -> None:
        """Last resort when a rollback cannot restore a coherent operator:
        remove the tenant row, fail its queued requests (through
        ``deferred``), drop the entry's ownership, charge and device
        state, and poison its value snapshot so no equal-values
        registration hits it again."""
        stranded: List[_FarmRequest] = []
        with self._cond:
            row = self.tenants.get(tenant)
            if row is not None and row.entry is entry:
                del self.tenants[tenant]
                while row.q:
                    stranded.append(row.q.popleft())
            self._cond.notify_all()
        for req in stranded:
            deferred.append((req.public, RuntimeError(
                "tenant %r was stranded by a failed registration rollback "
                "— re-register it" % (tenant,))))
        self.registry.disown(tenant, entry)
        entry.A_val = np.empty(0)      # never value-matches again
        self.pool.release(entry.uid)
        svc = entry.payload.get("service")
        try:
            if svc is not None:
                svc.release_device()
        except Exception:              # noqa: BLE001 — best effort on a
            pass                       # device that is failing already
        self._residency_gauges_locked(entry, resident=False, nbytes=0)
        self.live.set_gauge("farm_tenants", len(self.tenants))

    def _readmit_locked(self, entry: RegistryEntry) -> None:
        """Materialize an evicted entry again: make room for its last
        charged footprint, rebuild on the kept plans (counted as a
        rebuild, never a setup), then charge the actual bytes."""
        self._admit_begin_locked(entry.uid)
        try:
            self._readmit_admitting_locked(entry)
        finally:
            self._admit_end_locked(entry.uid)

    def _readmit_admitting_locked(self, entry: RegistryEntry) -> None:
        self._make_room_locked(self._bytes_hint.get(entry.uid, 0),
                               exclude=(entry.uid,))
        if entry.uid in self.pool.resident():
            # the waits above drop _mem_lock: a dispatch readmission may
            # have got here first and be mid-batch on the entry
            self.pool.touch(entry.uid)
            return
        t0 = time.perf_counter()
        entry.payload["service"].readmit()
        self.registry.note_rebuild(entry, time.perf_counter() - t0)
        self._n_readmissions += 1
        self.live.inc("farm_readmissions_total")
        try:
            self._charge_locked(entry)
        except Exception:
            # admission failed after the rebuild: drop the uncharged
            # device state (the host plans keep the values)
            svc = entry.payload.get("service")
            try:
                if svc is not None:
                    svc.release_device()
            except Exception:          # noqa: BLE001 — must not mask the
                pass                   # admission error
            raise

    def _entry_by_uid(self, uid: str) -> Optional[RegistryEntry]:
        for e in self.registry.entries():
            if e.uid == uid:
                return e
        return None

    def _evict_uid_locked(self, uid: str) -> None:
        entry = self._entry_by_uid(uid)
        if entry is not None:
            svc = entry.payload.get("service")
            if svc is not None:
                svc.release_device()
            else:
                rel = getattr(entry.obj, "release_device", None)
                if callable(rel):
                    rel()
        self.pool.release(uid)
        self._n_evictions += 1
        self.live.inc("farm_evictions_total")
        if entry is not None:
            self._residency_gauges_locked(entry, resident=False, nbytes=0)
        if _sink.sink_attached():
            _sink.emit(event="farm_evict", uid=uid, pool_used=self.pool.used)

    def _residency_gauges_locked(self, entry: RegistryEntry, resident: bool,
                                 nbytes: int) -> None:
        self.live.set_gauge("farm_hbm_used_bytes", self.pool.used)
        self.live.set_gauge("farm_hbm_total_bytes",
                            0 if self.pool.unlimited else self.pool.total)
        self.live.set_gauge("farm_resident_operators",
                            len(self.pool.resident()))
        with self._cond:
            tenants = list(self.tenants.items())
        for name, t in tenants:
            if t.entry is entry:
                self.live.set_gauge("farm_tenant_resident",
                                    1.0 if resident else 0.0, tenant=name)
                self.live.set_gauge("farm_tenant_bytes", nbytes,
                                    tenant=name)

    def _ensure_resident_locked(self, entry: RegistryEntry) -> SolverService:
        svc = entry.payload["service"]
        if entry.uid in self.pool.resident():
            self.pool.touch(entry.uid)
            return svc
        self._readmit_locked(entry)
        return svc

    def evict(self, tenant: str) -> bool:
        """Evict ``tenant``'s operator (the device state of every tenant
        sharing it; the host CSR and plans stay, and the next dispatch
        readmits by a rebuild). Waits out a batch pinned on it. False
        when it was not resident."""
        self.tenants[tenant]          # KeyError: unknown tenant
        with self._mem_lock:
            while True:
                # resolved again after every wait: a concurrent
                # re-register may have moved the tenant onto a new entry
                with self._cond:
                    t = self.tenants.get(tenant)
                if t is None:
                    raise KeyError(tenant)
                uid = t.entry.uid
                if uid not in self._pins and uid not in self._admitting:
                    break
                self._mem_cond.wait(timeout=0.5)
            if uid not in self.pool.resident():
                return False
            self._evict_uid_locked(uid)
        return True

    def set_max_bytes(self, max_bytes: int) -> None:
        """Change the byte budget in place (0: unlimited), evicting the
        coldest operators until the resident set fits (waiting out pinned
        in-flight batches rather than evicting under them)."""
        with self._mem_lock:
            self.pool.resize(max_bytes)
            while not self.pool.unlimited \
                    and self.pool.used > self.pool.total:
                if not self._evict_coldest_locked():
                    break
            self.live.set_gauge(
                "farm_hbm_total_bytes",
                0 if self.pool.unlimited else self.pool.total)
            self.live.set_gauge("farm_hbm_used_bytes", self.pool.used)

    # -- the request path -----------------------------------------------------

    def start(self) -> "SolverFarm":
        with self._cond:
            if self._closed:
                raise RuntimeError("SolverFarm is closed")
            if self.metrics_server is None and self.metrics_port is not None:
                self.live.set_gauge("farm_tenants", len(self.tenants))
                self.live.set_gauge("farm_resident_operators",
                                    len(self.pool.resident()))
                self.metrics_server = MetricsServer(
                    self.metrics_port, self.live.prometheus,
                    self._health_json)
            if self._thread is None:
                self._stop = False
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="amgcl-farm")
                self._thread.start()
        return self

    @property
    def metrics_url(self) -> Optional[str]:
        return self.metrics_server.url if self.metrics_server else None

    def _health_json(self) -> Dict[str, Any]:
        alive = self._thread is not None and self._thread.is_alive()
        with self._mem_lock:        # residency changes under _mem_lock
            resident = len(self.pool.resident())
        with self._cond:            # taken after it, never nested inside
            return {
                "ok": bool(alive or (self._thread is None
                                     and not self._stop)),
                "tenants": len(self.tenants),
                "resident": resident,
                "batches": self._n_batches,
                "evictions": self._n_evictions,
                "queue_depth": sum(len(t.q) for t in self.tenants.values()),
            }

    def submit(self, tenant: str, rhs, x0=None,
               timeout_s: Optional[float] = None, block: bool = True):
        """Enqueue one rhs for ``tenant``; returns a Future resolving to
        ``(x, report)``. The tenant's queue is bounded: when it is full a
        non-blocking submit raises ``queue.Full`` at once (backpressure),
        ``block=True`` (the default) waits for room up to the request
        timeout."""
        t = self.tenants[tenant]          # KeyError: unknown tenant
        n = t.entry.payload["service"].n
        rhs = torch.as_tensor(rhs)
        if tuple(rhs.shape) != (n,):
            raise ValueError("rhs has shape %s but tenant %r's system has "
                             "%d unknowns" % (tuple(rhs.shape), tenant, n))
        if x0 is not None:
            x0 = torch.as_tensor(x0)
            if tuple(x0.shape) != (n,):
                raise ValueError("x0 has shape %s but tenant %r's system "
                                 "has %d unknowns"
                                 % (tuple(x0.shape), tenant, n))
        self.start()
        timeout = timeout_s if timeout_s is not None else self.timeout_s
        req = _FarmRequest(rhs, timeout, x0=x0, rid=next(self._rid),
                           tenant=tenant)
        deadline = time.monotonic() + max(timeout, 0.0)
        with self._cond:
            while True:
                if self._closed:
                    raise RuntimeError("SolverFarm is closed")
                # resolved under the lock, and again after every wait: a
                # concurrent re-register installs a new _Tenant
                cur = self.tenants.get(tenant)
                if cur is None:
                    raise KeyError(tenant)
                if cur.entry.payload["service"].n != n:
                    raise RuntimeError(
                        "tenant %r re-registered with a different system "
                        "size while this submit was in progress" % (tenant,))
                if cur.shed_until > time.monotonic():
                    raise LoadShedError(
                        "tenant %r is shedding load under a sustained SLO "
                        "breach — retry after %.1fs"
                        % (tenant, max(cur.shed_until - time.monotonic(),
                                       0.0)))
                t = cur
                if len(t.q) < t.queue_max:
                    break
                if not block:
                    raise _queue.Full("tenant %r queue is full (%d)"
                                      % (tenant, t.queue_max))
                left = deadline - time.monotonic()
                if left <= 0:
                    raise _queue.Full("tenant %r queue stayed full for "
                                      "%.1fs" % (tenant, timeout))
                self._cond.wait(timeout=left)
            t.q.append(req)
            self._cond.notify_all()
            gone = self._thread is None
        if gone:
            # raced a dispatch-worker death: the supervisor drains the
            # queues and clears _thread under _cond, so an append after it
            # sees no worker and revives one
            self.start()
        self.live.set_gauge("farm_tenant_queue_depth", len(t.q),
                            tenant=tenant)
        return req.public

    def solve(self, tenant: str, rhs, x0=None,
              timeout_s: Optional[float] = None):
        """Submit and wait."""
        fut = self.submit(tenant, rhs, x0=x0, timeout_s=timeout_s)
        return fut.result(timeout=(timeout_s or self.timeout_s) + 120)

    # -- the dispatch loop ----------------------------------------------------

    def _pick_tenant_locked(self) -> Optional[_Tenant]:
        """Fair share: the next tenant (in rotating order) with pending
        work. The cursor moves past the pick, so a tenant that just
        dispatched goes to the back of the line."""
        names = list(self.tenants)
        if not names:
            return None
        for k in range(len(names)):
            i = (self._rr + k) % len(names)
            t = self.tenants[names[i]]
            if t.q:
                self._rr = (i + 1) % len(names)
                return t
        return None

    def _pop_for_entry_locked(self, entry: RegistryEntry
                              ) -> Optional[_FarmRequest]:
        """One more request for the same operator, from any tenant
        sharing it (in rotating order): the cross-tenant packing."""
        names = list(self.tenants)
        for k in range(len(names)):
            t = self.tenants[names[(self._rr + k) % len(names)]]
            if t.entry is entry and t.q:
                return t.q.popleft()
        return None

    def _next_batch(self):
        with self._cond:
            while True:
                t = self._pick_tenant_locked()
                if t is not None:
                    break
                if self._stop:
                    return None, None
                self._cond.wait(timeout=0.1)
            entry = t.entry
            batch: List[_FarmRequest] = [t.q.popleft()]
            self._cond.notify_all()      # a bounded-queue submitter may be
            #                              waiting for room
            bucket = entry.payload["service"].batch
            deadline = time.monotonic() + self.flush_s
            while len(batch) < bucket:
                got = self._pop_for_entry_locked(entry)
                if got is not None:
                    batch.append(got)
                    self._cond.notify_all()
                    continue
                if self._stop:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(timeout=min(left, 0.02))
            return batch, entry

    def _validate_batch_locked(self, batch: List[_FarmRequest],
                               entry: RegistryEntry):
        """Split off requests whose tenant was re-registered onto another
        entry between the pop and this dispatch (the old entry may be a
        rebuild target by now): returns ``(live, displaced)``, the
        displaced paired with their error, which the caller resolves once
        _mem_lock is dropped; they stay in the accounting batch."""
        with self._cond:
            current = {name: t.entry for name, t in self.tenants.items()}
        live, displaced = [], []
        for req in batch:
            if current.get(req.tenant) is entry:
                live.append(req)
            else:
                displaced.append((req, RuntimeError(
                    "tenant %r re-registered with a different operator "
                    "while request %d was in flight"
                    % (req.tenant, req.rid))))
        return live, displaced

    def _loop(self):
        """The dispatch thread: the inner loop under a supervisor, which
        fails every in-flight and queued public future on an unexpected
        exception and restarts the thread (a bounded number of times)."""
        try:
            self._loop_inner()
        except Exception as e:           # noqa: BLE001 — supervisor
            self._worker_died(e)

    def _loop_inner(self):
        while True:
            batch, entry = self._next_batch()
            if batch is None:
                return
            self._inflight_reqs = batch
            svc = None
            live: List[_FarmRequest] = []
            displaced: List[Any] = []
            try:
                with self._mem_lock:
                    live, displaced = self._validate_batch_locked(batch,
                                                                  entry)
                    if live:
                        svc = self._ensure_resident_locked(entry)
                        # pin, then solve outside _mem_lock
                        self._pins[entry.uid] = \
                            self._pins.get(entry.uid, 0) + 1
                for req, err in displaced:
                    if not req.future.done():
                        req.future.set_exception(err)
                if svc is not None:
                    try:
                        svc._run_batch(live)
                    finally:
                        with self._mem_lock:
                            left = self._pins.get(entry.uid, 1) - 1
                            if left > 0:
                                self._pins[entry.uid] = left
                            else:
                                self._pins.pop(entry.uid, None)
                            self._mem_cond.notify_all()
            except Exception as e:     # noqa: BLE001 — a failed batch
                for req, err in displaced:
                    if not req.future.done():
                        req.future.set_exception(err)
                for req in batch:      # fails its futures, not the farm
                    if not req.future.done():
                        req.future.set_exception(e)
                # an allocation failure means the device is out of room,
                # not that the worker is sick: free the coldest other
                # operator now, so the next submit readmits into headroom
                if isinstance(e, AllocationError) and entry is not None:
                    try:
                        with self._mem_lock:
                            victim = self.pool.coldest(
                                exclude=(entry.uid,) + tuple(self._pins)
                                + tuple(self._admitting))
                            if victim is not None:
                                self._evict_uid_locked(victim)
                    except Exception:            # noqa: BLE001
                        traceback.print_exc()
            try:
                # the whole batch: displaced requests carry their inner
                # exception into the books and the public futures
                self._account(batch)
            except Exception:          # noqa: BLE001 — accounting must not
                traceback.print_exc()  # kill the loop, nor vanish
            finally:
                self._inflight_reqs = []
            if self._stop:
                with self._cond:
                    if not any(t.q for t in self.tenants.values()):
                        return

    def _worker_died(self, exc):
        """Supervisor tail, on the dying dispatch thread: fail every
        in-flight and queued public future with WorkerDiedError, then
        restart the thread unless the farm closed or the restart budget
        is spent."""
        if isinstance(exc, WorkerDiedError):
            err = exc
        else:
            err = WorkerDiedError("farm dispatch worker died: %r" % (exc,))
            err.__cause__ = exc
        stragglers, self._inflight_reqs = self._inflight_reqs, []
        with self._cond:
            for t in self.tenants.values():
                while t.q:
                    stragglers.append(t.q.popleft())
            self._thread = None
            closed = self._closed
            restarts = self._worker_restarts
            self._n_worker_deaths += 1
        for req in stragglers:
            for fut in (req.future, req.public):
                if not fut.done():
                    fut.set_exception(err)
        self.live.inc("serve_worker_deaths_total")
        if not isinstance(exc, WorkerDiedError):
            traceback.print_exception(type(exc), exc, exc.__traceback__)
        if _sink.sink_attached():
            _sink.emit(event="farm_worker_death", error=repr(exc)[:200],
                       failed=len(stragglers), restarts=restarts)
        if not closed and restarts < self._restart_max:
            with self._cond:
                self._worker_restarts += 1
            self.live.inc("serve_worker_restarts_total")
            try:
                self.start()
            except Exception:                    # noqa: BLE001
                traceback.print_exc()

    def _account(self, batch: List[_FarmRequest]) -> None:
        """Per-tenant bookkeeping between the inner futures (resolved in
        ``_run_batch``) and the public ones (resolved last, even when the
        bookkeeping raised, so a caller is never stranded)."""
        try:
            self._account_rows(batch)
        finally:
            for req in batch:
                src, dst = req.future, req.public
                if dst.done():
                    continue
                if not src.done():
                    dst.set_exception(RuntimeError(
                        "farm batch finished without resolving request %d"
                        % req.rid))
                    continue
                err = src.exception()
                if err is not None:
                    dst.set_exception(err)
                else:
                    dst.set_result(src.result())

    def _account_rows(self, batch: List[_FarmRequest]) -> None:
        involved: Dict[str, _Tenant] = {}
        for req in batch:
            t = self.tenants.get(req.tenant)
            if t is None:
                continue
            fut = req.future
            err = fut.exception() if fut.done() else None
            row: Dict[str, Any] = {"timeout": False, "unhealthy": False}
            if isinstance(err, TimeoutError):
                row["timeout"] = True
                t.n_timeouts += 1
                self.live.inc("farm_tenant_timeouts_total", tenant=t.name)
            elif err is not None:
                row["unhealthy"] = True
                row["error"] = True
                t.n_unhealthy += 1
                self.live.inc("farm_tenant_unhealthy_total", tenant=t.name)
            else:
                _x, rep = fut.result()
                serve = rep.serve or {}
                lat_ms = serve.get("latency_ms")
                row["lat_ms"] = lat_ms
                for k in ("queue", "pad", "compile", "solve", "sync"):
                    row[k + "_ms"] = serve.get(k + "_ms")
                row["fill"] = serve.get("batch_fill")
                healthy = rep.health["ok"] if rep.health else True
                if not healthy:
                    row["unhealthy"] = True
                    t.n_unhealthy += 1
                    self.live.inc("farm_tenant_unhealthy_total",
                                  tenant=t.name)
                if lat_ms is not None:
                    with self._cond:   # stats() reads lat and win from
                        t.lat.append(lat_ms)   # other threads
                    self.live.observe("farm_latency_ms", lat_ms)
            t.n_requests += 1
            self.live.inc("farm_tenant_requests_total", tenant=t.name)
            with self._cond:
                t.win.append(row)
            involved[t.name] = t
        self._n_batches += 1
        self.live.inc("farm_batches_total")
        for t in involved.values():
            self.live.set_gauge("farm_tenant_queue_depth", len(t.q),
                                tenant=t.name)
            summ = self.tenant_slo_summary(t.name)
            if summ["p99_ms"] is not None:
                self.live.set_gauge("farm_tenant_p99_ms", summ["p99_ms"],
                                    tenant=t.name)
            self._check_tenant_slo(t, summ)

    # -- the per-tenant SLO watchdog ------------------------------------------

    def tenant_slo_summary(self, tenant: str) -> Dict[str, Any]:
        """A tenant's rolling window, in the shape of
        ``SolverService.slo_summary`` (so
        ``telemetry.health.serve_findings`` reads it as it is) plus the
        tenant's name."""
        t = self.tenants[tenant]
        with self._cond:
            rows = list(t.win)
        lat = [r["lat_ms"] for r in rows if r.get("lat_ms") is not None]
        n = len(rows)

        def mean(key):
            vals = [r[key] for r in rows if r.get(key) is not None]
            return round(sum(vals) / len(vals), 3) if vals else None

        out: Dict[str, Any] = {
            "tenant": tenant,
            "window": n,
            "p50_ms": round(_metrics.percentile(lat, 50), 3)
            if lat else None,
            "p99_ms": round(_metrics.percentile(lat, 99), 3)
            if lat else None,
            "timeout_rate": round(sum(
                1 for r in rows if r.get("timeout")) / n, 4) if n else 0,
            "unhealthy_rate": round(sum(
                1 for r in rows if r.get("unhealthy")) / n, 4) if n else 0,
            "batch_fill": mean("fill"),
            "spans_ms": {k: mean(k + "_ms") for k in
                         ("queue", "pad", "compile", "solve", "sync")},
            "slo": dict(t.slo, window=t.slo_window),
        }
        trips = []
        if t.slo["p99_ms"] and out["p99_ms"] is not None \
                and out["p99_ms"] > t.slo["p99_ms"]:
            trips.append("p99")
        if out["timeout_rate"] > t.slo["timeout_rate"]:
            trips.append("timeout_rate")
        if out["unhealthy_rate"] > t.slo["unhealthy_rate"]:
            trips.append("unhealthy_rate")
        out["trips"] = trips
        return out

    def _check_tenant_slo(self, t: _Tenant, summ: Dict[str, Any]) -> None:
        """Edge-triggered per tenant: a trip kind fires once when it
        enters the tripped state and re-arms when the tenant's window
        clears; one tenant's episode never touches another's state."""
        if not summ["window"]:
            return
        if self._shed_breaches > 0:
            # the load-shedding ladder: consecutive tripped evaluations
            # add up; at the threshold the tenant sheds (a typed reject
            # at submit) for a cooldown, then probes again
            if summ["trips"]:
                t.breaches += 1
                if t.breaches >= self._shed_breaches \
                        and t.shed_until <= time.monotonic():
                    t.shed_until = time.monotonic() \
                        + max(self._shed_cooldown, 0.0)
                    self._n_shed += 1
                    self.live.inc("farm_load_shed_total", tenant=t.name)
                    if _sink.sink_attached():
                        _sink.emit(event="farm_shed", tenant=t.name,
                                   trips=summ["trips"],
                                   cooldown_s=self._shed_cooldown,
                                   breaches=t.breaches)
            else:
                t.breaches = 0
                t.shed_until = 0.0
        new = [k for k in summ["trips"] if k not in t._slo_active]
        t._slo_active = set(summ["trips"])
        if not new:
            return
        t.slo_trips += len(new)
        self.live.inc("farm_tenant_slo_trips_total", by=len(new),
                      tenant=t.name)
        if _sink.sink_attached():
            _sink.emit(event="farm_slo", new_trips=new,
                       findings=_health.serve_findings(summ), **summ)

    # -- stats and lifecycle --------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The farm's lifetime rollup: per-tenant rows (requests,
        timeouts, unhealthy, SLO trips, latency percentiles, residency
        and bytes, the window's summary), the registry's hit, miss and
        rebuild counters, the pool, and the eviction and readmission
        totals."""
        with self._mem_lock:
            resident = self.pool.resident()
        rows = []
        with self._cond:
            tenants = list(self.tenants.items())
        for name, t in tenants:
            with self._cond:
                lat = list(t.lat)
            row: Dict[str, Any] = {
                "tenant": name,
                "fingerprint": t.entry.fingerprint,
                "uid": t.entry.uid,
                "outcome": t.outcome,
                "resident": t.entry.uid in resident,
                "bytes": resident.get(t.entry.uid, 0),
                "requests": t.n_requests,
                "timeouts": t.n_timeouts,
                "unhealthy": t.n_unhealthy,
                "slo_trips": t.slo_trips,
                "queue_depth": len(t.q),
                "shedding": t.shed_until > time.monotonic(),
                "slo_summary": self.tenant_slo_summary(name),
            }
            if lat:
                row["latency_ms"] = {
                    "p50": round(_metrics.percentile(lat, 50), 3),
                    "p99": round(_metrics.percentile(lat, 99), 3),
                    "max": round(max(lat), 3)}
            rows.append(row)
        out: Dict[str, Any] = {
            "tenants": rows,
            "registry": self.registry.stats(),
            "pool": {"total_bytes": 0 if self.pool.unlimited
                     else self.pool.total,
                     "used_bytes": self.pool.used,
                     "resident": dict(resident)},
            "requests": sum(r["requests"] for r in rows),
            "batches": self._n_batches,
            "evictions": self._n_evictions,
            "readmissions": self._n_readmissions,
            "batch_bucket": self.batch,
        }
        rec = {"worker_deaths": self._n_worker_deaths,
               "worker_restarts": self._worker_restarts,
               "shed": self._n_shed}
        if any(rec.values()):
            out["recovery"] = rec
        if self.metrics_server is not None:
            out["metrics_port"] = self.metrics_server.port
        return out

    def close(self, timeout: float = 30.0):
        """Drain every tenant queue, stop the dispatch thread and the
        scrape server, emit a final ``farm`` event. Terminal."""
        with self._cond:
            self._closed = True
            self._stop = True
            thread = self._thread
            self._cond.notify_all()
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                return                 # still draining; a later close()
        with self._cond:
            self._thread = None
            stragglers = []
            for t in self.tenants.values():
                while t.q:
                    stragglers.append(t.q.popleft())
        for req in stragglers:
            if not req.public.done():
                req.public.set_exception(RuntimeError("SolverFarm is closed"))
        if _sink.sink_attached():
            _sink.emit(event="farm", final=True, **self.stats())
        with self._cond:
            server, self.metrics_server = self.metrics_server, None
        if server is not None:
            server.close()

    def __enter__(self) -> "SolverFarm":
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False
