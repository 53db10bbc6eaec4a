"""Operator registry: cached hierarchies keyed by sparsity fingerprint
(counterpart of ``amgcl_tpu/serve/registry.py``).

The solver farm's setup-avoidance seam: a setup is expensive (strength
graphs, aggregation, the plans' symbolic pass), a numeric rebuild
against the kept plans is cheap. Whether the cheap path applies is a
property of the sparsity pattern, not the values, so the registry keys
cached operators by a fingerprint of the pattern (``ptr``, ``col``,
shape, block) plus a caller's config key (two tenants wanting different
coarsening on one pattern are different operators).

Acquisition:

* **hit** — an entry with the same pattern and bit-equal values exists:
  share it as it is (each owner holds a token; read-only use).
* **rebuild** — same pattern, new values, and no other owner is live on
  the entry (the registering owner refreshing its own time-stepped
  operator, or an orphan): refresh it in place through the object's
  ``rebuild()``. A ``rebuild_ok`` guard vetoes entries whose liveness
  the tokens cannot see (the farm rejects entries pinned by an
  in-flight batch or referenced by a live tenant).
* **miss** — no entry, or every same-pattern entry is another live
  owner's: a fresh build.

Entries outlive their owners (``release`` drops the token, not the
entry): an orphan is the cache a returning same-pattern tenant rebuilds
into. ``prune()`` drops orphans.

The JAX package wraps its lock in a runtime lock witness (ROADMAP
A.13); here it is a plain lock, whose place in the farm's declared
order ``serve/farm.py``'s ``LOCK_ORDER`` documents.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np



def sparsity_fingerprint(A) -> str:
    """Hex digest of a CSR matrix's sparsity PATTERN — shape, block
    size, and the ``ptr``/``col`` arrays; the values are deliberately
    excluded (two time steps of one problem share a fingerprint, which
    is what routes the second one to ``rebuild()``). Cached on the
    matrix object — patterns are immutable by convention."""
    cached = getattr(A, "_sparsity_fp", None)
    if cached is not None:
        return cached
    h = hashlib.blake2b(digest_size=16)
    br, bc = getattr(A, "block_size", (1, 1))
    h.update(np.asarray([A.nrows, A.ncols, A.nnz, br, bc],
                        np.int64).tobytes())
    h.update(np.ascontiguousarray(A.ptr).tobytes())
    h.update(np.ascontiguousarray(A.col).tobytes())
    fp = h.hexdigest()
    try:
        A._sparsity_fp = fp
    except AttributeError:
        pass
    return fp


def _obj_key(obj, depth: int = 2) -> str:
    """Type name + sorted scalar fields of ``obj``, recursing ``depth``
    levels into nested config objects — so a coarsening policy's
    ``eps_strong`` (or a smoother's damping) distinguishes two
    otherwise same-typed configs instead of silently sharing one
    hierarchy between them."""
    if obj is None:
        return "-"
    if isinstance(obj, (int, float, str, bool)):
        return repr(obj)
    if isinstance(obj, type):
        return obj.__name__
    bits = [type(obj).__name__]
    fields = getattr(obj, "__dict__", {})
    for k, v in sorted(fields.items()):
        if k.startswith("_"):
            continue
        if depth > 0 and not isinstance(
                v, (int, float, str, bool, type, type(None))) \
                and hasattr(v, "__dict__"):
            bits.append("%s=(%s)" % (k, _obj_key(v, depth - 1)))
        elif isinstance(v, (int, float, str, bool, type(None))):
            bits.append("%s=%r" % (k, v))
        elif isinstance(v, type):
            bits.append("%s=%s" % (k, v.__name__))
        else:
            bits.append("%s=%s" % (k, type(v).__name__))
    return ",".join(bits)


def stable_config_key(*objs) -> str:
    """Deterministic config key from solver/params objects: type names
    plus scalar attributes, recursing two levels into nested config
    objects (a coarsening policy's thresholds are part of the operator
    identity) — without dragging object ``repr``s, whose default form
    embeds addresses, into the key."""
    return "|".join(_obj_key(obj) for obj in objs)


class RegistryEntry:
    """One cached operator: the rebuildable object (a ``make_solver``
    bundle or a bare ``AMG`` — anything with ``rebuild``), the value
    array it currently carries, the owner tokens sharing it, and the
    build/rebuild cost record the acceptance criteria compare."""

    #: atomic uid sequence: entries are minted under per-registry
    #: locks, so two registries constructing at once must not race a
    #: bare read-modify-write
    _seq = itertools.count(1)

    def __init__(self, fingerprint: str, config_key: str, obj: Any,
                 A_val, setup_s: float):
        #: unique pool key (fingerprint alone may collide across
        #: same-pattern different-value entries)
        self.uid = "%s/%d" % (fingerprint[:12], next(RegistryEntry._seq))
        self.fingerprint = fingerprint
        self.config_key = config_key
        self.obj = obj
        #: SNAPSHOT of the values the cached hierarchy was built from —
        #: a copy, never a reference: a caller mutating its value array
        #: in place and re-registering (the pyamgcl time-stepping
        #: idiom) must compare against what was BUILT, or the identity
        #: check would return "hit" on a hierarchy holding stale values
        self.A_val = np.array(A_val, copy=True)
        self.owners: set = set()
        self.setup_s = float(setup_s)
        self.rebuild_s: Optional[float] = None
        self.rebuilds = 0
        self.hits = 0
        #: free slot for the farm's per-entry state (the SolverService)
        self.payload: Dict[str, Any] = {}

    def to_dict(self) -> Dict[str, Any]:
        out = {"uid": self.uid, "fingerprint": self.fingerprint,
               "owners": sorted(str(o) for o in self.owners),
               "setup_s": round(self.setup_s, 4),
               "rebuilds": self.rebuilds, "hits": self.hits}
        if self.rebuild_s is not None:
            out["rebuild_s"] = round(self.rebuild_s, 4)
        return out


class OperatorRegistry:
    """Thread-safe fingerprint-keyed cache of built operators with
    hit/miss/rebuild counters (the module docstring has the semantics).

    ``max_orphans`` bounds how many ownerless entries survive a
    ``release`` (oldest dropped first): orphans are rebuild targets for
    returning same-pattern registrants, but a long-running workload must
    not accumulate dead hierarchies. None (the default) keeps every
    orphan; the farm manages its bytes through its pool instead."""

    def __init__(self, max_orphans: Optional[int] = None):
        # takes part in the farm's declared order
        # (_mem_lock -> registry._lock -> _cond)
        self._lock = threading.Lock()
        #: (fingerprint, config_key) -> [RegistryEntry, ...] (a bucket:
        #: same-pattern different-value operators coexist)
        self._buckets: Dict[Tuple[str, str], List[RegistryEntry]] = {}
        self.max_orphans = max_orphans
        self.hits = 0
        self.misses = 0
        self.rebuilds = 0

    def acquire(self, owner, A, build: Callable[[Any], Any],
                config_key: str = "",
                rebuild_ok: Optional[Callable[[RegistryEntry], bool]]
                = None) -> Tuple[RegistryEntry, str]:
        """Resolve ``A`` for ``owner``: returns ``(entry, outcome)``
        with outcome in {"hit", "rebuild", "miss"}. ``build(A)`` runs
        (under the lock) only on a miss. ``rebuild_ok(entry)``, when
        given, vetoes the rebuild path per entry: the farm passes a
        guard that rejects entries pinned by an in-flight batch or still
        referenced by a live tenant other than ``owner`` — tokens alone
        cannot see either, and rebuilding such an entry would mutate a
        hierarchy someone is solving against."""
        fp = sparsity_fingerprint(A)
        with self._lock:
            bucket = self._buckets.setdefault((fp, config_key), [])
            for e in bucket:
                # value compare is against the entry's SNAPSHOT of what
                # was built — never an `is` check on the caller's array
                # (in-place mutation + re-register must NOT hit)
                if np.array_equal(e.A_val, np.asarray(A.val)):
                    self.hits += 1
                    e.hits += 1
                    e.owners.add(owner)
                    return e, "hit"
            for e in bucket:
                if e.owners <= {owner} \
                        and (rebuild_ok is None or rebuild_ok(e)):
                    # same pattern, new values, and nobody ELSE is live
                    # on this entry: the numeric-rebuild fast path
                    t0 = time.perf_counter()
                    e.obj.rebuild(A)
                    e.rebuild_s = time.perf_counter() - t0
                    e.A_val = np.array(A.val, copy=True)
                    e.rebuilds += 1
                    self.rebuilds += 1
                    e.owners.add(owner)
                    return e, "rebuild"
            t0 = time.perf_counter()
            obj = build(A)
            e = RegistryEntry(fp, config_key, obj, A.val,
                              time.perf_counter() - t0)
            plan = getattr(getattr(obj, "precond", obj),
                           "_reorder", None)
            if plan is not None:
                # the executed reorder's plan is keyed on this entry's
                # fingerprint: hits and rebuilds reuse the permutation
                e.payload["reorder"] = {
                    "variant": plan["variant"],
                    "fingerprint": plan["fingerprint"],
                    "predicted_gain": plan["predicted_gain"]}
            e.owners.add(owner)
            bucket.append(e)
            self.misses += 1
            return e, "miss"

    def probe(self, owner, A, config_key: str = "",
              rebuild_ok: Optional[Callable[[RegistryEntry], bool]]
              = None) -> str:
        """The outcome :meth:`acquire` WOULD take right now, without
        building or mutating anything. Advisory: a concurrent acquire
        can change the answer — callers who must not build under their
        own locks should prefer the farm's acquire-retry idiom (a
        build callable that raises on the first miss) over probing.
        Pass the same ``rebuild_ok`` guard the later acquire will use,
        or the prediction diverges on guarded entries."""
        fp = sparsity_fingerprint(A)
        with self._lock:
            bucket = self._buckets.get((fp, config_key), [])
            for e in bucket:
                if np.array_equal(e.A_val, np.asarray(A.val)):
                    return "hit"
            for e in bucket:
                if e.owners <= {owner} \
                        and (rebuild_ok is None or rebuild_ok(e)):
                    return "rebuild"
        return "miss"

    def note_rebuild(self, entry: RegistryEntry,
                     rebuild_s: Optional[float] = None) -> None:
        """Count an out-of-band rebuild against the registry (the farm's
        readmission rebuilds through the entry's service rather than
        ``acquire``, and the counters must still see it)."""
        with self._lock:
            entry.rebuilds += 1
            self.rebuilds += 1
            if rebuild_s is not None:
                entry.rebuild_s = float(rebuild_s)

    def release(self, owner, keep: Optional[RegistryEntry] = None
                ) -> None:
        """Drop ``owner`` from every entry it shares — except ``keep``,
        when given: a re-registering farm tenant releases its PREVIOUS
        entry only after the new acquire landed, in one call, so the
        old entry is never ownerless while the tenant's queued work
        could still dispatch against it. Entries stay cached (orphans
        are rebuild targets for returning tenants) up to
        ``max_orphans``; :meth:`prune` reclaims them all."""
        with self._lock:
            for bucket in self._buckets.values():
                for e in bucket:
                    if e is not keep:
                        e.owners.discard(owner)
            if self.max_orphans is not None:
                orphans = [e for bucket in self._buckets.values()
                           for e in bucket if not e.owners]
                excess = len(orphans) - self.max_orphans
                if excess > 0:
                    # the uid's trailing _seq is creation order — drop
                    # the oldest orphans first
                    oldest = sorted(orphans,
                                    key=lambda e: int(
                                        e.uid.rsplit("/", 1)[-1]))
                    doomed = {e.uid for e in oldest[:excess]}
                    for key in list(self._buckets):
                        survivors = [e for e in self._buckets[key]
                                     if e.uid not in doomed]
                        if survivors:
                            self._buckets[key] = survivors
                        else:
                            del self._buckets[key]

    def disown(self, owner, entry: RegistryEntry) -> None:
        """Drop ``owner`` from ONE entry — the admission-failure
        rollback: the caller acquired the entry but cannot keep it
        (serve/farm.py), and leaving it owned would make it
        unevictable and unprunable forever."""
        with self._lock:
            entry.owners.discard(owner)

    def prune(self) -> int:
        """Drop ownerless entries; returns how many were dropped."""
        dropped = 0
        with self._lock:
            for key in list(self._buckets):
                bucket = self._buckets[key]
                keep = [e for e in bucket if e.owners]
                dropped += len(bucket) - len(keep)
                if keep:
                    self._buckets[key] = keep
                else:
                    del self._buckets[key]
        return dropped

    def entries(self) -> List[RegistryEntry]:
        with self._lock:
            return [e for bucket in self._buckets.values()
                    for e in bucket]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            ents = [e.to_dict() for bucket in self._buckets.values()
                    for e in bucket]
            return {"hits": self.hits, "misses": self.misses,
                    "rebuilds": self.rebuilds, "entries": ents}
