"""The device-memory budgets and the Krylov iteration model
(counterpart of :class:`DeviceMemoryBudget`, :class:`LruMemoryPool` and
``krylov_iteration_model`` in ``amgcl_tpu/telemetry/ledger.py``).

One hierarchy build threads one budget through every level conversion,
so the storage-hungry dense-window blocks (``ops/densewin.py``) draw on
one hierarchy-wide pool instead of each matrix consulting the per-matrix
cap on its own. The solver farm's resident set is an
:class:`LruMemoryPool` (``serve/farm.py``). The iteration model prices
one Krylov iteration in FLOPs and device bytes; the serving layer books
the work of its zero-padded bucket columns with it.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

#: dense-window storage cap: the JAX package's default
#: (``AMGCL_TPU_DWIN_MAX_BYTES`` unset), a constant here as the port's
#: other format caps are (``ops/device.py``)
DWIN_MAX_BYTES = 6 << 30


class DeviceMemoryBudget:
    """Byte budget shared across one hierarchy build: consumers ask
    ``remaining()`` before materializing a storage-hungry buffer and
    ``try_charge(nbytes, tag)`` when they commit one, which refuses
    instead of overdrawing; the charge log keeps each charge's tag."""

    def __init__(self, total_bytes: int, name: str = "dense_window"):
        self.total = int(total_bytes)
        self.name = name
        self.used = 0
        self.charges = []           # [(tag, bytes), ...]

    def remaining(self) -> int:
        return self.total - self.used

    def try_charge(self, nbytes: int, tag: str = "") -> bool:
        nbytes = int(nbytes)
        if nbytes < 0 or self.used + nbytes > self.total:
            return False
        self.used += nbytes
        self.charges.append((tag, nbytes))
        return True

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "total_bytes": self.total,
                "used_bytes": self.used,
                "remaining_bytes": self.remaining(),
                "charges": [{"tag": t, "bytes": b} for t, b in self.charges]}

    def __repr__(self):
        return "DeviceMemoryBudget(%s: %d/%d bytes)" % (
            self.name, self.used, self.total)


def dense_window_budget() -> DeviceMemoryBudget:
    """A fresh hierarchy-wide dense-window budget of DWIN_MAX_BYTES."""
    return DeviceMemoryBudget(DWIN_MAX_BYTES)


class LruMemoryPool(DeviceMemoryBudget):
    """A farm-wide resident set (amgcl_tpu/telemetry/ledger.py:112-210):
    named charges that are released again (eviction returns the bytes)
    and re-charged (readmission), in least-recently-used order kept by
    :meth:`touch`, so the farm's admission loop can always name the
    coldest resident operator to evict (``AMG.bytes()`` is the unit of
    a charge).

    ``total_bytes <= 0`` means unlimited: the pool still tracks residency
    and LRU order, and never refuses a charge. The charge log is
    append-only, a release adding a negative row, and bounded at the
    last 256 rows (the totals stay exact)."""

    def __init__(self, total_bytes: int = 0, name: str = "farm_hbm"):
        total = int(total_bytes or 0)
        self.unlimited = total <= 0
        super().__init__(total if total > 0 else (1 << 62), name)
        self.charges = deque(self.charges, maxlen=256)
        #: key -> bytes; insertion order is the LRU order (coldest first)
        self._resident: Dict[str, int] = {}

    def charge(self, key: str, nbytes: int) -> bool:
        """Admit ``key`` at ``nbytes``. Re-charging a resident key swaps
        its charge atomically: on failure the old charge is restored,
        never dropped (its buffers are still live). False when it does
        not fit; the caller evicts ``coldest()`` and retries. Either way
        the key moves to the warm end of the LRU order."""
        nbytes = int(nbytes)
        old = self._resident.pop(key, None)
        if old is not None:
            self.used -= old
        if not self.try_charge(nbytes, tag=key):
            if old is not None:
                self.used += old
                self._resident[key] = old
            return False
        if old is not None:
            self.charges.append((key + ":released", -old))
        self._resident[key] = nbytes
        return True

    def release(self, key: str) -> int:
        """Evict ``key``: return its bytes to the pool (0 when it was not
        resident)."""
        nbytes = self._resident.pop(key, 0)
        if nbytes:
            self.used -= nbytes
            self.charges.append((key + ":released", -nbytes))
        return nbytes

    def touch(self, key: str) -> None:
        """Mark ``key`` most recently used."""
        if key in self._resident:
            self._resident[key] = self._resident.pop(key)

    def coldest(self, exclude=()) -> Optional[str]:
        """The least recently used resident key outside ``exclude`` (the
        eviction victim); None when nothing is evictable."""
        for key in self._resident:
            if key not in exclude:
                return key
        return None

    def resident(self) -> Dict[str, int]:
        """Copy of the resident map in LRU order (coldest first)."""
        return dict(self._resident)

    def resize(self, total_bytes: int) -> None:
        """Change the budget in place; the caller evicts down to it."""
        total = int(total_bytes or 0)
        self.unlimited = total <= 0
        self.total = total if total > 0 else (1 << 62)

    def to_dict(self) -> Dict[str, Any]:
        out = super().to_dict()
        if self.unlimited:
            out["total_bytes"] = 0
            out["remaining_bytes"] = None
        out["resident"] = dict(self._resident)
        return out


# -- the Krylov iteration model -------------------------------------------------

#: (SpMVs, preconditioner applications, dots, axpys) of one iteration
KRYLOV_OPS = {
    "CG":         (1, 1, 3, 3),
    "BiCGStab":   (2, 2, 7, 6),
    "BiCGStabL":  (2, 2, 8, 8),
    "GMRES":      (1, 1, 4, 4),
    "FGMRES":     (1, 1, 4, 4),
    "LGMRES":     (1, 1, 6, 6),
    "IDRs":       (2, 2, 8, 8),
    "Richardson": (1, 1, 1, 2),
    "PreOnly":    (0, 1, 0, 0),
}

#: vector streams of one iteration through the fused tails
KRYLOV_VEC_STREAMS_FUSED = {
    "CG": 11, "BiCGStab": 15, "BiCGStabL": 24, "GMRES": 16, "FGMRES": 16,
    "LGMRES": 20, "IDRs": 30, "Richardson": 4, "PreOnly": 0,
}


def _vec_dims(M):
    """Scalar-expanded (rows, cols) of an operator (block-aware)."""
    blk = getattr(M, "block", None)
    br, bc = blk if isinstance(blk, tuple) and len(blk) == 2 else (1, 1)
    return M.shape[0] * br, M.shape[1] * bc


def mv_cost(M):
    """``{"flops", "bytes"}`` of one ``y = M x``: the stored operator read
    once, x read and y written (the roofline floor)."""
    if M is None:
        return {"flops": 0, "bytes": 0}
    rows, cols = _vec_dims(M)
    itemsize = M.dtype.itemsize
    stored = int(M.bytes()) if hasattr(M, "bytes") else 0
    name = type(M).__name__
    if name == "DiaMatrix":
        flops = 2 * len(M.offsets) * rows
    elif name in ("EllMatrix", "WindowedEllMatrix"):
        flops = 2 * M.vals.numel()
    elif name == "DenseMatrix":
        flops = 2 * rows * cols
    elif name == "DenseWindowMatrix":
        flops = 2 * M.blocks.numel()
    else:
        flops = 2 * max(stored // max(itemsize, 1), 1)
    return {"flops": int(flops), "bytes": int(stored + (rows + cols)
                                              * itemsize)}


def krylov_iteration_model(solver_name, A_dev, cycle_total=None,
                           pre_cycles=1, batch=1, effective_batch=None):
    """FLOPs and device bytes of one Krylov iteration: the solver's
    SpMVs and fused vector streams, plus ``pre_cycles`` cycles a
    preconditioner application where ``cycle_total`` ({"flops",
    "bytes"} of one cycle) is given.

    ``batch`` adds the stacked axis. The port applies its operators
    column by column, reading each stored operator once a column, so
    every FLOP and byte scales with B (the JAX package's model reads the
    stored operator once for the B columns, as its batched products
    do). ``effective_batch`` prices padding: only that many of the
    ``batch`` columns are real work, and the model adds ``batch_fill``
    and the effective and padding-waste splits of flops and bytes."""
    spmv, papp, dots, axpys = KRYLOV_OPS.get(solver_name, (1, 1, 4, 4))
    batch = max(int(batch), 1)
    n = _vec_dims(A_dev)[0] if A_dev is not None else 0
    vec = n * (A_dev.dtype.itemsize if A_dev is not None else 4)
    mv = mv_cost(A_dev)
    cost = {"flops": mv["flops"] * spmv * batch,
            "bytes": mv["bytes"] * spmv * batch}
    streams = KRYLOV_VEC_STREAMS_FUSED.get(solver_name, 2 * dots + 3 * axpys)
    cost["flops"] += (2 * dots + 2 * axpys) * n * batch
    cost["bytes"] += streams * vec * batch
    if cycle_total:
        k = papp * max(int(pre_cycles), 1) * batch
        cost["flops"] += cycle_total["flops"] * k
        cost["bytes"] += cycle_total["bytes"] * k
    out = {"solver": solver_name, "spmvs": spmv, "precond_applies": papp,
           "dots": dots, "axpys": axpys, "vec_streams": streams,
           "fused_vec": True, **cost}
    if batch > 1:
        out["batch"] = batch
    if effective_batch is not None:
        eff = min(max(int(effective_batch), 0), batch)
        fill = eff / batch
        waste_f = int(round(cost["flops"] * (1 - fill)))
        waste_b = int(round(cost["bytes"] * (1 - fill)))
        out.update(effective_batch=eff, batch_fill=round(fill, 4),
                   padding_waste_flops=waste_f, padding_waste_bytes=waste_b,
                   effective_flops=cost["flops"] - waste_f,
                   effective_bytes=cost["bytes"] - waste_b)
    if cost["bytes"]:
        out["flop_per_byte"] = round(cost["flops"] / cost["bytes"], 4)
    return out
