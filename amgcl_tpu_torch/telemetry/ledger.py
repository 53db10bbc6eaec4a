"""The dense-window device-memory budget and the Krylov iteration model
(counterpart of :class:`DeviceMemoryBudget` and
``krylov_iteration_model`` in ``amgcl_tpu/telemetry/ledger.py``).

One hierarchy build threads one budget through every level conversion,
so the storage-hungry dense-window blocks (``ops/densewin.py``) draw on
one hierarchy-wide pool instead of each matrix consulting the per-matrix
cap on its own. The iteration model prices one Krylov iteration in
FLOPs and device bytes; the serving layer books the work of its
zero-padded bucket columns with it.
"""

from __future__ import annotations

#: dense-window storage cap: the JAX package's default
#: (``AMGCL_TPU_DWIN_MAX_BYTES`` unset), a constant here as the port's
#: other format caps are (``ops/device.py``)
DWIN_MAX_BYTES = 6 << 30


class DeviceMemoryBudget:
    """Byte budget shared across one hierarchy build: consumers ask
    ``remaining()`` before materializing a storage-hungry buffer and
    ``try_charge(nbytes)`` when they commit one, which refuses instead of
    overdrawing."""

    def __init__(self, total_bytes: int):
        self.total = int(total_bytes)
        self.used = 0

    def remaining(self) -> int:
        return self.total - self.used

    def try_charge(self, nbytes: int) -> bool:
        nbytes = int(nbytes)
        if nbytes < 0 or self.used + nbytes > self.total:
            return False
        self.used += nbytes
        return True

    def __repr__(self):
        return "DeviceMemoryBudget(%d/%d bytes)" % (self.used, self.total)


def dense_window_budget() -> DeviceMemoryBudget:
    """A fresh hierarchy-wide dense-window budget of DWIN_MAX_BYTES."""
    return DeviceMemoryBudget(DWIN_MAX_BYTES)


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
