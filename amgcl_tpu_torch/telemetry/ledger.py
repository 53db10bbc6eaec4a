"""The dense-window device-memory budget (counterpart of the
:class:`DeviceMemoryBudget` part of ``amgcl_tpu/telemetry/ledger.py``).

One hierarchy build threads one budget through every level conversion,
so the storage-hungry dense-window blocks (``ops/densewin.py``) draw on
one hierarchy-wide pool instead of each matrix consulting the per-matrix
cap on its own.
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
