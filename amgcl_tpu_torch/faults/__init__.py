"""Typed fault errors and the retry backoff of the serving path
(counterpart of ``amgcl_tpu/faults/__init__.py`` and of ``backoff_s`` in
``amgcl_tpu/faults/recovery.py``). The JAX package's injection seams
(``faults/inject.py``), memory watch and flight recorder are ROADMAP
A.13; the service runs without them.

Every fault path that gives up raises one of these errors (all
``RuntimeError`` subclasses, so broad handlers keep working)."""

from __future__ import annotations

import random

import torch


class FaultError(RuntimeError):
    """Base of the typed fault errors."""


class DeviceLostError(FaultError):
    """The device running a solve was lost or preempted."""


class WorkerDiedError(FaultError):
    """A service's dispatch thread died on an unexpected exception: every
    pending and queued future is failed with this (never stranded), and
    the supervisor restarts the worker."""


class PoisonRequestError(FaultError):
    """A request that batch bisection isolated as the one that keeps
    failing its batch."""


class LoadShedError(FaultError):
    """A typed reject of a service shedding load."""


class AllocationError(FaultError):
    """Device memory allocation failed at a solve or serve seam
    (``torch.cuda.OutOfMemoryError`` there): admission-class, not a
    worker death."""


class AdmissionError(AllocationError):
    """Admission failed after eviction attempts and backoff."""


class RecoveryExhausted(FaultError):
    """A recovery ladder ran out of rungs; carries the attempt trail
    (``.attempts``) and the last report (``.report``)."""

    def __init__(self, message, attempts=None, report=None):
        super().__init__(message)
        self.attempts = attempts or []
        self.report = report


def is_resource_exhausted(exc) -> bool:
    """True for a device allocation failure: torch's
    ``OutOfMemoryError``, or an error whose message says the device ran
    out of memory. Never raises."""
    if exc is None or isinstance(exc, FaultError):
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    try:
        msg = str(exc).lower()
    except Exception:                         # noqa: BLE001
        return False
    return "out of memory" in msg or "resource_exhausted" in msg


def backoff_s(attempt: int, key: int = 0, base_ms: float = 50.0,
              jitter: float = 0.1) -> float:
    """Exponential backoff with deterministic jitter for retry
    ``attempt`` (1-based): base · 2^(attempt − 1) · (1 + jitter · u), u
    drawn from a PRNG seeded by ``key`` and ``attempt``, so a replayed
    incident backs off the same (the JAX package's defaults:
    ``AMGCL_TPU_RETRY_BACKOFF_MS`` 50, ``AMGCL_TPU_RETRY_JITTER`` 0.1)."""
    u = random.Random(int(key) * 1000003 + int(attempt)).random()
    return max(base_ms / 1e3 * (2.0 ** max(attempt - 1, 0))
               * (1.0 + jitter * u), 0.0)


__all__ = [
    "FaultError", "DeviceLostError", "WorkerDiedError",
    "PoisonRequestError", "LoadShedError", "AllocationError",
    "AdmissionError", "RecoveryExhausted", "is_resource_exhausted",
    "backoff_s",
]
