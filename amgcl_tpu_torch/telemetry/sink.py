"""JSONL event sink (counterpart of ``amgcl_tpu/telemetry/sink.py``
without its environment knobs): one JSON object a line, stamped with
``ts``/``ts_iso``. The process-wide default sink is a no-op until
:func:`set_default_sink` installs one, so library code calls
:func:`emit` unconditionally."""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Dict, Optional


def _jsonable(obj):
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if hasattr(obj, "item"):
        return obj.item()
    return str(obj)


def _clean(obj):
    """Non-finite floats as their names ("nan", "inf"), so every line is
    strict JSON and the records of a breakdown stay parseable."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else str(obj)
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    if hasattr(obj, "tolist"):
        return _clean(obj.tolist())
    return obj


def stamp(record: Dict[str, Any], now: Optional[float] = None):
    """Copy of ``record`` with ``ts`` and ``ts_iso`` (existing ones
    win)."""
    rec = dict(record)
    rec.setdefault("ts", time.time() if now is None else now)
    rec.setdefault("ts_iso", time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                           time.gmtime(rec["ts"])))
    return rec


class JsonlSink:
    """Append-mode JSONL writer to ``path`` or ``stream`` (exactly one).
    A file sink opens, writes and closes per record. One lock per sink
    serializes the writes of the serve worker and the caller's
    thread."""

    def __init__(self, path: Optional[str] = None, stream=None):
        if (path is None) == (stream is None):
            raise ValueError("JsonlSink needs exactly one of path/stream")
        self.path = path
        self.stream = stream
        self._lock = threading.Lock()

    def emit(self, record: Optional[Dict[str, Any]] = None, **fields):
        rec = stamp(dict(record or {}, **fields))
        line = json.dumps(_clean(rec), default=_jsonable)
        with self._lock:
            if self.stream is not None:
                self.stream.write(line + "\n")
                self.stream.flush()
            else:
                with open(self.path, "a") as f:
                    f.write(line + "\n")
        return rec

    def close(self):
        pass


class NullSink:
    """The default sink: writes nothing."""

    def emit(self, record: Optional[Dict[str, Any]] = None, **fields):
        return dict(record or {}, **fields)

    def close(self):
        pass


_default_sink = NullSink()


def get_default_sink():
    return _default_sink


def set_default_sink(sink) -> None:
    """Install ``sink`` as the process-wide default (None: the no-op)."""
    global _default_sink
    _default_sink = NullSink() if sink is None else sink


def sink_attached() -> bool:
    """True when a real sink is installed."""
    return not isinstance(_default_sink, NullSink)


_emit_warned = False


def emit(record: Optional[Dict[str, Any]] = None, **fields):
    """Emit through the default sink. Never raises: a failing sink warns
    once and drops records, so telemetry cannot fail a solve."""
    global _emit_warned
    try:
        return _default_sink.emit(record, **fields)
    except Exception as e:                     # noqa: BLE001
        if not _emit_warned:
            _emit_warned = True
            import warnings
            warnings.warn("telemetry sink emit failed (%r) — records will "
                          "be dropped" % (e,))
        return dict(record or {}, **fields)
