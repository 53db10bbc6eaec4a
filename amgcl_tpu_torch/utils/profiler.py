"""Hierarchical scoped profiler (counterpart of
``amgcl_tpu/utils/profiler.py``): the reference's tic/toc tree
(amgcl/profiler.hpp:53-216), a nested tree of named scopes with absolute
seconds and percentages.

Usage::

    prof = Profiler()
    with prof.scope("setup"):
        with prof.scope("coarsening"):
            ...
    print(prof)

or ``prof.tic("setup") ... prof.toc("setup")`` as the reference's
macros. ``Profiler.device(device)`` synchronizes a CUDA device at every
tic and toc, so that a scope's total holds the device time of the work
launched inside it, not only its dispatch (on the CPU there is nothing
to wait for). ``to_dict()`` exports the tree; ``to_chrome_trace()`` the
recorded occurrences as Chrome/Perfetto trace-event JSON.
"""

from __future__ import annotations

import time
import warnings
from contextlib import contextmanager
from typing import Callable, Dict, Optional


class _Node:
    __slots__ = ("name", "total", "count", "children", "_started")

    def __init__(self, name):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.children: Dict[str, "_Node"] = {}
        self._started = None


class Profiler:
    #: per-occurrence event cap of the trace export: past it only the
    #: aggregated tree keeps accumulating, and the export notes the drops
    MAX_EVENTS = 100_000

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.root = _Node("[root]")
        self._stack = [self.root]
        self._t0 = time.perf_counter()
        self._sync = sync
        #: (path, start_s, end_s) per closed scope occurrence
        self.events = []
        self._events_dropped = 0

    @classmethod
    def device(cls, device=None) -> "Profiler":
        """A profiler whose scope boundaries wait for ``device``: a CUDA
        device is synchronized, a CPU one (or None) needs no wait."""
        import torch
        device = torch.device(device) if device is not None else None
        if device is None or device.type != "cuda":
            return cls()
        return cls(sync=lambda: torch.cuda.synchronize(device))

    def _record_event(self, node, start, end):
        if len(self.events) >= self.MAX_EVENTS:
            if self._events_dropped == 0:
                warnings.warn(
                    "Profiler event cap reached (%d per-occurrence "
                    "events); further scope occurrences are dropped from "
                    "the trace export — aggregate totals stay complete"
                    % self.MAX_EVENTS)
            self._events_dropped += 1
            return
        path = "/".join([n.name for n in self._stack[1:]] + [node.name])
        self.events.append((path, start, end))

    def tic(self, name: str):
        if self._sync:
            self._sync()
        cur = self._stack[-1]
        node = cur.children.get(name)
        if node is None:
            node = cur.children[name] = _Node(name)
        node._started = time.perf_counter()
        self._stack.append(node)

    def toc(self, name: str):
        """Close the innermost scope, which must be ``name``; a mismatch
        raises and leaves the stack as it was."""
        if self._sync:
            self._sync()
        node = self._stack[-1]
        if node.name != name:
            raise RuntimeError("profiler scope mismatch: toc(%r) inside %r"
                               % (name, node.name))
        self._stack.pop()
        now = time.perf_counter()
        node.total += now - node._started
        node.count += 1
        self._record_event(node, node._started, now)

    def _unwind(self, depth: int):
        """Close every scope above ``depth``, left open by an exception
        that escaped between a tic and its toc inside :meth:`scope`."""
        now = time.perf_counter()
        while len(self._stack) > depth:
            node = self._stack.pop()
            node.total += now - node._started
            node.count += 1
            self._record_event(node, node._started, now)

    @contextmanager
    def scope(self, name: str):
        depth = len(self._stack)
        self.tic(name)
        try:
            yield
        except BaseException:
            self._unwind(depth + 1)
            self.toc(name)
            raise
        else:
            self.toc(name)

    def to_dict(self) -> dict:
        """{"total_s", "scopes": {name: {"total_s", "count", "children":
        {...}}}}, the tree of ``str(self)``."""
        def walk(node):
            return {name: {"total_s": ch.total, "count": ch.count,
                           **({"children": walk(ch)} if ch.children
                              else {})}
                    for name, ch in node.children.items()}

        return {"total_s": time.perf_counter() - self._t0,
                "scopes": walk(self.root)}

    def to_chrome_trace(self, tid: int = 0, tid_name: Optional[str] = None,
                        pid: int = 0, epoch: Optional[float] = None,
                        counters: Optional[Dict[str, Dict[str, float]]]
                        = None) -> dict:
        """Chrome/Perfetto trace events of the recorded occurrences: one
        complete ('X') event per closed scope, microseconds from
        ``epoch`` (default: this profiler's birth; pass one shared
        ``time.perf_counter()`` value to merge several tracks).
        ``counters`` ({track: {scope_path: value}}) adds counter tracks
        that step to the value over each occurrence of the path."""
        t0 = self._t0 if epoch is None else epoch
        events = []
        if tid_name:
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tid_name}})
        for path, start, end in self.events:
            events.append({
                "name": path.rsplit("/", 1)[-1], "cat": "amgcl", "ph": "X",
                "ts": round((start - t0) * 1e6, 3),
                "dur": round((end - start) * 1e6, 3),
                "pid": pid, "tid": tid, "args": {"path": path}})
            for track, by_path in (counters or {}).items():
                val = by_path.get(path)
                if val is None:
                    continue
                for ts, v in ((start, val), (end, 0.0)):
                    events.append({
                        "name": track, "cat": "amgcl", "ph": "C",
                        "ts": round((ts - t0) * 1e6, 3), "pid": pid,
                        "args": {track: v}})
        if self._events_dropped:
            last_end = self.events[-1][2] if self.events else t0
            events.append({
                "name": "events_dropped", "cat": "amgcl", "ph": "i",
                "s": "g", "ts": round((last_end - t0) * 1e6, 3),
                "pid": pid, "tid": tid,
                "args": {"dropped": self._events_dropped,
                         "cap": self.MAX_EVENTS}})
        out = {"traceEvents": events, "displayTimeUnit": "ms"}
        if self._events_dropped:
            out["otherData"] = {"events_dropped": self._events_dropped}
        return out

    def __str__(self):
        lines = ["Profile:"]
        total = time.perf_counter() - self._t0
        lines.append("%-40s %10.3f s" % ("[total]", total))

        def walk(node, depth):
            for name, ch in node.children.items():
                pct = 100.0 * ch.total / total if total > 0 else 0.0
                lines.append("%-40s %10.3f s %6.2f%%"
                             % ("  " * depth + name, ch.total, pct))
                walk(ch, depth + 1)

        walk(self.root, 1)
        return "\n".join(lines)


def aggregate(profilers):
    """{scope_path: (min, avg, max)} of every scope's total across
    ``profilers`` (the reference's ``perf_counter::mpi_aggregator``,
    amgcl/perf_counter/mpi_aggregator.hpp:43-123): ranks of a
    multi-process launch, or repeated runs."""
    totals = {}

    def walk(node, path):
        for name, ch in node.children.items():
            p = path + "/" + name if path else name
            totals.setdefault(p, []).append(ch.total)
            walk(ch, p)

    for pr in profilers:
        walk(pr.root, "")
    return {k: (min(v), sum(v) / len(v), max(v)) for k, v in totals.items()}


def format_aggregate(agg) -> str:
    lines = ["Aggregated profile:",
             "%-40s %10s %10s %10s" % ("", "min", "avg", "max")]
    for k in sorted(agg):
        mn, av, mx = agg[k]
        lines.append("%-40s %9.3fs %9.3fs %9.3fs" % (k, mn, av, mx))
    return "\n".join(lines)


#: module-level default profiler, as the reference's global ``prof``
prof = Profiler()
