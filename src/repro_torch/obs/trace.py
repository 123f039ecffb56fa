"""Per-query trace spans (docs/ARCHITECTURE.md §13).

A ``Trace`` is one query's tree of timed ``Span``s — the canonical span
vocabulary is parse → plan → cache → batch.wait → compile → execute →
serialize, though callers may nest anything.  Traces are explicit
objects handed along the call chain rather than thread-locals, because a
served query hops threads twice (submit thread → scheduler worker →
session writer) and implicit context would silently detach.

Trace ids are caller-supplied (the wire client mints one per query and
sends it in the frame header; the server echoes the finished span tree
back in the response header) or minted locally.  Finished traces land in
a per-service ``TraceBuffer``: a bounded ring plus a slow-query ring for
traces over a wall-time threshold.

Everything here is wall-clock bookkeeping on the host — ``Span`` never
touches device state, so a span around a CUDA launch measures the launch
unless the caller synchronizes (the EXPLAIN ANALYZE path in
obs/profile.py is the one that synchronizes the graph's device to split
the first call from the steady state).  Pure Python, copied from the
reference package so that the port imports nothing of it.
"""
from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Trace", "TraceBuffer", "new_trace_id"]

_now = time.perf_counter


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed node in a trace tree.  Context manager::

        with trace.span("plan") as sp:
            plan = plan_pattern(...)
            sp.annotate(steps=len(plan.mask_steps))
    """

    __slots__ = ("name", "t0", "t1", "attrs", "children", "_trace")

    def __init__(self, name: str, trace: "Trace",
                 t0: Optional[float] = None):
        self.name = name
        self.t0 = _now() if t0 is None else t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = {}
        self.children: List["Span"] = []
        self._trace = trace

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)

    def finish(self) -> None:
        if self.t1 is None:
            self.t1 = _now()

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def span(self, name: str) -> "Span":
        """Open a child span (returns it started; use as a context manager
        or ``finish()`` it explicitly)."""
        child = Span(name, self._trace)
        with self._trace._lock:
            self.children.append(child)
        return child

    @property
    def duration_ms(self) -> float:
        end = self.t1 if self.t1 is not None else _now()
        return (end - self.t0) * 1e3

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name,
                             "ms": round(self.duration_ms, 4)}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["spans"] = [c.to_dict() for c in self.children]
        return d


class Trace:
    """One query's span tree, rooted at ``name`` (e.g. ``"query"``)."""

    __slots__ = ("trace_id", "root", "_lock")

    def __init__(self, name: str = "query",
                 trace_id: Optional[str] = None):
        self.trace_id = trace_id or new_trace_id()
        self._lock = threading.Lock()
        self.root = Span(name, self)

    def span(self, name: str, parent: Optional[Span] = None) -> Span:
        return (parent or self.root).span(name)

    def add_span(self, name: str, t0: float, t1: float,
                 parent: Optional[Span] = None, **attrs) -> Span:
        """Record a span from explicit ``perf_counter`` endpoints — for
        stage timings measured once per coalesced GROUP and copied into
        every member request's trace afterwards."""
        sp = Span(name, self, t0=t0)
        sp.t1 = t1
        sp.attrs.update(attrs)
        with self._lock:
            (parent or self.root).children.append(sp)
        return sp

    def annotate(self, **attrs) -> "Trace":
        self.root.annotate(**attrs)
        return self

    def finish(self) -> "Trace":
        self.root.finish()
        return self

    @property
    def finished(self) -> bool:
        return self.root.t1 is not None

    @property
    def duration_ms(self) -> float:
        return self.root.duration_ms

    def to_dict(self) -> Dict[str, Any]:
        d = self.root.to_dict()
        d["trace_id"] = self.trace_id
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Trace":
        """Rehydrate a serialized span tree (client side of the wire
        round-trip).  Durations are preserved as recorded; absolute
        perf_counter epochs are not meaningful across processes, so spans
        are re-anchored at 0."""
        tr = cls(name=d.get("name", "query"), trace_id=d.get("trace_id"))

        def _load(node: Dict[str, Any], into: Span) -> None:
            into.t0 = 0.0
            into.t1 = float(node.get("ms", 0.0)) / 1e3
            into.attrs = dict(node.get("attrs", {}))
            for child in node.get("spans", []):
                sp = Span(child.get("name", "?"), tr)
                into.children.append(sp)
                _load(child, sp)

        _load(d, tr.root)
        return tr


class TraceBuffer:
    """Bounded ring of finished traces + a slow-query ring.

    ``push`` finishes the trace if the caller hasn't, appends to the main
    ring (oldest evicted), and mirrors traces at or above ``slow_ms``
    into the slow ring.  ``slow_ms=0`` captures everything (the tests'
    lever); ``maxlen=0`` disables collection entirely.
    """

    def __init__(self, maxlen: int = 256, slow_ms: float = 250.0,
                 slow_maxlen: int = 64):
        self.maxlen = int(maxlen)
        self.slow_ms = float(slow_ms)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(self.maxlen, 1))
        self._slow: deque = deque(maxlen=max(int(slow_maxlen), 1))

    def push(self, trace: Trace) -> None:
        if self.maxlen <= 0:
            return
        trace.finish()
        with self._lock:
            self._ring.append(trace)
            if trace.duration_ms >= self.slow_ms:
                self._slow.append(trace)

    def traces(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._ring)
        return [t.to_dict() for t in items]

    def slow(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._slow)
        return [t.to_dict() for t in items]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
