"""Process-wide metrics primitives — counters, gauges, fixed-bucket
histograms — with Prometheus text exposition (docs/ARCHITECTURE.md §13).

Pure Python, copied from the reference package's ``obs/metrics.py`` so that
the port imports nothing of it.

One vocabulary for every subsystem's accounting instead of per-module
ad-hoc dicts: the scheduler, the LRU caches, the executor and frontier
engines, the overlay/compactor and the wire layer all register their
instruments here, and three consumers read them back —
``Service.stats()`` (the flat snapshot dict), the ``metrics`` wire verb
(Prometheus text), and the benchmark overhead guard.

Two registry scopes, by OWNERSHIP of the instrumented object:

* ``GLOBAL`` — the module-level registry for process-wide call sites
  (wire frames/bytes, executor plan counts, compactor sweeps): code that
  has no natural owner object.  A server process has exactly one of
  everything, so Prometheus exposition renders ``GLOBAL`` plus the
  service's own registry as one scrape.
* per-``Service`` ``MetricsRegistry`` instances — counters whose
  lifetime IS the service's (request/batch/cache accounting).  Tests
  build many short-lived services in one process; giving each its own
  registry keeps their ``stats()`` deltas deterministic instead of
  accumulating across instances.

Cost model: every mutating call checks the module-level ``_ENABLED``
flag first and returns immediately when instrumentation is off — the
disabled path is one global read and a branch (the bench_serve overhead
guard pins it at <5% on the coalesce row).  When enabled, counters and
gauges are one lock + int add; histograms add a bisect over a small
fixed bucket list.  Instrument objects are created once and cached on
``(name, labels)``, so steady-state call sites never re-enter the
registry lock.

Naming: short legacy keys (``result_hits`` — what ``Service.stats()``
has always returned) are accepted as metric names and normalized to
Prometheus conventions only at render time (``pg_service_result_hits_total``);
names that already carry a ``pg_`` prefix render as-is.  ``parse_prometheus``
is the matching reader (tests and the smoke gates use it to assert the
exposition agrees with ``stats()``).
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "enabled",
    "set_enabled",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "GLOBAL",
    "DEFAULT_MS_BUCKETS",
    "SIZE_BUCKETS",
    "render_prometheus",
    "parse_prometheus",
]

_ENABLED = True  # module-level switch; call sites read it once per call


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Flip instrumentation globally; returns the PREVIOUS value (so
    benchmark guards can restore it).  Applies to every registry at once —
    the flag is the module's, not a registry's."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


# latency histograms (milliseconds): sub-100µs scheduler waits up to
# multi-second compiles land in distinct buckets
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0,
)
# occupancy/width histograms (counts): powers of two up to the scheduler's
# max_batch × the largest Q bucket
SIZE_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class _Metric:
    """Shared identity: ``name`` plus a frozen label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = threading.Lock()

    def key(self) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
        return (self.name, self.labels)


class Counter(_Metric):
    """Monotonic counter.  ``inc`` is atomic (lock + int add) — safe under
    the scheduler worker, session writer threads and the compactor daemon
    concurrently (the ``Service._bump`` lost-update audit's fix)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = ()):
        super().__init__(name, help, labels)
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value += n

    def set_total(self, value) -> None:
        """Mirror an externally-maintained monotonic total (the LRU caches
        keep their own hit/miss ints; exposition copies them in here so the
        text format and ``stats()`` can never disagree).  Monotonicity is
        the CALLER's contract."""
        with self._lock:
            self._value = value

    def value(self):
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Point-in-time value (cache occupancy, capacity).  NOT gated on the
    enable flag: gauges record state rather than hot-path events — they
    are set at exposition time (``Service.metrics_text`` mirrors cache
    occupancy in) and must stay truthful even with instrumentation off."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = ()):
        super().__init__(name, help, labels)
        self._value = 0.0

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        self.inc(-n)

    def value(self):
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram: cumulative bucket counts, sum, count —
    the Prometheus ``le`` semantics.  Buckets are chosen at registration
    and never resize (observation cost stays a bisect + two adds)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = (),
                 buckets: Tuple[float, ...] = DEFAULT_MS_BUCKETS):
        super().__init__(name, help, labels)
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"buckets must be sorted and non-empty: {buckets}")
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value) -> None:
        if not _ENABLED:
            return
        v = float(value)
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def value(self) -> Dict[str, object]:
        """Snapshot as a plain dict (what ``Service.stats()`` embeds)."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, out = 0, {}
        for b, c in zip(self.buckets, counts):
            cum += c
            out[b] = cum
        return {"count": total, "sum": s, "buckets": out}


class MetricsRegistry:
    """Thread-safe get-or-create home for instruments.

    ``counter("result_hits")`` returns THE counter of that (name, labels)
    identity — repeated calls are a dict hit, so call sites may fetch by
    name on the hot path or hold the object, whichever reads better."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[tuple, _Metric] = {}

    def _get(self, cls, name: str, help: str, labels: dict, **kw) -> _Metric:
        lab = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        key = (name, lab)
        m = self._metrics.get(key)  # racy fast path: dict get is atomic
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, help=help, labels=lab, **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_MS_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, object]:
        """Flat dict: unlabeled metrics key by bare name, labeled ones by
        ``name{k=v,...}``.  Counters/gauges → numbers, histograms → the
        ``value()`` dict.  This is ``Service.stats()``'s backing read."""
        out: Dict[str, object] = {}
        for m in self.metrics():
            if m.labels:
                lab = ",".join(f"{k}={v}" for k, v in m.labels)
                out[f"{m.name}{{{lab}}}"] = m.value()
            else:
                out[m.name] = m.value()
        return out


GLOBAL = MetricsRegistry()


# --------------------------------------------------------------- exposition
def _prom_name(m: _Metric) -> str:
    """Normalize a metric name to Prometheus conventions: short legacy
    service keys pick up the ``pg_service_`` namespace, counters the
    ``_total`` suffix; explicit ``pg_*`` names pass through."""
    name = m.name
    if not name.startswith("pg_"):
        name = "pg_service_" + name
    name = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    if m.kind == "counter" and not name.endswith("_total"):
        name += "_total"
    return name


def _fmt_labels(labels: Iterable[Tuple[str, str]], extra: str = "") -> str:
    parts = [
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in labels
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def render_prometheus(*registries: MetricsRegistry) -> str:
    """Prometheus text format (version 0.0.4) for every instrument in
    ``registries``, grouped by family so ``# TYPE`` appears once per name.
    Disabled instrumentation still renders — values just stop moving."""
    families: Dict[str, List[_Metric]] = {}
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for reg in registries:
        for m in reg.metrics():
            pname = _prom_name(m)
            families.setdefault(pname, []).append(m)
            kinds.setdefault(pname, m.kind)
            if m.help:
                helps.setdefault(pname, m.help)
    lines: List[str] = []
    for pname in sorted(families):
        if pname in helps:
            lines.append(f"# HELP {pname} {helps[pname]}")
        lines.append(f"# TYPE {pname} {kinds[pname]}")
        for m in families[pname]:
            if isinstance(m, Histogram):
                snap = m.value()
                for le, cum in snap["buckets"].items():
                    le_lab = 'le="%s"' % _fmt_value(le)
                    lines.append(
                        f"{pname}_bucket{_fmt_labels(m.labels, le_lab)} {cum}")
                inf_lab = 'le="+Inf"'
                lines.append(
                    f"{pname}_bucket{_fmt_labels(m.labels, inf_lab)} "
                    f"{snap['count']}")
                lines.append(
                    f"{pname}_sum{_fmt_labels(m.labels)} {_fmt_value(snap['sum'])}")
                lines.append(
                    f"{pname}_count{_fmt_labels(m.labels)} {snap['count']}")
            else:
                lines.append(
                    f"{pname}{_fmt_labels(m.labels)} {_fmt_value(m.value())}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, float]:
    """Strict-enough reader for the text format: returns
    ``{"name" | "name{labels}": value}``.  Raises ``ValueError`` on any
    malformed sample line — the smoke gates call this to assert the
    exposition actually parses, so leniency here would defeat them."""
    out: Dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # name{labels} value  |  name value   (no timestamps emitted here)
        if "}" in line:
            name_part, _, rest = line.partition("}")
            name_part += "}"
            value_part = rest.strip()
            if "{" not in name_part:
                raise ValueError(f"line {lineno}: unbalanced labels: {line!r}")
        else:
            name_part, _, value_part = line.partition(" ")
        if not name_part or not value_part:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        try:
            value = float(value_part.split()[0])
        except ValueError:
            raise ValueError(
                f"line {lineno}: bad value {value_part!r}") from None
        bare = name_part.split("{", 1)[0]
        if not bare or not (bare[0].isalpha() or bare[0] == "_"):
            raise ValueError(f"line {lineno}: bad metric name {bare!r}")
        out[name_part] = value
    return out
