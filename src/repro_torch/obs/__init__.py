"""repro_torch.obs — observability layer (docs/ARCHITECTURE.md §13).

One instrumentation vocabulary for the whole port, with the reference's
metric names:

* ``obs.metrics`` — thread-safe counters / gauges / fixed-bucket
  histograms in per-``Service`` and process-``GLOBAL`` registries, with
  Prometheus text exposition and a module-level kill switch
  (``set_enabled(False)`` → every call site degrades to one branch).
* ``obs.trace`` — per-query span trees (parse→plan→cache→batch→execute→
  serialize) with wire-propagated trace ids, a bounded trace ring and a
  slow-query log.
* ``obs.profile`` — EXPLAIN ANALYZE: executed plans annotated with
  per-stage wall times and the measured first-call share, the graph's
  device synchronized after each stage.
"""
from repro_torch.obs.metrics import (
    GLOBAL,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    enabled,
    parse_prometheus,
    render_prometheus,
    set_enabled,
)
from repro_torch.obs.profile import ProfileReport, profile_match
from repro_torch.obs.trace import Span, Trace, TraceBuffer, new_trace_id

__all__ = [
    "GLOBAL",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "enabled",
    "parse_prometheus",
    "render_prometheus",
    "set_enabled",
    "ProfileReport",
    "profile_match",
    "Span",
    "Trace",
    "TraceBuffer",
    "new_trace_id",
]
