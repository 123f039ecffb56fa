"""repro_torch.obs — the observability layer's metrics (docs/ARCHITECTURE.md §13).

``obs.metrics`` holds thread-safe counters, gauges and fixed-bucket
histograms in per-owner and process-``GLOBAL`` registries, with Prometheus
text exposition and a module-level switch (``set_enabled(False)``).  The
per-query traces and EXPLAIN ANALYZE come with the service's port.
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

__all__ = [
    "GLOBAL",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "enabled",
    "set_enabled",
    "render_prometheus",
    "parse_prometheus",
]
