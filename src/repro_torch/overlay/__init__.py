"""Overlay subsystem: LSM-style delta write path, snapshots, copy-on-write
views and compaction (docs/ARCHITECTURE.md §11).

Import layering: ``overlay.delta`` is pure numpy (core imports it);
``overlay.views`` and ``overlay.compactor`` import core (``PropGraph``
reaches them through lazy imports in ``snapshot``/``fork``/``compact``).
"""
from repro_torch.overlay.delta import (AttrDelta, EdgeDelta, MutationEvent, overlaps,
                                       pattern_refs)

__all__ = [
    "AttrDelta",
    "EdgeDelta",
    "MutationEvent",
    "pattern_refs",
    "overlaps",
    "clone_propgraph",
    "compact_propgraph",
    "Compactor",
]


def __getattr__(name):
    # lazy: these pull in core.property_graph (a heavier import chain)
    if name == "clone_propgraph":
        from repro_torch.overlay.views import clone_propgraph
        return clone_propgraph
    if name in ("compact_propgraph", "Compactor"):
        from repro_torch.overlay import compactor
        return getattr(compactor, name)
    raise AttributeError(name)
