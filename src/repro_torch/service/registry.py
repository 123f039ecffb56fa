"""GraphRegistry — named, versioned property graphs for the service layer.

The Arkouda/Arachne deployment model (PAPER.md) is a persistent parallel
server holding symbol-table entries that many Python clients name in their
messages; this registry is that symbol table for ``PropGraph``s.  Each
entry is (name → graph), the graph carries its own monotone ``version``
(bumped by every mutator — ``core/property_graph.py``), and the registry
fans mutation events out to subscribers (the service's result-cache
invalidation hook).

A registered graph keeps whatever device or entity mesh it was built or
loaded with (``PropGraph(mesh=...)`` / ``load_propgraph(path, mesh=...)``)
— the registry never touches device state.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from repro_torch.core.property_graph import PropGraph

__all__ = ["GraphRegistry"]


class GraphRegistry:
    """Thread-safe name → ``PropGraph`` map with mutation fan-out.

    ``subscribe(listener)`` registers ``listener(name, pg)``, called after
    any mutation of a registered graph (and on registration itself, so a
    subscriber can treat "new graph under this name" and "graph changed"
    uniformly — both invalidate anything cached under the name).
    """

    def __init__(self):
        self._graphs: Dict[str, PropGraph] = {}
        self._listeners: List[Callable[[str, PropGraph], None]] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------ population
    def register(self, name: str, pg: PropGraph) -> PropGraph:
        """Attach ``pg`` under ``name``; future mutations of ``pg`` notify
        subscribers.  Re-registering a name replaces the graph (and
        notifies, since cached results for the old graph are now dead).

        Exactly one hook per (registry, name, graph): refreshing the same
        registration is idempotent, and a replaced graph's hook goes
        silent (``_dispatch`` forwards only while the graph is still the
        one served under the name) instead of purging forever."""
        with self._lock:
            self._graphs[name] = pg
        marks = getattr(pg, "_registry_marks", None)
        if marks is None:
            marks = pg._registry_marks = set()
        # id(self) cannot be recycled while a mark exists: the installed
        # hook's closure holds this registry, so the graph pins it alive
        key = (id(self), name)
        if key not in marks:
            marks.add(key)
            pg.on_mutation(lambda g, _name=name: self._dispatch(_name, g))
        # registration is structural as far as observers go: anything cached
        # under this name belongs to whatever was served before, so the
        # notify must purge ALL of it — not just what the graph's last
        # (possibly attribute-scoped) mutation event would overlap
        from repro_torch.overlay.delta import MutationEvent

        pg.last_mutation = MutationEvent.structural_event("register")
        self._notify(name, pg)
        return pg

    def unregister(self, name: str) -> None:
        """Drop ``name`` (no-op if absent).  The graph's installed hook goes
        silent via the ``_dispatch`` currency check; no notification fires —
        observers drop their own state via ``Service.drop_graph``."""
        with self._lock:
            self._graphs.pop(name, None)

    def _dispatch(self, name: str, pg: PropGraph) -> None:
        with self._lock:
            current = self._graphs.get(name)
        if current is pg:
            self._notify(name, pg)

    def load(self, name: str, path: str, *, backend: Optional[str] = None,
             mesh=None, device=None) -> PropGraph:
        """``load_propgraph`` + ``register`` — reopen an ingested-once graph
        on ``device`` (None: the CUDA card), or straight onto an entity
        ``mesh``, and serve it by name."""
        from repro_torch.core.io import load_propgraph

        return self.register(name, load_propgraph(path, backend=backend, mesh=mesh,
                                                  device=device))

    # -------------------------------------------------------------- queries
    def get(self, name: str) -> PropGraph:
        with self._lock:
            try:
                return self._graphs[name]
            except KeyError:
                raise KeyError(
                    f"unknown graph {name!r}; registered: {sorted(self._graphs)}"
                ) from None

    def version(self, name: str) -> int:
        """The graph's current mutation counter — the freshness component of
        every result-cache key."""
        return self.get(name).version

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._graphs)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._graphs

    def __len__(self) -> int:
        with self._lock:
            return len(self._graphs)

    # ---------------------------------------------------------- subscription
    def subscribe(self, listener: Callable[[str, PropGraph], None]) -> None:
        with self._lock:
            self._listeners.append(listener)

    def unsubscribe(self, listener: Callable[[str, PropGraph], None]) -> None:
        """Remove ``listener`` if present (no-op otherwise) — a closed
        service detaches so a shared registry stops feeding dead caches."""
        with self._lock:
            try:
                self._listeners.remove(listener)
            except ValueError:
                pass

    def _notify(self, name: str, pg: PropGraph) -> None:
        # snapshot under the lock: services subscribe/unsubscribe (open/
        # close) concurrently with mutation dispatch, and an unsynchronized
        # list mutation mid-iteration would skip or crash a listener.
        # Dispatch OUTSIDE the lock — listeners (cache purges) must not be
        # able to deadlock against registry readers.
        with self._lock:
            listeners = list(self._listeners)
        for listener in listeners:
            listener(name, pg)
