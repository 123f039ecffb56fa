"""Thread-safe LRU caches for the analytics service.

Two instances per ``Service`` (the reference package's service README, "Cache keys"):

* **plan cache** — key ``(canonical pattern, backend, impl)`` → ``Plan``.
  Plans are graph-independent semantically (a plan is the pattern plus
  per-mask impl choices; reorientation only changes propagation ORDER, not
  the match set), so the key deliberately excludes the graph version —
  a plan survives mutations; only its selectivity estimates go stale,
  which costs performance, never correctness.
* **result cache** — key ``(graph name, canonical pattern, impl)`` →
  ``(version, pattern refs, MatchResult)``.  Freshness is maintained by
  OVERLAP-BASED purging instead of a version key component: when the
  registry reports a mutation, the service drops only entries whose
  pattern footprint (labels/relationships/properties, carried in the
  value) the mutation's ``MutationEvent`` touches — a result cached at
  snapshot S keeps serving hits across writes that only grew the delta
  chain past S with unrelated attributes (docs/ARCHITECTURE.md §11).
  Structural events (edge inserts/deletes, rebuilds, compaction) purge
  every entry for the graph.

``maxsize=0`` disables a cache (every ``get`` misses, ``put`` is a no-op) —
the benchmark's "coalescing only" configuration.  Pure Python, copied from
the reference package so that the port imports nothing of it.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional

__all__ = ["LRUCache"]

_MISS = object()


class LRUCache:
    """OrderedDict-based LRU with hit/miss/eviction accounting.

    All operations take the internal lock — safe to share between client
    threads (submit-side result-cache probes), the scheduler worker and
    mutation hooks (purge)."""

    def __init__(self, maxsize: int):
        if maxsize < 0:
            raise ValueError(f"maxsize must be ≥ 0, got {maxsize}")
        self.maxsize = maxsize
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            val = self._data.get(key, _MISS)
            if val is _MISS:
                self.misses += 1
                return default
            self._data.move_to_end(key)
            self.hits += 1
            return val

    def put(self, key: Hashable, value: Any) -> None:
        if self.maxsize == 0:
            return
        with self._lock:
            self._data[key] = value
            # move_to_end is load-bearing on overwrite: assignment to an
            # EXISTING key keeps its old OrderedDict position, and a hot
            # re-inserted entry left there would be evicted as if cold
            # (tests/test_torch_service.py: ..._put_on_existing_key_refreshes...)
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1

    def purge(self, predicate: Callable[[Hashable, Any], bool]) -> int:
        """Drop every entry where ``predicate(key, value)`` holds; returns
        the number dropped (the service's invalidation counter feed).  The
        value participates so the result cache can purge by OVERLAP — its
        entries carry the pattern's attribute footprint (§11)."""
        with self._lock:
            dead = [k for k, v in self._data.items() if predicate(k, v)]
            for k in dead:
                del self._data[k]
            return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._data),
                "maxsize": self.maxsize,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
