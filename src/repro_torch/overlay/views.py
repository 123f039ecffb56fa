"""Snapshots and copy-on-write views over a PropGraph (docs/ARCHITECTURE.md §11).

Both are the same structurally-shared clone; only the ``frozen`` bit
differs:

* ``pg.snapshot()``  → frozen clone.  Pins (base store @ version, frozen
  delta chain); every mutator raises.  Long-running analytics read it
  while writes keep landing on the parent.
* ``pg.fork()``      → writable clone.  (base graph @ snapshot, private
  overlay): what-if mutations land in the clone's own delta buffers and
  tombstones, sharing the parent's device-resident base.

Sharing is safe because every heavy piece is immutable or replaced by the
mutators, never edited in place.  Torch tensors CAN be edited in place, so
this is a rule the port keeps: a write builds a new tensor (out-of-place
``index_put``/``index_fill``/``cat``) and reassigns it.

  shared by reference   base DIGraph tensors, sealed DIP stores (on a mesh
                        their shards), the ``_host`` stash, ``_counts``,
                        ``_base_keys``, typed property columns, tombstone
                        arrays (copy-on-write reassign), pair/delta CHUNK
                        arrays
  private per clone     chunk LISTS (appends diverge), delta index dicts,
                        AttributeMap (interning mutates), props dicts,
                        mutation hooks, the combined-view, alive-mask and
                        sampling caches
"""
from __future__ import annotations

import threading

from repro_torch.core.property_graph import PropGraph

__all__ = ["clone_propgraph"]


def clone_propgraph(pg: PropGraph, *, frozen: bool) -> PropGraph:
    # the parent's write lock keeps the multi-field read consistent — a
    # concurrent mutator or compaction cannot hand us a torn (new graph,
    # old stores) pin; the clone is its own write domain with a fresh lock
    with pg._write_lock:
        c = PropGraph.__new__(PropGraph)
        c.backend = pg.backend
        c.mesh = pg.mesh
        c.device = pg.device
        c.graph = pg.graph
        c._node_map_host = pg._node_map_host
        c._vstore = pg._vstore.clone() if pg._vstore is not None else None
        c._estore = pg._estore.clone() if pg._estore is not None else None
        c.vertex_props = dict(pg.vertex_props)
        c.edge_props = dict(pg.edge_props)
        c._col_dtypes = dict(pg._col_dtypes)
        c.version = pg.version
        c.last_mutation = None
        c._mutation_hooks = []  # observers watch the parent, not its views
        c._delta_edges = (pg._delta_edges.frozen_copy()
                          if pg._delta_edges is not None else None)
        c._dead_v = pg._dead_v  # copy-on-write: mutators reassign, never edit
        c._dead_e = pg._dead_e
        c._frozen = frozen
        c._write_lock = threading.RLock()
        c._reset_caches()
        return c
