"""Overlay compaction — the LSM merge step (docs/ARCHITECTURE.md §11).

``compact_propgraph`` folds a graph's whole overlay (delta edges, delta
attribute pairs, vertex/edge tombstones) into fresh base stores, as if the
surviving data had been bulk-ingested from scratch: the same ``build_di``
sort, pair insertion order and attribute-map order — so post-compaction
``match()`` / ``khop()`` / ``components()`` are bitwise what a
from-scratch build answers.  The structure is rebuilt and the pairs
remapped on the graph's device; the pair replay and the column remap run
on the host.

``Compactor`` is the background policy thread: it sweeps a registry of
graphs (any object with ``names()`` and ``get(name)``) and compacts each
writable graph whose ``overlay_size()`` crossed the threshold, bounding
the read cost of the delta union while writes stream in.  Snapshots
(frozen views) are never compacted — their pinned delta chain IS their
contract.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import dip_shard
from repro_torch.core.attr_map import AttributeMap
from repro_torch.core.di import build_di, edge_lookup
from repro_torch.core.property_graph import PropGraph, _AttrStore
from repro_torch.obs.metrics import GLOBAL as _OBS
from repro_torch.obs.metrics import enabled as _obs_enabled

__all__ = ["compact_propgraph", "Compactor"]


def compact_propgraph(pg: PropGraph) -> PropGraph:
    """Merge the overlay into the base, in place on ``pg`` (the caller
    bumps ``version``).

    Gathers the full effective state FIRST (so nothing is lost when the
    stores are swapped), rebuilds the DI structure from the surviving
    original-id edge list, then remaps attribute pairs and typed columns
    through the old→new internal-id maps.

    Runs under the graph's write lock (``PropGraph.compact`` takes it, as
    every mutator does), so no mutation can land between the gather and
    the swap and be lost.  Lock-free readers may see the swap torn; the
    version bump that follows tells them to retry.
    """
    g_eff = pg._require_graph()
    dev = g_eff.device
    nm_old = pg._node_map_host
    src = g_eff.src.cpu().numpy()
    dst = g_eff.dst.cpu().numpy()
    m_eff = len(src)
    ae = pg._alive_edge_mask()
    alive_e = np.ones(m_eff, dtype=bool) if ae is None else ae.cpu().numpy()

    # ---- gather the complete effective state before any swap -------------
    v_ent, v_att = pg._vstore.all_pairs()
    v_values = pg._vstore.amap.values
    e_ent, e_att = pg._estore.all_pairs()
    e_values = pg._estore.amap.values
    vprops = pg.host_columns("node")
    eprops = pg.host_columns("edge")

    # ---- rebuild structure from surviving original-id edges --------------
    new_g = build_di(nm_old[src[alive_e]], nm_old[dst[alive_e]], device=dev)
    if pg.mesh is not None:  # the new structure is placed as the old one was
        new_g = dip_shard.place_graph(new_g, pg.mesh)
    nm_new = new_g.node_map.cpu().numpy()

    # old internal id → new internal id (−1 = dropped).  The new universe is
    # the surviving edges' endpoint set — dead and detached vertices vanish,
    # exactly as a from-scratch build of the surviving edge list has it.
    if nm_new.size:
        pos = np.clip(np.searchsorted(nm_new, nm_old), 0, nm_new.size - 1)
        vmap = np.where(nm_new[pos] == nm_old, pos, -1).astype(np.int32)
    else:
        vmap = np.full(nm_old.size, -1, np.int32)
    if pg._dead_v is not None:
        vmap[pg._dead_v] = -1

    # old global edge id → new edge id, via endpoints through the new SEG
    new_eid_all = np.full(m_eff, -1, np.int32)
    eu, ev = vmap[src], vmap[dst]
    ok_e = alive_e & (eu >= 0) & (ev >= 0)
    if ok_e.any() and new_g.m > 0:
        new_eid_all[ok_e] = edge_lookup(new_g, torch.from_numpy(eu[ok_e]).to(dev),
                                        torch.from_numpy(ev[ok_e]).to(dev)).cpu().numpy()

    # ---- attribute stores: replay the pair history remapped --------------
    def replay(n_rows, values, ent, att, remap):
        store = _AttrStore(pg.backend, n_rows, dev, mesh=pg.mesh)  # re-shards when it seals
        store.amap = AttributeMap(values)  # id order preserved → same masks
        if ent.size:
            ne = remap[ent]
            keep = ne >= 0
            if keep.any():
                store._pairs_e.append(ne[keep].astype(np.int32))
                store._pairs_a.append(att[keep].astype(np.int32))
        return store

    vs = replay(new_g.n, v_values, v_ent, v_att, vmap)
    es = replay(max(new_g.m, 1), e_values, e_ent, e_att, new_eid_all)

    # ---- typed columns ---------------------------------------------------
    new_vprops, new_eprops, new_dtypes = {}, {}, {}
    inv = np.searchsorted(nm_old, nm_new)  # nm_new ⊆ nm_old: exact hits
    for name, (col, msk) in vprops.items():
        new_vprops[name], new_dtypes[("node", name)] = pg._place_column(col[inv], msk[inv])
    okc = new_eid_all >= 0
    for name, (col, msk) in eprops.items():
        c = np.zeros(m_eff, col.dtype)
        c[:len(col)] = col  # columns may predate the delta edges
        mm = np.zeros(m_eff, dtype=bool)
        mm[:len(msk)] = msk
        nc = np.zeros(new_g.m, col.dtype)
        nmk = np.zeros(new_g.m, dtype=bool)
        nc[new_eid_all[okc]] = c[okc]
        nmk[new_eid_all[okc]] = mm[okc]
        new_eprops[name], new_dtypes[("edge", name)] = pg._place_column(nc, nmk)

    # ---- swap (the caller sets last_mutation and bumps version) ----------
    pg._set_graph(new_g)
    pg._vstore = vs
    pg._estore = es
    pg.vertex_props = new_vprops
    pg.edge_props = new_eprops
    pg._col_dtypes = new_dtypes
    pg._delta_edges = None
    pg._dead_v = None
    pg._dead_e = None
    pg._reset_caches()
    return pg


class Compactor(threading.Thread):
    """Background merge policy: sweep a registry, compact writable graphs
    whose overlay crossed ``threshold`` entries.

    Safe against concurrent WRITERS because ``PropGraph.compact()`` and
    every mutator serialize on the graph's write lock — a write can never
    land inside the gather→rebuild→swap window and be lost in the swap.
    Readers take no lock: a compaction landing mid-query is like any other
    write (the version moves).  ``sweep()`` is callable directly for
    deterministic tests.

    Failures are never silent: a per-graph compaction error is counted
    (``errors``/``last_error``, ``stats()``) and after ``MAX_FAILURES``
    consecutive failures the graph is skipped — a deterministically failing
    graph cannot pin the thread in a hot retry loop; its counter resets if
    a later manual ``compact()`` drains the overlay or a sweep succeeds.  A
    failure of the registry itself backs the thread off (doubling the wait
    up to 2 s).
    """

    MAX_FAILURES = 3  # consecutive per-graph failures before it is skipped

    def __init__(self, registry, threshold: int, interval: float = 0.05):
        super().__init__(daemon=True, name="overlay-compactor")
        self._registry = registry
        self.threshold = threshold
        self.interval = interval
        self.compactions = 0
        self.errors = 0
        self.last_error: Optional[str] = None
        self._failures: Dict[str, int] = {}  # graph name → consecutive failures
        self._stop_evt = threading.Event()

    def sweep(self) -> int:
        t0 = time.perf_counter()
        done = 0
        for name in self._registry.names():
            try:
                pg = self._registry.get(name)
            except KeyError:
                continue  # dropped between names() and get()
            if pg is None or getattr(pg, "_frozen", False):
                continue
            overlay = pg.overlay_size()
            if overlay < self.threshold:
                # below the threshold — if it failed here before, something
                # (a manual compact) drained it: forgive it
                self._failures.pop(name, None)
                continue
            if self._failures.get(name, 0) >= self.MAX_FAILURES:
                continue  # a repeatedly failing graph: stop burning CPU on it
            if _obs_enabled():
                _OBS.histogram(
                    "pg_compact_delta_size",
                    "overlay entries folded per compaction",
                    buckets=(16, 64, 256, 1024, 4096, 16384, 65536),
                ).observe(overlay)
            try:
                pg.compact()
            except Exception as e:  # noqa: BLE001 — isolate to this graph
                self.errors += 1
                self._failures[name] = self._failures.get(name, 0) + 1
                self.last_error = f"{name}: {type(e).__name__}: {e}"
                if _obs_enabled():
                    _OBS.counter("pg_compact_failures",
                                 "background compaction failures").inc()
                continue
            self._failures.pop(name, None)
            done += 1
        self.compactions += done
        if _obs_enabled():
            _OBS.counter("pg_compact_compactions",
                         "background compactions completed").inc(done)
            _OBS.histogram("pg_compact_sweep_ms",
                           "compactor sweep duration").observe((time.perf_counter() - t0) * 1e3)
        return done

    def stats(self) -> Dict[str, object]:
        """Operator-facing counters."""
        return {
            "compactions": self.compactions,
            "errors": self.errors,
            "last_error": self.last_error,
            "failing_graphs": dict(self._failures),
        }

    def run(self) -> None:
        delay = self.interval
        while not self._stop_evt.wait(delay):
            try:
                self.sweep()
                delay = self.interval
            except Exception as e:  # noqa: BLE001 — registry-level failure:
                # record it and back off instead of spinning silently
                self.errors += 1
                self.last_error = f"sweep: {type(e).__name__}: {e}"
                delay = min(max(delay * 2, self.interval), 2.0)

    def stop(self, timeout: Optional[float] = 2.0) -> None:
        self._stop_evt.set()
        if self.is_alive():
            self.join(timeout=timeout)
