"""PropGraph — the user-facing property-graph API (mirrors Arachne's Python surface).

Workflow (§V of the paper):

    pg = PropGraph(backend="arr")                      # on the CUDA card
    pg.add_edges_from(src, dst)                        # bulk DI build
    pg.add_node_labels(nodes, labels)                  # strings ok
    pg.add_edge_relationships(esrc, edst, rels)
    pg.add_node_properties("age", nodes, ages)         # typed columns
    vmask = pg.query_labels(["person", "place"])       # OR semantics
    res = pg.match("(a:person {age > 30})-[:follows]->(b:place)")

Ingestion follows the paper's three steps: (1) attribute values remapped to
dense int ids (``AttributeMap``), (2) internal vertex/edge indices generated
(vertex normalization + ``edge_lookup`` binary search), (3) bulk insert into
the chosen DIP backend, which seals at its first query.  Backends: ``arr``
(DIP-ARR bitmap), ``list`` (DIP-LIST CSR), ``listd`` (DIP-LISTD linked
chains + inverted CSR).  ``core/io.py`` saves a graph and loads it under
any backend.

The port covers ingest, ``match()``, ``sample()``, the frontier analytics
(``khop``, ``components``, ``shortest_paths``, ``pagerank``,
``communities``) and the overlay (docs/ARCHITECTURE.md §11: writes after a
store sealed, ``insert_edges``, tombstones, property updates,
``snapshot``/``fork``, ``compact``) on every backend, with EXPLAIN ANALYZE
(``match(profile=True)``, ``explain_analyze``) and the analytics' run
metrics.

Distribution (docs/ARCHITECTURE.md §7): ``PropGraph(backend=...,
mesh=make_entity_mesh(...))`` shards the DIP stores — the heavy query-side
data — over the mesh's P devices (``core.dip_shard``), and every store
query runs shard by shard, each shard scanning only its N/P entities.
``khop``, ``shortest_paths`` and ``pagerank`` relax each shard's block of
the edges and all-reduce the partials.  The DI arrays, the typed columns,
the combine, the propagation, sampling, ``components`` and
``communities`` stay on the mesh's lead device (``launch/sharding.py``).
Every answer equals the single-device one: bitwise, PageRank within float
tolerance.

Overlay reads compose before propagation: a sealed store answers
``base | delta`` (the delta's matches reach the device as ids, never as a
full-length host mask), and tombstoned vertices and edges AND out of every
mask through alive masks built on the device once per ``version``.
Torch tensors are mutable where JAX arrays are not, so every write
replaces a tensor (out-of-place ``index_put``/``index_fill``/``cat``) and
never edits one a snapshot or fork may share.

``device=None`` means the CUDA card; with no card that raises
``RuntimeError`` instead of quietly running on the CPU.  Pass
``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import functools
import operator
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitplane, dip_arr, dip_list, dip_listd, dip_shard
from repro_torch.core.attr_map import AttributeMap
from repro_torch.core.device import resolve_device
from repro_torch.core.di import DIGraph, build_di, edge_lookup
from repro_torch.core.queries import (
    extract_subgraph,
    filtered_bfs,
    gather,
    induce_edge_mask,
)
from repro_torch.obs.metrics import GLOBAL as _OBS
from repro_torch.obs.metrics import SIZE_BUCKETS as _SIZE_BUCKETS
from repro_torch.obs.metrics import enabled as _obs_enabled
from repro_torch.overlay.delta import AttrDelta, EdgeDelta, MutationEvent, pair_keys, word_bits

__all__ = ["PropGraph", "BACKENDS", "resolve_device"]

BACKENDS = ("arr", "list", "listd")

# popcount of every byte value: per-attribute counts off a packed plane
_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)

# the reference runs with 64-bit types off: a column placed on its device
# is narrowed to 32 bits, and predicates compare in the narrowed type
_NARROW = {
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.uint32,
    np.dtype(np.float64): np.float32,
    np.dtype(np.complex128): np.complex64,
}


def _obs_traverse(op: str, rounds: Optional[int], seeds: Optional[int]) -> None:
    """Frontier/semiring engine accounting (docs/ARCHITECTURE.md §13), under
    the reference's metric names: per-op run counts, the relax rounds and
    the seed-set size.  The reference records the loop's bound, because its
    converged count lives inside a jitted loop; the port's loops read a
    flag back each round anyway, so ``rounds`` is the count they ran (what
    ``traverse.engine.rounds`` gained during the call).  Host-side only."""
    if not _obs_enabled():
        return
    _OBS.counter("pg_traverse_runs", "frontier/semiring engine runs",
                 op=op).inc()
    if rounds is not None:
        _OBS.histogram("pg_traverse_relax_rounds",
                       "relax-round budget per run (loop bound)",
                       buckets=_SIZE_BUCKETS, op=op).observe(rounds)
    if seeds is not None:
        _OBS.histogram("pg_traverse_seed_size",
                       "seed/frontier-origin set size per run",
                       buckets=_SIZE_BUCKETS, op=op).observe(seeds)


def _observed(op: str, seeds, run):
    """``run()``, recorded by ``_obs_traverse`` with the relax rounds it
    ran and the size of ``seeds`` (None: an analytic without seeds)."""
    from repro_torch.traverse import engine

    r0 = sum(engine.rounds.values())
    out = run()
    n = None if seeds is None else (
        seeds.numel() if torch.is_tensor(seeds) else int(np.asarray(seeds).size))
    _obs_traverse(op, sum(engine.rounds.values()) - r0, n)
    return out


def _row_counts(host: dip_arr.DIPArr) -> np.ndarray:
    """(k,) entities per attribute row of a host plane."""
    bm = np.ascontiguousarray(host.bitmap)
    if host.packed:
        return _POP8[bm.view(np.uint8)].sum(axis=1, dtype=np.int64)
    return bm.sum(axis=1, dtype=np.int64)


_BUILDERS = {  # backend -> (host build, placement)
    "arr": (dip_arr.build_dip_arr_host, dip_arr.to_device),
    "list": (dip_list.build_dip_list_host, dip_list.to_device),
    "listd": (dip_listd.build_dip_listd_host, dip_listd.to_device),
}


class _AttrStore:
    """One DIP store over ``n_entities`` (vertices or edges).

    Inserts collect (entity, attribute) pairs on the host; the first query
    seals the store: it is built on the host, its per-attribute counts
    taken, and it is placed on the device.

    LSM write path (docs/ARCHITECTURE.md §11): once sealed, the base is
    immutable and later inserts land in ``_delta``, a small append-only
    host buffer, in O(batch).  Queries answer ``base | delta``; exact stats
    come from ``attr_counts`` (base counts plus the delta's counts deduped
    against ``base_keys``); the compactor folds the delta back into the
    pairs before a fresh seal.  ``out_n`` is the query result length: the
    EFFECTIVE entity universe (base + delta edges for the edge store),
    while ``n`` stays the sealed base's row count.

    With ``mesh`` set the seal places the padded shards instead
    (``finalize_sharded``) and releases the host build: no device keeps a
    dense copy, and the queries run shard by shard (``core.dip_shard``),
    answering on the lead device (``device``).
    """

    def __init__(self, backend: str, n_entities: int, device: torch.device, mesh=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.backend = backend
        self.n = n_entities
        self.out_n = n_entities
        self.device = device
        self.mesh = mesh
        self.amap = AttributeMap()
        self._pairs_e: List[np.ndarray] = []  # entity ids, insertion order
        self._pairs_a: List[np.ndarray] = []  # attribute ids
        self._store = None  # DIPArr, DIPList or DIPListD on the device
        self._sharded = None  # its sharded placement, in mesh mode (never both)
        self._host = None  # host build awaiting upload
        self._counts: Optional[np.ndarray] = None
        self._k_base: Optional[int] = None  # attribute rows in the sealed store
        self.plane_only = False  # sealed from a plane: no raw pairs to save
        self._plane_pairs = None  # (ent, att) read off a plane_only store's bits
        self._delta = AttrDelta()  # pairs landed after the base was sealed
        self._base_keys: Optional[np.ndarray] = None  # sorted base pair keys
        self.gen = 0  # bumped by every insert: the key of ``_delta_counts``
        self._delta_counts_cache = None  # (gen, counts)

    @classmethod
    def from_plane(cls, values: Sequence[str], bitmap, *, k: int, n: int, packed: bool,
                   device: torch.device) -> "_AttrStore":
        """A sealed store holding an existing plane (uint32 or int32 words
        when ``packed``, else int8 bytes) for the attribute ``values``."""
        store = cls("arr", n, device)
        store.amap = AttributeMap(values)
        if k != store.k:
            raise ValueError(f"plane has {k} rows for {len(store.amap)} attribute values")
        host = dip_arr.DIPArr(bitmap=np.array(bitmap), k=k, n=n, packed=bool(packed))
        store._counts = _row_counts(host)
        store._store = dip_arr.to_device(host, device)
        store._k_base = k
        store.plane_only = True
        return store

    @property
    def sealed(self) -> bool:
        return self._store is not None or self._sharded is not None

    @property
    def packed(self) -> bool:
        """True when the store holds (or will hold) the packed word plane
        (arr only); captured at build time."""
        if self.backend != "arr":
            return False
        for built in (self._store, self._sharded, self._host):
            if built is not None:
                return bool(built.packed)
        return bitplane.packed_default()

    def insert(self, entity_ids: np.ndarray, values: Sequence[str]) -> None:
        self.gen += 1  # even when no pair lands: interning widens ``k``
        attr_ids = self.amap.encode(values)
        attr_ids = np.broadcast_to(np.atleast_1d(attr_ids), np.shape(entity_ids)).ravel()
        entity_ids = np.asarray(entity_ids, np.int32).ravel()
        ok = entity_ids >= 0  # unmatched edge rows (edge_lookup -1) are dropped
        ent, att = entity_ids[ok], attr_ids[ok].astype(np.int32)
        if self.sealed:
            # the sealed base is immutable: O(batch) delta append, no rebuild
            self._delta.append(ent, att)
            return
        # before the seal, entities past the base universe (delta edges) can
        # never enter the n-row build — they live in the delta regardless
        hi = ent >= self.n
        if hi.any():
            self._delta.append(ent[hi], att[hi])
            ent, att = ent[~hi], att[~hi]
        self._pairs_e.append(ent)
        self._pairs_a.append(att)
        self._counts = None
        self._host = None
        self._base_keys = None

    @property
    def k(self) -> int:
        return max(len(self.amap), 1)

    def pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """All base (entity, attribute) pairs, in insertion order; a
        ``plane_only`` store's are read off its plane's set bits (arr keeps
        one bit per distinct pair, so they are exactly its deduped pairs)."""
        if self.plane_only:
            if self._plane_pairs is None:
                self._plane_pairs = self._read_plane_pairs()
            return self._plane_pairs
        if not self._pairs_e:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return np.concatenate(self._pairs_e), np.concatenate(self._pairs_a)

    def _read_plane_pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """(entities, attributes) of the sealed plane's set bits, attribute
        by attribute, on the store's device."""
        st = self._store
        ents, atts = [], []
        for a in range(st.k):
            row = st.bitmap[a]
            bits = bitplane.unpack_mask(row, st.n) if st.packed else row != 0
            e = torch.nonzero(bits).flatten().to(torch.int32).cpu().numpy()
            ents.append(e)
            atts.append(np.full(e.size, a, np.int32))
        if not ents:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return np.concatenate(ents), np.concatenate(atts)

    def _build_host(self):
        """Host build from the raw pairs, with its per-attribute counts
        (plane row sums; list: the deduped pairs' ``bincount``; listd: the
        ``a_off`` segment lengths, which keep duplicate pairs); stashed so a
        stats read followed by a query builds once."""
        if self._host is not None:
            return self._host
        ent, att = self.pairs()
        host = _BUILDERS[self.backend][0](ent, att, k=self.k, n=self.n)
        if self.backend == "arr":
            self._counts = _row_counts(host)
        elif self.backend == "list":
            self._counts = np.bincount(host.val, minlength=self.k)
        else:
            self._counts = np.diff(host.a_off)  # int32, a_off's type, as the reference's
        self._host = host
        self._k_base = self.k
        return host

    def finalize(self):
        """Seal: place the host build on the device (once); in mesh mode,
        place its shards (``finalize_sharded``)."""
        if self.mesh is not None:
            return self.finalize_sharded()
        if self._store is None:
            self._store = _BUILDERS[self.backend][1](self._build_host(), self.device)
            self._host = None
        return self._store

    def finalize_sharded(self):
        """The padded, mesh-placed store (mesh mode only), built once: the
        host build is placed shard by shard and then released, so no device
        (and no cache slot) holds a dense copy; the counts survive in
        ``_counts``."""
        if self._sharded is None:
            self._sharded = dip_shard.place_store(self.backend, self._build_host(), self.mesh)
            self._host = None
        return self._sharded

    def known_ids(self, values: Sequence[str]) -> np.ndarray:
        """Interned attribute ids for ``values`` (unknown values dropped)."""
        ids = np.atleast_1d(self.amap.lookup(list(values)))
        return ids[ids >= 0].astype(np.int32)

    def base_keys(self) -> np.ndarray:
        """Sorted distinct packed (entity, attribute) keys of the BASE pairs
        — the dedup reference ``attr_counts`` uses, so re-inserting a pair
        that already sits in the sealed base never double-counts.  Sorted
        on the store's device."""
        if self._base_keys is None:
            ent, att = self.pairs()
            keys = torch.from_numpy(pair_keys(ent, att)).to(self.device)
            self._base_keys = torch.unique(keys).cpu().numpy()
        return self._base_keys

    def all_pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """Full (entity, attribute) pair history, base ++ delta, insertion
        order preserved — what the compactor folds into a fresh base."""
        ent, att = self.pairs()
        de, da = self._delta.cat()
        if not de.size:
            return ent, att
        return np.concatenate([ent, de]), np.concatenate([att, da])

    def attr_counts(self, *, dead_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """(k,) per-attribute entity counts — the selectivity statistics the
        planner orders joins with, derived on the host.  With a live delta
        the sealed base's counts pad to the current attribute set and the
        delta's (base-deduped) counts add in; ``dead_ids`` subtracts the
        pairs of tombstoned entities, so the counts agree with what the
        alive-masked queries return."""
        if self._counts is None:
            self._build_host()
        counts = self._counts
        if len(counts) < self.k:
            counts = np.concatenate([counts, np.zeros(self.k - len(counts), counts.dtype)])
        if self._delta.size:
            counts = counts + self._delta_counts()
        if dead_ids is not None and np.asarray(dead_ids).size:
            counts = counts - self._dead_attr_counts(np.asarray(dead_ids))
        return counts

    def _delta_counts(self) -> np.ndarray:
        """The delta's base-deduped per-attribute counts, cached per ``gen``
        — the planner reads them every plan."""
        c = self._delta_counts_cache
        if c is None or c[0] != self.gen:
            c = self._delta_counts_cache = (self.gen, self._delta.counts(self.k, self.base_keys()))
        return c[1]

    def _dead_attr_counts(self, dead_ids: np.ndarray) -> np.ndarray:
        """(k,) per-attribute pair counts held by tombstoned entities, as
        ``attr_counts`` counts them: base pairs the way the backend stores
        them (listd keeps duplicate pairs, arr and list dedupe — their
        distinct pairs are ``base_keys``) plus the delta's base-deduped
        distinct pairs.  The graph caches the result per version
        (``PropGraph._attr_counts``)."""
        k = self.k
        out = np.zeros(k, np.int64)
        if self.backend == "listd":
            ent, att = self.pairs()
        else:
            keys = self.base_keys()
            ent, att = keys >> 31, keys & 0x7FFFFFFF
        top = int(max(self.out_n, self.n, int(dead_ids.max()) + 1))
        dead = np.zeros(top + 1, bool)
        dead[dead_ids] = True
        if ent.size:
            sel = dead[ent]
            if sel.any():
                out += np.bincount(att[sel].astype(np.int64), minlength=k)[:k]
        if self._delta.size:
            keys = self._delta.added_keys(self.base_keys())
            sel = dead[keys >> 31]
            if sel.any():
                out += np.bincount((keys[sel] & 0x7FFFFFFF).astype(np.int64), minlength=k)[:k]
        return out

    @property
    def nnz(self) -> int:
        """Stored (entity, attribute) pairs after dedupe — Σ attr_counts."""
        return int(np.sum(self.attr_counts()))

    def _mask(self, values: Sequence[str]) -> np.ndarray:
        return self.amap.mask(values, self._k_base)

    def _masks(self, values_list: Sequence[Sequence[str]]) -> torch.Tensor:
        return torch.from_numpy(np.stack([self._mask(v) for v in values_list])).to(self.device)

    # ---- the delta union, on the device ---------------------------------
    def _pad_to_out(self, mask: torch.Tensor) -> torch.Tensor:
        """Extend an (..., n)-wide base result to the effective universe:
        entities past the sealed base (delta edges) hold no base attributes."""
        pad = self.out_n - mask.shape[-1]
        if pad > 0:
            mask = torch.cat([mask, mask.new_zeros(mask.shape[:-1] + (pad,))], dim=-1)
        return mask

    def _pad_words_to_out(self, words: torch.Tensor) -> torch.Tensor:
        """Word-space ``_pad_to_out``: the base's tail bits past ``n`` are
        zero, so the extension is a concat of zero words."""
        w_out = bitplane.n_words(self.out_n)
        pad = w_out - words.shape[-1]
        if pad > 0:
            words = torch.cat([words, words.new_zeros(words.shape[:-1] + (pad,))], dim=-1)
        return words[..., :w_out]

    def _delta_rows(self, values_list, *, words: bool) -> Optional[Tuple[np.ndarray, ...]]:
        """Flat (row-major) targets of the delta union of each query row:
        entity ids, or (word ids, int32 words) when ``words``; None when the
        delta adds nothing."""
        if not self._delta.size:
            return None
        width = bitplane.n_words(self.out_n) if words else self.out_n
        idx, vals = [], []
        for q, values in enumerate(values_list):
            ents = self._delta.entities(self.known_ids(values))
            if words:
                wid, wv = word_bits(ents)
                idx.append(q * width + wid)
                vals.append(wv)
            else:
                idx.append(q * width + ents)
        flat = np.concatenate(idx)
        if not flat.size:
            return None
        return (flat, np.concatenate(vals)) if words else (flat,)

    def _union_delta(self, out: torch.Tensor, values_list, *, words: bool) -> torch.Tensor:
        """``out`` (one or Q rows) OR the delta's matches: the matching ids
        (or words) are uploaded and set on the device, out of place."""
        rows = self._delta_rows(values_list, words=words)
        if rows is None:
            return out
        flat = torch.from_numpy(rows[0]).to(out.device)
        dense = out.reshape(-1)
        if words:
            bits = torch.from_numpy(rows[1]).to(out.device)
            dense = dense.index_put((flat,), dense[flat] | bits)
        else:
            dense = dense.index_fill(0, flat, True)
        return dense.view(out.shape)

    def _query_base(self, values: Sequence[str], *, impl: Optional[str] = None) -> torch.Tensor:
        """(n,) bool over the sealed base only.  The query mask is built at
        ``_k_base`` — values interned after the seal are invisible here (the
        delta union answers them)."""
        if self.mesh is not None:
            ss = self.finalize_sharded()  # seals: the mask is built at ``_k_base``
            return dip_shard.query_any_sharded(self.backend, ss,
                                               torch.from_numpy(self._mask(values)), impl=impl)
        store = self.finalize()
        if self.backend == "listd" and impl == "budget":
            ids = self.known_ids(values)
            ids = ids[ids < self._k_base]  # delta-only values have no chain
            if ids.size == 0:
                return torch.zeros(self.n, dtype=torch.bool, device=self.device)
            # the selected segments' total, lane-aligned, at least one tile
            budget = int(self._counts[ids].sum())
            budget = max(-(-budget // 128) * 128, 128)
            return dip_listd.query_any_budget(
                store, torch.from_numpy(ids).to(self.device), budget=budget)
        mask = torch.from_numpy(self._mask(values)).to(self.device)
        if self.backend == "arr":
            return dip_arr.query_any(store, mask, impl=impl or "matvec")
        if self.backend == "list":
            return dip_list.query_any(store, mask)
        return dip_listd.query_any(store, mask, impl=impl or "inverted")

    def query_any(self, values: Sequence[str], *, impl: Optional[str] = None) -> torch.Tensor:
        """(out_n,) bool — entities holding ANY of ``values``.  ``impl``: arr
        ``scan``/``matvec``/``kernel``; listd ``inverted``/``linked``/
        ``budget``; list has one implementation and ignores it."""
        ids = self.known_ids(values) if len(values) else np.zeros(0, np.int32)
        if ids.size == 0:
            # empty list / all-unknown values: definitionally empty
            return torch.zeros(self.out_n, dtype=torch.bool, device=self.device)
        out = self._pad_to_out(self._query_base(values, impl=impl))
        return self._union_delta(out, [values], words=False)

    def query_any_batched(self, values_list: Sequence[Sequence[str]], *,
                          impl: Optional[str] = None) -> torch.Tensor:
        """(Q, out_n) bool — Q OR-queries: one launch on arr, a loop over the
        queries on list and listd."""
        if self.backend != "arr":
            return torch.stack([self.query_any(v, impl=impl) for v in values_list])
        if self.mesh is not None:
            rows = dip_shard.query_any_batched_sharded(self.finalize_sharded(),
                                                       self._masks(values_list), impl=impl)
        else:
            rows = dip_arr.query_any_batched(self.finalize(), self._masks(values_list),
                                             impl=impl or "matvec")
        return self._union_delta(self._pad_to_out(rows), values_list, words=False)

    def query_any_words(self, values: Sequence[str], *,
                        impl: Optional[str] = None) -> torch.Tensor:
        """Packed query: (ceil(out_n/32),) int32 words.  Every impl is the
        packed OR-scan; ``impl`` is accepted for the planner's sake."""
        if not self.packed:
            raise ValueError("query_any_words requires a packed store")
        ids = self.known_ids(values) if len(values) else np.zeros(0, np.int32)
        if ids.size == 0:
            return torch.zeros(bitplane.n_words(self.out_n), dtype=torch.int32,
                               device=self.device)
        store = self.finalize()
        mask = torch.from_numpy(self._mask(values)).to(self.device)
        if self.mesh is not None:
            words = dip_shard.query_any_words_sharded(store, mask, impl=impl)
        else:
            words = dip_arr.query_any_words(store, mask)
        out = self._pad_words_to_out(words)
        return self._union_delta(out, [values], words=True)

    def query_any_batched_words(self, values_list: Sequence[Sequence[str]], *,
                                impl: Optional[str] = None) -> torch.Tensor:
        """(Q, ceil(out_n/32)) int32 — Q packed OR-queries, one launch."""
        if not self.packed:
            raise ValueError("query_any_batched_words requires a packed store")
        if self.mesh is not None:
            rows = dip_shard.query_any_batched_words_sharded(
                self.finalize_sharded(), self._masks(values_list), impl=impl)
        else:
            rows = dip_arr.query_any_batched_words(self.finalize(), self._masks(values_list))
        return self._union_delta(self._pad_words_to_out(rows), values_list, words=True)

    def to_arrays(self) -> dict:
        """The sealed store as host arrays (see ``PropGraph.from_arrays``)."""
        if self.backend != "arr":
            raise ValueError(f"to_arrays moves DIP-ARR planes; save a {self.backend!r} graph "
                             "with save_propgraph and reload it with load_propgraph")
        store = self.finalize()
        if self.mesh is not None:  # the shards, joined on the host and cut to n
            bm = np.concatenate([b.cpu().numpy() for b in store.bitmap], axis=1)
            bm = bm[:, :bitplane.n_words(store.n) if store.packed else store.n]
        else:
            bm = store.bitmap.cpu().numpy()
        return {"values": self.amap.values, "bitmap": bm.view(np.uint32) if store.packed else bm,
                "k": store.k, "n": store.n, "packed": store.packed}

    def clone(self) -> "_AttrStore":
        """Structurally-shared copy for snapshots and forks: the sealed
        store, stash, stats, base keys and pair CHUNKS are shared (all
        append-only or never written); the chunk lists, delta chain and
        attribute map are private, so parent and clone diverge without
        copying the base."""
        c = _AttrStore.__new__(_AttrStore)
        c.__dict__.update(self.__dict__)
        c.amap = AttributeMap(self.amap.values)
        c._pairs_e = list(self._pairs_e)
        c._pairs_a = list(self._pairs_a)
        c._delta = self._delta.frozen_copy()
        return c


def _mesh_device(mesh, device) -> torch.device:
    """The mesh's lead device; ``device``, when given, must name it."""
    from repro_torch.launch.mesh import EntityMesh

    if not isinstance(mesh, EntityMesh):
        raise TypeError(f"mesh must be an EntityMesh (launch.mesh.make_entity_mesh), "
                        f"got {type(mesh).__name__}")
    if device is not None:
        d = torch.device(device)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d != mesh.lead:
            raise ValueError(f"device={d} is not the mesh's lead device {mesh.lead}")
    return mesh.lead


def _write_locked(fn):
    """Serialize a mutator (or ``compact``) on the graph's write lock.

    Writes and compaction exclude each other: ``compact_propgraph`` gathers
    the overlay, rebuilds, then swaps the stores — a mutation landing inside
    that window would be lost in the swap, so every path that changes graph
    state takes the same re-entrant lock (re-entrant because
    ``insert_edges`` falls back to ``add_edges_from`` and ``compact`` runs
    nested helpers).  Readers take no lock; ``snapshot()`` clones under it
    for a consistent pin."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._write_lock:
            return fn(self, *args, **kwargs)

    return wrapper


class PropGraph:
    """A directed, labeled property multigraph over the DI structure, on one
    device (``device=None`` → the CUDA card) or sharded over an entity mesh
    (``mesh=``, ``launch.mesh.make_entity_mesh``; ``device`` is then the
    mesh's lead device), with the overlay's writes."""

    def __init__(self, backend: str = "arr", mesh=None, *, device=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.backend = backend
        self.mesh = mesh
        self.device = _mesh_device(mesh, device) if mesh is not None else resolve_device(device)
        self.graph: Optional[DIGraph] = None
        self._node_map_host: Optional[np.ndarray] = None
        self._vstore: Optional[_AttrStore] = None
        self._estore: Optional[_AttrStore] = None
        # typed property columns: name -> (values (x,), valid mask (x,)), and
        # each column's type as the reference holds it (see _place_column)
        self.vertex_props: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.edge_props: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._col_dtypes: Dict[Tuple[str, str], np.dtype] = {}
        # monotone mutation counter + observers (cache invalidation contract);
        # ``last_mutation`` says what the last write touched
        self.version: int = 0
        self.last_mutation: Optional[MutationEvent] = None
        self._mutation_hooks: List = []
        # ---- overlay state (docs/ARCHITECTURE.md §11) -------------------
        self._delta_edges: Optional[EdgeDelta] = None  # structural inserts
        self._dead_v: Optional[np.ndarray] = None  # (n,) bool tombstones
        self._dead_e: Optional[np.ndarray] = None  # sorted global edge ids
        self._frozen = False  # snapshots refuse mutation
        # serializes mutators + compact() (see _write_locked); re-entrant,
        # never taken by the read paths
        self._write_lock = threading.RLock()
        self._reset_caches()

    def _reset_caches(self) -> None:
        """Drop every derived view of the overlay: the combined edge view,
        the alive masks, the tombstone-exact counts, the sampling view and
        its edge words."""
        self._caches: Dict[str, Tuple[tuple, object]] = {}

    def _cached(self, name: str, build, arg=None):
        """``build()`` once per (``version``, ``arg``).  Every write bumps
        the version, so no derived view outlives the state it was read
        from; the key is taken before the build, so a write landing during
        it leaves an entry no later read hits."""
        key = (self.version, arg)
        hit = self._caches.get(name)
        if hit is not None and hit[0] == key:
            return hit[1]
        value = build()
        self._caches[name] = (key, value)
        return value

    # ----------------------------------------------------------- mutation API
    def on_mutation(self, hook) -> "PropGraph":
        """Register ``hook(pg)`` to run after every mutating call; hooks see
        the bumped ``version``."""
        self._mutation_hooks.append(hook)
        return self

    def _bump_version(self) -> None:
        self.version += 1
        for hook in list(self._mutation_hooks):
            hook(self)

    def _check_writable(self) -> None:
        if self._frozen:
            raise RuntimeError("this PropGraph is a frozen snapshot; fork() it for a "
                               "writable view")

    # ------------------------------------------------------------- structure
    def _set_graph(self, graph: DIGraph) -> None:
        self.graph = graph
        self._node_map_host = graph.node_map.cpu().numpy()

    @_write_locked
    def add_edges_from(self, src, dst) -> "PropGraph":
        """Bulk edge ingestion → DI build (normalize + sort + SEG) on the
        graph's device.  Rebuilding the structure drops previously attached
        attributes (fresh stores) and the whole overlay.  For incremental
        growth that keeps attributes and costs O(batch), use
        ``insert_edges``."""
        self._check_writable()
        src = np.asarray(src)
        if src.size == 0 and self.graph is not None:
            return self  # no-op: nothing to rebuild from
        graph = build_di(src, np.asarray(dst), device=self.device)
        self._set_graph(graph if self.mesh is None else dip_shard.place_graph(graph, self.mesh))
        self._vstore = _AttrStore(self.backend, self.graph.n, self.device, mesh=self.mesh)
        self._estore = _AttrStore(self.backend, max(self.graph.m, 1), self.device, mesh=self.mesh)
        self._delta_edges = None
        self._dead_v = None
        self._dead_e = None
        self._reset_caches()
        self.last_mutation = MutationEvent.structural_event("add_edges_from")
        self._bump_version()
        return self

    @_write_locked
    def insert_edges(self, src, dst) -> "PropGraph":
        """O(batch) structural ingestion: append (src, dst) pairs to the edge
        delta instead of re-sorting the DI structure.  Endpoints must exist
        in the vertex universe (growing it is ``add_edges_from``'s bulk
        path).  Delta edges get global ids ``m_base + i``; queries and
        analytics see them through the combined edge view until
        ``compact()`` folds them in.  Pairs already present ALIVE (base or
        delta) are dropped: one structural edge per (u, v).

        Tombstones behave exactly as after ``compact()`` made them physical:
        a pair whose only occurrence is tombstoned (``delete_edges``) comes
        back as a fresh BARE delta edge (its relationships and property
        values do not carry over); an endpoint tombstoned by
        ``delete_vertices`` raises ``ValueError``, as an unknown vertex does
        after compaction."""
        self._check_writable()
        if self.graph is None:
            return self.add_edges_from(src, dst)
        src = np.asarray(src).ravel()
        dst = np.asarray(dst).ravel()
        if src.size == 0:
            return self  # no-op
        u = self._vertex_internal(src)
        v = self._vertex_internal(dst)
        if (u < 0).any() or (v < 0).any():
            unknown = np.unique(np.concatenate([src[u < 0], dst[v < 0]]))
            raise ValueError(
                f"insert_edges endpoints must already exist; unknown vertices "
                f"{unknown[:10].tolist()} — use add_edges_from (bulk rebuild) "
                f"to grow the vertex universe")
        if self._dead_v is not None:
            du, dv = self._dead_v[u], self._dead_v[v]
            if du.any() or dv.any():
                gone = np.unique(np.concatenate([src[du], dst[dv]]))
                raise ValueError(
                    f"insert_edges endpoints {gone[:10].tolist()} are "
                    f"tombstoned (delete_vertices) — a deleted vertex is "
                    f"gone before and after compaction; re-add it via "
                    f"add_edges_from (bulk rebuild)")
        if self._delta_edges is None:
            self._delta_edges = EdgeDelta(self.graph.m)
        base_idx = self._lookup_base(u, v)
        alive_in_base = base_idx >= 0
        if self._dead_e is not None and self._dead_e.size:
            # a tombstoned base pair no longer exists — it is insertable
            alive_in_base &= ~np.isin(base_idx, self._dead_e)
        fresh = ~alive_in_base
        added = (self._delta_edges.append(u[fresh], v[fresh], dead=self._dead_e)
                 if fresh.any() else 0)
        if added == 0:
            return self  # every pair already present: caches stay live
        self._estore.out_n = max(self.graph.m + self._delta_edges.size, 1)
        self.last_mutation = MutationEvent.structural_event("insert_edges")
        self._bump_version()
        return self

    @_write_locked
    def delete_vertices(self, nodes) -> "PropGraph":
        """Tombstone vertices (and implicitly every incident edge) in the
        overlay — the base structure is untouched, so snapshots taken before
        the delete still see them.  ``compact()`` makes it physical."""
        self._check_writable()
        self._require_base()
        idx = self._vertex_internal(np.asarray(nodes).ravel())
        idx = idx[idx >= 0]
        if idx.size == 0:
            return self  # no-op
        dead = (np.zeros(self.graph.n, bool) if self._dead_v is None
                else self._dead_v.copy())  # copy-on-write: snapshots share ours
        before = int(dead.sum())
        dead[idx] = True
        if int(dead.sum()) == before:
            return self  # all already dead
        self._dead_v = dead
        self.last_mutation = MutationEvent.structural_event("delete_vertices")
        self._bump_version()
        return self

    @_write_locked
    def delete_edges(self, src, dst) -> "PropGraph":
        """Tombstone individual edges (base or delta) by endpoint pair."""
        self._check_writable()
        self._require_base()
        idx = self._edge_internal(src, dst)
        idx = idx[idx >= 0].astype(np.int32)
        if idx.size == 0:
            return self  # no-op
        cur = self._dead_e if self._dead_e is not None else np.zeros(0, np.int32)
        merged = np.unique(np.concatenate([cur, idx]))
        if merged.size == cur.size:
            return self  # all already dead
        self._dead_e = merged
        self.last_mutation = MutationEvent.structural_event("delete_edges")
        self._bump_version()
        return self

    def _effective_graph(self) -> DIGraph:
        """Base DI structure ++ delta edges, as one edge-centric view.

        The combined graph keeps the base's SEG (valid for the sorted base
        prefix only) and is flagged ``unsorted`` so SEG-dependent paths
        route around it; everything the executor and frontier engine run is
        edge-centric and consumes it unchanged.  Cached per version:
        queries between writes pay the concat once."""
        base = self.graph
        de = self._delta_edges
        if de is None or de.size == 0:
            return base

        def build():
            ds, dd = de.cat()
            return DIGraph(src=torch.cat([base.src, torch.from_numpy(ds).to(base.device)]),
                           dst=torch.cat([base.dst, torch.from_numpy(dd).to(base.device)]),
                           seg=base.seg, node_map=base.node_map, n=base.n, m=base.m + de.size,
                           max_deg=-1, unsorted=True)

        return self._cached("effective", build)

    def _require_base(self) -> DIGraph:
        """The sealed base structure — the writes' vertex id space — without
        building the combined view (a write batch leaves that to the next
        read)."""
        if self.graph is None:
            raise RuntimeError("call add_edges_from(...) first")
        return self.graph

    def _require_graph(self) -> DIGraph:
        self._require_base()
        return self._effective_graph()

    def _vertex_internal(self, nodes) -> np.ndarray:
        """Original vertex ids → internal [0, n) ids (−1 if absent)."""
        self._require_base()
        nm = self._node_map_host
        nodes = np.asarray(nodes).ravel()
        pos = np.clip(np.searchsorted(nm, nodes), 0, len(nm) - 1)
        ok = nm[pos] == nodes
        return np.where(ok, pos, -1).astype(np.int32)

    def _lookup_base(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Base edge ids of internal (u, v) pairs (−1 where absent); the
        SORTED base, whose SEG windows ``edge_lookup`` searches."""
        g = self.graph
        return edge_lookup(g, torch.from_numpy(np.maximum(u, 0)).to(g.device),
                           torch.from_numpy(np.maximum(v, 0)).to(g.device)).cpu().numpy()

    def _edge_internal(self, src, dst) -> np.ndarray:
        """Original endpoint pairs → global edge ids (−1 if absent): base
        edges, then delta edges, and a tombstoned edge resolves to the
        pair's revived delta edge if one exists — so writes and deletes
        address exactly what a compacted graph would hold."""
        self._require_base()
        u = self._vertex_internal(src)
        v = self._vertex_internal(dst)
        idx = np.where((u >= 0) & (v >= 0), self._lookup_base(u, v), -1).astype(np.int32)
        de = self._delta_edges
        if de is not None and de.size:
            miss = idx < 0
            if miss.any():
                # base misses may still be delta edges (global ids ≥ m_base)
                didx = de.lookup(u[miss], v[miss])
                idx[miss] = np.where((u[miss] >= 0) & (v[miss] >= 0), didx, -1)
        if self._dead_e is not None and self._dead_e.size:
            dead_hit = np.isin(idx, self._dead_e)
            if dead_hit.any():
                if de is not None and de.size:
                    rep = de.lookup(u[dead_hit], v[dead_hit])
                    rep = np.where(np.isin(rep, self._dead_e), -1, rep)
                else:
                    rep = np.full(int(dead_hit.sum()), -1, np.int32)
                idx[dead_hit] = rep
        return idx

    # ------------------------------------------------------------ attributes
    @_write_locked
    def add_node_labels(self, nodes, labels) -> "PropGraph":
        self._check_writable()
        self._require_base()
        if np.asarray(nodes).size == 0:
            return self  # no-op
        self._vstore.insert(self._vertex_internal(nodes), labels)
        self.last_mutation = MutationEvent.labels_event(labels)
        self._bump_version()
        return self

    @_write_locked
    def add_edge_relationships(self, src, dst, relationships) -> "PropGraph":
        self._check_writable()
        self._require_base()
        if np.asarray(src).size == 0:
            return self  # no-op
        self._estore.insert(self._edge_internal(src, dst), relationships)
        self.last_mutation = MutationEvent.rels_event(relationships)
        self._bump_version()
        return self

    def _add_column(self, kind: str, size: int, idx: np.ndarray, name: str, values,
                    fill) -> None:
        vals = np.asarray(values)
        col = np.full((size,), fill, dtype=vals.dtype)
        valid = np.zeros((size,), dtype=bool)
        ok = idx >= 0
        col[idx[ok]] = vals[ok]
        valid[idx[ok]] = True
        self._set_column(kind, name, col, valid)
        self.last_mutation = MutationEvent.props_event(name)
        self._bump_version()

    @_write_locked
    def add_node_properties(self, name: str, nodes, values, fill=0) -> "PropGraph":
        self._check_writable()
        g = self._require_base()
        if np.asarray(nodes).size == 0:
            return self  # no-op
        self._add_column("node", g.n, self._vertex_internal(nodes), name, values, fill)
        return self

    @_write_locked
    def add_edge_properties(self, name: str, src, dst, values, fill=0) -> "PropGraph":
        self._check_writable()
        g = self._require_graph()
        if np.asarray(src).size == 0:
            return self  # no-op
        self._add_column("edge", g.m, self._edge_internal(src, dst), name, values, fill)
        return self

    def _update_column(self, kind: str, name: str, idx: np.ndarray, values,
                       size: int) -> None:
        """Point-update an existing column at internal ids ``idx`` (−1
        dropped), first padding it to ``size`` rows.  New tensors replace
        the column (out-of-place ``index_put``): a snapshot or fork holding
        the old ones never sees the write."""
        cols = self.vertex_props if kind == "node" else self.edge_props
        col, valid = cols[name]
        ok = idx >= 0
        if int(col.shape[0]) < size:
            pad = size - int(col.shape[0])
            col = torch.cat([col, col.new_zeros(pad)])
            valid = torch.cat([valid, valid.new_zeros(pad)])
        # the reference narrows the values to 32 bits, then casts them to
        # the column's type (uint16/uint32 columns are held as int64)
        vals = np.asarray(values).ravel()[ok]
        vals = vals.astype(_NARROW.get(vals.dtype, vals.dtype), copy=False)
        vals = torch.from_numpy(vals.astype(self._col_dtypes[(kind, name)]))
        at = torch.from_numpy(idx[ok].astype(np.int64)).to(col.device)
        cols[name] = (col.index_put((at,), vals.to(col.device, col.dtype)),
                      valid.index_fill(0, at, True))
        self.last_mutation = MutationEvent.props_event(name)
        self._bump_version()

    @_write_locked
    def update_node_properties(self, name: str, nodes, values) -> "PropGraph":
        """Point-update an EXISTING typed column onto fresh tensors, so
        snapshots holding the previous column are untouched.  Unknown
        vertices are dropped; an unknown property is an error
        (``add_node_properties`` defines columns)."""
        self._check_writable()
        g = self._require_base()
        if name not in self.vertex_props:
            raise KeyError(f"unknown vertex property {name!r}; add_node_properties first")
        idx = self._vertex_internal(np.asarray(nodes).ravel())
        if not (idx >= 0).any():
            return self  # no-op
        self._update_column("node", name, idx, values, g.n)
        return self

    @_write_locked
    def update_edge_properties(self, name: str, src, dst, values) -> "PropGraph":
        """Point-update an existing edge column; delta edges are addressable
        too (the column pads to the effective edge count on first touch)."""
        self._check_writable()
        g = self._require_graph()
        if name not in self.edge_props:
            raise KeyError(f"unknown edge property {name!r}; add_edge_properties first")
        idx = self._edge_internal(src, dst)
        if not (idx >= 0).any():
            return self  # no-op
        self._update_column("edge", name, idx, values, g.m)
        return self

    def _set_column(self, kind: str, name: str, col, valid) -> None:
        cols = self.vertex_props if kind == "node" else self.edge_props
        cols[name], self._col_dtypes[(kind, name)] = self._place_column(col, valid)

    def _place_column(self, col, valid) -> Tuple[Tuple[torch.Tensor, torch.Tensor], np.dtype]:
        """Narrow 64-bit columns to 32 bits as the reference's device
        placement does (otherwise predicate masks split from it), then
        place.  Returns the placed ``(col, valid)`` and the narrowed type,
        which predicates wrap their literals into.  Torch compares no
        unsigned type wider than 8 bits on the CPU, so uint16/uint32
        columns are held as int64 (same values)."""
        col = np.array(col)  # a private, writable copy (callers may pass read-only views)
        col = col.astype(_NARROW.get(col.dtype, col.dtype), copy=False)
        dtype = col.dtype
        if dtype in (np.uint16, np.uint32):
            col = col.astype(np.int64)
        col = torch.from_numpy(np.ascontiguousarray(col))
        valid = torch.from_numpy(np.array(valid, bool))
        if self.mesh is not None:
            return (dip_shard.place_column(col, self.mesh),
                    dip_shard.place_column(valid, self.mesh)), dtype
        return (col.to(self.device), valid.to(self.device)), dtype

    # ---------------------------------------------------------- alive masks
    def _alive_vertex_mask(self) -> Optional[torch.Tensor]:
        """(n,) bool on the device (False = tombstoned), or None when nothing
        is deleted; built once per version from the dead ids."""
        if self._dead_v is None:
            return None

        def build():
            ids = torch.from_numpy(np.flatnonzero(self._dead_v)).to(self.device)
            return torch.ones(self.graph.n, dtype=torch.bool,
                              device=self.device).index_fill(0, ids, False)

        return self._cached("alive_v", build)

    def _alive_edge_mask(self) -> Optional[torch.Tensor]:
        """(m_eff,) bool or None — False on tombstoned edges and on edges
        with a deleted endpoint (deleting a vertex detaches it).  Built on
        the device once per version."""
        if self._dead_e is None and self._dead_v is None:
            return None
        g = self._require_graph()

        def build():
            alive = torch.ones(g.m, dtype=torch.bool, device=g.device)
            if self._dead_e is not None and self._dead_e.size:
                ids = torch.from_numpy(self._dead_e.astype(np.int64)).to(g.device)
                alive = alive.index_fill(0, ids, False)
            av = self._alive_vertex_mask()
            if av is not None:
                alive = alive & gather(av, g.src) & gather(av, g.dst)
            return alive

        return self._cached("alive_e", build)

    def _and_alive_edges(self, out: torch.Tensor) -> torch.Tensor:
        """``out`` (an (m_eff,) edge mask) AND the alive edges.  An edgeless
        graph's edge store keeps one padding row, which no edge holds."""
        ae = self._alive_edge_mask()
        if ae is None:
            return out
        if ae.shape[0] == 0:
            ae = ae.new_zeros(out.shape)
        if ae.shape != out.shape:
            raise RuntimeError(f"edge mask of {tuple(out.shape)} against "
                               f"{tuple(ae.shape)} alive edges")
        return out & ae

    def _alive_words(self, kind: str) -> Optional[torch.Tensor]:
        """The packed form of the vertex (``"node"``) or edge alive mask, for
        the executor's word-space combine; cached with the mask."""
        mask = self._alive_vertex_mask() if kind == "node" else self._alive_edge_mask()
        if mask is None:
            return None
        return self._cached(f"alive_words_{kind}", lambda: bitplane.pack_mask(mask))

    def _dead_vertex_ids(self) -> Optional[np.ndarray]:
        """Tombstoned internal vertex ids, or None when nothing is dead —
        the subtraction set for tombstone-exact attribute stats."""
        if self._dead_v is None:
            return None
        ids = self._cached("dead_v_ids", lambda: np.flatnonzero(self._dead_v))
        return ids if ids.size else None

    def _dead_edge_ids(self) -> Optional[np.ndarray]:
        """Global ids of the edges the alive mask excludes (tombstoned edges
        plus edges detached by a dead endpoint) — ``_alive_edge_mask``'s
        universe, as ids."""
        ae = self._alive_edge_mask()
        if ae is None:
            return None
        ids = self._cached("dead_e_ids", lambda: np.flatnonzero(~ae.cpu().numpy()))
        return ids if ids.size else None

    # --------------------------------------------------------------- queries
    def query_labels(self, labels, *, impl: Optional[str] = None) -> torch.Tensor:
        """(n,) bool — vertices holding ANY of ``labels`` (§VI OR semantics).
        Overlay-aware: delta-held labels OR in, tombstoned vertices AND out."""
        self._require_graph()
        out = self._vstore.query_any(labels, impl=impl)
        av = self._alive_vertex_mask()
        return out if av is None else out & av

    def query_relationships(self, relationships, *, impl: Optional[str] = None) -> torch.Tensor:
        """(m,) bool — edges holding ANY of ``relationships`` (effective edge
        universe: base ++ delta, minus tombstones)."""
        self._require_graph()
        return self._and_alive_edges(self._estore.query_any(relationships, impl=impl))

    # ------------------------------------------------- typed property masks
    _PRED_OPS = {
        "==": operator.eq,
        "!=": operator.ne,
        "<": operator.lt,
        "<=": operator.le,
        ">": operator.gt,
        ">=": operator.ge,
    }

    def _predicate_parts(self, kind: str, name: str, op: str,
                         value) -> Tuple[torch.Tensor, torch.Tensor, object]:
        """Validate a predicate and return its raw ``(col, valid)`` column
        pair and the literal to compare with: KeyError for an unknown
        property, ValueError for an unknown op, TypeError for a string
        literal (columns are numeric).

        An integer literal on an integer column is taken as the reference
        takes it: it must fit int32 (``OverflowError`` otherwise), and is
        then wrapped into the column's type — on a uint32 column ``-3`` is
        ``4294967293``."""
        cols = self.vertex_props if kind == "node" else self.edge_props
        ckind = "vertex" if kind == "node" else "edge"
        if name not in cols:
            raise KeyError(f"unknown {ckind} property {name!r}; known: {sorted(cols)}")
        if op not in self._PRED_OPS:
            raise ValueError(f"unknown predicate op {op!r}; known: {sorted(self._PRED_OPS)}")
        if isinstance(value, str):
            raise TypeError(
                f"{ckind} predicate {name!r} {op} {value!r}: string comparisons "
                "are not supported on typed property columns — model "
                "string-valued attributes as labels/relationships instead")
        col, valid = cols[name]
        dtype = self._col_dtypes[(kind, name)]
        if isinstance(value, int) and not isinstance(value, bool) and dtype.kind in "iu":
            if not -2**31 <= value < 2**31:
                raise OverflowError(f"{ckind} predicate {name!r} {op} {value}: the literal "
                                    f"does not fit int32")
            bits = 8 * dtype.itemsize
            value &= (1 << bits) - 1
            if dtype.kind == "i" and value >= 1 << (bits - 1):
                value -= 1 << bits
        return col, valid, value

    def _predicate_mask(self, kind: str, name: str, op: str, value) -> torch.Tensor:
        col, valid, value = self._predicate_parts(kind, name, op, value)
        return valid & self._PRED_OPS[op](col, value)

    def vertex_predicate_mask(self, name: str, op: str, value) -> torch.Tensor:
        """(n,) bool — vertices whose typed property ``name`` compares true
        (entities without the property never match; tombstoned vertices
        never match either)."""
        self._require_graph()
        out = self._predicate_mask("node", name, op, value)
        av = self._alive_vertex_mask()
        return out if av is None else out & av

    def edge_predicate_mask(self, name: str, op: str, value) -> torch.Tensor:
        """(m_eff,) bool — edges whose typed property ``name`` compares
        true.  Columns predating the current delta edges pad with False (a
        delta edge has no value until ``update_edge_properties`` sets one)."""
        g = self._require_graph()
        out = self._predicate_mask("edge", name, op, value)
        if out.shape[0] < g.m:
            out = torch.cat([out, out.new_zeros(g.m - out.shape[0])])
        return self._and_alive_edges(out)

    # ------------------------------------------------------ pattern matching
    def match(self, pattern, *, impl: Optional[str] = None, profile: bool = False):
        """Declarative pattern query, e.g.
        ``pg.match("(a:person {age > 30})-[:follows]->(b:person)")``.

        Parses ``pattern`` (str or a pre-built ``Pattern``), plans it against
        the DIP statistics and runs the mask pipeline.  Returns a
        ``MatchResult`` whose masks cover exactly the entities in at least
        one full match.  ``impl`` overrides the planner's per-mask choice.

        ``profile=True`` returns ``(MatchResult, ProfileReport)`` instead —
        the EXPLAIN ANALYZE path (docs/ARCHITECTURE.md §13): per-stage wall
        times, the graph's device synchronized after each, with the first
        call's one-off share measured by a steady-state re-run.
        """
        if profile:
            from repro_torch.obs.profile import profile_match

            return profile_match(self, pattern, impl=impl)
        from repro_torch.query import execute_plan, parse, plan_pattern

        pat = parse(pattern) if isinstance(pattern, str) else pattern
        return execute_plan(self, plan_pattern(self, pat, impl=impl))

    def explain(self, pattern, *, impl: Optional[str] = None) -> str:
        """The plan ``match`` would run, as text."""
        from repro_torch.query import parse, plan_pattern

        pat = parse(pattern) if isinstance(pattern, str) else pattern
        return plan_pattern(self, pat, impl=impl).describe()

    def explain_analyze(self, pattern, *, impl: Optional[str] = None):
        """EXPLAIN ANALYZE: run ``pattern`` and return a ``ProfileReport`` —
        the executed plan annotated with measured per-stage times (parse /
        plan / mask materialization / propagation) and the first call's
        one-off share (``report.compile_ms`` / ``report.cold``).
        ``report.describe()`` renders the plan with the timing table."""
        from repro_torch.obs.profile import profile_match

        return profile_match(self, pattern, impl=impl)[1]

    def subgraph(self, labels: Optional[Sequence[str]] = None,
                 relationships: Optional[Sequence[str]] = None, *,
                 impl: Optional[str] = None) -> Tuple[DIGraph, np.ndarray]:
        """Intersect label/relationship query masks into an induced subgraph."""
        g = self._require_graph()
        vmask = (self.query_labels(labels, impl=impl) if labels is not None
                 else torch.ones(g.n, dtype=torch.bool, device=g.device))
        emask = (self.query_relationships(relationships, impl=impl) if relationships is not None
                 else torch.ones(g.m, dtype=torch.bool, device=g.device))
        av = self._alive_vertex_mask()
        if av is not None:
            vmask = vmask & av
        return extract_subgraph(g, induce_edge_mask(g, vmask, self._and_alive_edges(emask)))

    def bfs(self, sources, labels: Optional[Sequence[str]] = None,
            relationships: Optional[Sequence[str]] = None, max_iters: int = 64) -> torch.Tensor:
        """Property-filtered BFS from original-id sources; (n,) depths."""
        g = self._require_graph()
        v_ok = self.query_labels(labels) if labels is not None else None
        e_ok = self.query_relationships(relationships) if relationships is not None else None
        av = self._alive_vertex_mask()
        if av is not None:
            v_ok = av if v_ok is None else v_ok & av
        ae = self._alive_edge_mask()
        if ae is not None:
            e_ok = ae if e_ok is None else e_ok & ae
        srcs = torch.from_numpy(np.maximum(self._vertex_internal(sources), 0)).to(g.device)
        return filtered_bfs(g, srcs, edge_allowed=e_ok, vertex_allowed=v_ok, max_iters=max_iters)

    # -------------------------------------------------- frontier analytics
    # Each run is recorded for the observability layer (``_obs_traverse``).
    # On a mesh, khop / shortest_paths / pagerank relax shard by shard over
    # the graph's cached edge blocks (``_edge_blocks``); components and
    # communities run the single-device program on the lead device.
    def _edge_blocks(self, direction: int):
        """The effective graph's per-shard edge blocks walked in
        ``direction`` (``traverse.engine._pad_edges``), cached per version:
        the base and the overlay's combined view each cut theirs once."""
        from repro_torch.traverse.engine import _pad_edges

        return self._cached(f"edge_blocks_{direction}", lambda: _pad_edges(
            self._require_graph(), self.mesh, direction))

    def khop(self, seeds, k: int, *, pattern=None, undirected: bool = False,
             impl: Optional[str] = None) -> torch.Tensor:
        """Vertices within ≤``k`` hops of ``seeds`` (original ids), following
        only edges the filter ``pattern`` allows — (n,) bool, seeds included.

        ``pattern`` is a node-only or single-hop filter (the same §VI masks
        ``match`` composes): for ``"(a:host)-[:flows {bytes > 0}]->(b)"``
        an edge is traversable iff it holds ``flows``, satisfies the
        predicate, its tail matches ``a`` and its head matches ``b``;
        ``<-[...]-`` walks edges in reverse; a node-only pattern confines
        the traversal to matching vertices.  ``None`` allows everything.

        ``impl``: ``None``/``"frontier"`` = the edge-centric Boolean step
        (sharded on a mesh); ``"csr"`` = the CSR gather of each new
        frontier's windows (forward and directed only, off a mesh, on a
        graph without delta edges, whose combined view has no SEG windows;
        degrades to ``frontier`` otherwise).  All are bitwise identical.
        Tombstoned edges never carry the walk, and tombstoned seeds drop
        out.
        """
        from repro_torch import traverse

        if impl not in (None, "frontier", "csr"):
            raise ValueError(f"unknown impl {impl!r}")
        g, e_ok, direction = self._step_filter(pattern)
        ids = self._seed_ids(seeds)
        if (impl == "csr" and self.mesh is None and direction == 1 and not undirected
                and not g.unsorted):
            return _observed("khop", seeds, lambda: traverse.khop_csr(g, ids, e_ok, k=k))
        if self.mesh is not None:
            return _observed("khop", seeds, lambda: traverse.khop_mask_sharded(
                g, self._seed_mask(ids), e_ok, k=k, mesh=self.mesh, direction=direction,
                undirected=undirected, blocks=self._edge_blocks(direction)))
        return _observed("khop", seeds, lambda: traverse.khop_mask(
            g, self._seed_mask(ids), e_ok, k=k, direction=direction, undirected=undirected))

    def _step_filter(self, pattern):
        """(graph, edge filter, direction) of a walk whose every step the
        single-hop ``pattern`` constrains: its edge masks AND the masks of
        the hop's tail and head (in traversal order) at the edge's ends."""
        from repro_torch import traverse

        g = self._require_graph()
        v_tail, v_head, e_mask, direction = traverse.single_hop_filters(self, pattern)
        e_ok = torch.ones(g.m, dtype=torch.bool, device=g.device) if e_mask is None else e_mask
        tail, head = (g.src, g.dst) if direction == 1 else (g.dst, g.src)
        if v_tail is not None:
            e_ok = e_ok & gather(v_tail, tail)
        if v_head is not None:
            e_ok = e_ok & gather(v_head, head)
        ae = self._alive_edge_mask()
        if ae is not None:
            e_ok = e_ok & ae  # overlay tombstones compose before propagation
        return g, e_ok, direction

    def _seed_ids(self, seeds) -> np.ndarray:
        """Internal ids of the live seeds the graph knows (unknown and
        tombstoned seeds drop out)."""
        ids = self._vertex_internal(seeds)
        ids = ids[ids >= 0]
        if self._dead_v is not None and ids.size:
            ids = ids[~self._dead_v[ids]]
        return ids

    def _seed_mask(self, ids: np.ndarray) -> torch.Tensor:
        g = self.graph
        return dip_list.mark(torch.from_numpy(ids.astype(np.int64)).to(g.device), g.n, g.device)

    # ---------------------------------------------------- fused sampling
    def _sampling_view(self):
        """(seg, dst, max_deg, perm) windows for the current effective
        graph.  A sorted base graph is its own view (perm None); the
        overlay's combined view (``unsorted``) has no valid SEG, so its
        endpoints are re-sorted on the device (a stable sort by source, the
        reference's host ``argsort(kind="stable")``) into a sampleable CSR
        — ``perm[j]`` is the global edge id at sorted position j, the gather
        that routes per-edge filters into window space.  Cached per
        version: traffic between writes sorts once."""
        g = self._require_graph()
        if not g.unsorted:
            return g.seg, g.dst, int(g.max_deg), None

        def build():
            order = torch.sort(g.src, stable=True).indices
            bounds = torch.arange(g.n + 1, dtype=torch.int32, device=g.device)
            seg = torch.searchsorted(gather(g.src, order), bounds, out_int32=True)
            md = int((seg[1:] - seg[:-1]).max()) if g.n else 0
            return seg, gather(g.dst, order), md, order.to(torch.int32)

        return self._cached("sample_view", build)

    def _sample_edge_words(self, pattern, perm=None) -> Optional[torch.Tensor]:
        """Packed (int32-word) edge-allowed bitmap for sampling under the
        single-hop filter ``pattern``: an edge is sampleable iff it holds
        the relationship, satisfies the predicates, its tail matches the
        ``a`` constraint, its head matches ``b``, AND it is alive in the
        overlay (tombstoned edges and edges of deleted vertices never
        appear).  ``perm`` routes the mask into an overlay view's window
        order.  None = every edge.  Cached per (version, pattern) so a
        served pattern packs once."""
        arg = (None if pattern is None else str(pattern), perm is not None)
        return self._cached("sample_words", lambda: self._build_edge_words(pattern, perm), arg)

    def _build_edge_words(self, pattern, perm) -> Optional[torch.Tensor]:
        from repro_torch.traverse import single_hop_filters

        g = self._require_graph()
        v_tail, v_head, e_ok, direction = single_hop_filters(self, pattern)
        if direction != 1:
            raise ValueError(
                "sampling follows out-edges; reverse-direction filter "
                "patterns (<-[...]-) are not supported")
        if v_tail is not None or v_head is not None:
            if e_ok is None:
                e_ok = torch.ones(g.m, dtype=torch.bool, device=g.device)
            if v_tail is not None:
                e_ok = e_ok & v_tail[g.src]
            if v_head is not None:
                e_ok = e_ok & v_head[g.dst]
        ae = self._alive_edge_mask()
        if ae is not None:
            e_ok = ae if e_ok is None else e_ok & ae
        if e_ok is None:
            return None
        if perm is not None:
            e_ok = gather(e_ok, perm)
        return bitplane.pack_mask(e_ok)

    def _sample_rest(self, frontier, nbrs0, mask0, fanouts, base: int,
                     seg, dstv, max_deg, ew_words):
        """Layers 1..L of the layered loop and block assembly.  Layer l
        draws from ``layer_key(base, l)`` — independent per layer."""
        from repro_torch.graph.sampler import layer_key, local_block, sorted_unique
        from repro_torch.kernels.neighbor_sample import neighbor_sample

        g = self._require_graph()
        layer_frontiers = [frontier]
        layer_samples = [(frontier, nbrs0, mask0)]
        layer_frontiers.append(
            sorted_unique(np.concatenate([frontier, nbrs0[mask0]])).astype(np.int32))
        for li in range(1, len(fanouts)):
            cur = layer_frontiers[-1]
            nb, _ei, mk = neighbor_sample(
                seg, dstv, g.n, g.m, cur, layer_key(base, li), fanout=fanouts[li],
                edge_words=ew_words, max_deg=max_deg)
            nb = nb[:len(cur)].cpu().numpy()
            mk = mk[:len(cur)].cpu().numpy()
            layer_samples.append((cur, nb, mk))
            layer_frontiers.append(
                sorted_unique(np.concatenate([cur, nb[mk]])).astype(np.int32))
        blocks = []
        for li in range(len(fanouts) - 1, -1, -1):
            dst_nodes, nb, mk = layer_samples[li]
            blocks.append(local_block(dst_nodes, layer_frontiers[li + 1], nb, mk))
        return blocks

    def sample(self, seeds_or_pattern, fanouts, *, key: Optional[int] = None, seed: int = 0,
               pattern=None, use_pallas: bool = False):
        """Fused property-filtered neighborhood sampling — the
        pattern→sample path.

        ``seeds_or_pattern``: original vertex ids, or a Cypher-lite pattern
        string — then the seeds are the vertices the pattern's FIRST node
        variable binds, and the packed ``match`` combine's words feed the
        window gather directly (the host reads one popcount scalar to pick
        the capacity bucket).  ``fanouts``: per-layer caps, innermost first
        (GraphSAGE order).  ``pattern``: an optional single-hop filter
        constraining which edges may be sampled at EVERY layer
        (relationship, predicates, endpoint labels).  ``key``/``seed``: the
        integer base key (``key`` wins when given) — results are
        reproducible given it (layer l draws from ``layer_key(base, l)``
        only).  ``use_pallas`` is kept for signature parity with the
        reference; here the CUDA kernel runs on every card call.

        Returns ``SampledBlock``s innermost-first (``blocks[-1].dst_nodes``
        = the seed batch); node ids are INTERNAL [0, n) ids — index
        property columns directly, or map back through ``graph.node_map``.
        Selection is uniform without replacement over each seed's filtered
        adjacency: degree-0 seeds emit fully-masked slots, filtered degree
        ≤ fanout keeps every allowed edge once.  Unknown and tombstoned
        seed ids drop out (the ``khop`` rule); overlay tombstones are never
        sampled, and delta edges are, through the re-sorted view.
        """
        from repro_torch.graph.sampler import layer_key
        from repro_torch.kernels.neighbor_sample import (
            neighbor_sample,
            neighbor_sample_from_words,
        )

        g = self._require_graph()
        fanouts = [int(f) for f in fanouts]
        if not fanouts or min(fanouts) < 1:
            raise ValueError(f"fanouts must be ≥1 per layer, got {fanouts}")
        seg, dstv, max_deg, perm = self._sampling_view()
        ew_words = self._sample_edge_words(pattern, perm)
        base = int(seed) if key is None else int(key)
        k0 = layer_key(base, 0)
        if isinstance(seeds_or_pattern, str) or hasattr(seeds_or_pattern, "nodes"):
            res = self.match(seeds_or_pattern)
            seed_mask = res.node_masks[0] if res.node_masks else res.vertex_mask
            count = int(seed_mask.sum())  # the one host scalar read
            idx, valid, nb, _ei, mk = neighbor_sample_from_words(
                seg, dstv, g.n, g.m, bitplane.pack_mask(seed_mask), count, k0,
                fanout=fanouts[0], edge_words=ew_words, max_deg=max_deg)
            keep = valid.cpu().numpy()
            frontier = idx.cpu().numpy()[keep].astype(np.int32)
            nbrs0, mask0 = nb.cpu().numpy()[keep], mk.cpu().numpy()[keep]
        else:
            ids = self._seed_ids(seeds_or_pattern)
            nb, _ei, mk = neighbor_sample(
                seg, dstv, g.n, g.m, ids, k0, fanout=fanouts[0],
                edge_words=ew_words, max_deg=max_deg, use_pallas=use_pallas)
            frontier = ids.astype(np.int32)
            nbrs0 = nb[:len(ids)].cpu().numpy()
            mask0 = mk[:len(ids)].cpu().numpy()
        return self._sample_rest(frontier, nbrs0, mask0, fanouts, base,
                                 seg, dstv, max_deg, ew_words)

    def components(self, pattern=None, *, max_iters: int = 128) -> torch.Tensor:
        """Connected components of the subgraph the filter ``pattern``
        allows — (n,) int32 labels (component id = smallest member vertex
        id, internal numbering), -1 for vertices outside the filter.

        Edges count as undirected; an edge participates iff it satisfies
        the pattern's relationship/predicate masks AND both endpoints
        match their node constraints.  Vertices matching either endpoint
        constraint participate (isolated ones form singletons).  ``None``
        = plain structural components.
        """
        from repro_torch import traverse

        g, v_ok, e_ok, _ = self._subgraph_filters(pattern)
        return _observed("components", None, lambda: traverse.components_masked(
            g, v_ok, e_ok, max_iters=max_iters))

    def _weighted_edge_filter(self, e_ok, weight: Optional[str]):
        """Fold a numeric edge-property column into a traversal: (f32
        weights or None, the edge filter with the column's validity mask
        ANDed in).  An edge without the property is NOT traversable under
        a weighted semiring — there is no sound default weight."""
        if weight is None:
            return None, e_ok
        from repro_torch.query.weights import edge_weight_values

        w, wvalid = edge_weight_values(self, weight)
        return w, (wvalid if e_ok is None else e_ok & wvalid)

    def shortest_paths(self, seeds, *, weight: Optional[str] = None, pattern=None,
                       undirected: bool = False,
                       max_iters: Optional[int] = None) -> torch.Tensor:
        """Multi-source shortest-path distances from ``seeds`` (original
        ids) over the (min, +) tropical semiring — (n,) f32, 0.0 at the
        seeds, +inf where unreachable.

        ``weight`` names a numeric edge property; edges without it do not
        participate (``None`` = unit weights, hop counts).  ``pattern`` is
        the single-hop filter ``khop`` takes: it constrains each STEP of
        the walk (relationship, predicates, endpoint labels, ``<-[...]-``
        direction); the fixed point supplies the path structure."""
        from repro_torch import traverse

        g, e_ok, direction = self._step_filter(pattern)
        w, e_ok = self._weighted_edge_filter(e_ok, weight)
        if self.mesh is not None:
            return _observed("shortest_paths", seeds, lambda: traverse.shortest_paths_sharded(
                g, self._seed_mask(self._seed_ids(seeds)), w, e_ok, mesh=self.mesh,
                direction=direction, undirected=undirected, max_iters=max_iters,
                blocks=self._edge_blocks(direction)))
        return _observed("shortest_paths", seeds, lambda: traverse.shortest_paths_masked(
            g, self._seed_mask(self._seed_ids(seeds)), w, e_ok, direction=direction,
            undirected=undirected, max_iters=max_iters))

    def _subgraph_filters(self, pattern):
        """Whole-subgraph mask composition shared by the components-shaped
        analytics: pattern endpoint masks gate edges AND define vertex
        membership (either endpoint constraint admits a vertex)."""
        from repro_torch import traverse

        g = self._require_graph()
        v_tail, v_head, e_mask, direction = traverse.single_hop_filters(self, pattern)
        tail, head = (g.src, g.dst) if direction == 1 else (g.dst, g.src)
        e_ok, v_ok = e_mask, None
        if v_tail is not None or v_head is not None:
            ones = torch.ones(g.n, dtype=torch.bool, device=g.device)
            vt = ones if v_tail is None else v_tail
            vh = ones if v_head is None else v_head
            em = torch.ones(g.m, dtype=torch.bool, device=g.device) if e_ok is None else e_ok
            e_ok = em & gather(vt, tail) & gather(vh, head)
            v_ok = vt | vh
        ae = self._alive_edge_mask()
        if ae is not None:
            e_ok = ae if e_ok is None else e_ok & ae
        av = self._alive_vertex_mask()
        if av is not None:
            v_ok = av if v_ok is None else v_ok & av
        return g, v_ok, e_ok, direction

    def pagerank(self, *, pattern=None, weight: Optional[str] = None, damping: float = 0.85,
                 iters: int = 20) -> torch.Tensor:
        """PageRank on the subgraph the filter ``pattern`` allows — (n,) f32
        ranks, 0.0 for vertices outside the filter.

        The (+, ×) semiring instance: per-iteration contributions
        ``rank/out_degree`` flow along allowed edges (``weight`` scales
        them per edge; edges without the property drop out), teleport and
        dangling mass redistribute over the allowed vertex count.  With no
        filter this is the classic §I kernel (``graph.pagerank``)."""
        from repro_torch import traverse

        g, v_ok, e_ok, direction = self._subgraph_filters(pattern)
        w, e_ok = self._weighted_edge_filter(e_ok, weight)
        if self.mesh is not None:
            return _observed("pagerank", None, lambda: traverse.pagerank_sharded(
                g, v_ok, e_ok, w, mesh=self.mesh, damping=damping, iters=iters,
                direction=direction, blocks=self._edge_blocks(direction)))
        return _observed("pagerank", None, lambda: traverse.pagerank_masked(
            g, v_ok, e_ok, w, damping=damping, iters=iters, direction=direction))

    def communities(self, pattern=None, *, max_iters: int = 64) -> torch.Tensor:
        """Community labels by synchronous label propagation on the
        subgraph the filter ``pattern`` allows — (n,) int32 (label = a
        member vertex id, internal numbering), -1 outside the filter.

        Most frequent neighbor label, smallest wins ties; edges count as
        undirected, exactly ``components``' participation rule.  All
        integer, so the result is exact."""
        from repro_torch import traverse

        g, v_ok, e_ok, _ = self._subgraph_filters(pattern)
        return _observed("communities", None, lambda: traverse.label_propagation_masked(
            g, v_ok, e_ok, max_iters=max_iters))

    # ------------------------------------------- snapshots / views / overlay
    def snapshot(self) -> "PropGraph":
        """Immutable view pinned at (base store @ version, frozen delta
        chain).  Zero-copy: the sealed device stores, DI tensors and typed
        columns are SHARED with the parent — only the small delta chunk
        lists are shallow-copied.  Writes keep landing on the parent (its
        delta chain grows past the snapshot's frozen prefix, its columns are
        replaced by new tensors), so a long ``components()`` or ``match()``
        on the snapshot reads one consistent view.  Mutators on a snapshot
        raise; ``fork()`` one to branch."""
        from repro_torch.overlay.views import clone_propgraph

        return clone_propgraph(self, frozen=True)

    def fork(self) -> "PropGraph":
        """Writable copy-on-write view: (base graph @ snapshot, private
        overlay).  Shares the base's device tensors with the parent; each
        side's later writes land in its own delta and tombstones — the
        what-if primitive ("delete this hub, what breaks")."""
        from repro_torch.overlay.views import clone_propgraph

        return clone_propgraph(self, frozen=False)

    @_write_locked
    def compact(self) -> "PropGraph":
        """Fold the whole overlay (delta edges, delta attribute pairs,
        tombstones) into fresh base stores — the LSM merge step.  Equal to
        a rebuild from scratch of the surviving data; structural for cache
        purposes.  No-op when there is no overlay."""
        self._check_writable()
        if not self.has_overlay():
            return self
        from repro_torch.overlay.compactor import compact_propgraph

        compact_propgraph(self)
        self.last_mutation = MutationEvent.structural_event("compact")
        self._bump_version()
        return self

    def has_overlay(self) -> bool:
        """Any uncompacted overlay state (delta pairs/edges or tombstones)?"""
        return self.overlay_size() > 0

    def overlay_size(self) -> int:
        """Total overlay entries — the compaction-policy signal the
        background ``Compactor`` thresholds on."""
        return sum(self.delta_stats().values())

    def delta_stats(self) -> Dict[str, int]:
        """Per-component overlay sizes."""
        return {
            "delta_edges": self._delta_edges.size if self._delta_edges else 0,
            "delta_vertex_pairs": self._vstore._delta.size if self._vstore else 0,
            "delta_edge_pairs": self._estore._delta.size if self._estore else 0,
            "dead_vertices": int(self._dead_v.sum()) if self._dead_v is not None else 0,
            "dead_edges": int(self._dead_e.size) if self._dead_e is not None else 0,
        }

    @property
    def frozen(self) -> bool:
        return self._frozen

    # ------------------------------------------------------- state transfer
    def to_arrays(self) -> dict:
        """The graph's state as host arrays: the DI fields, each sealed
        store's attribute values and plane, the property columns with their
        valid masks.  ``from_arrays`` rebuilds an equal graph from it.  A
        graph with an overlay is flattened first, on a private fork (as
        ``save_propgraph`` does), so the caller's overlay stays."""
        if self.has_overlay():
            flat = self.fork()
            flat.compact()
            return flat.to_arrays()
        g = self._require_graph()
        return {
            "graph": {"src": g.src.cpu().numpy(), "dst": g.dst.cpu().numpy(),
                      "seg": g.seg.cpu().numpy(), "node_map": g.node_map.cpu().numpy(),
                      "n": g.n, "m": g.m, "max_deg": g.max_deg},
            "vstore": self._vstore.to_arrays(),
            "estore": self._estore.to_arrays(),
            "vertex_props": self.host_columns("node"),
            "edge_props": self.host_columns("edge"),
        }

    def host_columns(self, kind: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """``kind`` ("node" or "edge") property columns as host arrays in the
        type the reference holds them in (a uint32 column held as int64 on
        the device comes back uint32), with their valid masks."""
        props = self.vertex_props if kind == "node" else self.edge_props
        return {k: (c.cpu().numpy().astype(self._col_dtypes[(kind, k)], copy=False),
                    v.cpu().numpy()) for k, (c, v) in props.items()}

    @classmethod
    def from_arrays(cls, arrays: dict, *, device=None) -> "PropGraph":
        """A graph on ``device`` equal to the one ``arrays`` describes —
        the layout ``to_arrays`` writes, which the reference package's
        state fills as well (``np.asarray`` of its DI fields, its sealed
        stores' planes and its columns).  Stores arrive sealed."""
        pg = cls(backend="arr", device=device)
        gd = arrays["graph"]

        def t(a):  # a private copy: the caller's arrays may be read-only views
            return torch.from_numpy(np.array(a)).to(pg.device)

        pg._set_graph(DIGraph(
            src=t(np.asarray(gd["src"], np.int32)), dst=t(np.asarray(gd["dst"], np.int32)),
            seg=t(np.asarray(gd["seg"], np.int32)), node_map=t(gd["node_map"]),
            n=int(gd["n"]), m=int(gd["m"]), max_deg=int(gd["max_deg"])))
        for attr, key in (("_vstore", "vstore"), ("_estore", "estore")):
            s = arrays[key]
            setattr(pg, attr, _AttrStore.from_plane(
                s["values"], s["bitmap"], k=int(s["k"]), n=int(s["n"]),
                packed=bool(s["packed"]), device=pg.device))
        for kind, key in (("node", "vertex_props"), ("edge", "edge_props")):
            for name, (col, valid) in arrays.get(key, {}).items():
                pg._set_column(kind, name, col, valid)
        return pg

    # ------------------------------------------------------------------ info
    @property
    def n_vertices(self) -> int:
        return self._require_graph().n

    @property
    def n_edges(self) -> int:
        return self._require_graph().m

    def label_set(self) -> List[str]:
        return self._vstore.amap.values if self._vstore else []

    def relationship_set(self) -> List[str]:
        return self._estore.amap.values if self._estore else []

    def _attr_counts(self, kind: str) -> np.ndarray:
        """The vertex (``"node"``) or edge store's per-attribute counts with
        the tombstoned entities' pairs subtracted — what the alive-masked
        queries return; the planner reads them every plan, so they are
        cached per version."""
        if kind == "node":
            return self._cached("counts_node", lambda: self._vstore.attr_counts(
                dead_ids=self._dead_vertex_ids()))
        return self._cached("counts_edge", lambda: self._estore.attr_counts(
            dead_ids=self._dead_edge_ids()))

    def label_counts(self) -> Dict[str, int]:
        """Per-label vertex counts, off the host-derived store stats.
        Tombstoned vertices are subtracted, so the counts agree with
        ``query_labels`` (which masks them out)."""
        if self._vstore is None:
            return {}
        counts = self._attr_counts("node")
        return {v: int(counts[i]) for i, v in enumerate(self._vstore.amap.values)}

    def relationship_counts(self) -> Dict[str, int]:
        """Per-relationship edge counts, off the host-derived store stats
        (tombstoned and detached edges subtracted)."""
        if self._estore is None:
            return {}
        counts = self._attr_counts("edge")
        return {v: int(counts[i]) for i, v in enumerate(self._estore.amap.values)}

