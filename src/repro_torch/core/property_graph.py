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

This port covers one device: ingest, ``match()``, ``sample()`` and the
frontier analytics (``khop``, ``components``, ``shortest_paths``,
``pagerank``, ``communities``) on every backend.  Meshes, the overlay
(writes after a store sealed, deletes, snapshots, forks, compaction) and
the observability layer are not ported yet and raise
``NotImplementedError``.

``device=None`` means the CUDA card; with no card that raises
``RuntimeError`` instead of quietly running on the CPU.  Pass
``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import operator
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitplane, dip_arr, dip_list, dip_listd
from repro_torch.core.attr_map import AttributeMap
from repro_torch.core.device import resolve_device
from repro_torch.core.di import DIGraph, build_di, edge_lookup
from repro_torch.core.queries import (
    extract_subgraph,
    filtered_bfs,
    gather,
    induce_edge_mask,
)

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
    taken, and it is placed on the device.  Writes after the seal need the
    overlay, which is not ported yet.
    """

    def __init__(self, backend: str, n_entities: int, device: torch.device):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.backend = backend
        self.n = n_entities
        self.device = device
        self.amap = AttributeMap()
        self._pairs_e: List[np.ndarray] = []  # entity ids, insertion order
        self._pairs_a: List[np.ndarray] = []  # attribute ids
        self._store = None  # DIPArr, DIPList or DIPListD on the device
        self._host = None  # host build awaiting upload
        self._counts: Optional[np.ndarray] = None
        self._k_base: Optional[int] = None  # attribute rows in the sealed store
        self.plane_only = False  # sealed from a plane: no raw pairs to save

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
        return self._store is not None

    @property
    def packed(self) -> bool:
        """True when the store holds (or will hold) the packed word plane
        (arr only); captured at build time."""
        if self.backend != "arr":
            return False
        for built in (self._store, self._host):
            if built is not None:
                return bool(built.packed)
        return bitplane.packed_default()

    def insert(self, entity_ids: np.ndarray, values: Sequence[str]) -> None:
        if self.sealed:
            raise NotImplementedError(
                "adding attributes after the store answered a query needs the "
                "overlay write path, which is not ported yet")
        attr_ids = self.amap.encode(values)
        attr_ids = np.broadcast_to(np.atleast_1d(attr_ids), np.shape(entity_ids)).ravel()
        entity_ids = np.asarray(entity_ids, np.int32).ravel()
        ok = entity_ids >= 0  # unmatched edge rows (edge_lookup -1) are dropped
        self._pairs_e.append(entity_ids[ok])
        self._pairs_a.append(attr_ids[ok].astype(np.int32))
        self._counts = None
        self._host = None

    @property
    def k(self) -> int:
        return max(len(self.amap), 1)

    def pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """All (entity, attribute) pairs, in insertion order."""
        if not self._pairs_e:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return np.concatenate(self._pairs_e), np.concatenate(self._pairs_a)

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
            self._counts = np.diff(host.a_off).astype(np.int64)
        self._host = host
        self._k_base = self.k
        return host

    def finalize(self):
        """Seal: place the host build on the device (once)."""
        if self._store is None:
            self._store = _BUILDERS[self.backend][1](self._build_host(), self.device)
            self._host = None
        return self._store

    def known_ids(self, values: Sequence[str]) -> np.ndarray:
        """Interned attribute ids for ``values`` (unknown values dropped)."""
        ids = np.atleast_1d(self.amap.lookup(list(values)))
        return ids[ids >= 0].astype(np.int32)

    def attr_counts(self) -> np.ndarray:
        """(k,) per-attribute entity counts — the selectivity statistics the
        planner orders joins with, derived on the host."""
        if self._counts is None:
            self._build_host()
        counts = self._counts
        if len(counts) < self.k:
            counts = np.concatenate([counts, np.zeros(self.k - len(counts), counts.dtype)])
        return counts

    @property
    def nnz(self) -> int:
        """Stored (entity, attribute) pairs after dedupe — Σ attr_counts."""
        return int(np.sum(self.attr_counts()))

    def _mask(self, values: Sequence[str]) -> np.ndarray:
        return self.amap.mask(values, self._k_base)

    def _masks(self, values_list: Sequence[Sequence[str]]) -> torch.Tensor:
        return torch.from_numpy(np.stack([self._mask(v) for v in values_list])).to(self.device)

    def query_any(self, values: Sequence[str], *, impl: Optional[str] = None) -> torch.Tensor:
        """(n,) bool — entities holding ANY of ``values``.  ``impl``: arr
        ``scan``/``matvec``/``kernel``; listd ``inverted``/``linked``/
        ``budget``; list has one implementation and ignores it."""
        ids = self.known_ids(values) if len(values) else np.zeros(0, np.int32)
        if ids.size == 0:
            # empty list / all-unknown values: definitionally empty
            return torch.zeros(self.n, dtype=torch.bool, device=self.device)
        store = self.finalize()
        if self.backend == "listd" and impl == "budget":
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

    def query_any_batched(self, values_list: Sequence[Sequence[str]], *,
                          impl: Optional[str] = None) -> torch.Tensor:
        """(Q, n) bool — Q OR-queries: one launch on arr, a loop over the
        queries on list and listd."""
        if self.backend != "arr":
            return torch.stack([self.query_any(v, impl=impl) for v in values_list])
        store = self.finalize()
        return dip_arr.query_any_batched(store, self._masks(values_list), impl=impl or "matvec")

    def query_any_words(self, values: Sequence[str], *,
                        impl: Optional[str] = None) -> torch.Tensor:
        """Packed query: (ceil(n/32),) int32 words.  Every impl is the
        packed OR-scan; ``impl`` is accepted for the planner's sake."""
        if not self.packed:
            raise ValueError("query_any_words requires a packed store")
        ids = self.known_ids(values) if len(values) else np.zeros(0, np.int32)
        if ids.size == 0:
            return torch.zeros(bitplane.n_words(self.n), dtype=torch.int32, device=self.device)
        store = self.finalize()
        mask = torch.from_numpy(self._mask(values)).to(self.device)
        return dip_arr.query_any_words(store, mask)

    def query_any_batched_words(self, values_list: Sequence[Sequence[str]], *,
                                impl: Optional[str] = None) -> torch.Tensor:
        """(Q, ceil(n/32)) int32 — Q packed OR-queries, one launch."""
        if not self.packed:
            raise ValueError("query_any_batched_words requires a packed store")
        store = self.finalize()
        return dip_arr.query_any_batched_words(store, self._masks(values_list))

    def to_arrays(self) -> dict:
        """The sealed store as host arrays (see ``PropGraph.from_arrays``)."""
        if self.backend != "arr":
            raise ValueError(f"to_arrays moves DIP-ARR planes; save a {self.backend!r} graph "
                             "with save_propgraph and reload it with load_propgraph")
        store = self.finalize()
        bm = store.bitmap.cpu().numpy()
        return {"values": self.amap.values, "bitmap": bm.view(np.uint32) if store.packed else bm,
                "k": store.k, "n": store.n, "packed": store.packed}


class PropGraph:
    """A static, directed, labeled property multigraph over the DI structure,
    on one device (``device=None`` → the CUDA card)."""

    def __init__(self, backend: str = "arr", mesh=None, *, device=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported yet")
        self.backend = backend
        self.mesh = None
        self.device = resolve_device(device)
        self.graph: Optional[DIGraph] = None
        self._node_map_host: Optional[np.ndarray] = None
        self._vstore: Optional[_AttrStore] = None
        self._estore: Optional[_AttrStore] = None
        # typed property columns: name -> (values (x,), valid mask (x,)), and
        # each column's type as the reference holds it (see _place_column)
        self.vertex_props: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.edge_props: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._col_dtypes: Dict[Tuple[str, str], np.dtype] = {}
        # monotone mutation counter + observers (cache invalidation contract)
        self.version: int = 0
        self._mutation_hooks: List = []

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

    # ------------------------------------------------------------- structure
    def _set_graph(self, graph: DIGraph) -> None:
        self.graph = graph
        self._node_map_host = graph.node_map.cpu().numpy()

    def add_edges_from(self, src, dst) -> "PropGraph":
        """Bulk edge ingestion → DI build (normalize + sort + SEG) on the
        graph's device.  Rebuilding the structure drops previously attached
        attributes (fresh stores)."""
        src = np.asarray(src)
        if src.size == 0 and self.graph is not None:
            return self  # no-op: nothing to rebuild from
        self._set_graph(build_di(src, np.asarray(dst), device=self.device))
        self._vstore = _AttrStore(self.backend, self.graph.n, self.device)
        self._estore = _AttrStore(self.backend, max(self.graph.m, 1), self.device)
        self._bump_version()
        return self

    def _require_graph(self) -> DIGraph:
        if self.graph is None:
            raise RuntimeError("call add_edges_from(...) first")
        return self.graph

    def _vertex_internal(self, nodes) -> np.ndarray:
        """Original vertex ids → internal [0, n) ids (−1 if absent)."""
        self._require_graph()
        nm = self._node_map_host
        nodes = np.asarray(nodes).ravel()
        pos = np.clip(np.searchsorted(nm, nodes), 0, len(nm) - 1)
        ok = nm[pos] == nodes
        return np.where(ok, pos, -1).astype(np.int32)

    def _edge_internal(self, src, dst) -> np.ndarray:
        g = self._require_graph()
        u = self._vertex_internal(src)
        v = self._vertex_internal(dst)
        idx = edge_lookup(g, torch.from_numpy(np.maximum(u, 0)).to(g.device),
                          torch.from_numpy(np.maximum(v, 0)).to(g.device)).cpu().numpy()
        return np.where((u >= 0) & (v >= 0), idx, -1).astype(np.int32)

    # ------------------------------------------------------------ attributes
    def add_node_labels(self, nodes, labels) -> "PropGraph":
        self._require_graph()
        if np.asarray(nodes).size == 0:
            return self  # no-op
        self._vstore.insert(self._vertex_internal(nodes), labels)
        self._bump_version()
        return self

    def add_edge_relationships(self, src, dst, relationships) -> "PropGraph":
        self._require_graph()
        if np.asarray(src).size == 0:
            return self  # no-op
        self._estore.insert(self._edge_internal(src, dst), relationships)
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
        self._bump_version()

    def add_node_properties(self, name: str, nodes, values, fill=0) -> "PropGraph":
        g = self._require_graph()
        if np.asarray(nodes).size == 0:
            return self  # no-op
        self._add_column("node", g.n, self._vertex_internal(nodes), name, values, fill)
        return self

    def add_edge_properties(self, name: str, src, dst, values, fill=0) -> "PropGraph":
        g = self._require_graph()
        if np.asarray(src).size == 0:
            return self  # no-op
        self._add_column("edge", g.m, self._edge_internal(src, dst), name, values, fill)
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
        return ((torch.from_numpy(np.ascontiguousarray(col)).to(self.device),
                 torch.from_numpy(np.array(valid, bool)).to(self.device)), dtype)

    # --------------------------------------------------------------- queries
    def query_labels(self, labels, *, impl: Optional[str] = None) -> torch.Tensor:
        """(n,) bool — vertices holding ANY of ``labels`` (§VI OR semantics)."""
        self._require_graph()
        return self._vstore.query_any(labels, impl=impl)

    def query_relationships(self, relationships, *, impl: Optional[str] = None) -> torch.Tensor:
        """(m,) bool — edges holding ANY of ``relationships``."""
        self._require_graph()
        return self._estore.query_any(relationships, impl=impl)

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
        (entities without the property never match)."""
        self._require_graph()
        return self._predicate_mask("node", name, op, value)

    def edge_predicate_mask(self, name: str, op: str, value) -> torch.Tensor:
        """(m,) bool — edges whose typed property ``name`` compares true."""
        self._require_graph()
        return self._predicate_mask("edge", name, op, value)

    # ------------------------------------------------------ pattern matching
    def match(self, pattern, *, impl: Optional[str] = None, profile: bool = False):
        """Declarative pattern query, e.g.
        ``pg.match("(a:person {age > 30})-[:follows]->(b:person)")``.

        Parses ``pattern`` (str or a pre-built ``Pattern``), plans it against
        the DIP statistics and runs the mask pipeline.  Returns a
        ``MatchResult`` whose masks cover exactly the entities in at least
        one full match.  ``impl`` overrides the planner's per-mask choice.
        """
        if profile:
            raise NotImplementedError("match(profile=True) needs the observability layer, "
                                      "which is not ported yet")
        from repro_torch.query import execute_plan, parse, plan_pattern

        pat = parse(pattern) if isinstance(pattern, str) else pattern
        return execute_plan(self, plan_pattern(self, pat, impl=impl))

    def explain(self, pattern, *, impl: Optional[str] = None) -> str:
        """The plan ``match`` would run, as text."""
        from repro_torch.query import parse, plan_pattern

        pat = parse(pattern) if isinstance(pattern, str) else pattern
        return plan_pattern(self, pat, impl=impl).describe()

    def subgraph(self, labels: Optional[Sequence[str]] = None,
                 relationships: Optional[Sequence[str]] = None, *,
                 impl: Optional[str] = None) -> Tuple[DIGraph, np.ndarray]:
        """Intersect label/relationship query masks into an induced subgraph."""
        g = self._require_graph()
        vmask = (self.query_labels(labels, impl=impl) if labels is not None
                 else torch.ones(g.n, dtype=torch.bool, device=g.device))
        emask = (self.query_relationships(relationships, impl=impl) if relationships is not None
                 else torch.ones(g.m, dtype=torch.bool, device=g.device))
        return extract_subgraph(g, induce_edge_mask(g, vmask, emask))

    def bfs(self, sources, labels: Optional[Sequence[str]] = None,
            relationships: Optional[Sequence[str]] = None, max_iters: int = 64) -> torch.Tensor:
        """Property-filtered BFS from original-id sources; (n,) depths."""
        g = self._require_graph()
        v_ok = self.query_labels(labels) if labels is not None else None
        e_ok = self.query_relationships(relationships) if relationships is not None else None
        srcs = torch.from_numpy(np.maximum(self._vertex_internal(sources), 0)).to(g.device)
        return filtered_bfs(g, srcs, edge_allowed=e_ok, vertex_allowed=v_ok, max_iters=max_iters)

    # -------------------------------------------------- frontier analytics
    # The reference also records each run for the observability layer
    # (``_obs_traverse``) and runs sharded under a mesh; both wait for their
    # ports.
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

        ``impl``: ``None``/``"frontier"`` = the edge-centric Boolean step;
        ``"csr"`` = the CSR gather of each new frontier's windows (forward
        and directed only; degrades to ``frontier`` otherwise).  Both are
        bitwise identical.
        """
        from repro_torch import traverse

        if impl not in (None, "frontier", "csr"):
            raise ValueError(f"unknown impl {impl!r}")
        g, e_ok, direction = self._step_filter(pattern)
        ids = self._seed_ids(seeds)
        # a combined base++delta view of the overlay has no SEG windows and
        # will degrade csr to the frontier step too
        if impl == "csr" and direction == 1 and not undirected:
            return traverse.khop_csr(g, ids, e_ok, k=k)
        return traverse.khop_mask(g, self._seed_mask(ids), e_ok, k=k,
                                  direction=direction, undirected=undirected)

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
        # the overlay's alive edge mask ANDs in here
        return g, e_ok, direction

    def _seed_ids(self, seeds) -> np.ndarray:
        """Internal ids of the seeds the graph knows (the others drop out)."""
        ids = self._vertex_internal(seeds)
        # the overlay's dead seeds drop out here too
        return ids[ids >= 0]

    def _seed_mask(self, ids: np.ndarray) -> torch.Tensor:
        g = self.graph
        return dip_list.mark(torch.from_numpy(ids.astype(np.int64)).to(g.device), g.n, g.device)

    # ---------------------------------------------------- fused sampling
    def _sampling_view(self):
        """(seg, dst, max_deg, perm) windows for the current graph.  Without
        the overlay the sorted base graph is its own view (perm None)."""
        g = self._require_graph()
        return g.seg, g.dst, int(g.max_deg), None

    def _sample_edge_words(self, pattern) -> Optional[torch.Tensor]:
        """Packed (int32-word) edge-allowed bitmap for sampling under the
        single-hop filter ``pattern``: an edge is sampleable iff it holds
        the relationship, satisfies the predicates, its tail matches the
        ``a`` constraint and its head matches ``b``.  None = every edge.
        Cached per (version, pattern) so a served pattern packs once.  The
        overlay's alive-edge mask joins this AND when the overlay is ported."""
        from repro_torch.traverse import single_hop_filters

        key = (self.version, None if pattern is None else str(pattern))
        cache = getattr(self, "_sample_filter_cache", None)
        if cache is not None and cache[0] == key:
            return cache[1]
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
        words = None if e_ok is None else bitplane.pack_mask(e_ok)
        self._sample_filter_cache = (key, words)
        return words

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
        ≤ fanout keeps every allowed edge once.  Unknown seed ids drop out.
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
        seg, dstv, max_deg, _perm = self._sampling_view()
        ew_words = self._sample_edge_words(pattern)
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
            ids = self._vertex_internal(seeds_or_pattern)
            ids = ids[ids >= 0]
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
        return traverse.components_masked(g, v_ok, e_ok, max_iters=max_iters)

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
        return traverse.shortest_paths_masked(g, self._seed_mask(self._seed_ids(seeds)), w, e_ok,
                                              direction=direction, undirected=undirected,
                                              max_iters=max_iters)

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
        # the overlay's alive edge and vertex masks AND in here
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
        return traverse.pagerank_masked(g, v_ok, e_ok, w, damping=damping, iters=iters,
                                        direction=direction)

    def communities(self, pattern=None, *, max_iters: int = 64) -> torch.Tensor:
        """Community labels by synchronous label propagation on the
        subgraph the filter ``pattern`` allows — (n,) int32 (label = a
        member vertex id, internal numbering), -1 outside the filter.

        Most frequent neighbor label, smallest wins ties; edges count as
        undirected, exactly ``components``' participation rule.  All
        integer, so the result is exact."""
        from repro_torch import traverse

        g, v_ok, e_ok, _ = self._subgraph_filters(pattern)
        return traverse.label_propagation_masked(g, v_ok, e_ok, max_iters=max_iters)

    # ------------------------------------------------------- state transfer
    def to_arrays(self) -> dict:
        """The graph's state as host arrays: the DI fields, each sealed
        store's attribute values and plane, the property columns with their
        valid masks.  ``from_arrays`` rebuilds an equal graph from it."""
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

    def label_counts(self) -> Dict[str, int]:
        """Per-label vertex counts, off the host-derived store stats."""
        if self._vstore is None:
            return {}
        counts = self._vstore.attr_counts()
        return {v: int(counts[i]) for i, v in enumerate(self._vstore.amap.values)}

    def relationship_counts(self) -> Dict[str, int]:
        """Per-relationship edge counts, off the host-derived store stats."""
        if self._estore is None:
            return {}
        counts = self._estore.attr_counts()
        return {v: int(counts[i]) for i, v in enumerate(self._estore.amap.values)}


def _not_ported(name: str, part: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"PropGraph.{name} needs {part}, which is not ported yet")

    method.__name__ = name
    return method


for _part, _names in (
    ("the overlay", ("insert_edges", "delete_vertices", "delete_edges",
                     "update_node_properties", "update_edge_properties", "snapshot",
                     "fork", "compact")),
    ("the observability layer", ("explain_analyze",)),
):
    for _name in _names:
        setattr(PropGraph, _name, _not_ported(_name, _part))
