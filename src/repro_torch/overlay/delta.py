"""Delta buffers — the overlay's LSM-style write path (docs/ARCHITECTURE.md §11).

The paper's DIP stores are bulk-built and read-mostly.  The overlay makes
each store a two-level LSM pair:

    sealed base (DIP store on the graph's device, immutable)
      + delta   (small append-only host buffers, this module)

Writes append to the delta in O(batch); queries union the sealed base's
mask with the delta's matches (``base_mask | delta_mask``), composed
BEFORE propagation so the frontier engine and the executor never see the
split.  The compactor (``repro_torch.overlay.compactor``) folds the delta
back into the base.

Everything here is host-side numpy and append-only: chunks are never
changed after they are appended, so a *frozen copy* (a shallow copy of the
chunk lists) is a complete, immutable snapshot of the delta chain — the
sharing ``PropGraph.snapshot()`` / ``fork()`` are built on
(``repro_torch.overlay.views``).

The union reaches the device as the matching entity ids (``entities``) or
as (word, bits) pairs (``word_bits``), never as a full-length host mask:
at graph3 scale a full mask is megabytes over PCIe for every query.

``MutationEvent`` is the cache-invalidation contract: each mutator
publishes WHICH attribute values / property names a write touched, so a
result cache purges only overlapping results.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["AttrDelta", "EdgeDelta", "MutationEvent", "pattern_refs", "overlaps",
           "pair_keys", "word_bits"]

WORD = 32  # bits per packed word (core.bitplane.WORD)


def pair_keys(ents: np.ndarray, atts: np.ndarray) -> np.ndarray:
    """Fused (entity, attribute) sort keys — both ids are < 2**31, so the
    packed int64 is collision-free for any store this framework builds."""
    return (ents.astype(np.int64) << 31) | atts.astype(np.int64)


def word_bits(ents: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(word ids, int32 words) whose OR into a packed mask sets the bits of
    ``ents``: one entry per distinct word, the uint32 bits held as int32."""
    e = np.unique(np.asarray(ents, np.int64))
    if e.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    wid = e >> 5
    bits = np.left_shift(np.uint32(1), (e & 31).astype(np.uint32))
    starts = np.flatnonzero(np.concatenate([[True], wid[1:] != wid[:-1]]))
    return wid[starts], np.bitwise_or.reduceat(bits, starts).view(np.int32)


class AttrDelta:
    """Append-only (entity, attribute) pair buffer over one DIP store.

    Chunks are immutable once appended; ``frozen_copy`` shares them.  The
    delta answers the same OR-query as the base store and carries EXACT
    selectivity stats (``counts`` dedupes within the delta and against the
    base's key set, so ``attr_counts`` stays exact, never an estimate).
    """

    def __init__(self):
        self._ents: List[np.ndarray] = []
        self._atts: List[np.ndarray] = []
        self._size = 0
        self._cat: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def size(self) -> int:
        return self._size

    def append(self, ents: np.ndarray, atts: np.ndarray) -> None:
        ents = np.asarray(ents, np.int32).ravel()
        if ents.size == 0:
            return
        self._ents.append(ents)
        self._atts.append(np.asarray(atts, np.int32).ravel())
        self._size += ents.size
        self._cat = None

    def cat(self) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenated (entities, attributes) — cached until the next append."""
        if self._cat is None:
            if self._ents:
                self._cat = (np.concatenate(self._ents), np.concatenate(self._atts))
            else:
                self._cat = (np.zeros(0, np.int32), np.zeros(0, np.int32))
        return self._cat

    def entities(self, attr_ids: np.ndarray) -> np.ndarray:
        """Sorted distinct entities holding ANY of ``attr_ids`` in the delta."""
        if not self._size:
            return np.zeros(0, np.int64)
        ents, atts = self.cat()
        return np.unique(ents[np.isin(atts, attr_ids)]).astype(np.int64)

    # ``mask`` and ``mask_words`` keep the reference's API; no query path
    # calls them (the stores upload ``entities`` or ``word_bits`` instead)
    def mask(self, attr_ids: np.ndarray, out_n: int) -> np.ndarray:
        """(out_n,) bool — entities holding ANY of ``attr_ids`` in the delta."""
        out = np.zeros(out_n, dtype=bool)
        out[self.entities(attr_ids)] = True
        return out

    def mask_words(self, attr_ids: np.ndarray, out_n: int) -> np.ndarray:
        """Packed form of :meth:`mask`: (ceil(out_n/32),) int32 words with the
        uint32 bits, little-endian bit order; tail padding bits stay zero."""
        out = np.zeros((out_n + WORD - 1) // WORD, np.int32)
        wid, bits = word_bits(self.entities(attr_ids))
        out[wid] = bits
        return out

    def counts(self, k: int, base_keys: Optional[np.ndarray]) -> np.ndarray:
        """(k,) int64 per-attribute counts of pairs the delta ADDS: deduped
        within the delta and against ``base_keys`` (the sealed base's sorted
        pair keys), so base + delta counts are exact."""
        out = np.zeros(k, np.int64)
        if not self._size:
            return out
        keys = self.added_keys(base_keys)
        if keys.size:
            out += np.bincount((keys & 0x7FFFFFFF).astype(np.int64), minlength=k)
        return out

    def added_keys(self, base_keys: Optional[np.ndarray]) -> np.ndarray:
        """Sorted distinct pair keys of the delta that ``base_keys`` lacks."""
        ents, atts = self.cat()
        keys = np.unique(pair_keys(ents, atts))
        if base_keys is not None and base_keys.size:
            pos = np.clip(np.searchsorted(base_keys, keys), 0, base_keys.size - 1)
            keys = keys[base_keys[pos] != keys]
        return keys

    def frozen_copy(self) -> "AttrDelta":
        """Immutable-prefix snapshot: shares the (never-changed) chunks;
        later appends to the parent grow only the parent's chunk list."""
        c = AttrDelta()
        c._ents = list(self._ents)
        c._atts = list(self._atts)
        c._size = self._size
        c._cat = self._cat
        return c


class EdgeDelta:
    """Append-only structural edge buffer: (src, dst) internal-id chunks.

    Delta edges get GLOBAL edge ids ``m_base + position`` — attribute and
    property writes address them uniformly with base edges.  ``append``
    dedupes within the delta (the DI structure keeps one structural edge
    per (u, v); callers drop ALIVE base duplicates via ``edge_lookup``
    first).  ``size`` counts physical appended edges — a revive (see
    ``append``'s ``dead`` parameter) orphans its tombstoned predecessor in
    the chunks, so ``size`` can exceed ``len(_index)``.
    """

    def __init__(self, m_base: int):
        self.m_base = m_base
        self._src: List[np.ndarray] = []
        self._dst: List[np.ndarray] = []
        self._index: Dict[Tuple[int, int], int] = {}
        self._n = 0  # physical appended edges == Σ chunk lengths
        self._cat: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def size(self) -> int:
        return self._n

    def append(self, src: np.ndarray, dst: np.ndarray,
               dead: Optional[np.ndarray] = None) -> int:
        """Add (src, dst) pairs not yet LIVE in the delta; returns how many
        were appended.  ``dead`` (tombstoned global edge ids) marks index
        entries that no longer exist: a key currently mapped to a dead id
        is re-mapped to a fresh id — the revive path ``insert_edges`` uses
        after ``delete_edges``.  The dead physical edge stays in the chunks
        (its tombstone keeps masking it); ``lookup`` answers with the
        latest, live id."""
        src = np.asarray(src, np.int32).ravel()
        dst = np.asarray(dst, np.int32).ravel()
        dead_set = (frozenset(map(int, np.asarray(dead).ravel()))
                    if dead is not None else frozenset())
        ns, nd = [], []
        idx = self._index
        gid = self.m_base + self._n
        for u, v in zip(src.tolist(), dst.tolist()):
            key = (u, v)
            cur = idx.get(key)
            if cur is not None and cur not in dead_set:
                continue
            idx[key] = gid
            gid += 1
            ns.append(u)
            nd.append(v)
        if not ns:
            return 0
        self._src.append(np.asarray(ns, np.int32))
        self._dst.append(np.asarray(nd, np.int32))
        self._n += len(ns)
        self._cat = None
        return len(ns)

    def lookup(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Global edge ids for (src, dst) pairs; -1 where absent.  A revived
        pair answers with its latest (live) id, never the orphaned one."""
        idx = self._index
        return np.asarray(
            [idx.get((u, v), -1) for u, v in zip(np.asarray(src).ravel().tolist(),
                                                 np.asarray(dst).ravel().tolist())],
            np.int32)

    def cat(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._cat is None:
            if self._src:
                self._cat = (np.concatenate(self._src), np.concatenate(self._dst))
            else:
                self._cat = (np.zeros(0, np.int32), np.zeros(0, np.int32))
        return self._cat

    def frozen_copy(self) -> "EdgeDelta":
        c = EdgeDelta(self.m_base)
        c._src = list(self._src)
        c._dst = list(self._dst)
        c._index = dict(self._index)
        c._n = self._n
        c._cat = self._cat
        return c


# --------------------------------------------------------------- invalidation
@dataclasses.dataclass(frozen=True)
class MutationEvent:
    """What one mutation touched — the overlap-based invalidation contract.

    ``structural=True`` (edges inserted/deleted, vertices deleted, rebuild,
    compaction) invalidates every cached result for the graph: unconstrained
    pattern slots match ANY entity, so no attribute overlap test is sound.
    Attribute events carry the touched label/relationship values and
    property names; a cached result dies only if its pattern references one
    of them.
    """

    kind: str
    structural: bool = False
    labels: FrozenSet[str] = frozenset()
    rels: FrozenSet[str] = frozenset()
    props: FrozenSet[str] = frozenset()

    @classmethod
    def structural_event(cls, kind: str) -> "MutationEvent":
        return cls(kind=kind, structural=True)

    @classmethod
    def labels_event(cls, values: Sequence[str]) -> "MutationEvent":
        return cls(kind="labels", labels=frozenset(map(str, np.ravel(values))))

    @classmethod
    def rels_event(cls, values: Sequence[str]) -> "MutationEvent":
        return cls(kind="rels", rels=frozenset(map(str, np.ravel(values))))

    @classmethod
    def props_event(cls, name: str) -> "MutationEvent":
        return cls(kind="props", props=frozenset((str(name),)))


def pattern_refs(pattern) -> Tuple[FrozenSet[str], FrozenSet[str], FrozenSet[str]]:
    """(labels, relationships, property names) a pattern AST
    (``repro_torch.query.ast.Pattern``) references — a result-cache
    entry's overlap footprint."""
    labels, rels, props = set(), set(), set()
    for node in pattern.nodes:
        labels.update(node.labels)
        props.update(p.name for p in node.predicates)
    for edge in pattern.edges:
        rels.update(edge.rels)
        props.update(p.name for p in edge.predicates)
    return frozenset(labels), frozenset(rels), frozenset(props)


def overlaps(event: MutationEvent,
             refs: Tuple[FrozenSet[str], FrozenSet[str], FrozenSet[str]]) -> bool:
    """Does ``event`` touch anything the cached pattern reads?"""
    if event.structural:
        return True
    labels, rels, props = refs
    return bool(event.labels & labels or event.rels & rels or event.props & props)
