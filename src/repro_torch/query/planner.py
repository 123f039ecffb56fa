"""Selectivity-aware pattern planner.

Decisions, all driven by per-attribute entity counts read off the DIP stores
(``_AttrStore.attr_counts()`` — bitmap row sums / CSR segment lengths, the
stats the paper's stores carry for free):

1. **Chain orientation** (join order for a path): constraint propagation
   starts from the more selective end of the chain, so if the rightmost node
   pattern is estimated smaller than the leftmost the whole pattern is
   reversed (semantically identical; ``Pattern.reversed()``).
2. **Per-mask implementation**:
     * ``arr``:   ``scan`` for tiny attribute universes (k < SCAN_MAX_K,
                  where padding to the MXU wastes lanes), else ``matvec``.
     * ``list``:  single implementation (``list``).
     * ``listd``: ``budget`` (output-sized gather, O(est hits)) when the
                  query is selective — est hits ≤ BUDGET_SEL_CUTOFF·nnz —
                  else ``inverted`` (full O(nnz) scan).
3. **Kernel fusion** (``arr`` only): when ≥2 node slots carry label masks
   (resp. ≥2 edge slots carry relationship masks), they are batched into ONE
   ``bitmap_query`` launch against their store (the batched multi-mask entry
   point) instead of one launch per slot.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.query.ast import Pattern
from repro_torch.query.plan import MaskStep, Plan, PredicateStep

__all__ = [
    "plan_pattern",
    "validate_pattern",
    "SCAN_MAX_K",
    "BUDGET_SEL_CUTOFF",
    "FUSE_MIN_MASKS",
    "MAX_VARLEN",
]

SCAN_MAX_K = 8  # arr: below this attribute-universe size the VPU row scan wins
BUDGET_SEL_CUTOFF = 0.25  # listd: budget gather only pays off for selective queries
FUSE_MIN_MASKS = 2  # arr: batch node-label masks into one kernel launch from here
MAX_VARLEN = 32  # bounded '*lo..hi' hops unroll hi layers; cap the program size


def validate_pattern(pattern: Pattern) -> None:
    """Plan-time pattern checks — everything that can only fail later but
    is knowable NOW, so clients (including remote ``PGClient`` users) get
    the error before paying for execution or a round-trip:

    * string predicate literals: property columns are numeric typed
      columns, so ``{name == "alice"}`` can never compare element-wise —
      rejected here naming the column (it used to parse and only fail at
      execution).
    * traversal bounds the executor cannot run: bounded hops unroll, so
      ``hi`` is capped at ``MAX_VARLEN``; unbounded hops run to a fixed
      point, which supports ``lo ≤ 1`` only (an exact "walks of length
      ≥ lo" test for lo ≥ 2 needs a bounded upper end — any walk shortens
      to ≤ n-1 edges, so ``*lo..{2n}`` is an exact substitute).
    """
    ents = [("vertex", nd) for nd in pattern.nodes]
    ents += [("edge", e) for e in pattern.edges]
    for kind, ent in ents:
        for p in ent.predicates:
            if isinstance(p.value, str):
                raise TypeError(
                    f"{kind} predicate {p.name!r} {p.op} {p.value!r}: string "
                    "comparisons are not supported on typed property columns "
                    "— model string-valued attributes as "
                    "labels/relationships instead"
                )
    for edge in pattern.edges:
        if edge.hi is None and edge.lo > 1:
            raise ValueError(
                f"unbounded traversal {edge._star_text()!r} supports a lower "
                f"bound of at most 1; give an explicit upper bound "
                f"(*{edge.lo}..k) — any walk shortens to < n edges, so "
                "*lo..2n is exact"
            )
        if edge.hi is not None and edge.hi > MAX_VARLEN:
            raise ValueError(
                f"traversal upper bound {edge.hi} exceeds MAX_VARLEN="
                f"{MAX_VARLEN} (bounded hops unroll); use an unbounded "
                "'*' hop for fixed-point reachability"
            )


def _estimate(store, values: Tuple[str, ...], universe: int,
              counts=None) -> Tuple[int, float]:
    """(estimated hit count, selectivity) for an OR query over ``values``.

    Σ of per-attribute counts — exact for disjoint attributes, an upper
    bound under overlap; either way monotone in the true count, which is all
    the ordering decisions need.  ``counts`` overrides the per-attribute
    stats (``plan_pattern`` passes the tombstone-adjusted array so the
    estimates stay exact on graphs with uncompacted deletes).
    """
    if store is None or not values:
        return 0, 0.0
    if counts is None:
        counts = store.attr_counts()
    ids = store.amap.lookup(list(values))
    ids = ids[ids >= 0]
    est = int(counts[ids].sum()) if ids.size else 0
    return est, est / max(universe, 1)


def _choose_impl(
    backend: str, est_count: int, nnz: int, k: int, override: Optional[str]
) -> str:
    if override is not None:
        return override
    if backend == "arr":
        return "scan" if k < SCAN_MAX_K else "matvec"
    if backend == "list":
        return "list"
    # listd: output-sized budget gather vs full inverted-CSR scan
    if nnz > 0 and est_count <= BUDGET_SEL_CUTOFF * nnz:
        return "budget"
    return "inverted"


def plan_pattern(pg, pattern: Pattern, *, impl: Optional[str] = None) -> Plan:
    """Plan ``pattern`` against ``pg`` (a ``repro_torch.core.PropGraph``).

    ``impl`` force-overrides the per-mask implementation choice (the same
    escape hatch ``PropGraph.query_labels(impl=...)`` exposes); fusion is
    disabled under an override so the requested impl actually runs.
    """
    g = pg._require_graph()
    vstore, estore = pg._vstore, pg._estore
    validate_pattern(pattern)

    # tombstone-adjusted stats, read once per plan: dead entities are
    # masked out of every query result, so they must not inflate the
    # selectivity estimates either
    vcounts = pg._attr_counts("node") if vstore is not None else None
    ecounts = pg._attr_counts("edge") if estore is not None else None

    # -- 1. chain orientation: start from the more selective end ------------
    reversed_chain = False
    if pattern.hops >= 1:
        first, _ = _estimate(vstore, pattern.nodes[0].labels, g.n, vcounts)
        last, _ = _estimate(vstore, pattern.nodes[-1].labels, g.n, vcounts)
        first = first if pattern.nodes[0].labels else g.n
        last = last if pattern.nodes[-1].labels else g.n
        if last < first:
            pattern = pattern.reversed()
            reversed_chain = True

    # -- 2. per-slot mask steps with impl choice ----------------------------
    mask_steps = []
    predicate_steps = []
    for slot, node in enumerate(pattern.nodes):
        if node.labels:
            est, sel = _estimate(vstore, node.labels, g.n, vcounts)
            # stats-only read: nnz comes off attr_counts, so planning never
            # materializes a store (mesh mode would otherwise build a dense
            # device copy just to read its size)
            chosen = _choose_impl(pg.backend, est, vstore.nnz, vstore.k, impl)
            mask_steps.append(
                MaskStep(
                    kind="node",
                    slot=slot,
                    values=node.labels,
                    impl=chosen,
                    est_count=est,
                    est_selectivity=sel,
                )
            )
        for pred in node.predicates:
            predicate_steps.append(PredicateStep(kind="node", slot=slot, predicate=pred))
    for slot, edge in enumerate(pattern.edges):
        if edge.rels:
            est, sel = _estimate(estore, edge.rels, g.m, ecounts)
            chosen = _choose_impl(pg.backend, est, estore.nnz, estore.k, impl)
            mask_steps.append(
                MaskStep(
                    kind="edge",
                    slot=slot,
                    values=edge.rels,
                    impl=chosen,
                    est_count=est,
                    est_selectivity=sel,
                )
            )
        for pred in edge.predicates:
            predicate_steps.append(PredicateStep(kind="edge", slot=slot, predicate=pred))

    # -- 3. fusion: batch arr label/relationship masks, one launch per store
    fused_slots: Tuple[int, ...] = ()
    fused_eslots: Tuple[int, ...] = ()
    if pg.backend == "arr" and impl is None:
        # the hand-written bitmap_query kernels on a CUDA graph; the CPU
        # port plans exactly what the reference plans off its accelerator
        fused_impl = "kernel" if pg.device.type == "cuda" else "matvec"
        node_mask_slots = [s.slot for s in mask_steps if s.kind == "node"]
        edge_mask_slots = [s.slot for s in mask_steps if s.kind == "edge"]
        if len(node_mask_slots) >= FUSE_MIN_MASKS:
            fused_slots = tuple(node_mask_slots)
        # edge masks batch against THEIR store on the same criterion — they
        # previously always ran standalone even when the plan carried several
        if len(edge_mask_slots) >= FUSE_MIN_MASKS:
            fused_eslots = tuple(edge_mask_slots)
        fused_kinds = (("node",) if fused_slots else ()) + (
            ("edge",) if fused_eslots else ())
        if fused_kinds:
            mask_steps = [
                (
                    dataclasses.replace(s, impl=fused_impl, fused=True)
                    if s.kind in fused_kinds
                    else s
                )
                for s in mask_steps
            ]

    return Plan(
        pattern=pattern,
        mask_steps=tuple(mask_steps),
        predicate_steps=tuple(predicate_steps),
        backend=pg.backend,
        reversed_chain=reversed_chain,
        fused_node_slots=fused_slots,
        fused_edge_slots=fused_eslots,
    )
