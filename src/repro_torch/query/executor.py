"""Plan execution — the constraint-propagation pipeline behind ``match``.

1. **Mask materialization**: every planned attribute mask runs through the
   DIP store; slots the planner marked ``fused`` ride one batched launch per
   store.  On a packed store the masks stay 32-bit words.
2. **Combination**: predicate masks off the typed property columns AND into
   their slots, and so do the overlay's alive masks (tombstoned vertices
   and edges drop out of EVERY slot, constrained or not).  On packed stores
   this happens in word space (``_combine_packed``) with a single unpack at
   the propagation boundary.
3. **Chain propagation** (static hop structure): a forward pass computes
   per-position reachable sets, a backward pass prunes to vertices/edges on
   at least one COMPLETE match.  Variable-length hops (``*lo..hi``, ``*``)
   run through the frontier step: bounded hops unroll ``hi`` exact-length
   frontier layers in each direction, unbounded hops run the frontier to a
   fixed point.  For a var hop between slots i and i+1 with forward layers
   ``u_s`` and backward layers ``w_t``:

     slot-i survivors   = fwd_i ∧ ∪_{L∈[lo,hi]} w_L
     hop edges (alive)  = allowed ∧ ∪_{s+t∈[lo-1,hi-1]} u_s[tail] ∧ w_t[head]
     interior vertices  = ∪_{s,t≥1, lo≤s+t≤hi} u_s ∧ w_t

   Matches are WALKS (revisits allowed).  The result is exact.

Every step is a plain torch op on the graph's device; the bool scatter-OR
counts arrivals (``queries.scatter_or``), so no hop reads anything back to
the host.  Only the ``*`` closure's exit test does, once per round.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import bitplane
from repro_torch.core.di import DIGraph
from repro_torch.core.queries import (
    extract_subgraph,
    gather,
    induce_edge_mask_directed,
    scatter_or,
)
from repro_torch.obs.metrics import GLOBAL as _OBS
from repro_torch.obs.metrics import enabled as _obs_enabled
from repro_torch.query.plan import Plan
from repro_torch.traverse.engine import frontier_step, reach_closure

__all__ = ["MatchResult", "execute_plan", "execute_plan_with_masks"]

# process-global execution accounting (docs/ARCHITECTURE.md §13), the
# reference's names: host-side counts only, never a device sync
_M_PLANS = _OBS.counter("pg_exec_plans", "plans run through propagation")
_M_MASKS = _OBS.counter("pg_exec_mask_steps", "attribute mask steps materialized")
_M_FUSED = _OBS.counter(
    "pg_exec_fused_masks", "mask steps that rode a fused batched launch")


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """Result of ``PropGraph.match``: exact participation masks.

    ``node_masks[i]`` / ``edge_masks[i]`` are per-slot masks in the PLAN's
    chain order (``bindings()`` gives name-keyed access — variable names
    travel with their slots through any reorientation).  For a
    variable-length hop, ``edge_masks[i]`` covers every edge on some matched
    walk, and interior walk vertices appear in ``vertex_mask`` only.
    """

    vertex_mask: torch.Tensor  # (n,) bool — vertices in ≥1 full match
    edge_mask: torch.Tensor  # (m,) bool — edges in ≥1 full match
    node_masks: Tuple[torch.Tensor, ...]  # per node slot, (n,) bool
    edge_masks: Tuple[torch.Tensor, ...]  # per edge slot, (m,) bool
    plan: Plan

    def bindings(self) -> Dict[str, torch.Tensor]:
        """Variable name → participation mask (node vars (n,), edge vars (m,))."""
        out: Dict[str, torch.Tensor] = {}
        for node, mask in zip(self.plan.pattern.nodes, self.node_masks):
            if node.var:
                out[node.var] = out[node.var] | mask if node.var in out else mask
        for edge, mask in zip(self.plan.pattern.edges, self.edge_masks):
            if edge.var:
                out[edge.var] = out[edge.var] | mask if edge.var in out else mask
        return out

    def n_vertices(self) -> int:
        return int(self.vertex_mask.sum())

    def n_edges(self) -> int:
        return int(self.edge_mask.sum())

    def subgraph(self, g: DIGraph):
        """Materialize the matched edges as a fresh DI graph."""
        return extract_subgraph(g, self.edge_mask)

    def expand(self, g: DIGraph, k: int, *, edge_allowed=None):
        """NScale-style neighborhood expansion: vertices within ``k`` hops of
        the match, following ``edge_allowed`` (default: every edge)."""
        from repro_torch.graph.typed_algorithms import khop_typed

        allowed = (torch.ones(g.m, dtype=torch.bool, device=g.device) if edge_allowed is None
                   else edge_allowed)
        return khop_typed(g, torch.nonzero(self.vertex_mask).flatten(), allowed, k=k)


def _propagate(g: DIGraph, cands, emasks, hops: Tuple[Tuple[int, int, int], ...]):
    """Forward/backward chain propagation.  ``hops`` carries one
    ``(direction, lo, hi)`` per hop; ``hi == -1`` means unbounded.

    Fixed hops: f_0 = c_0; f_i = heads(A_i ∧ f_{i-1}[tail]); b_h = f_h;
    alive_i = A_i ∧ f_{i-1}[tail] ∧ b_i[head]; b_{i-1} = tails(alive_i),
    where A_i is the locally-consistent edge set of hop i.  Variable-length
    hops follow the module docstring's walk algebra.
    """
    n, m, dev = g.n, g.m, g.device
    h = len(hops)
    ends = [(g.src, g.dst) if d == 1 else (g.dst, g.src) for d, _, _ in hops]

    fwd = [cands[0]]
    local = [None] * h  # fixed hops: locally-consistent edge sets
    flayers = [None] * h  # bounded var hops: forward exact-step layers
    fclosure = [None] * h  # unbounded var hops: forward closure
    for i, (d, lo, hi) in enumerate(hops):
        tail, head = ends[i]
        if (lo, hi) == (1, 1):
            local[i] = induce_edge_mask_directed(g, cands[i], cands[i + 1], emasks[i], d)
            fwd.append(scatter_or(head, local[i] & gather(fwd[i], tail), n))
        elif hi == -1:
            U = reach_closure(g, fwd[i], emasks[i], direction=d)
            fclosure[i] = U
            reach = U if lo == 0 else frontier_step(g, U, emasks[i], direction=d)
            fwd.append(cands[i + 1] & reach)
        else:
            layers = [fwd[i]]
            for _ in range(hi):
                layers.append(frontier_step(g, layers[-1], emasks[i], direction=d))
            flayers[i] = layers
            reach = layers[lo]
            for L in range(lo + 1, hi + 1):
                reach = reach | layers[L]
            fwd.append(cands[i + 1] & reach)

    back = [None] * (h + 1)
    back[h] = fwd[h]
    alive = [None] * h
    interiors = []  # var-hop walk vertices that belong to no slot
    for i in range(h - 1, -1, -1):
        d, lo, hi = hops[i]
        tail, head = ends[i]
        if (lo, hi) == (1, 1):
            al = local[i] & gather(fwd[i], tail) & gather(back[i + 1], head)
            alive[i] = al
            back[i] = scatter_or(tail, al, n)
        elif hi == -1:
            U = fclosure[i]
            W = reach_closure(g, back[i + 1], emasks[i], direction=-d)
            alive[i] = emasks[i] & gather(U, tail) & gather(W, head)
            back[i] = fwd[i] & (W if lo == 0 else frontier_step(g, W, emasks[i], direction=-d))
            interiors.append(frontier_step(g, U, emasks[i], direction=d)
                             & frontier_step(g, W, emasks[i], direction=-d))
        else:
            u = flayers[i]
            w = [back[i + 1]]
            for _ in range(hi):
                w.append(frontier_step(g, w[-1], emasks[i], direction=-d))
            # prefix unions keep the per-s window unions O(1) whenever the
            # window reaches down to its base (always for lo ≤ 1)
            pre0 = [w[0]]  # pre0[j] = w[0] | … | w[j]
            for t in range(1, hi + 1):
                pre0.append(pre0[-1] | w[t])
            pre1 = [None, w[1]] if hi >= 1 else [None]  # pre1[j] = w[1] | … | w[j]
            for t in range(2, hi + 1):
                pre1.append(pre1[-1] | w[t])

            def w_union(a, b):  # ∪ w[a..b], 0 ≤ a ≤ b ≤ hi
                if a == 0:
                    return pre0[b]
                if a == 1:
                    return pre1[b]
                out = w[a]
                for t in range(a + 1, b + 1):
                    out = out | w[t]
                return out

            back[i] = fwd[i] & w_union(lo, hi)
            acc = torch.zeros(m, dtype=torch.bool, device=dev)
            for s in range(hi):
                hu = w_union(max(0, lo - 1 - s), hi - 1 - s)
                acc = acc | (gather(u[s], tail) & gather(hu, head))
            alive[i] = emasks[i] & acc
            inter = torch.zeros(n, dtype=torch.bool, device=dev)
            for s in range(1, hi):
                a, b = max(1, lo - s), hi - s
                if a <= b:
                    inter = inter | (u[s] & w_union(a, b))
            interiors.append(inter)

    vmask = back[0]
    for b in back[1:]:
        vmask = vmask | b
    for x in interiors:
        vmask = vmask | x
    if h:
        emask = alive[0]
        for a in alive[1:]:
            emask = emask | a
    else:
        emask = torch.zeros(m, dtype=torch.bool, device=dev)
    return vmask, emask, tuple(back), tuple(alive)


def _fused_step_sets(plan: Plan):
    """The (node steps, edge steps) riding the fused batched launches, plus
    the fused slot-id sets — shared by the bool and packed materializers so
    the ``pg_exec_fused_masks`` accounting is the same on both paths."""
    fused_n = set(plan.fused_node_slots)
    fused_e = set(plan.fused_edge_slots)
    nsteps = [s for s in plan.mask_steps if s.kind == "node" and s.slot in fused_n]
    esteps = [s for s in plan.mask_steps if s.kind == "edge" and s.slot in fused_e]
    if _obs_enabled():
        _M_MASKS.inc(len(plan.mask_steps))
        _M_FUSED.inc(len(nsteps) + len(esteps))
    return fused_n, fused_e, nsteps, esteps


def _materialize(pg, plan: Plan, batched: str, single: str):
    """Run every planned attribute mask through the stores' ``batched`` /
    ``single`` query methods; fused node and edge slots each coalesce into
    one batched launch against their store."""
    node_out: Dict[int, torch.Tensor] = {}
    edge_out: Dict[int, torch.Tensor] = {}
    fused_n, fused_e, fused_nsteps, fused_esteps = _fused_step_sets(plan)
    for store, steps, out in ((pg._vstore, fused_nsteps, node_out),
                              (pg._estore, fused_esteps, edge_out)):
        if steps:
            stacked = getattr(store, batched)([s.values for s in steps], impl=steps[0].impl)
            for s, row in zip(steps, stacked):
                out[s.slot] = row
    for s in plan.mask_steps:
        if s.kind == "node" and s.slot not in fused_n:
            node_out[s.slot] = getattr(pg._vstore, single)(s.values, impl=s.impl)
        elif s.kind == "edge" and s.slot not in fused_e:
            edge_out[s.slot] = getattr(pg._estore, single)(s.values, impl=s.impl)
    return node_out, edge_out


def _ones_words(n: int, device) -> torch.Tensor:
    """Packed all-True mask over ``n`` entities — full words of ones, tail
    bits zero."""
    w = bitplane.n_words(n)
    words = torch.full((w,), -1, dtype=torch.int32, device=device)
    rem = n % bitplane.WORD
    if w and rem:
        words[-1] = (1 << rem) - 1
    return words


def _combine_packed(nwords, ewords, vpreds, epreds, av_words, ae_words, *, n: int, m: int,
                    device):
    """Word-space mask combination: predicate evaluation, packing, AND with
    the label/relationship words and the packed alive masks, and the single
    unpack at the propagation boundary.  ``nwords[slot]`` /
    ``ewords[slot]``: packed store words or None (unconstrained);
    ``vpreds[slot]`` / ``epreds[slot]``: lists of ``(col, valid, compare,
    value)``; ``av_words`` / ``ae_words``: the packed alive masks or None.
    An edge column shorter than ``m`` (it predates the overlay's delta
    edges) pads with invalid rows."""

    def combine(words, preds, size, alive_words):
        out = words if words is not None else _ones_words(size, device)
        for col, valid, compare, value in preds:
            pm = valid & compare(col, value)
            if pm.shape[0] < size:
                pm = torch.cat([pm, pm.new_zeros(size - pm.shape[0])])
            out = out & bitplane.pack_mask(pm)
        if alive_words is not None:
            out = out & alive_words
        return bitplane.unpack_mask(out, size)

    cands = [combine(nwords[i], vpreds[i], n, av_words) for i in range(len(nwords))]
    emasks = [combine(ewords[i], epreds[i], m, ae_words) for i in range(len(ewords))]
    return cands, emasks


def _execute_plan_packed(pg, plan: Plan) -> "MatchResult":
    """Packed execution: store words → word-space predicate combine → ONE
    unpack at the propagation boundary."""
    g = pg._require_graph()
    if _obs_enabled():
        _M_PLANS.inc()
    node_words, edge_words = _materialize(pg, plan, "query_any_batched_words", "query_any_words")
    vpreds = [[] for _ in plan.pattern.nodes]
    epreds = [[] for _ in plan.pattern.edges]
    for step in plan.predicate_steps:
        p = step.predicate
        # validation (KeyError/ValueError/TypeError) fires before any work
        col, valid, value = pg._predicate_parts(step.kind, p.name, p.op, p.value)
        (vpreds if step.kind == "node" else epreds)[step.slot].append(
            (col, valid, pg._PRED_OPS[p.op], value))
    cands, emasks = _combine_packed(
        [node_words.get(i) for i in range(len(vpreds))],
        [edge_words.get(i) for i in range(len(epreds))],
        vpreds, epreds, pg._alive_words("node"), pg._alive_words("edge"),
        n=g.n, m=g.m, device=g.device)
    return _finish_propagation(plan, g, cands, emasks)


def execute_plan(pg, plan: Plan) -> "MatchResult":
    """Execute ``plan`` against ``pg``; see the module docstring for stages."""
    pg._require_graph()  # the documented RuntimeError, before store access
    # the packed combine is for arr stores holding word planes; list and
    # listd stores answer bool masks
    if pg.backend == "arr" and pg._vstore.packed and pg._estore.packed:
        return _execute_plan_packed(pg, plan)
    label_masks, rel_masks = _materialize(pg, plan, "query_any_batched", "query_any")
    return execute_plan_with_masks(pg, plan, label_masks, rel_masks)


def execute_plan_with_masks(pg, plan: Plan, label_masks: Dict[int, torch.Tensor],
                            rel_masks: Dict[int, torch.Tensor]) -> "MatchResult":
    """Stages 2–3 of ``execute_plan`` on PRE-MATERIALIZED bool attribute
    masks: ``label_masks[slot]`` / ``rel_masks[slot]`` replace the plan's
    ``mask_steps`` outputs (missing slots mean "no attribute constraint").

    This is the service's coalescing entry (``service/scheduler.py``): a
    micro-batch of requests materializes all its label/relationship masks
    in one ``query_any_batched`` launch per store, then runs each request's
    propagation here.  Masks computed from the same stores give bitwise
    ``execute_plan``'s answer."""
    g = pg._require_graph()
    if _obs_enabled():
        _M_PLANS.inc()
    cands = []
    for slot in range(len(plan.pattern.nodes)):
        c = label_masks.get(slot, torch.ones(g.n, dtype=torch.bool, device=g.device))
        for step in plan.predicate_steps:
            if step.kind == "node" and step.slot == slot:
                p = step.predicate
                c = c & pg.vertex_predicate_mask(p.name, p.op, p.value)
        cands.append(c)
    emasks = []
    for slot in range(len(plan.pattern.edges)):
        e = rel_masks.get(slot, torch.ones(g.m, dtype=torch.bool, device=g.device))
        for step in plan.predicate_steps:
            if step.kind == "edge" and step.slot == slot:
                p = step.predicate
                e = e & pg.edge_predicate_mask(p.name, p.op, p.value)
        emasks.append(e)
    # overlay tombstones drop out of EVERY slot — including unconstrained
    # ones, whose all-ones default would otherwise bring them back
    av = pg._alive_vertex_mask()
    if av is not None:
        cands = [c & av for c in cands]
    emasks = [pg._and_alive_edges(e) for e in emasks]
    return _finish_propagation(plan, g, cands, emasks)


def _finish_propagation(plan: Plan, g: DIGraph, cands, emasks) -> "MatchResult":
    """The static-hop chain propagation and result packaging, shared by the
    bool and packed combine paths."""
    hops = tuple((e.direction, e.lo, -1 if e.hi is None else e.hi) for e in plan.pattern.edges)
    vmask, emask, node_masks, alive = _propagate(g, cands, emasks, hops)
    return MatchResult(vertex_mask=vmask, edge_mask=emask, node_masks=node_masks,
                       edge_masks=alive, plan=plan)
