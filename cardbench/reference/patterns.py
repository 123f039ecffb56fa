"""Plain reference for chain pattern matching (walk semantics).

A match binds each node of the chain to a vertex and each hop to a walk
from its left vertex to its right one: one allowed edge for a fixed hop,
``lo``..``hi`` allowed edges for a variable-length hop (vertices may
repeat).  The answer is exact participation:

* a node variable's mask: the vertices it binds in at least one match;
* a hop's edge mask: the edges on at least one matched walk of that hop;
* ``vertex_mask``: every node-bound vertex and every vertex inside a matched
  walk; ``edge_mask``: every hop's edges.

Plain torch on the harness's own arrays (``graphdata.make``), on any
device; it imports nothing of the program.  ``closure_rounds`` caps the
unbounded hops' expansion: the harness's control (an unrolled closure, a
guarantee broken) sets it; the reference leaves it at None (the fixed
point).
"""
from __future__ import annotations

import operator

import torch

from cardbench.reference.cypher import parse

OPS = {"==": operator.eq, "!=": operator.ne, "<": operator.lt, "<=": operator.le,
       ">": operator.gt, ">=": operator.ge}


class Graph:
    """The harness's arrays, with the per-attribute entity lists sorted once
    and each column in the type the configuration says the store holds it
    in (``held``); ``prop_dtype`` replaces that type for floating columns
    (a control's lower precision)."""

    def __init__(self, data: dict, cfg: dict, device, *, prop_dtype=None):
        self.n, self.m = data["n"], data["m"]
        self.src = data["esrc"].to(device)
        self.dst = data["edst"].to(device)
        self.device = device
        self.labels = self._by_attr(data["label_ent"], data["label_id"],
                                    cfg["labels"]["prefix"], device)
        self.rels = self._by_attr(data["rel_ent"], data["rel_id"],
                                  cfg["relationships"]["prefix"], device)

        def held(specs, name, a):
            dtype = getattr(torch, specs[name].get("held", specs[name]["dtype"]))
            if prop_dtype is not None and dtype.is_floating_point:
                dtype = prop_dtype
            return a.to(device, dtype)

        self.vprops = {k: held(cfg["vertex_properties"], k, v) for k, v in data["vprops"].items()}
        self.eprops = {k: held(cfg["edge_properties"], k, v) for k, v in data["eprops"].items()}

    @staticmethod
    def _by_attr(ents, ids, prefix, device):
        ents, ids = ents.to(device), ids.to(device)
        order = torch.argsort(ids, stable=True)
        ents, ids = ents[order], ids[order]
        counts = torch.bincount(ids).tolist()
        out, start = {}, 0
        for i, c in enumerate(counts):
            out[f"{prefix}{i}"] = ents[start:start + c]
            start += c
        return out

    def mask(self, kind: str, part) -> torch.Tensor:
        size = self.n if kind == "node" else self.m
        attrs = self.labels if kind == "node" else self.rels
        props = self.vprops if kind == "node" else self.eprops
        if part.alts:
            out = torch.zeros(size, dtype=torch.bool, device=self.device)
            for a in part.alts:
                if a in attrs:
                    out[attrs[a]] = True
        else:
            out = torch.ones(size, dtype=torch.bool, device=self.device)
        for name, op, value in part.preds:
            out &= OPS[op](props[name], value)
        return out

    def step(self, frontier, allowed, direction: int) -> torch.Tensor:
        """Vertices one allowed edge away from ``frontier`` (walked in
        ``direction``; -1 walks each edge from its dst to its src)."""
        tail, head = (self.src, self.dst) if direction == 1 else (self.dst, self.src)
        out = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        out[head[allowed & frontier[tail]]] = True
        return out

    def edges_between(self, tails, heads, allowed, direction: int) -> torch.Tensor:
        tail, head = (self.src, self.dst) if direction == 1 else (self.dst, self.src)
        return allowed & tails[tail] & heads[head]

    def closure(self, start, allowed, direction: int, rounds=None) -> torch.Tensor:
        """Vertices reachable from ``start`` in 0 or more steps."""
        out, frontier, it = start.clone(), start, 0
        while bool(frontier.any()) and (rounds is None or it < rounds):
            frontier = self.step(frontier, allowed, direction) & ~out
            out |= frontier
            it += 1
        return out


def _layers(g: Graph, start, allowed, direction, count):
    out = [start]
    for _ in range(count):
        out.append(g.step(out[-1], allowed, direction))
    return out


def _union(masks, size, device):
    out = torch.zeros(size, dtype=torch.bool, device=device)
    for x in masks:
        out |= x
    return out


def match(g: Graph, text: str, *, closure_rounds=None) -> dict:
    """The exact answer to ``text``: ``vertex_mask``, ``edge_mask`` and
    ``bindings`` (variable → mask), all bool tensors on ``g.device``."""
    chain = parse(text)
    cands = [g.mask("node", p) for p in chain.nodes]
    allowed = [g.mask("edge", h) for h in chain.hops]
    n, m, dev = g.n, g.m, g.device

    def stepped(start, i, d, count):
        for _ in range(count):
            start = g.step(start, allowed[i], d)
        return start

    # forward: fwd[i] = the vertices slot i can bind with a valid prefix
    fwd = [cands[0]]
    for i, h in enumerate(chain.hops):
        if h.hi is None:
            reach = stepped(g.closure(fwd[i], allowed[i], h.direction, closure_rounds),
                            i, h.direction, h.lo)
        else:
            reach = _union(_layers(g, fwd[i], allowed[i], h.direction, h.hi)[h.lo:], n, dev)
        fwd.append(cands[i + 1] & reach)
    # backward: back[i] = slot i's vertices on a complete match
    back = [None] * len(fwd)
    back[-1] = fwd[-1]
    hop_edges, inner = [None] * len(chain.hops), []
    for i in range(len(chain.hops) - 1, -1, -1):
        h, a = chain.hops[i], allowed[i]
        if h.hi is None:
            if h.lo > 1:
                raise NotImplementedError("unbounded hops with lo > 1")
            u = g.closure(fwd[i], a, h.direction, closure_rounds)
            w = g.closure(back[i + 1], a, -h.direction, closure_rounds)
            back[i] = fwd[i] & (w if h.lo == 0 else g.step(w, a, -h.direction))
            hop_edges[i] = g.edges_between(u, w, a, h.direction)
            inner.append(g.step(u, a, h.direction) & g.step(w, a, -h.direction))
            continue
        u = _layers(g, fwd[i], a, h.direction, h.hi)
        w = _layers(g, back[i + 1], a, -h.direction, h.hi)
        back[i] = fwd[i] & _union(w[h.lo:], n, dev)
        # an edge is the (s+1)-th of a walk of length L = s + 1 + r
        e = torch.zeros(m, dtype=torch.bool, device=dev)
        for s in range(h.hi):
            heads = _union(w[max(0, h.lo - 1 - s):h.hi - s], n, dev)
            e |= g.edges_between(u[s], heads, a, h.direction)
        hop_edges[i] = e
        # vertex at position s (1 ≤ s < L) of a walk of length L in [lo, hi]
        for s in range(1, h.hi):
            inner.append(u[s] & _union(w[max(1, h.lo - s):h.hi - s + 1], n, dev))
    vmask = _union(back + inner, n, dev)
    emask = _union(hop_edges, m, dev)
    bindings = {}
    for part, mask in list(zip(chain.nodes, back)) + list(zip(chain.hops, hop_edges)):
        if part.var:
            bindings[part.var] = bindings[part.var] | mask if part.var in bindings else mask
    return {"vertex_mask": vmask, "edge_mask": emask, "bindings": bindings}


def mismatched_bits(got: dict, want: dict) -> int:
    """Entries in which two answers differ: both masks and every binding (a
    binding on one side only counts all its entries)."""
    def diff(a, b):
        if a is None or b is None:
            return int((a if b is None else b).numel())
        if a.shape != b.shape:
            return int(max(a.numel(), b.numel()))
        return int((a.to(b.device) != b).sum())

    bits = diff(got["vertex_mask"], want["vertex_mask"]) + diff(got["edge_mask"],
                                                                want["edge_mask"])
    for var in set(got["bindings"]) | set(want["bindings"]):
        bits += diff(got["bindings"].get(var), want["bindings"].get(var))
    return bits
