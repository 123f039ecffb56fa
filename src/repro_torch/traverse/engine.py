"""Frontier engine — semiring frontier expansion over DI.

One primitive unifies the query executor's chain propagation and the
frontier analytics: a per-vertex value vector crossed with a (possibly
masked or weighted) edge set gives the next value vector, under a
:class:`Semiring` — ⊕ combines the messages arriving at a vertex, ⊗
extends a vertex value along an edge.  Everything here is a client of
:func:`semiring_relax`:

  * ``frontier_step``   — the (OR, AND) Boolean instance: heads of allowed
    edges whose tail is in the frontier.
  * ``khop_mask``       — union of ≤k Boolean expansions, with early exit.
  * ``reach_closure``   — expansion to a fixed point (the ``*`` pattern
    hop; bounded by ``n`` rounds).
  * ``khop_csr``        — the CSR fast path: each BFS level gathers only
    the new frontier's adjacency windows off ``seg``/``dst`` (Σ deg of
    the frontier edges a level instead of m); bitwise equal to
    ``khop_mask``.

Every fixed point runs as a Python loop that reads one flag back to the
host per round (the reference runs one device-side while loop with
``cond = changed & (it < cap)``; the caps are kept exactly: a cap is part
of the answer).  ``rounds`` counts the rounds each loop ran, summed over
calls since ``reset_rounds()``, and ``capped`` the calls that stopped at
their cap with the state still changing.

The Boolean, tropical and min-label instances are exact (idempotent ⊕);
the counting (+, ×) instance sums floats, whose order ``index_add_`` does
not fix on the card, so it agrees with the reference within a tolerance.

The sharded path (an ``EntityMesh``, ``launch/mesh.py``) relaxes each
shard's own block of the padded edge list (``_pad_edges``) into a partial
(n,) vector on the shard's device, and ONE all-reduce named by
``Semiring.allreduce`` ⊕-combines the partials (``launch/collectives.py``):
the value vector is all that moves between devices a step.  The exact
instances stay bitwise the single-device relax; the counting one sums its
partials in shard order.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.di import DIGraph
from repro_torch.core.dip_list import mark, scatter_ids
from repro_torch.core.queries import gather, scatter_or
from repro_torch.kernels.seg_mm.ref import gather_ids

__all__ = [
    "Semiring",
    "BOOLEAN",
    "TROPICAL",
    "COUNTING",
    "MINLABEL",
    "semiring_relax",
    "frontier_step",
    "khop_mask",
    "reach_closure",
    "khop_csr",
    "semiring_relax_sharded",
    "khop_mask_sharded",
    "reach_closure_sharded",
    "rounds",
    "capped",
    "reset_rounds",
]

_I32_MAX = int(np.iinfo(np.int32).max)


@dataclasses.dataclass(frozen=True)
class Semiring:
    """One relax algebra: ⊕ combines messages at a vertex, ⊗ extends a
    vertex value along an edge.  ``zero`` is the ⊕ identity and the ⊗
    absorber, so an all-``zero`` relax input is a fixed point.
    ``allreduce`` names the matching cross-shard ⊕ (``collectives.all_reduce``)."""

    name: str
    zero: object  # ⊕ identity / ⊗ absorber (False, +inf, 0.0, INT32_MAX)
    scatter: str  # the ⊕ scatter combine: "max" | "min" | "add"
    extend: Callable  # ⊗: (tail value, edge value) → message
    allreduce: str  # the cross-shard ⊕: "max" | "min" | "sum"


# (OR, AND) over bool — reachability.
BOOLEAN = Semiring("boolean", False, "max", lambda x, w: x & w, "max")

# (min, +) over f32 — weighted shortest paths.  A masked edge carries +inf.
TROPICAL = Semiring("tropical", float("inf"), "min", lambda x, w: x + w, "min")

# (+, ×) over f32 — weighted SpMV, the PageRank contribution step.
COUNTING = Semiring("counting", 0.0, "add", lambda x, w: x * w, "sum")

# (min, select) over int32 — the component min-hook: an allowed edge
# forwards the tail's label, a masked edge the identity.
MINLABEL = Semiring("minlabel", _I32_MAX, "min",
                    lambda x, w: torch.where(w, x, _I32_MAX), "min")

rounds: Dict[str, int] = {}
capped: Dict[str, int] = {}


def reset_rounds() -> None:
    rounds.clear()
    capped.clear()


def _fixed_point(name: str, step: Callable, state: torch.Tensor, cap: int) -> torch.Tensor:
    """``state = step(state)`` until a round changes nothing or ``cap``
    rounds ran; one flag read back per round.  ``!=`` counts a NaN as a
    change, as the reference's loop does."""
    it, changed = 0, True
    while changed and it < cap:
        new = step(state)
        changed = bool((new != state).any())
        state = new
        it += 1
    rounds[name] = rounds.get(name, 0) + it
    if changed:
        capped[name] = capped.get(name, 0) + 1
    return state


def _ends(g: DIGraph, direction: int):
    """(tail, head) endpoint arrays: +1 follows src→dst, -1 walks dst→src."""
    return (g.src, g.dst) if direction == 1 else (g.dst, g.src)


def _ends64(g: DIGraph, direction: int):
    """:func:`_ends` widened to int64 (``scatter_reduce_`` takes no other
    index type): loops widen once per call, not once per round."""
    tail, head = _ends(g, direction)
    return tail.long(), head.long()


def _all_edges(g: DIGraph, edge_allowed) -> torch.Tensor:
    if edge_allowed is None:
        return torch.ones(g.m, dtype=torch.bool, device=g.device)
    return edge_allowed


def _scatter(sr: Semiring, out: torch.Tensor, head: torch.Tensor, msg: torch.Tensor,
             nan_exact: bool) -> torch.Tensor:
    """``out[head[e]] ⊕= msg[e]`` in place, ⊕ a sum or a min.  ``nan_exact``: a NaN message
    makes its head NaN, as the reference's scatter-min does; the card's
    atomic min may drop NaNs, so they are scattered apart."""
    if sr.scatter == "add":
        return out.index_add_(0, head, msg)
    if not nan_exact:
        return out.scatter_reduce_(0, head.long(), msg, "amin", include_self=True)
    nan = torch.isnan(msg)
    out.scatter_reduce_(0, head.long(), msg.masked_fill(nan, float("inf")), "amin",
                        include_self=True)
    return out.masked_fill_(scatter_or(head, nan, out.shape[0]), float("nan"))


def _relax(tail, head, n: int, x, edge_vals, sr: Semiring, undirected: bool,
           nan_exact: bool = False) -> torch.Tensor:
    if sr.scatter == "max":  # max over bool: OR
        out = scatter_or(head, sr.extend(gather(x, tail), edge_vals), n)
        if undirected:
            out = out | scatter_or(tail, sr.extend(gather(x, head), edge_vals), n)
        return out
    out = torch.full_like(x, sr.zero)
    _scatter(sr, out, head, sr.extend(gather(x, tail), edge_vals), nan_exact)
    if undirected:
        _scatter(sr, out, tail, sr.extend(gather(x, head), edge_vals), nan_exact)
    return out


def semiring_relax(
    g: DIGraph,
    x: torch.Tensor,
    edge_vals: torch.Tensor,
    sr: Semiring,
    *,
    direction: int = 1,
    undirected: bool = False,
) -> torch.Tensor:
    """ONE edge-centric relax: ``out[v] = ⊕_{(u→v)} x[u] ⊗ w[e]``; vertices
    with no incoming message hold ``sr.zero``.  The result does not include
    the input values.  ``undirected`` relaxes every edge in reverse into the
    same output too.  ⊕ is a scatter-OR for :data:`BOOLEAN`,
    ``scatter_reduce_`` ("amin") for the min semirings and ``index_add_``
    for :data:`COUNTING`."""
    tail, head = _ends(g, direction)
    return _relax(tail, head, g.n, x, edge_vals, sr, undirected,
                  nan_exact=x.is_floating_point())


def frontier_step(
    g: DIGraph,
    frontier: torch.Tensor,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    direction: int = 1,
    undirected: bool = False,
) -> torch.Tensor:
    """ONE masked Boolean expansion: heads of allowed edges whose tail is in
    the frontier.  Exactly one step; the input frontier is not included."""
    return semiring_relax(g, frontier, _all_edges(g, edge_allowed), BOOLEAN,
                          direction=direction, undirected=undirected)


def khop_mask(
    g: DIGraph,
    seed_mask: torch.Tensor,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    k: int,
    direction: int = 1,
    undirected: bool = False,
) -> torch.Tensor:
    """Vertices within ≤k allowed hops of the seeds (seeds included), with
    early exit once the mask stops growing."""
    e_ok = _all_edges(g, edge_allowed)
    return _fixed_point(
        "khop", lambda mask: mask | frontier_step(g, mask, e_ok, direction=direction,
                                                  undirected=undirected),
        seed_mask, k)


def reach_closure(
    g: DIGraph,
    seed_mask: torch.Tensor,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    direction: int = 1,
    undirected: bool = False,
    max_iters: Optional[int] = None,
) -> torch.Tensor:
    """Fixed point of frontier expansion: everything reachable from the
    seeds in ≥0 allowed hops.  The mask grows monotonically, so n rounds
    always suffice (``max_iters`` defaults to that bound)."""
    bound = (g.n + 1) if max_iters is None else max_iters
    return khop_mask(g, seed_mask, edge_allowed, k=bound,
                     direction=direction, undirected=undirected)


# ------------------------------------------------------------- CSR fast path
def _csr_step(g: DIGraph, reached: torch.Tensor, frontier: torch.Tensor,
              e_ok: torch.Tensor, max_deg: int) -> torch.Tensor:
    """Gather exactly the adjacency windows of ``frontier`` (int64 ids) and
    mark the allowed neighbors in ``reached``.  Window bounds are read off
    ``seg`` as the reference reads them (an id in [-(n+1), -1] wraps, the
    rest clamp), at most ``max_deg`` lanes a window."""
    n = g.n
    start = gather(g.seg, gather_ids(frontier, n + 1)).long()
    end = gather(g.seg, gather_ids(torch.clamp(frontier + 1, max=n), n + 1)).long()
    deg = (end - start).clamp_(0, max_deg)
    total = int(deg.sum())  # the level's one extra host read: the gather's size
    if total == 0:
        return reached
    owner = torch.repeat_interleave(torch.arange(deg.shape[0], device=deg.device), deg,
                                    output_size=total)
    first = torch.cumsum(deg, 0) - deg  # each window's first lane
    eidx = start[owner] + torch.arange(total, device=deg.device) - first[owner]
    nbr = torch.where(gather(e_ok, eidx), gather(g.dst, eidx).long(), n)
    return reached | mark(nbr, n, reached.device)  # disallowed lanes land in row n, dropped


def khop_csr(
    g: DIGraph,
    seed_ids,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    k: int,
    max_deg: Optional[int] = None,
) -> torch.Tensor:
    """CSR-gather k-hop: BFS levels, each expanding only the NEW frontier's
    adjacency windows.  Follows DI edges src→dst (the layout CSR indexes).
    Bitwise equal to ``khop_mask``: the union of ≤k expansions is the union
    of the first k BFS levels.

    The reference pads each frontier to a power-of-two bucket to bound its
    jit compiles; nothing here compiles, so each level gathers exactly the
    frontier's windows (``repeat_interleave`` over their lengths): its
    gather costs Σ deg(frontier), whatever the widest window, beside O(n)
    elementwise work on the (n,) masks.  Two host reads a level: the
    frontier's ids and its window total.  Seed ids are taken as the
    reference takes them: marked where ``.at[ids].set`` marks (wrap in
    [-n, -1], drop the rest) and expanded from the windows ``seg[ids]``
    reads."""
    if g.unsorted:
        # the overlay's combined base++delta view: SEG covers only the sorted
        # base prefix, so the windows gathered here would miss every delta
        # edge — the caller must use khop_mask (PropGraph.khop degrades)
        raise ValueError(
            "khop_csr requires a sorted DI graph with valid SEG; got an "
            "unsorted combined view — use khop_mask instead")
    e_ok = _all_edges(g, edge_allowed)
    if max_deg is None:
        max_deg = g.max_deg if g.max_deg >= 0 else (
            int((g.seg[1:] - g.seg[:-1]).max()) if g.n else 0)
    max_deg = max(max_deg, 1)
    seeds = np.unique(np.asarray(seed_ids, np.int32))
    frontier = torch.from_numpy(seeds.astype(np.int64)).to(g.device)
    reached = mark(scatter_ids(frontier, g.n), g.n, g.device)
    levels = 0
    for _ in range(k):
        if frontier.numel() == 0 or g.m == 0:
            break
        new = _csr_step(g, reached, frontier, e_ok, max_deg)
        frontier = torch.nonzero(new & ~reached).flatten()
        reached = new
        levels += 1
    rounds["khop_csr"] = rounds.get("khop_csr", 0) + levels
    return reached


# ------------------------------------------------------------- sharded path
@dataclasses.dataclass(frozen=True)
class EdgeBlocks:
    """The (tail, head) endpoint arrays of one walking direction, padded to
    a multiple of P and cut into P contiguous int64 blocks, block ``i`` on
    the mesh's ``devices[i]``.  Pad edges point at vertex 0."""

    tail: Tuple[torch.Tensor, ...]
    head: Tuple[torch.Tensor, ...]
    m: int  # real edges; the rest of each block's tail is padding
    m_pad: int


def _pad_edges(g: DIGraph, mesh, direction: int) -> EdgeBlocks:
    """The per-shard edge blocks of ``g`` walked in ``direction``.  They
    depend on the graph alone, so ``PropGraph`` caches them per version and
    direction; the edge values of each call are cut to match by
    ``_shard_edge_vals``."""
    tail, head = _ends64(g, direction)
    p = mesh.size
    m_pad = (-(-max(g.m, 1) // p)) * p
    pad = m_pad - g.m
    if pad:
        tail = torch.cat([tail, tail.new_zeros(pad)])
        head = torch.cat([head, head.new_zeros(pad)])
    step = m_pad // p
    return EdgeBlocks(
        tail=tuple(tail[i * step:(i + 1) * step].to(d) for i, d in enumerate(mesh.devices)),
        head=tuple(head[i * step:(i + 1) * step].to(d) for i, d in enumerate(mesh.devices)),
        m=g.m, m_pad=m_pad)


def _shard_edge_vals(vals: torch.Tensor, blocks: EdgeBlocks, mesh, pad_value):
    """A call's (m,) edge values cut as ``blocks`` is.  Pad edges carry the
    semiring's ⊗ absorber (False / +inf / 0.0), so the relax reads them but
    they never contribute a message."""
    pad = blocks.m_pad - vals.shape[0]
    if pad:
        vals = torch.cat([vals, vals.new_full((pad,), pad_value)])
    step = blocks.m_pad // mesh.size
    return tuple(vals[i * step:(i + 1) * step].to(d) for i, d in enumerate(mesh.devices))


@lru_cache(maxsize=None)
def _sharded_relax_fn(mesh, direction: int, undirected: bool, sr: Semiring):
    """ONE semiring relax over the mesh: every shard relaxes only its own
    block of the edges into a partial (n,) vector on its device, and ONE
    ``sr.allreduce`` all-reduce ⊕-combines the partials.  Cached per (mesh,
    direction, undirected, semiring); returns the lead's copy."""
    from repro_torch.launch.collectives import all_reduce, broadcast

    def step(blocks: EdgeBlocks, ev_parts, x: torch.Tensor, nan_exact: bool = False):
        parts = [_relax(t, h, x.shape[0], xi, ev, sr, undirected, nan_exact)
                 for t, h, ev, xi in zip(blocks.tail, blocks.head, ev_parts,
                                         broadcast(x, mesh.devices))]
        return all_reduce(parts, sr.allreduce)[0]

    return step


def semiring_relax_sharded(
    g: DIGraph,
    x: torch.Tensor,
    edge_vals: torch.Tensor,
    sr: Semiring,
    *,
    mesh,
    direction: int = 1,
    undirected: bool = False,
    blocks: Optional[EdgeBlocks] = None,
) -> torch.Tensor:
    """:func:`semiring_relax` with the per-step sharded layout (``blocks``:
    the graph's cached ``_pad_edges``, built here when None).  The
    idempotent-⊕ semirings (Boolean, tropical, min-label) are bitwise the
    single-device relax; :data:`COUNTING` sums its partials in shard order
    and agrees within tolerance only."""
    blocks = blocks if blocks is not None else _pad_edges(g, mesh, direction)
    step = _sharded_relax_fn(mesh, direction, undirected, sr)
    return step(blocks, _shard_edge_vals(edge_vals, blocks, mesh, sr.zero), x,
                nan_exact=x.is_floating_point())


@lru_cache(maxsize=None)
def _sharded_khop_fn(mesh, direction: int, undirected: bool, packed: bool = False):
    """Boolean k-hop whose step is the sharded relax on a frontier mask.
    ``packed=False``: int8 partials and a max all-reduce, 1 byte/entity a
    step.  ``packed=True`` (the default layout): each shard packs its
    partial into words and the step rides ``bitplane.or_allreduce`` — 1
    bit/entity a step, the packed plane's 8× cut applied to the only thing
    the sharded frontier exchanges."""
    from repro_torch.core import bitplane
    from repro_torch.launch.collectives import all_reduce, broadcast

    def step(blocks: EdgeBlocks, e_parts, mask: torch.Tensor) -> torch.Tensor:
        n = mask.shape[0]
        parts = [_relax(t, h, n, f, e, BOOLEAN, undirected)
                 for t, h, e, f in zip(blocks.tail, blocks.head, e_parts,
                                       broadcast(mask, mesh.devices))]
        if packed:
            words = bitplane.or_allreduce([bitplane.pack_mask(p) for p in parts])
            return bitplane.unpack_mask(words[0], n)
        return all_reduce([p.to(torch.int8) for p in parts], "max")[0] > 0

    def fn(seed_mask: torch.Tensor, e_ok: torch.Tensor, *, k: int,
           blocks: EdgeBlocks) -> torch.Tensor:
        e_parts = _shard_edge_vals(e_ok, blocks, mesh, False)
        return _fixed_point("khop", lambda mask: mask | step(blocks, e_parts, mask),
                            seed_mask, k)

    return fn


def khop_mask_sharded(
    g: DIGraph,
    seed_mask: torch.Tensor,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    k: int,
    mesh,
    direction: int = 1,
    undirected: bool = False,
    blocks: Optional[EdgeBlocks] = None,
) -> torch.Tensor:
    """``khop_mask`` with the per-step sharded layout; bitwise the
    single-device path (packed or byte exchange: OR is OR either way)."""
    from repro_torch.core import bitplane

    blocks = blocks if blocks is not None else _pad_edges(g, mesh, direction)
    fn = _sharded_khop_fn(mesh, direction, undirected, bitplane.packed_default())
    return fn(seed_mask, _all_edges(g, edge_allowed), k=k, blocks=blocks)


def reach_closure_sharded(
    g: DIGraph,
    seed_mask: torch.Tensor,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    mesh,
    direction: int = 1,
    undirected: bool = False,
    blocks: Optional[EdgeBlocks] = None,
) -> torch.Tensor:
    """Sharded fixed-point expansion (n rounds always suffice)."""
    return khop_mask_sharded(g, seed_mask, edge_allowed, k=g.n + 1, mesh=mesh,
                             direction=direction, undirected=undirected, blocks=blocks)
