"""DIP-LISTD — doubly-linked attribute chains (§IV-B), two ways.

The paper threads a distributed doubly-linked list through every Node that
carries a given attribute, with ``last_entity_tracker[attr]`` holding the
most recently inserted Node, so attribute→entities traversal walks prev
pointers — O(N) *sequential* (the measured ~10× slowdown, §VII-B).

  1. **Faithful emulation** (``query_any_linked``): Nodes are parallel
     arrays ``(entity, attr, prev, nxt)`` in insertion order plus
     ``last_tracker[k]``; the query is a pointer chase, one node per chain
     per step.  Kept as the paper's baseline: its slowness is the finding.

  2. **Inverted CSR** (``query_any_inverted`` / ``query_any_budget``):
     attribute-major offsets ``a_off[k+1]`` and entities ``a_ent[nnz]`` give
     the same attribute→entities reads in parallel.  ``query_any_budget``
     touches only the selected attributes' segments, padded to a budget.

Every query is plain torch (the reference leaves them to XLA).  Entity ids
outside [0, n) drop as the reference's scatters drop them
(``dip_list.scatter_ids``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.dip_list import mark, scatter_ids
from repro_torch.kernels.seg_mm.ref import gather_ids

__all__ = [
    "DIPListD",
    "build_dip_listd",
    "build_dip_listd_host",
    "to_device",
    "query_any_linked",
    "query_any_inverted",
    "query_any_budget",
    "query_any",
]

_FIELDS = ("entity", "attr", "prev", "nxt", "last_tracker", "a_off", "a_ent")


@dataclasses.dataclass(frozen=True)
class DIPListD:
    """Node arrays in insertion order + per-attribute chain heads + inverted
    CSR; numpy arrays for a host build, int32 tensors once placed.
    ``last_tracker[a]`` is the last node inserted for attribute ``a`` (-1 if
    none)."""

    entity: object  # (nnz,) int32
    attr: object  # (nnz,) int32
    prev: object  # (nnz,) int32 — previous node with the same attr, -1 at the head
    nxt: object  # (nnz,) int32 — next node with the same attr, -1 at the tail
    last_tracker: object  # (k,) int32
    a_off: object  # (k+1,) int32 inverted-CSR offsets
    a_ent: object  # (nnz,) int32 entities grouped by attribute
    k: int
    n: int
    nnz: int


def _check_attrs(att: np.ndarray, k: int) -> None:
    """Reject the attribute ids the reference's insertion replay rejects:
    IndexError for an id outside [-k, k) (its ``last[a]``), ValueError for
    any other negative id (its ``bincount``)."""
    if att.size and ((att >= k) | (att < -k)).any():
        bad = att[(att >= k) | (att < -k)][0]
        raise IndexError(f"index {bad} is out of bounds for axis 0 with size {k}")
    if att.size and (att < 0).any():
        raise ValueError("'list' argument must have no negative elements")


def build_dip_listd_host(entity_ids, attr_ids, *, k: int, n: int) -> DIPListD:
    """Host (numpy) build from insertion-ordered (entity, attribute) pairs.

    The chains are the ones the paper's insertion protocol leaves (each new
    node's prev is the last node of its attribute, whose next becomes the
    new node), computed at once: a stable sort by attribute lists each
    chain in insertion order, so a node's prev is its predecessor in its
    attribute's run.  Duplicate pairs stay (each insertion is a node)."""
    ent = np.asarray(entity_ids, dtype=np.int32).ravel()
    att = np.asarray(attr_ids, dtype=np.int32).ravel()
    _check_attrs(att, k)
    nnz = int(ent.shape[0])
    order = np.argsort(att, kind="stable").astype(np.int32)
    counts = np.bincount(att, minlength=k)
    a_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    same = np.zeros(nnz, bool)  # sorted slot p continues the run of p - 1
    same[1:] = att[order[1:]] == att[order[:-1]]
    prev = np.full(nnz, -1, dtype=np.int32)
    nxt = np.full(nnz, -1, dtype=np.int32)
    prev[order[1:][same[1:]]] = order[:-1][same[1:]]
    nxt[order[:-1][same[1:]]] = order[1:][same[1:]]
    last = np.where(counts > 0, order[np.maximum(a_off[1:] - 1, 0)] if nnz else -1,
                    -1).astype(np.int32)
    return DIPListD(entity=ent, attr=att, prev=prev, nxt=nxt, last_tracker=last,
                    a_off=a_off, a_ent=ent[order], k=k, n=n, nnz=nnz)


def to_device(host: DIPListD, device) -> DIPListD:
    """Place a host build on ``device``."""
    return dataclasses.replace(
        host, **{f: torch.from_numpy(np.ascontiguousarray(getattr(host, f))).to(device)
                 for f in _FIELDS})


def build_dip_listd(entity_ids, attr_ids, *, k: int, n: int, device=None) -> DIPListD:
    """Bulk build on the host, then placed on ``device`` (None: the CUDA
    card, raising if there is none)."""
    device = resolve_device(device)
    return to_device(build_dip_listd_host(entity_ids, attr_ids, k=k, n=n), device)


def query_any_linked(d: DIPListD, attr_mask: torch.Tensor) -> torch.Tensor:
    """Paper-faithful query: walk the prev chain of every selected attribute
    from ``last_tracker``, marking entities — the O(N) pointer chase of
    §VI-B, expected to lose to the other stores.

    Every selected chain advances one node per step, together; the walk
    takes exactly as many steps as the longest selected chain, whose length
    (the attribute's node count) is read off ``a_off`` on the host before
    the walk, so no step reads anything back.  A finished chain parks on a
    spare node whose prev is itself and whose entity is dropped."""
    dev = attr_mask.device
    if d.nnz == 0:
        return torch.zeros(d.n, dtype=torch.bool, device=dev)
    sel = attr_mask.cpu().numpy().astype(bool)
    lengths = np.diff(d.a_off.cpu().numpy().astype(np.int64))
    steps = int(lengths[sel].max(initial=0))
    if steps == 0:
        return torch.zeros(d.n, dtype=torch.bool, device=dev)
    spare = torch.full((1,), d.nnz, dtype=torch.int64, device=dev)
    prev = torch.cat([torch.where(d.prev >= 0, d.prev.to(torch.int64), d.nnz), spare])
    target = torch.cat([scatter_ids(d.entity, d.n), spare.new_full((1,), d.n)])
    heads = d.last_tracker.to(torch.int64)[torch.from_numpy(np.flatnonzero(sel)).to(dev)]
    heads = torch.where(heads >= 0, heads, d.nnz)
    hits = torch.zeros(d.n + 1, dtype=torch.bool, device=dev)
    for _ in range(steps):
        hits.index_fill_(0, target.index_select(0, heads), True)
        heads = prev.index_select(0, heads)
    return hits[:d.n]


def query_any_inverted(d: DIPListD, attr_mask: torch.Tensor) -> torch.Tensor:
    """Inverted-CSR query, full-scan form: every slot whose attribute is
    selected marks its entity.  O(nnz) in parallel — the drop-in
    replacement for the linked walk."""
    dev = attr_mask.device
    if d.nnz == 0:
        return torch.zeros(d.n, dtype=torch.bool, device=dev)
    counts = (d.a_off[1:] - d.a_off[:-1]).to(torch.int64)
    hit = torch.repeat_interleave(attr_mask, counts, output_size=d.nnz)
    return mark(torch.where(hit, scatter_ids(d.a_ent, d.n), d.n), d.n, dev)


def query_any_budget(d: DIPListD, attr_ids: torch.Tensor, *, budget: int) -> torch.Tensor:
    """Output-sized inverted-CSR query: only the selected attributes'
    segments, laid end to end over ``budget`` slots (the host picks it ≥ the
    segments' total from ``a_off``; a smaller budget marks only the first
    ``budget`` slots, as the reference does).  ``attr_ids``: (A,) ids, -1
    entries ignored.  Work O(budget), independent of nnz."""
    dev = d.a_ent.device
    ids = torch.as_tensor(attr_ids, device=dev).to(torch.int64).ravel()
    if d.nnz == 0 or ids.numel() == 0:
        return torch.zeros(d.n, dtype=torch.bool, device=dev)
    a_off = d.a_off.to(torch.int64)
    k1 = a_off.shape[0]
    picked = ids >= 0
    seg_start = torch.where(picked, a_off[gather_ids(ids, k1)], 0)
    seg_len = torch.where(picked, a_off[gather_ids(ids + 1, k1)], 0) - seg_start
    cum = torch.cat([seg_len.new_zeros(1), torch.cumsum(seg_len, 0)])
    # budget slot j belongs to query segment q(j) = searchsorted(cum, j) - 1
    j = torch.arange(budget, dtype=torch.int64, device=dev)
    q = (torch.searchsorted(cum, j, right=True) - 1).clamp(0, ids.numel() - 1)
    valid = j < cum[-1]
    src = (seg_start[q] + j - cum[q]).clamp(0, d.nnz - 1)
    return mark(torch.where(valid, scatter_ids(d.a_ent[src], d.n), d.n), d.n, dev)


def query_any(d: DIPListD, attr_mask: torch.Tensor, *, impl: str = "inverted") -> torch.Tensor:
    if impl == "linked":
        return query_any_linked(d, attr_mask)
    if impl == "inverted":
        return query_any_inverted(d, attr_mask)
    raise ValueError(f"unknown impl {impl!r}")
