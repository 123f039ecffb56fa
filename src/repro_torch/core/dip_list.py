"""DIP-LIST — per-entity attribute lists (§IV-B of the paper), as entity-major CSR.

The paper stores, for every entity, a Chapel list/domain of attribute ids.
Ragged per-entity lists become offsets + values (CSR): ``off[n+1]`` and
``val[nnz]``, entity-major, with ``slot_entity[nnz]`` naming each slot's
owner so a query scatters its hits back without a ragged repeat.

Space O(N·K) worst case (every entity holds every attribute), matching §IV-D.

The query is plain torch (the reference leaves it to XLA: a gather and a
scatter-max).  Out-of-range ids answer as the reference's do: an attribute
id outside [0, k) reads the mask entry ``gather_ids`` names, and an entity
id outside [0, n) drops its hit (``scatter_ids``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels.seg_mm.ref import gather_ids

__all__ = [
    "DIPList",
    "build_dip_list",
    "build_dip_list_host",
    "to_device",
    "query_any",
    "attrs_of_entity_padded",
    "entity_of_slot",
    "scatter_ids",
    "mark",
]


@dataclasses.dataclass(frozen=True)
class DIPList:
    """Entity-major CSR attribute store.

    ``off[e] .. off[e+1]`` indexes the sorted attribute-id list of entity
    ``e`` inside ``val``; ``slot_entity[i]`` is the entity owning slot ``i``.
    numpy arrays for a host build, int32 tensors once placed."""

    off: object  # (n+1,) int32
    val: object  # (nnz,) int32 attribute ids, sorted within each entity
    slot_entity: object  # (nnz,) int32 owning entity per slot
    k: int
    n: int
    nnz: int


def build_dip_list_host(entity_ids, attr_ids, *, k: int, n: int, dedupe: bool = True) -> DIPList:
    """Sort the pairs by (entity, attr), drop repeated pairs (``dedupe``),
    then CSR offsets via bincount + cumsum — the bulk replacement for the
    paper's per-element list insertions.  Entities ≥ n keep their slots
    but get no offsets (``off[n]`` < ``nnz`` then), as in the reference."""
    entity_ids = np.asarray(entity_ids, np.int32).ravel()
    attr_ids = np.asarray(attr_ids, np.int32).ravel()
    order = np.lexsort((attr_ids, entity_ids))
    ent_s, attr_s = entity_ids[order], attr_ids[order]
    if dedupe and ent_s.size:
        keep = np.concatenate(
            [[True], (ent_s[1:] != ent_s[:-1]) | (attr_s[1:] != attr_s[:-1])])
        ent_s, attr_s = ent_s[keep], attr_s[keep]
    nnz = int(ent_s.shape[0])
    counts = np.bincount(ent_s, minlength=n)[:n] if nnz else np.zeros(n, np.int64)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return DIPList(off=off, val=attr_s, slot_entity=ent_s, k=k, n=n, nnz=nnz)


def to_device(host: DIPList, device) -> DIPList:
    """Place a host build on ``device``."""
    return dataclasses.replace(
        host, **{f: torch.from_numpy(np.ascontiguousarray(getattr(host, f))).to(device)
                 for f in ("off", "val", "slot_entity")})


def build_dip_list(entity_ids, attr_ids, *, k: int, n: int, dedupe: bool = True,
                   device=None) -> DIPList:
    """Bulk build on the host, then placed on ``device`` (None: the CUDA
    card, raising if there is none)."""
    device = resolve_device(device)
    return to_device(build_dip_list_host(entity_ids, attr_ids, k=k, n=n, dedupe=dedupe), device)


def scatter_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 targets of a scatter into ``n`` rows as the reference's
    dropping scatters take them: an id in [-n, -1] wraps, any other id
    outside [0, n) lands in a spare row ``n`` (dropped)."""
    idx = ids.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def mark(targets: torch.Tensor, n: int, device) -> torch.Tensor:
    """(n,) bool with True at every target in [0, n) — the scatter-OR.
    Only True is ever written, so duplicate targets cannot let a False
    win; a spare row takes the dropped targets."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=device)
    return out.index_fill_(0, targets, True)[:n]


def query_any(dlist: DIPList, attr_mask: torch.Tensor) -> torch.Tensor:
    """OR-semantics query (§VI-A): every slot is scanned — O(nnz).
    hit[i] = attr_mask[val[i]]; mask[e] = OR of the hits over e's slots."""
    dev = attr_mask.device
    if dlist.nnz == 0:
        return torch.zeros(dlist.n, dtype=torch.bool, device=dev)
    hit = attr_mask[gather_ids(dlist.val, attr_mask.shape[0])]
    return mark(torch.where(hit, scatter_ids(dlist.slot_entity, dlist.n), dlist.n), dlist.n, dev)


def attrs_of_entity_padded(dlist: DIPList, e, *, max_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entity→attributes read, padded to ``max_k``: (ids, valid), ids -1
    where not valid.  ``e`` reads ``off`` as the reference's gather does."""
    dev = dlist.val.device
    lane = torch.arange(max_k, dtype=torch.int64, device=dev)
    if dlist.nnz == 0:
        return (torch.full((max_k,), -1, dtype=torch.int32, device=dev),
                torch.zeros(max_k, dtype=torch.bool, device=dev))
    e = torch.as_tensor(e, device=dev).reshape(1)
    off = dlist.off.to(torch.int64)
    start = off[gather_ids(e, off.shape[0])]
    deg = off[gather_ids(e + 1, off.shape[0])] - start
    idx = (start + lane).clamp(0, dlist.nnz - 1)
    valid = lane < deg
    return torch.where(valid, dlist.val[idx], -1).to(torch.int32), valid


def entity_of_slot(dlist: DIPList) -> torch.Tensor:
    """(nnz,) owning entity of each slot."""
    return dlist.slot_entity
