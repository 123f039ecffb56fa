"""Sharded DIP execution over an entity mesh — the paper's "distributable" claim.

The three DIP stores are distributable by construction (§IV): their entity
axis block-distributes over P locales, giving O(NK/P) query cost.  This
module realizes that on an ``EntityMesh`` (``launch/mesh.py``), single-
controller: a sharded array is a tuple of P contiguous tensors, shard ``i``
on ``mesh.devices[i]``.

  * ``place_*`` pads the entity/slot axis of a HOST-built store to a
    multiple of P (``pg_word_pad`` words for a packed plane), cuts the
    shards from the host arrays and uploads them one at a time, as
    ``launch.sharding.pg_specs`` places them.  The dense form never lands
    on a device, and every shard is contiguous (the bitmap_query kernels
    refuse strided planes).
  * ``query_any*_sharded`` run the OR-semantics query shard by shard, each
    shard scanning ONLY its own slice:
      - ``arr``: B1 (packed) or B2 (byte) once per shard on its (K, W/P) or
        (K, N/P) slice (``kernels.bitmap_query`` ``*_sharded``); the parts
        need no collective and are gathered onto the lead device.
      - ``list`` / ``listd``: slot shards do not align with entity shards
        at the boundaries, so each shard scatters its hits into a full
        (n,) partial mask and ONE collective ORs them (``_or_combine``:
        the byte path's max, the packed path's OR all-reduce of words).

Padding is harmless by construction: list pad slots point at entity ``n``
and land in a spare row that is cut off (torch has no dropping scatter),
listd pad slots carry ``slot_idx ≥ nnz`` and are masked, pad bitmap
columns and words are zero and are sliced off.  Every sharded query is
bitwise its single-device counterpart.  Results land on the lead device,
where the executor, the predicates and the overlay's delta union read
them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import bitplane
from repro_torch.core.di import DIGraph
from repro_torch.core.dip_arr import DIPArr
from repro_torch.core.dip_arr import query_any_batched as _arr_query_any_batched
from repro_torch.core.dip_list import DIPList, mark, scatter_ids
from repro_torch.core.dip_listd import DIPListD
from repro_torch.kernels.bitmap_query import ops as _ops

__all__ = [
    "ShardedDIPArr",
    "ShardedDIPList",
    "ShardedDIPListD",
    "place_graph",
    "place_store",
    "place_column",
    "query_any_sharded",
    "query_any_batched_sharded",
    "query_any_words_sharded",
    "query_any_batched_words_sharded",
    "store_bytes",
]

Shards = Tuple[torch.Tensor, ...]


def _shards(mesh) -> int:
    from repro_torch.launch.sharding import pg_entity_shards

    return pg_entity_shards(mesh)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pad_to(x: np.ndarray, size: int, fill=0, axis: int = 0) -> np.ndarray:
    """Pad ``axis`` of a host array to ``size`` with ``fill``, on the host:
    the padded dense form never reaches a device."""
    pad = size - x.shape[axis]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def _put(x: np.ndarray, mesh, axis: int = 0) -> Shards:
    """Split a host array (its ``axis`` a multiple of P) into P contiguous
    blocks and upload block ``i`` to ``mesh.devices[i]``, one at a time."""
    blocks = np.split(x, _shards(mesh), axis=axis)
    return tuple(torch.from_numpy(np.ascontiguousarray(b)).to(dev)
                 for b, dev in zip(blocks, mesh.devices))


def _replicate(x: np.ndarray, mesh) -> Shards:
    from repro_torch.launch.collectives import broadcast

    return broadcast(torch.from_numpy(np.ascontiguousarray(x)), mesh.devices)


# --------------------------------------------------------------- sharded stores
@dataclasses.dataclass(frozen=True)
class ShardedDIPArr:
    """DIP-ARR bitmap padded to ``(k, n_pad)`` (n_pad = P⌈n/P⌉) and split
    on the entity axis — K whole on every shard.  The packed plane splits
    its WORD axis instead: ``(k, W_pad)`` int32 words with ``W_pad`` from
    ``pg_word_pad`` (``n_pad = 32·W_pad``), so every shard owns whole
    words and a word-sharded mask is the entity-sharded mask."""

    bitmap: Shards  # P × (k, n_pad/P) int8 OR P × (k, W_pad/P) int32
    k: int
    n: int  # logical entity count (columns/bits ≥ n are zero padding)
    n_pad: int
    mesh: object
    packed: bool = False


@dataclasses.dataclass(frozen=True)
class ShardedDIPList:
    """DIP-LIST CSR with ``val``/``slot_entity`` padded to ``nnz_pad`` and
    slot-sharded.  Pad slots carry ``slot_entity = n``: the query scatters
    them into a spare row it cuts off.  ``off`` stays on the host: the
    sharded query scatters by ``slot_entity`` and never reads offsets."""

    val: Shards  # P × (nnz_pad/P,) int32
    slot_entity: Shards  # P × (nnz_pad/P,) int32; pad slots = n
    k: int
    n: int
    nnz: int  # logical slot count (slots ≥ nnz are padding)
    nnz_pad: int
    mesh: object


@dataclasses.dataclass(frozen=True)
class ShardedDIPListD:
    """DIP-LISTD's inverted CSR, slot-sharded.  Only the query-side arrays
    reach the devices: the linked-chain arrays stay on the host (the
    pointer chase is sequential, §VI-B, and has no sharded form)."""

    a_off: Shards  # (k+1,) int32 on every shard's device
    a_ent: Shards  # P × (nnz_pad/P,) int32 (attribute-major)
    slot_idx: Shards  # P × (nnz_pad/P,) int32 global slot index
    k: int
    n: int
    nnz: int
    nnz_pad: int
    mesh: object


ShardedStore = Union[ShardedDIPArr, ShardedDIPList, ShardedDIPListD]

_ARR_IMPLS = ("matvec", "scan", "kernel")


def store_bytes(ss: ShardedStore) -> Tuple[int, ...]:
    """Bytes each shard's device holds for the store (replicated arrays
    counted on every device)."""
    fields = [f.name for f in dataclasses.fields(ss)
              if isinstance(getattr(ss, f.name), tuple) and f.name != "mesh"]
    return tuple(sum(getattr(ss, f)[i].numel() * getattr(ss, f)[i].element_size()
                     for f in fields) for i in range(ss.mesh.size))


# ------------------------------------------------------------------- placement
def place_column(col: torch.Tensor, mesh) -> torch.Tensor:
    """A (n,)/(m,) typed column or valid mask, placed as ``pg_prop_spec``
    says: whole on the lead device."""
    return col.to(mesh.lead)


def place_graph(g: DIGraph, mesh) -> DIGraph:
    """The DI arrays placed as ``pg_di_specs`` says: whole on the lead
    device (the sharded traversal cuts its own per-shard edge blocks)."""
    lead = mesh.lead
    return dataclasses.replace(g, src=g.src.to(lead), dst=g.dst.to(lead), seg=g.seg.to(lead),
                               node_map=g.node_map.to(lead))


def _pad_multiple(mesh, size: int) -> int:
    """Smallest positive multiple of P ≥ ``size`` — the padded extent of
    every sharded store axis."""
    p = _shards(mesh)
    return max(-(-size // p), 1) * p


def place_store(backend: str, store, mesh) -> ShardedStore:
    """Pad and place a host-built DIP store for sharded execution."""
    if backend == "arr":
        return place_dip_arr(store, mesh)
    if backend == "list":
        return place_dip_list(store, mesh)
    if backend == "listd":
        return place_dip_listd(store, mesh)
    raise ValueError(f"unknown backend {backend!r}")


def place_dip_arr(store: DIPArr, mesh) -> ShardedDIPArr:
    from repro_torch.launch.sharding import pg_word_pad

    bm = _host(store.bitmap)
    if store.packed:
        # split the WORD axis: P whole words a shard, n_pad = 32·W_pad bits;
        # pad words are zero, so pad bits are zero and nothing masks them
        w_pad = pg_word_pad(mesh, store.n)
        bm = _pad_to(np.ascontiguousarray(bm).view(np.int32), w_pad, axis=1)
        n_pad = w_pad * bitplane.WORD
    else:
        n_pad = _pad_multiple(mesh, store.n)
        bm = _pad_to(bm, n_pad, axis=1)
    return ShardedDIPArr(bitmap=_put(bm, mesh, axis=1), k=store.k, n=store.n, n_pad=n_pad,
                         mesh=mesh, packed=store.packed)


def place_dip_list(store: DIPList, mesh) -> ShardedDIPList:
    nnz_pad = _pad_multiple(mesh, store.nnz)
    return ShardedDIPList(
        val=_put(_pad_to(_host(store.val).astype(np.int32, copy=False), nnz_pad), mesh),
        # pad fill = n: the spare row of the query's scatter
        slot_entity=_put(_pad_to(_host(store.slot_entity).astype(np.int32, copy=False),
                                 nnz_pad, fill=store.n), mesh),
        k=store.k, n=store.n, nnz=store.nnz, nnz_pad=nnz_pad, mesh=mesh)


def place_dip_listd(store: DIPListD, mesh) -> ShardedDIPListD:
    nnz_pad = _pad_multiple(mesh, store.nnz)
    return ShardedDIPListD(
        a_off=_replicate(_host(store.a_off).astype(np.int32, copy=False), mesh),
        a_ent=_put(_pad_to(_host(store.a_ent).astype(np.int32, copy=False), nnz_pad), mesh),
        # cut from a host arange: no device holds the whole O(nnz) index array
        slot_idx=_put(np.arange(nnz_pad, dtype=np.int32), mesh),
        k=store.k, n=store.n, nnz=store.nnz, nnz_pad=nnz_pad, mesh=mesh)


# --------------------------------------------------------------------- queries
def _lead(parts: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    from repro_torch.launch.collectives import gather

    return gather(parts, mesh.lead, dim=-1)


def _local_arr(shard: torch.Tensor, packed: bool = False) -> DIPArr:
    """A shard's (K, N/P) slice as a DIPArr, so a per-shard query runs
    ``dip_arr``'s own code; packed slices are whole words."""
    n = shard.shape[1] * (bitplane.WORD if packed else 1)
    return DIPArr(bitmap=shard, k=shard.shape[0], n=n, packed=packed)


def _arr_words_parts(ss: ShardedDIPArr, masks: torch.Tensor) -> Shards:
    """(Q, W_pad/P) word parts of a packed plane: B1 once per shard (every
    impl of a packed plane is the word OR-scan)."""
    return _ops.bitmap_query_batched_packed_sharded(ss.bitmap, masks, mesh=ss.mesh)


def _arr_byte_parts(ss: ShardedDIPArr, masks: torch.Tensor, impl: str) -> Shards:
    """(Q, n_pad/P) bool parts of a byte plane: B2 once per shard, or a
    matvec per shard."""
    if impl in ("scan", "kernel"):
        return _ops.bitmap_query_batched_sharded(ss.bitmap, masks, mesh=ss.mesh)
    from repro_torch.launch.collectives import broadcast

    return tuple(_arr_query_any_batched(_local_arr(b), m, impl=impl)
                 for b, m in zip(ss.bitmap, broadcast(masks, ss.mesh.devices)))


def _arr_query_batched_words_sharded(ss: ShardedDIPArr, masks: torch.Tensor) -> torch.Tensor:
    return _lead(_arr_words_parts(ss, masks), ss.mesh)[:, :bitplane.n_words(ss.n)]


def _arr_query_batched_sharded(ss: ShardedDIPArr, masks: torch.Tensor, impl: str) -> torch.Tensor:
    if ss.packed:
        return bitplane.unpack_mask(_arr_query_batched_words_sharded(ss, masks), ss.n)
    return _lead(_arr_byte_parts(ss, masks, impl), ss.mesh)[:, :ss.n]


def _or_combine(parts: Sequence[torch.Tensor], mesh, n: int, packed: bool) -> torch.Tensor:
    """OR the per-shard (n,) partial masks: the single mask-combination
    collective.  Byte path: an int8 max all-reduce (1 byte/entity).
    Packed path: pack each partial FIRST, OR-all-reduce the words (1
    bit/entity between devices), unpack after.  The lead's copy is the
    answer."""
    from repro_torch.launch.collectives import all_reduce

    if packed:
        words = bitplane.or_allreduce([bitplane.pack_mask(p) for p in parts])
        return bitplane.unpack_mask(words[0], n)
    return all_reduce([p.to(torch.int8) for p in parts], "max")[0] > 0


def _scatter_hits(hit: torch.Tensor, ent: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bool with the shard's hits set; misses and pad slots (entity
    ``n``) land in the spare row ``mark`` cuts off."""
    return mark(torch.where(hit, scatter_ids(ent, n), n), n, hit.device)


def _list_query_sharded(ss: ShardedDIPList, mask: torch.Tensor, packed: bool) -> torch.Tensor:
    from repro_torch.launch.collectives import broadcast

    parts = []
    for val, ent, m in zip(ss.val, ss.slot_entity, broadcast(mask, ss.mesh.devices)):
        hit = m[val.clamp(0, ss.k - 1).long()]  # hits among THIS shard's slots only
        parts.append(_scatter_hits(hit, ent, ss.n))
    return _or_combine(parts, ss.mesh, ss.n, packed)


def _listd_query_sharded(ss: ShardedDIPListD, mask: torch.Tensor, packed: bool) -> torch.Tensor:
    from repro_torch.launch.collectives import broadcast

    parts = []
    for ent, idx, a_off, m in zip(ss.a_ent, ss.slot_idx, ss.a_off,
                                  broadcast(mask, ss.mesh.devices)):
        # slot → owning attribute through the replicated inverted-CSR offsets
        a = (torch.searchsorted(a_off, idx, right=True) - 1).clamp(0, ss.k - 1)
        hit = m[a] & (idx < ss.nnz)
        parts.append(_scatter_hits(hit, ent, ss.n))
    return _or_combine(parts, ss.mesh, ss.n, packed)


def _check_arr_impl(impl: Optional[str]) -> str:
    impl = impl or "matvec"
    if impl not in _ARR_IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def query_any_sharded(backend: str, ss: ShardedStore, attr_mask: torch.Tensor,
                      *, impl: Optional[str] = None) -> torch.Tensor:
    """(n,) bool OR-semantics query over the store's mesh, on the lead
    device.

    ``impl`` follows the single-device names; the impls whose work layout
    is single-device by nature (listd ``budget``/``linked``) degrade to the
    ``inverted`` slot scan, which is O(nnz/P) a shard."""
    if backend == "arr":
        impl = _check_arr_impl(impl)
        return _arr_query_batched_sharded(ss, attr_mask[None, :], impl)[0]
    packed = bitplane.packed_default()
    if backend == "list":
        return _list_query_sharded(ss, attr_mask, packed)
    if backend == "listd":
        # budget/linked are single-device layouts → the inverted slot scan;
        # anything else is a typo and fails as the single-device query does
        if impl not in (None, "inverted", "budget", "linked"):
            raise ValueError(f"unknown impl {impl!r}")
        return _listd_query_sharded(ss, attr_mask, packed)
    raise ValueError(f"unknown backend {backend!r}")


def query_any_batched_sharded(ss: ShardedDIPArr, attr_masks: torch.Tensor,
                              *, impl: Optional[str] = None) -> torch.Tensor:
    """(Q, n) bool — the planner's fused multi-mask entry, sharded (arr
    only; the other stores batch with a loop in ``_AttrStore``)."""
    return _arr_query_batched_sharded(ss, attr_masks, _check_arr_impl(impl))


def query_any_words_sharded(ss: ShardedDIPArr, attr_mask: torch.Tensor,
                            *, impl: Optional[str] = None) -> torch.Tensor:
    """(ceil(n/32),) int32 packed query over a word-sharded plane."""
    _check_arr_impl(impl)
    return _arr_query_batched_words_sharded(ss, attr_mask[None, :])[0]


def query_any_batched_words_sharded(ss: ShardedDIPArr, attr_masks: torch.Tensor,
                                    *, impl: Optional[str] = None) -> torch.Tensor:
    """(Q, ceil(n/32)) int32 packed batched query (the fused entry)."""
    _check_arr_impl(impl)
    return _arr_query_batched_words_sharded(ss, attr_masks)
