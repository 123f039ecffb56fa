"""Neighbor sampling over DI — layered fanout sampling for GNN minibatches.

GraphSAGE-style layered fanout sampling (e.g. 15-10): starting from a seed
batch, sample up to ``fanout[l]`` neighbors per frontier node per layer,
emitting one bipartite block per layer.  The DI structure makes the inner
gather an offset lookup plus a contiguous slice (``SEG``/``DST``), the
paper's neighborhood access path.

Selection is uniform WITHOUT replacement over the (optionally packed-mask
filtered) adjacency — the ``kernels/neighbor_sample`` window-priority core
(B3 on the card): degree-0 seeds come out fully masked, and degree ≤
fanout keeps every allowed edge exactly once.  Blocks carry *local*
(re-normalized) ids so downstream layers operate on compact arrays.

Keys: layer l draws its priorities from ``layer_key(base, l)``, a plain
deterministic integer function of ``(base, l)`` — layers are independent
whatever base callers pass, and layer l's draw does not shift when other
layers are added or removed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.di import DIGraph
from repro_torch.kernels.neighbor_sample import ops
from repro_torch.kernels.neighbor_sample.ops import bucketed_window

__all__ = ["SampledBlock", "sample_block", "sample_layers", "block_shapes",
           "layer_key", "layer_keys_batch", "local_block", "sorted_unique"]

_M64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One bipartite message-flow block (layer) of a sampled minibatch.

    src_nodes: (n_src,) global ids feeding this layer (dst_nodes ∪ sampled nbrs)
    dst_nodes: (n_dst,) global ids updated by this layer
    edge_src/edge_dst: (n_edges,) *local* indices into src_nodes/dst_nodes
    edge_mask: (n_edges,) bool — False for padded sample slots

    Fields are host (numpy) arrays: block assembly is host-side compaction.
    """

    src_nodes: np.ndarray
    dst_nodes: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    n_src: int
    n_dst: int
    n_edges: int


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def layer_key(seed: int, layer: int) -> int:
    """The priority key of ``layer`` under the base ``seed``: an integer in
    [0, 2**63) that depends on ``(seed, layer)`` only."""
    return _mix64(_mix64(int(seed) & _M64) ^ (int(layer) & _M64)) >> 1


def layer_keys_batch(seeds, layer: int) -> np.ndarray:
    """(R,) seeds → (R,) layer-``layer`` keys; row r is
    ``layer_key(seeds[r], layer)``."""
    return np.array([layer_key(int(s), layer) for s in np.asarray(seeds).ravel()],
                    dtype=np.int64)


def sample_block(g: DIGraph, seeds, key: int, *, fanout: int,
                 edge_words=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ≤ fanout out-neighbors per seed, uniform WITHOUT replacement
    over the adjacency slice (filtered by the packed ``edge_words`` bitmap
    when given).  Returns (neighbors, mask), both (len(seeds), fanout);
    masked slots hold -1.  Degree-0 seeds are fully masked; degree ≤
    fanout yields every (allowed) neighbor exactly once."""
    seeds = ops._as_device(seeds, g.device, torch.int32).reshape(-1)
    window = bucketed_window(max(g.max_deg, fanout))
    u = ops._draw_priorities(key, (seeds.shape[0], window), g.device)
    valid = torch.ones(seeds.shape[0], dtype=torch.bool, device=g.device)
    nbrs, _eids, mask = ops._window_select(
        g.seg, g.dst, g.m, g.n, seeds, valid, ops._words(edge_words, g.device), u, int(fanout))
    return nbrs, mask


def sorted_unique(ids: np.ndarray) -> np.ndarray:
    """``np.unique(ids)`` (sorted, distinct) as one sort and a neighbour
    compare.  Recent numpy's ``np.unique`` hashes integer input before it
    sorts, and that took most of a sample request's time on the card's
    host (``chip_smoke.py``'s sampling profile)."""
    s = np.sort(ids)
    return s[np.concatenate([[True], s[1:] != s[:-1]])] if s.size else s


def local_block(dst_nodes: np.ndarray, src_nodes: np.ndarray,
                nbrs: np.ndarray, mask: np.ndarray) -> SampledBlock:
    """Renumber one layer's (dst_nodes, sampled nbrs) into a local-id
    bipartite block.  ``src_nodes`` must be sorted unique and contain every
    unmasked neighbor; renumbering is by binary search (of the unmasked
    slots only: masked ones get local id 0), so local ids are a pure
    function of the global id sets — stable across runs and identical
    however the sample was produced."""
    flat, ok = nbrs.ravel(), mask.ravel().copy()
    edge_src = np.zeros(flat.shape, np.int32)
    live = flat[ok]
    pos = np.minimum(np.searchsorted(src_nodes, live), max(len(src_nodes) - 1, 0))
    found = src_nodes[pos] == live
    ok[ok] = found
    edge_src[ok] = pos[found]
    edge_dst = np.repeat(
        np.arange(len(dst_nodes), dtype=np.int32), nbrs.shape[1])
    return SampledBlock(
        src_nodes=np.asarray(src_nodes),
        dst_nodes=np.asarray(dst_nodes),
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_mask=ok,
        n_src=int(len(src_nodes)),
        n_dst=int(len(dst_nodes)),
        n_edges=int(edge_src.shape[0]),
    )


def sample_layers(g: DIGraph, seeds: np.ndarray, fanouts: Sequence[int], *, seed: int = 0,
                  key: Optional[int] = None, edge_words=None) -> List[SampledBlock]:
    """Multi-layer fanout sampling (innermost layer first, GraphSAGE order).

    Host-driven compaction between layers (unique) keeps block sizes tight.
    Layer l's key is ``layer_key(base, l)`` with base ``key`` if given, else
    ``seed`` (module docstring).  Returns blocks ordered for a forward pass:
    blocks[0] aggregates the widest frontier.
    """
    base = int(seed) if key is None else int(key)
    frontier = np.asarray(seeds, np.int32)
    layer_frontiers = [frontier]
    layer_samples = []
    for li, f in enumerate(fanouts):
        nbrs, mask = sample_block(g, frontier, layer_key(base, li), fanout=int(f),
                                  edge_words=edge_words)
        nbrs_np, mask_np = nbrs.cpu().numpy(), mask.cpu().numpy()
        layer_samples.append((frontier, nbrs_np, mask_np))
        nxt = sorted_unique(np.concatenate([frontier, nbrs_np[mask_np]]))
        layer_frontiers.append(nxt.astype(np.int32))
        frontier = layer_frontiers[-1]

    blocks: List[SampledBlock] = []
    for li in range(len(fanouts) - 1, -1, -1):
        dst_nodes, nbrs_np, mask_np = layer_samples[li]
        src_nodes = layer_frontiers[li + 1]
        blocks.append(local_block(dst_nodes, src_nodes, nbrs_np, mask_np))
    return blocks


def block_shapes(batch_nodes: int, fanouts: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Static worst-case (n_src, n_dst, n_edges) per block, innermost-first
    (padded dense blocks)."""
    sizes = [batch_nodes]
    for f in fanouts:
        sizes.append(sizes[-1] * (f + 1))  # dst ∪ sampled
    shapes = []
    for li in range(len(fanouts) - 1, -1, -1):
        n_dst = sizes[li]
        n_src = sizes[li + 1]
        shapes.append((n_src, n_dst, n_dst * fanouts[li]))
    return shapes
