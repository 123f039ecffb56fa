"""Batched property-filtered neighbor sampling — one kernel launch per seed batch.

The serving-path sampler: gather the SEG/DST adjacency window of every
seed in a batch, reject edges the packed edge mask disallows by reading its
int32 words directly (bit ``e & 31`` of word ``e >> 5`` — the
``core.bitplane`` layout, no bool plane), draw one uniform priority per
window lane, and keep the ``fanout`` smallest-priority allowed lanes per
seed.  Order statistics of i.i.d. uniforms make that a uniform
without-replacement sample of the filtered adjacency; degree-0 (or fully
filtered) seeds come out fully masked, and seeds with filtered degree ≤
fanout keep every allowed edge exactly once.

Routing follows ``bitmap_query``: :func:`window_select` checks its inputs,
sends CPU tensors to the plain version (``ref.window_select_ref``) and
launches the CUDA kernel B3 (``kernel.py``) on CUDA tensors — there is no
fallback from the card to the plain version.  ``launches`` counts B3
launches (never plain-version calls); ``reset_launches()`` zeroes it.

Shapes are bucketed as in the reference — the request count R through
:func:`bucketed_requests`, the seed capacity S through
:func:`bucketed_seeds`, the window W through :func:`bucketed_window` — so
the set of distinct (kind, shapes) a process sees stays bounded;
:func:`sample_compile_count` counts them (a plain counter; nothing here
compiles per shape).

Randomness contract: every priority is drawn by :func:`_draw_priorities`
from an integer key with an explicit ``torch.Generator`` on the tensors'
device, so the same key gives the same bits, and row r of a batched call
draws from key r alone — bitwise the same request run by itself.  The CPU's
and the card's generators give different bits for one key; to compare the
two, hand both the same priorities (the tests and ``chip_smoke.py`` patch
this one function).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitplane
from repro_torch.kernels.neighbor_sample import kernel, ref
from repro_torch.obs.metrics import GLOBAL as _OBS
from repro_torch.obs.metrics import enabled as _obs_enabled

__all__ = [
    "SEED_BUCKET_MIN",
    "WINDOW_BUCKET_MIN",
    "REQUEST_BUCKETS",
    "bucketed_requests",
    "bucketed_seeds",
    "bucketed_window",
    "window_select",
    "neighbor_sample",
    "neighbor_sample_batched",
    "neighbor_sample_from_words",
    "sample_compile_count",
    "sample_embed",
]

SEED_BUCKET_MIN = 16  # smallest seed-capacity bucket
WINDOW_BUCKET_MIN = 8  # smallest adjacency-window bucket
REQUEST_BUCKETS = (1, 2, 4, 8, 16, 32)  # coalesced-group R buckets

WINDOW_SELECT = "window_select"  # B3
launches: Dict[str, int] = {WINDOW_SELECT: 0}
_SEEN_KEYS: set = set()
# the reference's sampler accounting (docs/ARCHITECTURE.md §13): a call is
# a "launch" and a (kind, static shapes) key not seen before a
# "compile"; the port builds no program per shape, so here the second
# counts the distinct shapes the process has sampled at
_M_COMPILES = _OBS.counter(
    "pg_sample_compiles", "distinct neighbor_sample program specializations")
_M_LAUNCHES = _OBS.counter(
    "pg_sample_launches", "neighbor_sample device launches")


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _pow2_bucket(size: int, floor: int) -> int:
    cap = floor
    while cap < size:
        cap <<= 1
    return cap


def bucketed_seeds(s: int) -> int:
    """Seed-batch capacity bucket: next power of two ≥ s (min 16)."""
    return _pow2_bucket(max(int(s), 1), SEED_BUCKET_MIN)


def bucketed_window(w: int) -> int:
    """Adjacency-window bucket: next power of two ≥ w (min 8).  Static per
    graph — callers pass max(graph max-degree, fanout)."""
    return _pow2_bucket(max(int(w), 1), WINDOW_BUCKET_MIN)


def bucketed_requests(r: int) -> int:
    """Coalesced request-count bucket (fixed grid, multiples of the top
    bucket beyond it)."""
    if r < 1:
        raise ValueError(f"r must be ≥ 1, got {r}")
    for b in REQUEST_BUCKETS:
        if r <= b:
            return b
    top = REQUEST_BUCKETS[-1]
    return -(-r // top) * top


def _note_launch(kind: str, shape_key: tuple) -> None:
    """Record the (kind, static shapes) of a sampling call; with metrics on,
    count the call and, for a key not seen before, a new shape."""
    key = (kind,) + shape_key
    new = key not in _SEEN_KEYS
    _SEEN_KEYS.add(key)
    if _obs_enabled():
        _M_LAUNCHES.inc()
        if new:
            _M_COMPILES.inc()


def sample_compile_count() -> int:
    """Distinct sampler (kind, shape) specializations this process has seen."""
    return len(_SEEN_KEYS)


def _draw_priorities(key: int, shape: Tuple[int, ...], device) -> torch.Tensor:
    """Uniform [0, 1) float32 priorities of ``shape`` on ``device`` from the
    integer ``key`` — the one place the sampler draws randomness."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


# --------------------------------------------------------------- core select
def _check(start, deg, dst, ew_words, pri, fanout: int) -> None:
    name = WINDOW_SELECT
    if start.dtype != torch.int32 or deg.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError(f"{name}: start, deg and dst must be int32, got "
                        f"{start.dtype}, {deg.dtype}, {dst.dtype}")
    if pri.dtype != torch.float32:
        raise TypeError(f"{name}: priorities must be float32, got {pri.dtype}")
    if dst.dim() != 1 or start.shape != deg.shape or pri.shape[:-1] != start.shape:
        raise ValueError(f"{name}: want start/deg (..., S), pri (..., S, W), dst (m,); got "
                         f"{tuple(start.shape)}, {tuple(deg.shape)}, {tuple(pri.shape)}, "
                         f"{tuple(dst.shape)}")
    if not 1 <= fanout <= pri.shape[-1]:
        raise ValueError(f"{name}: fanout {fanout} must be in [1, W={pri.shape[-1]}]")
    tensors = [start, deg, dst, pri]
    if ew_words is not None:
        if ew_words.dtype != torch.int32:
            raise TypeError(f"{name}: edge words must be int32, got {ew_words.dtype}")
        if ew_words.shape[-1] < bitplane.n_words(dst.shape[0]):
            raise ValueError(f"{name}: {ew_words.shape[-1]} edge words do not cover "
                             f"{dst.shape[0]} edges")
        if ew_words.dim() not in (1, 2):
            raise ValueError(f"{name}: edge words must be (W_m,) or (R, W_m)")
        if ew_words.dim() == 2 and not (start.dim() == 2 and ew_words.shape[0] == start.shape[0]):
            raise ValueError(f"{name}: (R, W_m) edge words need (R, S) seeds, got "
                             f"{tuple(ew_words.shape)} and {tuple(start.shape)}")
        tensors.append(ew_words)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: inputs on several devices {[t.device for t in tensors]}")
    if pri.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {pri.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if dst.shape[0] >= 2**31:
        raise ValueError(f"{name}: edge ids must fit in int32")


def window_select(start: torch.Tensor, deg: torch.Tensor, dst: torch.Tensor,
                  ew_words: Optional[torch.Tensor], pri: torch.Tensor, *,
                  fanout: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per seed, the ``fanout`` allowed window lanes of smallest priority
    (B3; the contract of ``ref.window_select_ref``).  ``start``/``deg``
    (..., S) int32, ``pri`` (..., S, W) f32, ``ew_words`` (W_m,) or
    (R, W_m) int32 or None → (nbrs, eids, mask) each (..., S, fanout)."""
    fanout = int(fanout)
    _check(start, deg, dst, ew_words, pri, fanout)
    if pri.device.type == "cpu":
        return ref.window_select_ref(start, deg, dst, ew_words, pri, fanout=fanout)
    shape = tuple(pri.shape[:-1]) + (fanout,)
    nbrs = torch.empty(shape, dtype=torch.int32, device=pri.device)
    eids = torch.empty(shape, dtype=torch.int32, device=pri.device)
    ok = torch.empty(shape, dtype=torch.bool, device=pri.device)
    if start.numel():
        kernel.launch_window_select(start, deg, dst, ew_words, pri, nbrs, eids, ok)
        launches[WINDOW_SELECT] += 1
    return nbrs, eids, ok


def _window_select(seg, dst, m: int, n: int, seeds, valid, ew_words, u, fanout: int):
    """The selection core: per seed, look up its SEG window, then
    :func:`window_select` (B3 on the card).  seeds (..., S) int32 in
    [0, n) (pad rows arbitrary but ``valid`` False), u (..., S, W) f32
    priorities, ew_words packed int32 or None.  Returns (nbrs, eids, mask)
    each (..., S, fanout); -1 in masked slots."""
    del m  # the window bound comes from dst itself
    sidx = seeds.to(torch.int64).clamp(0, max(n - 1, 0))
    start = seg[sidx]
    deg = torch.where(valid, seg[(sidx + 1).clamp(max=n)] - start, 0).to(torch.int32)
    return window_select(start.contiguous(), deg.contiguous(), dst, ew_words,
                         u.contiguous(), fanout=fanout)


# ---------------------------------------------------------- public wrappers
def _count(seeds) -> int:
    return seeds.numel() if torch.is_tensor(seeds) else int(np.asarray(seeds).size)


def _as_device(x, device, dtype) -> torch.Tensor:
    """Host or device ids/masks/words → a contiguous tensor on ``device``
    (numpy uint32 words are viewed as int32: the same bits)."""
    if not torch.is_tensor(x):
        a = np.asarray(x)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        x = torch.from_numpy(np.array(a))  # a private copy: callers may pass read-only views
    return x.to(device=device, dtype=dtype).contiguous()


def _words(edge_words, device) -> Optional[torch.Tensor]:
    return None if edge_words is None else _as_device(edge_words, device, torch.int32)


def _pad_seeds(seeds, cap: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    seeds = _as_device(seeds, device, torch.int32).reshape(-1)
    s = int(seeds.shape[0])
    if s > cap:
        raise ValueError(f"{s} seeds exceed capacity {cap}")
    valid = torch.arange(cap, device=device) < s
    if s < cap:
        seeds = torch.cat([seeds, torch.zeros(cap - s, dtype=torch.int32, device=device)])
    return seeds, valid


def _window_for(max_deg: Optional[int], seg, fanout: int) -> int:
    if max_deg is None or max_deg < 0:
        max_deg = int((seg[1:] - seg[:-1]).max()) if seg.numel() > 1 else 0
    return bucketed_window(max(int(max_deg), int(fanout)))


def neighbor_sample(seg, dst, n: int, m: int, seeds, key: int, *, fanout: int,
                    edge_words=None, max_deg: Optional[int] = None,
                    use_pallas: bool = False):
    """Sample ≤ ``fanout`` filtered out-neighbors per seed, one B3 launch.

    ``seg``/``dst``: the DI arrays (int32, on the sampling device);
    ``seeds``: internal ids; ``key``: integer priority key;
    ``edge_words``: packed (ceil(m/32),) edge-allowed bitmap (None = every
    edge).  Returns (nbrs, eids, mask) shaped (S_cap, fanout) with
    S_cap = ``bucketed_seeds(len(seeds))``; rows past the real seed count
    are fully masked.  ``use_pallas`` is kept for signature parity with the
    reference, where it opts a TPU kernel in; here B3 runs on every CUDA
    call, so it changes nothing."""
    del use_pallas
    cap = bucketed_seeds(_count(seeds))
    window = _window_for(max_deg, seg, fanout)
    sd, valid = _pad_seeds(seeds, cap, seg.device)
    _note_launch("one", (cap, window, int(fanout), edge_words is not None, n, m))
    u = _draw_priorities(key, (cap, window), seg.device)
    return _window_select(seg, dst, m, n, sd, valid, _words(edge_words, seg.device), u,
                          int(fanout))


def neighbor_sample_batched(seg, dst, n: int, m: int, seeds, valid, keys: Sequence[int], *,
                            fanout: int, edge_words=None,
                            max_deg: Optional[int] = None):
    """Coalesced entry: R stacked requests → ONE B3 launch.

    ``seeds``/``valid``: (R, S_cap) padded id rows; ``keys``: R integer
    per-request keys; ``edge_words``: (R, W_m) per-request packed edge
    filters or None.  Row r draws from ``keys[r]`` and reads row r of the
    edge words only, so it is bitwise the same request run alone at the
    same S_cap.  Returns (nbrs, eids, mask) shaped (R, S_cap, fanout)."""
    device = seg.device
    seeds = _as_device(seeds, device, torch.int32)
    valid = _as_device(valid, device, torch.bool)
    R, S = int(seeds.shape[0]), int(seeds.shape[1])
    keys = [int(k) for k in keys]
    if len(keys) != R:
        raise ValueError(f"{len(keys)} keys for {R} request rows")
    window = _window_for(max_deg, seg, fanout)
    _note_launch("many", (R, S, window, int(fanout), edge_words is not None, n, m))
    u = torch.stack([_draw_priorities(k, (S, window), device) for k in keys])
    return _window_select(seg, dst, m, n, seeds, valid, _words(edge_words, device), u,
                          int(fanout))


def neighbor_sample_from_words(seg, dst, n: int, m: int, seed_words, seed_count: int,
                               key: int, *, fanout: int, edge_words=None,
                               max_deg: Optional[int] = None):
    """Packed-seed entry: seeds arrive as a packed int32 bitmap (the
    ``match()`` combine's output words); ``seed_count`` (its popcount, the
    one scalar the host reads) picks the capacity bucket.  The ids are the
    set bits in ascending order, padded with ``n``.  Returns (seeds, valid,
    nbrs, eids, mask) with S_cap = ``bucketed_seeds(seed_count)``."""
    device = seg.device
    cap = bucketed_seeds(seed_count)
    window = _window_for(max_deg, seg, fanout)
    _note_launch("words", (cap, window, int(fanout), edge_words is not None, n, m))
    bits = bitplane.unpack_mask(_as_device(seed_words, device, torch.int32), n)
    found = torch.nonzero(bits).flatten()[:cap].to(torch.int32)
    idx = torch.full((cap,), n, dtype=torch.int32, device=device)
    idx[:found.numel()] = found
    valid = idx < n
    u = _draw_priorities(key, (cap, window), device)
    nbrs, eids, ok = _window_select(seg, dst, m, n, idx, valid, _words(edge_words, device), u,
                                    int(fanout))
    return idx, valid, nbrs, eids, ok


def sample_embed(seg, dst, n: int, m: int, seeds, key: int, table, *, fanout: int,
                 edge_words=None, max_deg: Optional[int] = None):
    """``sample+lookup``: sample filtered neighbors (B3), then mean-pool
    their embedding rows (plain torch: a gather and a masked mean).
    ``table``: (V, D) with V ≥ n.  Returns (bags (S_cap, D), nbrs, eids,
    mask); bags of fully-masked seeds are zero."""
    cap = bucketed_seeds(_count(seeds))
    window = _window_for(max_deg, seg, fanout)
    sd, valid = _pad_seeds(seeds, cap, seg.device)
    _note_launch("embed", (cap, window, int(fanout), edge_words is not None, n, m,
                           int(table.shape[-1])))
    u = _draw_priorities(key, (cap, window), seg.device)
    nbrs, eids, ok = _window_select(seg, dst, m, n, sd, valid, _words(edge_words, seg.device),
                                    u, int(fanout))
    rows = table[nbrs.to(torch.int64).clamp(0, table.shape[0] - 1)]  # (S, fanout, D)
    w = ok[..., None].to(table.dtype)
    cnt = ok.sum(dim=-1, keepdim=True).clamp(min=1).to(table.dtype)
    bags = (rows * w).sum(dim=1) / cnt  # all-masked seeds → 0
    return bags, nbrs, eids, ok
