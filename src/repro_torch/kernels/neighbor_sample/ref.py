"""Plain versions for the neighbor_sample kernel (B3, ``window_select``).

Two layers:

* :func:`window_select_ref` — the plain PyTorch version of the CUDA kernel,
  with its contract: per seed, the ``fanout`` allowed window lanes with the
  smallest priorities, ascending, ties to the lower lane.  The CPU path of
  ``ops.py`` runs it, and the kernel is held to it bitwise on the card.  It
  repeats the kernel's arithmetic and is no measure of speed.
* the numpy oracle — :func:`select_by_priority_ref` (exact selection given
  a priority matrix, one seed at a time) and :func:`check_sample`
  (structural validation of any sampled output against the CSR and edge
  filter, independent of randomness: every unmasked slot is a real,
  filter-allowed edge of its seed; no slot is sampled twice; the number of
  unmasked slots is exactly ``min(fanout, filtered degree)``; masked slots
  hold the -1 sentinel).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["bit_at", "window_select_ref", "filtered_degrees", "select_by_priority_ref",
           "check_sample"]


def bit_at(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bit ``idx`` of packed int32 words (the ``core.bitplane`` layout:
    bit ``e & 31`` of word ``e >> 5``) as bool.  ``words`` is ``(W_m,)`` or
    ``(R, W_m)``; in the second form ``idx`` is ``(R, ...)`` and row r reads
    its own words.  ``& 1`` drops the sign bits an arithmetic shift drags in."""
    idx = idx.to(torch.int64)
    if words.dim() == 1:
        w = words[idx >> 5]
    else:
        w = torch.gather(words.to(torch.int64), 1,
                         (idx >> 5).reshape(idx.shape[0], -1)).reshape(idx.shape)
    return ((w >> (idx & 31)) & 1).to(torch.bool)


def window_select_ref(start: torch.Tensor, deg: torch.Tensor, dst: torch.Tensor,
                      ew_words: Optional[torch.Tensor], pri: torch.Tensor, *,
                      fanout: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """start/deg: (..., S) int32 window offsets and effective degrees (0 for
    pad seeds); dst: (m,) int32; ew_words: packed int32 edge bitmap —
    ``(W_m,)`` shared, ``(R, W_m)`` one row per leading index of a
    ``(R, S)`` batch — or None (= all allowed); pri: (..., S, W) f32.

    Lane l of seed i (edge ``start[i] + l``) is allowed when
    ``l < deg[i]``, the edge exists (``< m``) and its bit is set.  Returns
    (nbrs, eids, mask) shaped (..., S, fanout): the allowed lanes with the
    smallest priorities, ascending, ties to the lower lane (a stable sort),
    -1 and False in the slots past the allowed count.
    """
    m = dst.shape[0]
    w = pri.shape[-1]
    lane = torch.arange(w, dtype=torch.int64, device=pri.device)
    eidx = start.to(torch.int64)[..., None] + lane
    allowed = (lane < deg.to(torch.int64)[..., None]) & (eidx < m)
    eidx_c = eidx.clamp(0, max(m - 1, 0))
    if ew_words is not None:
        allowed &= bit_at(ew_words, eidx_c)
    masked = torch.where(allowed, pri, torch.full((), float("inf"), dtype=pri.dtype,
                                                   device=pri.device))
    vals, sel = torch.sort(masked, dim=-1, stable=True)
    vals, sel = vals[..., :fanout], sel[..., :fanout]
    ok = vals < float("inf")
    sel_e = torch.gather(eidx_c, -1, sel)
    if m == 0:  # nothing can be allowed; no DST row to read
        neg = torch.full(ok.shape, -1, dtype=torch.int32, device=pri.device)
        return neg, neg.clone(), ok
    nbrs = torch.where(ok, dst[sel_e], -1).to(torch.int32)
    eids = torch.where(ok, sel_e, -1).to(torch.int32)
    return nbrs, eids, ok


# ------------------------------------------------------------ numpy oracle
def filtered_degrees(seg: np.ndarray, edge_ok, seeds: np.ndarray) -> np.ndarray:
    """Per-seed count of adjacency-window edges the filter allows."""
    seg = np.asarray(seg)
    seeds = np.asarray(seeds)
    out = np.zeros(seeds.shape[0], np.int64)
    for i, s in enumerate(seeds):
        lo, hi = int(seg[s]), int(seg[s + 1])
        if edge_ok is None:
            out[i] = hi - lo
        else:
            out[i] = int(np.asarray(edge_ok[lo:hi]).sum())
    return out


def select_by_priority_ref(seg, dst, seeds, edge_ok, priorities, fanout: int):
    """Reference selection: smallest-priority allowed lanes per seed.

    ``priorities`` is (S, W) float; lane w of seed i corresponds to global
    edge ``seg[seeds[i]] + w`` while in window.  Returns ``(nbrs, eids,
    mask)`` shaped (S, fanout): global neighbor ids / edge ids (-1 where
    masked), and the validity mask.
    """
    seg = np.asarray(seg)
    dst = np.asarray(dst)
    seeds = np.asarray(seeds)
    pri = np.asarray(priorities, np.float64)
    S, W = pri.shape
    nbrs = np.full((S, fanout), -1, np.int64)
    eids = np.full((S, fanout), -1, np.int64)
    mask = np.zeros((S, fanout), bool)
    for i in range(S):
        s = int(seeds[i])
        lo, hi = int(seg[s]), int(seg[s + 1])
        deg = min(hi - lo, W)
        lanes = [
            w for w in range(deg)
            if edge_ok is None or bool(np.asarray(edge_ok[lo + w]))
        ]
        # stable sort on priority → ties break to the lower lane
        lanes.sort(key=lambda w: (pri[i, w], w))
        for k, w in enumerate(lanes[:fanout]):
            eids[i, k] = lo + w
            nbrs[i, k] = dst[lo + w]
            mask[i, k] = True
    return nbrs, eids, mask


def check_sample(seg, dst, seeds, edge_ok, fanout: int,
                 nbrs, eids, mask) -> None:
    """Raise AssertionError unless (nbrs, eids, mask) is a valid
    without-replacement uniform-candidate sample of the filtered
    adjacency (module docstring).  RNG-independent."""
    seg = np.asarray(seg)
    dst = np.asarray(dst)
    seeds = np.asarray(seeds)
    nbrs = np.asarray(nbrs)
    eids = np.asarray(eids)
    mask = np.asarray(mask)
    want = np.minimum(filtered_degrees(seg, edge_ok, seeds), fanout)
    got = mask.sum(axis=1)
    assert (got == want).all(), (
        f"sampled-slot counts {got.tolist()} != min(fanout, filtered deg) "
        f"{want.tolist()}")
    for i, s in enumerate(seeds):
        lo, hi = int(seg[s]), int(seg[s + 1])
        live = eids[i][mask[i]]
        assert len(set(live.tolist())) == len(live), (
            f"seed {s}: duplicate edges sampled: {live.tolist()}")
        for e in live.tolist():
            assert lo <= e < hi, f"seed {s}: edge {e} outside window [{lo},{hi})"
            if edge_ok is not None:
                assert bool(np.asarray(edge_ok[e])), (
                    f"seed {s}: filtered-out edge {e} sampled")
        assert (nbrs[i][mask[i]] == dst[live]).all(), (
            f"seed {s}: neighbor ids disagree with DST at sampled edges")
        assert (nbrs[i][~mask[i]] == -1).all(), (
            f"seed {s}: masked slots must hold -1, got {nbrs[i][~mask[i]]}")
        assert (eids[i][~mask[i]] == -1).all()
