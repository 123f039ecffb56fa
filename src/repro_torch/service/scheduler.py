"""Micro-batching scheduler: many small queries → few large fused launches.

Two pieces, both policy-free about caches (the ``Service`` owns those):

* ``execute_coalesced(pg, plans)`` — the coalescing core.  A group of
  compatible plans (same graph, same version, same impl override) has ALL
  of its label mask steps materialized in ONE ``query_any_batched`` call on
  the vertex store and all relationship steps in one call on the edge
  store; on the ``arr`` backend each call is a single launch of the
  packed OR kernel B1 (``bitmap_query_batched_packed``: (Q, K) selects
  over the (K, W) word plane, Q the total mask count across requests) on
  the card.  Each request then runs its own constraint propagation via
  ``execute_plan_with_masks``.  ``list``/``listd`` stores have no batched
  kernel; they fall back to per-request ``execute_plan`` behind the same
  signature, so callers never branch on backend.  Variable-length
  traversal plans (``*`` hops) also run per-request — their propagation
  is a per-plan frontier loop, not a shareable mask launch — while the
  result cache still serves them (keys are the extended canonical text).

  Q varies with load, so mask batches are padded to ``bucketed_q(Q)``
  with empty queries (all-False mask rows → all-False result rows, dropped
  on distribution): the launch shapes stay within ``Q_BUCKETS``, as the
  reference's compiled shapes do, not every batch size the workload
  produces.

  Bitwise contract: the output list equals ``[execute_plan(pg, p) for p in
  plans]`` exactly, on every backend — including ``arr``'s packed combine,
  which ``execute_plan`` takes: the word OR and the bool masks it unpacks
  to carry the same bits, so fusing the steps into one launch changes
  schedules, never masks.

* ``MicroBatcher`` — the concurrency piece: a worker thread drains a queue
  of requests; the first request opens a batching window (``window_ms``)
  and everything arriving inside it (up to ``max_batch``) executes as one
  batch.  The window is ADAPTIVE by default: when the queue is empty at
  dequeue time (an idle service, c=1) the request executes immediately —
  no latency tax for batching that cannot happen — and the window opens
  only under queue pressure, where waiting actually buys coalescing; it
  also CLOSES early once the queue has stayed empty for a short grace
  period (``grace_ms``): coalescible arrivals land µs apart, so a queue
  that stays dry for the grace means every in-flight client is blocked
  on this very batch and the rest of the window would be pure stall.
  Single worker by design: device work serializes anyway (every launch
  goes on the card's default stream), and one consumer makes version
  reads and cache updates race-free.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.kernels.bitmap_query.ops import bucketed_q
from repro_torch.query import execute_plan, execute_plan_with_masks

__all__ = ["execute_coalesced", "MicroBatcher"]


def _batched_rows(store, values_list: Sequence, impl: Optional[str]) -> List:
    """All OR-queries in ``values_list`` through one ``query_any_batched``
    call, Q padded to the bucket size (pad queries are empty ⇒ zero mask
    rows, sliced off here)."""
    q = len(values_list)
    padded = list(values_list) + [()] * (bucketed_q(q) - q)
    rows = store.query_any_batched(padded, impl=impl)
    return [rows[i] for i in range(q)]


def execute_coalesced(pg, plans: Sequence, *, impl: Optional[str] = None,
                      stats: Optional[Dict[str, int]] = None) -> List:
    """Execute ``plans`` against ``pg``; returns one ``MatchResult`` per
    plan, bitwise-identical to sequential ``execute_plan`` calls.

    ``stats`` (optional mutable dict) is incremented in place:
    ``coalesced_launches`` (batched store calls made), ``coalesced_masks``
    (mask steps that went through them), ``fallback_requests`` (plans that
    ran the sequential path because the backend has no batched kernel),
    ``traversal_fallback_requests`` (variable-length plans, which always
    run per-request: their propagation is a per-plan frontier loop/layer
    unroll, not a shareable batched mask launch — see plan.has_traversal).
    """
    out: List = [None] * len(plans)
    trav = [i for i, p in enumerate(plans) if p.has_traversal]
    if trav:
        if stats is not None:
            stats["traversal_fallback_requests"] = (
                stats.get("traversal_fallback_requests", 0) + len(trav))
        for i in trav:
            out[i] = execute_plan(pg, plans[i])
    fixed = [i for i, p in enumerate(plans) if not p.has_traversal]
    if not fixed:
        return out

    n_masks = sum(len(plans[i].mask_steps) for i in fixed)
    if pg.backend != "arr" or n_masks < 2:
        # list/listd: per-request execution behind the same API (their
        # query_any_batched is a host loop — batching buys nothing); tiny
        # arr groups: a fused launch would fuse one mask, skip the ceremony
        if stats is not None and pg.backend != "arr":
            stats["fallback_requests"] = stats.get("fallback_requests", 0) + len(fixed)
        for i in fixed:
            out[i] = execute_plan(pg, plans[i])
        return out

    node_jobs = []  # (plan index, slot, values)
    edge_jobs = []
    for i in fixed:
        for s in plans[i].mask_steps:
            (node_jobs if s.kind == "node" else edge_jobs).append((i, s.slot, s.values))

    label_masks: Dict[int, Dict[int, object]] = {i: {} for i in fixed}
    rel_masks: Dict[int, Dict[int, object]] = {i: {} for i in fixed}
    launches = 0
    if node_jobs:
        rows = _batched_rows(pg._vstore, [j[2] for j in node_jobs], impl)
        for (i, slot, _), row in zip(node_jobs, rows):
            label_masks[i][slot] = row
        launches += 1
    if edge_jobs:
        rows = _batched_rows(pg._estore, [j[2] for j in edge_jobs], impl)
        for (i, slot, _), row in zip(edge_jobs, rows):
            rel_masks[i][slot] = row
        launches += 1
    if stats is not None:
        stats["coalesced_launches"] = stats.get("coalesced_launches", 0) + launches
        stats["coalesced_masks"] = stats.get("coalesced_masks", 0) + n_masks

    for i in fixed:
        out[i] = execute_plan_with_masks(pg, plans[i], label_masks[i], rel_masks[i])
    return out


class MicroBatcher:
    """Queue + worker thread turning a request stream into batches.

    ``execute_batch(requests)`` is the owner's callback (the ``Service``
    groups by graph/version there); it must never raise — per-request
    errors belong on the requests' futures.  ``submit`` after ``close``
    raises ``RuntimeError``.
    """

    _SENTINEL = object()

    def __init__(self, execute_batch: Callable[[List], None], *,
                 max_batch: int = 32, window_ms: float = 2.0,
                 adaptive: bool = True, grace_ms: float = 0.25,
                 metrics=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be ≥ 1, got {max_batch}")
        self._execute_batch = execute_batch
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.adaptive = adaptive
        self.grace_s = grace_ms / 1e3
        # optional obs.MetricsRegistry: batch occupancy + window wait
        # histograms (docs/ARCHITECTURE.md §13); instruments are created
        # here once so the worker loop never enters the registry lock
        self._m_occupancy = self._m_wait = None
        if metrics is not None:
            from repro_torch.obs.metrics import SIZE_BUCKETS

            self._m_occupancy = metrics.histogram(
                "pg_sched_batch_occupancy",
                "requests per executed micro-batch", buckets=SIZE_BUCKETS)
            self._m_wait = metrics.histogram(
                "pg_sched_window_wait_ms",
                "batch-window wait from first dequeue to execution")
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lifecycle = threading.Lock()  # orders submit vs close: nothing
        # can land behind the shutdown sentinel and silently never execute
        self._worker = threading.Thread(
            target=self._loop, name="pgserve-scheduler", daemon=True
        )
        self._worker.start()

    @property
    def closed(self) -> bool:
        return self._closed

    def submit(self, request) -> None:
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            self._queue.put(request)

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Drain-then-stop: requests enqueued before close still execute."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            self._queue.put(self._SENTINEL)
        self._worker.join(timeout=timeout)

    # ---------------------------------------------------------------- worker
    def _loop(self) -> None:
        while True:
            first = self._queue.get()
            if first is self._SENTINEL:
                return
            batch = [first]
            stop = False
            t_first = time.monotonic()
            # adaptive window: an empty queue means nothing can coalesce —
            # skip the window entirely (c=1 pays zero batching latency);
            # a non-empty queue means pressure, so the window opens and
            # late arrivals join the batch
            open_window = not (self.adaptive and self._queue.empty())
            deadline = time.monotonic() + (self.window_s if open_window else 0.0)
            while open_window and len(batch) < self.max_batch:
                # clamp: under load the deadline may already be in the past,
                # and a negative timeout must never reach the queue wait
                remaining = max(0.0, deadline - time.monotonic())
                try:
                    # remaining == 0 (window_ms=0 or expired) still drains
                    # whatever is already queued, without blocking
                    if remaining == 0.0:
                        req = self._queue.get_nowait()
                    elif self.adaptive:
                        # arrivals that will coalesce land µs apart; a
                        # queue that stays empty for a full grace period
                        # means nothing else is coming this window (a
                        # closed-loop client set is blocked on THIS batch)
                        # — execute instead of burning the rest of it
                        req = self._queue.get(
                            timeout=min(remaining, self.grace_s))
                    else:
                        req = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if req is self._SENTINEL:
                    stop = True
                    break
                batch.append(req)
            if self._m_occupancy is not None:
                self._m_occupancy.observe(len(batch))
                self._m_wait.observe((time.monotonic() - t_first) * 1e3)
            try:
                self._execute_batch(batch)
            except Exception as e:  # noqa: BLE001 — keep the worker alive
                # the callback contract says "never raise"; if it does,
                # fail the batch's futures instead of hanging their clients
                for req in batch:
                    fut = getattr(req, "future", None)
                    if fut is not None and not fut.done():
                        fut.set_exception(e)
            if stop:
                return
