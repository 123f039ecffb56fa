"""Service — the client-facing concurrent graph analytics API.

Wires the three subsystems together (the reference package's service
README walks the request lifecycle):

    registry (named, versioned graphs)
      └─ scheduler (micro-batches compatible requests, coalesces masks)
           ├─ plan cache    (canonical pattern, backend, impl) → Plan
           └─ result cache  (graph, canonical, impl)
                              → (version, pattern refs, MatchResult)
                            invalidated by mutation-event OVERLAP, so
                            entries survive unrelated writes (§11)

``submit()`` returns a ``concurrent.futures.Future`` immediately;
``query()`` blocks on one request; ``query_batch()`` is the synchronous
entry that runs a whole group through the coalesced path in the caller's
thread (deterministic batching — what the equivalence tests and benchmarks
use).  All device execution of the async path happens on one scheduler
thread, on the card's default stream, and cache bookkeeping has a single
writer for it.  Graphs live on their own device (the CUDA card unless they
were built with ``device="cpu"``); the service moves nothing between
devices.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import SIZE_BUCKETS, MetricsRegistry, render_prometheus
from repro_torch.obs.trace import Trace, TraceBuffer
from repro_torch.overlay.delta import overlaps, pattern_refs
from repro_torch.query import Pattern, execute_plan, parse, plan_pattern
from repro_torch.service.cache import LRUCache
from repro_torch.service.registry import GraphRegistry
from repro_torch.service.scheduler import MicroBatcher, execute_coalesced

__all__ = ["Service", "ServiceConfig"]


def _host(x) -> np.ndarray:
    """A result vector as host numpy (the analytics verbs' return type)."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs, all orthogonal.  ``coalesce=False`` + zero cache sizes turns
    the service into a plain per-request executor — the benchmark's
    sequential baseline inside the same machinery."""

    max_batch: int = 32  # requests per micro-batch
    window_ms: float = 2.0  # batching window opened by the first request
    adaptive_window: bool = True  # skip the window when the queue is empty
    # (c=1 pays no batching latency); open it only under queue pressure
    grace_ms: float = 0.25  # adaptive early close: end the window once the
    # queue has stayed empty this long (nothing more is coming to coalesce)
    plan_cache_size: int = 256
    result_cache_size: int = 256
    coalesce: bool = True  # fuse compatible mask steps into batched launches
    submit_fastpath: bool = True  # resolve result-cache hits at submit(),
    # before the queue — hot patterns skip the batching window entirely
    auto_compact_threshold: Optional[int] = None  # overlay entries per graph
    # before the background Compactor folds deltas into the base (None = off)
    trace_buffer: int = 256  # finished per-query traces kept in the ring
    # (0 = tracing off: no Trace objects allocated on the serve path)
    slow_query_ms: float = 250.0  # traces at/over this wall time are
    # mirrored into the slow-query log (0 = log every traced query)


@dataclasses.dataclass
class _Request:
    graph: str
    canonical: str
    ast: Pattern
    impl: Optional[str]
    future: Future
    trace: Optional[Trace] = None
    t_enqueue: float = 0.0  # perf_counter at submit → the batch.wait span


@dataclasses.dataclass
class _SampleRequest:
    """One neighborhood-sampling request (docs/ARCHITECTURE.md §15).

    ``seeds_or_pattern`` is either explicit original vertex ids or a
    Cypher-lite seed pattern; ``filter_canonical``/``filter_ast`` carry the
    optional khop-style edge filter; ``seed_val`` is the integer base key
    (layer keys are derived from it — the request samples bitwise-identically
    solo or coalesced).  ``cache_key`` is None for keyed-entropy
    (``deterministic=False``) requests, which are NEVER cached."""

    graph: str
    seeds_or_pattern: object
    fanouts: tuple
    filter_canonical: str
    filter_ast: Optional[Pattern]
    seed_val: int
    cache_key: Optional[tuple]
    refs: tuple
    future: Future
    trace: Optional[Trace] = None
    t_enqueue: float = 0.0


class Service:
    """In-process graph analytics service (see module docstring).

    Use as a context manager or call ``close()`` — the scheduler owns a
    worker thread.
    """

    def __init__(self, registry: Optional[GraphRegistry] = None, *,
                 config: Optional[ServiceConfig] = None):
        self.registry = registry if registry is not None else GraphRegistry()
        self.config = config if config is not None else ServiceConfig()
        self.plan_cache = LRUCache(self.config.plan_cache_size)
        self.result_cache = LRUCache(self.config.result_cache_size)
        self._canon_cache = LRUCache(512)  # raw text → (canonical, ast)
        # per-instance metrics registry (docs/ARCHITECTURE.md §13): request/
        # batch/cache counters live with THIS service — many short-lived
        # services in one test process keep independent stats() deltas.
        # The audit of the old `_stats` dict found its single-lock `_bump`
        # race-free but contended across the scheduler worker, session
        # writer threads and the compactor; per-counter locks replace it.
        self.metrics = MetricsRegistry()
        # per-key counter cache: _bump is on the submit fastpath, so it
        # must not pay the registry's key construction per call.  Plain
        # dict — GIL-atomic get/set, and counter identity is stable (the
        # registry dedups), so a racing double-store is benign.
        self._counters: Dict[str, object] = {}
        self._m_coalesce_width = self.metrics.histogram(
            "pg_sched_coalesce_width",
            "requests fused per coalesced launch", buckets=SIZE_BUCKETS)
        self.traces = TraceBuffer(maxlen=self.config.trace_buffer,
                                  slow_ms=self.config.slow_query_ms)
        self._sample_nonce = itertools.count()  # keyed-entropy requests
        self.registry.subscribe(self._on_mutation)
        self._batcher = MicroBatcher(
            self._execute_batch,
            max_batch=self.config.max_batch,
            window_ms=self.config.window_ms,
            adaptive=self.config.adaptive_window,
            grace_ms=self.config.grace_ms,
            metrics=self.metrics,
        )
        self._compactor = None
        if self.config.auto_compact_threshold is not None:
            from repro_torch.overlay.compactor import Compactor

            self._compactor = Compactor(
                self.registry, self.config.auto_compact_threshold)
            self._compactor.start()

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._compactor is not None:
            self._compactor.stop()
        self._batcher.close()
        # a shared registry must not keep feeding (and pinning) this
        # service's caches after shutdown
        self.registry.unsubscribe(self._on_mutation)

    def __enter__(self) -> "Service":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- graphs
    def add_graph(self, name: str, pg) -> "Service":
        """Register a built ``PropGraph`` under ``name``."""
        self.registry.register(name, pg)
        return self

    def load_graph(self, name: str, path: str, *, backend: Optional[str] = None,
                   mesh=None, device=None) -> "Service":
        """Reopen a saved graph on ``device`` (None: the CUDA card) and serve
        it; a ``mesh`` raises (ROADMAP A10)."""
        self.registry.load(name, path, backend=backend, mesh=mesh, device=device)
        return self

    def snapshot_graph(self, graph: str, name: Optional[str] = None) -> str:
        """Pin an immutable snapshot of ``graph`` and serve it under its own
        name (default ``"<graph>@s<version>"``).  The snapshot shares the
        parent's device-resident base — zero-copy — and never changes, so
        results cached under the snapshot name stay valid FOREVER while the
        parent keeps absorbing writes (docs/ARCHITECTURE.md §11).  Taking
        the same snapshot name at the same parent version is idempotent."""
        pg = self.registry.get(graph)
        name = name if name is not None else f"{graph}@s{pg.version}"
        try:
            existing = self.registry.get(name)
            if existing.frozen and existing.version == pg.version:
                return name  # same pin — keep it (and its cached results)
        except KeyError:
            pass
        self.registry.register(name, pg.snapshot())
        self._bump("snapshots")
        return name

    def fork_graph(self, graph: str, name: Optional[str] = None) -> str:
        """Register a writable copy-on-write view of ``graph`` (default name
        ``"<graph>@fork<version>"``) — the per-tenant what-if branch."""
        pg = self.registry.get(graph)
        name = name if name is not None else f"{graph}@fork{pg.version}"
        self.registry.register(name, pg.fork())
        self._bump("forks")
        return name

    def drop_graph(self, name: str) -> "Service":
        """Stop serving ``name`` (snapshot, fork or plain graph) and drop
        every result cached under it."""
        self.registry.unregister(name)
        dropped = self.result_cache.purge(lambda k, v: k[0] == name)
        if dropped:
            self._bump("invalidated_results", dropped)
        return self

    def compact_graph(self, name: str) -> Dict[str, int]:
        """Foreground compaction of ``name``'s overlay; returns the overlay
        stats that were folded in (all zero = it was already compact)."""
        pg = self.registry.get(name)
        stats = pg.delta_stats()
        pg.compact()
        return stats

    # --------------------------------------------------------------- clients
    def submit(self, graph: str, pattern: Union[str, Pattern], *,
               impl: Optional[str] = None,
               trace: Optional[Trace] = None) -> Future:
        """Enqueue one pattern query; returns its ``Future`` immediately.

        Parse errors surface here (caller's thread), not on the future —
        a malformed pattern is a client bug, not a serving failure.

        ``trace`` carries a caller-minted span tree (the wire server hands
        in one rooted at the client's trace id); with tracing enabled
        (``ServiceConfig.trace_buffer > 0``) an untraced submit mints its
        own.  The trace travels WITH the request across the thread hops
        and lands finished in ``Service.traces``."""
        if self._batcher.closed:
            # uniform closed-service contract: even a pattern the result
            # cache could answer raises, like every cache miss would
            raise RuntimeError("scheduler is closed")
        t0 = time.perf_counter()
        canonical, ast = self._canon(pattern)
        t1 = time.perf_counter()
        tr = trace
        if tr is None and self.config.trace_buffer > 0:
            tr = Trace("query")
        if tr is not None:
            tr.annotate(graph=graph, pattern=canonical)
            tr.add_span("parse", t0, t1)
        fut: Future = Future()
        self._bump("submitted")
        if self.config.submit_fastpath:
            if graph in self.registry:
                # entry liveness is maintained by overlap purging, not a
                # version key: a hit here may have been cached several
                # (non-overlapping) writes ago and is still exact (§11)
                hit = self.result_cache.get((graph, canonical, impl))
                if hit is not None:
                    self._bump("result_hits")
                    self._bump("fastpath_hits")
                    self._bump("completed")
                    if tr is not None:
                        tr.add_span("cache", t1, time.perf_counter(),
                                    hit=True, fastpath=True)
                    fut.set_result(hit[2])
                    if tr is not None:
                        self.traces.push(tr)
                    return fut
        self._batcher.submit(
            _Request(graph=graph, canonical=canonical, ast=ast, impl=impl,
                     future=fut, trace=tr, t_enqueue=time.perf_counter())
        )
        return fut

    def query(self, graph: str, pattern: Union[str, Pattern], *,
              impl: Optional[str] = None, timeout: Optional[float] = 60.0):
        """Blocking single query → ``MatchResult``."""
        return self.submit(graph, pattern, impl=impl).result(timeout=timeout)

    def query_batch(self, graph: str, patterns: Sequence[Union[str, Pattern]],
                    *, impl: Optional[str] = None) -> List:
        """Synchronous coalesced execution of ``patterns`` as ONE group in
        the caller's thread (bypasses the queue — batch composition is
        deterministic, which the bitwise-equivalence tests rely on).
        The first failing pattern's error raises; prior semantics of a
        plain loop of ``match()`` calls."""
        pg = self.registry.get(graph)
        positions: Dict[str, List[int]] = {}  # canonical → indices (dedup)
        canon_asts: Dict[str, Pattern] = {}
        for i, pat in enumerate(patterns):
            canonical, ast = self._canon(pat)
            if canonical in positions:
                self._bump("dedup_hits")
            else:
                canon_asts[canonical] = ast
            positions.setdefault(canonical, []).append(i)
        outcomes = self._serve_group(pg, graph, impl, canon_asts)
        out: List = [None] * len(patterns)
        for canonical, idxs in positions.items():
            res = outcomes[canonical]
            if isinstance(res, BaseException):
                raise res
            for i in idxs:
                out[i] = res
        self._bump("batches")
        self._bump("batched_requests", len(patterns))
        self._bump("completed", len(patterns))
        return out

    # -------------------------------------------------------------- sampling
    def submit_sample(self, graph: str, seeds_or_pattern, fanouts, *,
                      pattern: Union[str, Pattern, None] = None,
                      seed: int = 0, deterministic: bool = True,
                      trace: Optional[Trace] = None) -> Future:
        """Enqueue one ``PropGraph.sample`` request; Future → SampledBlock
        list (innermost first, internal ids — the §15 contract).

        The MicroBatcher coalesces sample requests across clients: same
        (graph, fanouts, seed-count bucket) → ONE batched layer-0 launch of
        B3, results keyed back out per request.  Each request draws only
        from its own ``layer_key``-derived keys, so the result is bitwise
        the solo run — coalescing changes schedules, never samples.

        ``deterministic=True`` (seeded) requests are cacheable — repeats
        of the same (graph, seeds, fanouts, filter, seed) serve from the
        result cache until a mutation invalidates them.
        ``deterministic=False`` ignores ``seed``, draws a fresh nonce per
        request, and is NEVER cached."""
        if self._batcher.closed:
            raise RuntimeError("scheduler is closed")
        fanouts = tuple(int(f) for f in fanouts)
        if not fanouts or min(fanouts) < 1:
            raise ValueError(f"fanouts must be ≥1 per layer, got {fanouts}")
        if pattern is not None:
            fcanon, fast = self._canon(pattern)
            refs = pattern_refs(fast)
        else:
            fcanon, fast = "", None
            refs = (frozenset(), frozenset(), frozenset())
        if isinstance(seeds_or_pattern, (str, Pattern)):
            scanon, sast = self._canon(seeds_or_pattern)
            seeds_or_pattern = sast
            sref = pattern_refs(sast)
            refs = tuple(a | b for a, b in zip(refs, sref))
            spec = f"p:{scanon}"
        else:
            seeds_or_pattern = np.asarray(seeds_or_pattern).ravel()
            spec = f"v:{','.join(str(int(s)) for s in seeds_or_pattern)}"
        if deterministic:
            seed_val = int(seed)
            cache_key = (graph,
                         f"sample:{spec}:f={fanouts}:q={fcanon}:s={seed_val}",
                         None)
        else:
            seed_val = (time.time_ns() ^ (next(self._sample_nonce) << 17)
                        ) & 0x7FFFFFFF
            cache_key = None
        tr = trace
        if tr is None and self.config.trace_buffer > 0:
            tr = Trace("sample")
        if tr is not None:
            tr.annotate(graph=graph, fanouts=str(fanouts), filter=fcanon)
        fut: Future = Future()
        self._bump("sample_requests")
        if (cache_key is not None and self.config.submit_fastpath
                and graph in self.registry):
            hit = self.result_cache.get(cache_key)
            if hit is not None:
                self._bump("result_hits")
                self._bump("fastpath_hits")
                self._bump("completed")
                fut.set_result(hit[2])
                if tr is not None:
                    self.traces.push(tr)
                return fut
        self._batcher.submit(_SampleRequest(
            graph=graph, seeds_or_pattern=seeds_or_pattern, fanouts=fanouts,
            filter_canonical=fcanon, filter_ast=fast, seed_val=seed_val,
            cache_key=cache_key, refs=refs, future=fut, trace=tr,
            t_enqueue=time.perf_counter()))
        return fut

    def sample(self, graph: str, seeds_or_pattern, fanouts, *,
               pattern: Union[str, Pattern, None] = None, seed: int = 0,
               deterministic: bool = True,
               timeout: Optional[float] = 60.0):
        """Blocking single sample → SampledBlock list."""
        return self.submit_sample(
            graph, seeds_or_pattern, fanouts, pattern=pattern, seed=seed,
            deterministic=deterministic).result(timeout=timeout)

    def sample_batch(self, graph: str, specs: Sequence, fanouts, *,
                     pattern: Union[str, Pattern, None] = None,
                     deterministic: bool = True) -> List:
        """Synchronous coalesced sampling: ``specs`` is a sequence of
        ``(seeds_or_pattern, prng_seed)`` pairs served as deterministic
        groups in the caller's thread (the ``query_batch`` analogue the
        parity tests and benchmarks drive).  A spec may also be a
        ``(seeds_or_pattern, prng_seed, edge_filter)`` triple, whose filter
        takes the place of ``pattern`` for that request — requests under
        different filters still share a group's launch, each row reading
        its own edge words (the reference takes pairs only).  Returns one
        block list per spec; the first failure raises."""
        futs = []
        reqs = []
        fanouts = tuple(int(f) for f in fanouts)
        for spec in specs:
            seeds, sv = spec[0], spec[1]
            filt = spec[2] if len(spec) > 2 else pattern
            fut: Future = Future()
            fut.set_running_or_notify_cancel()
            if filt is not None:
                fcanon, fast = self._canon(filt)
            else:
                fcanon, fast = "", None
            if isinstance(seeds, (str, Pattern)):
                _, seeds = self._canon(seeds)
            else:
                seeds = np.asarray(seeds).ravel()
            # cache_key stays None: this entry exists for deterministic
            # grouping (tests/benches), not caching
            reqs.append(_SampleRequest(
                graph=graph, seeds_or_pattern=seeds, fanouts=fanouts,
                filter_canonical=fcanon, filter_ast=fast,
                seed_val=int(sv), cache_key=None,
                refs=(frozenset(), frozenset(), frozenset()),
                future=fut))
            futs.append(fut)
        self._serve_samples(reqs, started=True)
        return [f.result(timeout=0) for f in futs]

    # ------------------------------------------------------------- analytics
    def shortest_paths(self, graph: str, seeds, *,
                       weight: Optional[str] = None,
                       pattern: Union[str, Pattern, None] = None,
                       undirected: bool = False,
                       max_iters: Optional[int] = None):
        """Serve ``PropGraph.shortest_paths`` under ``graph``: (n,) f32
        distances as host numpy.  Cached like pattern queries — the entry's
        footprint is the filter pattern's refs PLUS the weight property,
        so a write to ``weight``'s column invalidates it while unrelated
        property writes leave it live (§11, §12)."""
        canon_seeds = tuple(sorted({int(s) for s in np.ravel(seeds)}))
        params = (f"s={canon_seeds}:w={weight}:u={int(bool(undirected))}"
                  f":k={max_iters}")
        return self._analytics(
            graph, "shortest_paths", params, pattern, weight,
            lambda pg: pg.shortest_paths(
                list(canon_seeds), weight=weight, pattern=pattern,
                undirected=undirected, max_iters=max_iters))

    def pagerank(self, graph: str, *, weight: Optional[str] = None,
                 pattern: Union[str, Pattern, None] = None,
                 damping: float = 0.85, iters: int = 20):
        """Serve ``PropGraph.pagerank`` under ``graph``: (n,) f32 ranks as
        numpy, cached/invalidated like :meth:`shortest_paths`."""
        params = f"w={weight}:d={damping!r}:it={iters}"
        return self._analytics(
            graph, "pagerank", params, pattern, weight,
            lambda pg: pg.pagerank(pattern=pattern, weight=weight,
                                   damping=damping, iters=iters))

    def communities(self, graph: str, *,
                    pattern: Union[str, Pattern, None] = None,
                    max_iters: int = 64):
        """Serve ``PropGraph.communities`` under ``graph``: (n,) int32
        labels as numpy, cached/invalidated like :meth:`shortest_paths`."""
        params = f"k={max_iters}"
        return self._analytics(
            graph, "communities", params, pattern, None,
            lambda pg: pg.communities(pattern=pattern, max_iters=max_iters))

    def _analytics(self, graph: str, op: str, params: str,
                   pattern, weight: Optional[str], run):
        """Shared serve path for the semiring analytics verbs: result cache
        keyed ``(graph, "analytics:op:pattern:params", None)`` — key[0] is
        the graph name, so every existing purge path (drop, structural
        events, overlap tests against the stored refs) applies unchanged.
        Runs in the caller's thread (the mutator precedent): analytics hit
        the frontier engine directly, never the plan/coalesce pipeline.
        Consistency under concurrent mutators mirrors ``_serve_group``:
        version read before running, re-checked after, up to 3 attempts;
        a torn view is returned best-effort but never cached, and the
        put-then-purge guard drops an entry a racing write may have missed."""
        pg = self.registry.get(graph)
        if pattern is not None:
            canonical, ast = self._canon(pattern)
            refs = pattern_refs(ast)
        else:
            canonical, refs = "", (frozenset(), frozenset(), frozenset())
        if weight is not None:
            refs = (refs[0], refs[1], refs[2] | frozenset((str(weight),)))
        key = (graph, f"analytics:{op}:{canonical}:{params}", None)
        self._bump("analytics_requests")
        hit = self.result_cache.get(key)
        if hit is not None:
            self._bump("result_hits")
            return hit[2]
        self._bump("result_misses")
        res = None
        for attempt in range(3):
            version = pg.version
            try:
                res = _host(run(pg))
            except Exception:
                if pg.version != version and attempt < 2:
                    continue  # a concurrent mutation tore the view — retry
                self._bump("errors")
                raise
            if pg.version == version:
                self.result_cache.put(key, (version, refs, res))
                if pg.version != version:
                    # a write landed between the stability check and the
                    # put — drop our own entry (see _serve_group)
                    self.result_cache.purge(lambda kk, vv, _k=key: kk == _k)
                break
        return res

    # ----------------------------------------------------------------- stats
    def stats(self) -> Dict[str, object]:
        """Counter snapshot: request/batch totals, coalescing activity,
        cache hit/miss/eviction/invalidation accounting.  Backed by the
        per-service metrics registry — the same instruments the Prometheus
        exposition renders, so the two views cannot disagree.  Legacy flat
        keys (``submitted``, ``result_hits``, …) are unchanged; registry
        histograms appear under their ``pg_``-prefixed names as dicts."""
        out: Dict[str, object] = self.metrics.snapshot()
        out["plan_cache"] = self.plan_cache.stats()
        out["result_cache"] = self.result_cache.stats()
        if self._compactor is not None:
            # background compactions and their failures must be visible to
            # operators — a failing graph is skipped, never silently retried
            out["compactor"] = self._compactor.stats()
        return out

    def metrics_text(self) -> str:
        """Prometheus text exposition: this service's registry (request/
        batch/cache counters, scheduler histograms) plus the process
        ``GLOBAL`` registry (wire, executor, compactor).  Cache and
        compactor internals keep their own counters; they are mirrored
        into labeled instruments here at render time so the scrape always
        agrees with ``stats()``."""
        for tier, cache in (("plan", self.plan_cache),
                            ("result", self.result_cache)):
            s = cache.stats()
            for k in ("hits", "misses", "evictions"):
                self.metrics.counter(
                    f"pg_cache_{k}", f"LRU cache {k} by tier",
                    tier=tier).set_total(s[k])
            self.metrics.gauge(
                "pg_cache_size", "LRU cache live entries",
                tier=tier).set(s["size"])
            self.metrics.gauge(
                "pg_cache_maxsize", "LRU cache capacity",
                tier=tier).set(s["maxsize"])
        # compactor sweeps/failures live in GLOBAL (pg_compact_*): the
        # Compactor instruments itself, so nothing to mirror here
        return render_prometheus(self.metrics, obs_metrics.GLOBAL)

    def trace_log(self) -> List[Dict[str, object]]:
        """Finished per-query trace trees, oldest first (bounded ring)."""
        return self.traces.traces()

    def slow_queries(self) -> List[Dict[str, object]]:
        """Traces that ran at/over ``ServiceConfig.slow_query_ms``."""
        return self.traces.slow()

    def _bump(self, key: str, n: int = 1) -> None:
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = self.metrics.counter(key)
        c.inc(n)

    # ------------------------------------------------------------- internals
    def _canon(self, pattern: Union[str, Pattern]):
        """Pattern → (canonical text, AST); the canonical form is
        ``parse(...).to_text()``, so textual variants ("(a)-[]->(b)" with
        odd spacing) share cache entries."""
        if isinstance(pattern, Pattern):
            return pattern.to_text(), pattern
        cached = self._canon_cache.get(pattern)
        if cached is not None:
            return cached
        ast = parse(pattern)
        entry = (ast.to_text(), ast)
        self._canon_cache.put(pattern, entry)
        return entry

    def _plan(self, pg, canonical: str, ast: Pattern, impl: Optional[str]):
        key = (canonical, pg.backend, impl)
        plan = self.plan_cache.get(key)
        if plan is not None:
            self._bump("plan_hits")
            return plan
        self._bump("plan_misses")
        plan = plan_pattern(pg, ast, impl=impl)
        self.plan_cache.put(key, plan)
        return plan

    def _execute_plans(self, pg, plans: List, impl: Optional[str]) -> List:
        if not self.config.coalesce:
            return [execute_plan(pg, p) for p in plans]
        local: Dict[str, int] = {}
        results = execute_coalesced(pg, plans, impl=impl, stats=local)
        for k, v in local.items():
            self._bump(k, v)
        self._m_coalesce_width.observe(len(plans))
        return results

    def _serve_group(self, pg, graph: str, impl: Optional[str],
                     canon_asts: Dict[str, Pattern],
                     timings: Optional[Dict[str, object]] = None
                     ) -> Dict[str, object]:
        """The serve pipeline for ONE deduplicated group: result-cache
        probe → per-request planning → coalesced execution → cache put.
        Returns canonical → ``MatchResult`` or ``Exception`` — both entry
        points (``query_batch`` and the scheduler worker) fan the outcomes
        out to their callers.

        Failure isolation: planning errors (bad property names etc.) fail
        only their own request; if the COALESCED execution raises, the
        group re-runs per-request so one poisoned plan cannot take down
        co-batched tenants.  Consistency under concurrent mutators: the
        version is read before executing and re-checked after — a
        mid-flight mutation (torn graph/store view) retries the group and
        nothing torn is ever cached or returned as authoritative.

        ``timings`` (optional mutable dict) receives the group's stage
        endpoints — ``cache``/``plan``/``execute`` → ``(t0, t1)`` in
        ``perf_counter`` seconds plus ``cache_hits`` (canonicals served
        from cache) — measured ONCE per group; the batch path copies them
        into every member request's trace."""
        t_cache0 = time.perf_counter()
        outcomes: Dict[str, object] = {}
        todo: Dict[str, Pattern] = {}
        for canonical, ast in canon_asts.items():
            hit = self.result_cache.get((graph, canonical, impl))
            if hit is not None:
                self._bump("result_hits")
                outcomes[canonical] = hit[2]
            else:
                self._bump("result_misses")
                todo[canonical] = ast
        t_cache1 = time.perf_counter()
        if timings is not None:
            timings["cache"] = (t_cache0, t_cache1)
            timings["cache_hits"] = set(outcomes)
        if not todo:
            return outcomes

        plans: Dict[str, object] = {}
        for canonical, ast in todo.items():
            try:
                plans[canonical] = self._plan(pg, canonical, ast, impl)
            except Exception as e:  # noqa: BLE001 — isolated to this request
                outcomes[canonical] = e
                self._bump("errors")
        t_plan1 = time.perf_counter()
        if timings is not None:
            timings["plan"] = (t_cache1, t_plan1)
        if not plans:
            return outcomes

        keys = list(plans)
        results: List[object] = []
        stable = False
        for attempt in range(3):
            version = pg.version
            try:
                results = self._execute_plans(pg, [plans[c] for c in keys], impl)
            except Exception as e:  # noqa: BLE001
                if pg.version != version and attempt < 2:
                    continue  # a concurrent mutation tore the view — retry
                # the group itself failed: isolate by per-request execution
                results = []
                for c in keys:
                    try:
                        results.append(execute_plan(pg, plans[c]))
                    except Exception as ee:  # noqa: BLE001
                        results.append(ee)
                break
            if pg.version == version:
                stable = True
                break  # consistent snapshot — safe to cache
        if timings is not None:
            timings["execute"] = (t_plan1, time.perf_counter())
        put_keys = []
        for c, res in zip(keys, results):
            if isinstance(res, BaseException):
                outcomes[c] = res
                self._bump("errors")
            else:
                if stable:
                    refs = pattern_refs(canon_asts[c])
                    self.result_cache.put((graph, c, impl), (version, refs, res))
                    put_keys.append((graph, c, impl))
                outcomes[c] = res
        if put_keys and pg.version != version:
            # a write landed between the stability check and the put: the
            # overlap purge it triggered may have run BEFORE our put made
            # the entry visible — without a version in the key that entry
            # would now serve stale hits forever, so drop our own puts
            for k in put_keys:
                self.result_cache.purge(lambda kk, vv, _k=k: kk == _k)
        return outcomes

    def _resolve_sample_seeds(self, pg, seeds_or_pattern) -> np.ndarray:
        """Request seeds → internal ids, exactly ``PropGraph.sample``'s
        rule: pattern seeds are the first node variable's matches in
        ascending internal order (what the device ``nonzero`` extraction
        yields); explicit ids keep caller order, unknown and tombstoned
        ids drop out."""
        if isinstance(seeds_or_pattern, (str, Pattern)):
            res = pg.match(seeds_or_pattern)
            mask = res.node_masks[0] if res.node_masks else res.vertex_mask
            return np.flatnonzero(mask.cpu().numpy()).astype(np.int32)
        return pg._seed_ids(seeds_or_pattern).astype(np.int32)

    def _serve_samples(self, reqs: List[_SampleRequest],
                       started: bool = False) -> None:
        """Serve a window's sample requests: cache probe → seed resolution
        → group by (graph, fanouts, seed-count bucket) → ONE batched
        layer-0 launch per group + per-request deeper layers.  The group
        key carries the CAPACITY BUCKET because the per-request uniform
        draw is shaped (bucket, window): equal buckets are what make a
        coalesced row bitwise its solo run.  Never raises — failures land
        on the affected futures."""
        from repro_torch.kernels.neighbor_sample import bucketed_seeds

        groups: Dict[tuple, List] = {}
        for r in reqs:
            if not started and not r.future.set_running_or_notify_cancel():
                continue
            try:
                pg = self.registry.get(r.graph)
            except KeyError as e:
                r.future.set_exception(e)
                self._bump("errors")
                continue
            if r.cache_key is not None:
                hit = self.result_cache.get(r.cache_key)
                if hit is not None:
                    self._bump("result_hits")
                    self._bump("completed")
                    r.future.set_result(hit[2])
                    if r.trace is not None:
                        self.traces.push(r.trace)
                    continue
                self._bump("result_misses")
            try:
                ids = self._resolve_sample_seeds(pg, r.seeds_or_pattern)
            except Exception as e:  # noqa: BLE001 — isolated to this request
                r.future.set_exception(e)
                self._bump("errors")
                continue
            key = (r.graph, r.fanouts, bucketed_seeds(max(ids.size, 1)))
            groups.setdefault(key, []).append((r, pg, ids))
        for (gname, fanouts, cap), entries in groups.items():
            self._serve_sample_group(gname, fanouts, cap, entries)

    def _serve_sample_group(self, gname: str, fanouts: tuple, cap: int,
                            entries: List) -> None:
        """One coalesced group: R request rows (padded to the request
        bucket) through ``neighbor_sample_batched`` — layer 0 of every
        request in ONE B3 launch, each row with its own edge words — then
        each request finishes its deeper layers via
        ``PropGraph._sample_rest`` (identical keys to a solo run).  Every
        request takes ``_sample_edge_words`` of its filter, as ``sample``
        does: on a graph with tombstones an unfiltered request's words are
        the alive edges, not None.  Version consistency mirrors
        ``_serve_group``: read before, re-check after, up to 3 attempts;
        torn views are returned best-effort but never cached."""
        from repro_torch.core import bitplane
        from repro_torch.graph import sampler
        from repro_torch.kernels.neighbor_sample import (
            bucketed_requests,
            neighbor_sample_batched,
        )

        pg = entries[0][1]
        R = len(entries)
        results: List[object] = [None] * R
        version = None
        stable = False
        for attempt in range(3):
            version = pg.version
            try:
                seg, dstv, max_deg, perm = pg._sampling_view()
                g = pg._require_graph()
                ew_rows, any_words = [], False
                for r, _pg, _ids in entries:
                    ew = pg._sample_edge_words(
                        r.filter_canonical if r.filter_canonical else None,
                        perm)
                    ew_rows.append(ew)
                    any_words = any_words or ew is not None
                nw = bitplane.n_words(max(g.m, 1))
                rcap = bucketed_requests(R)
                seeds_m = np.zeros((rcap, cap), np.int32)
                valid_m = np.zeros((rcap, cap), bool)
                seedvals = np.zeros((rcap,), np.int64)
                for i, (r, _pg, ids) in enumerate(entries):
                    s = min(ids.size, cap)
                    seeds_m[i, :s] = ids[:s]
                    valid_m[i, :s] = True
                    seedvals[i] = r.seed_val
                seedvals[R:] = seedvals[R - 1]  # pad rows: all-invalid
                # all R layer-0 keys at once; row i is
                # layer_key(seed_i, 0), the solo-run key
                keys = sampler.layer_keys_batch(seedvals, 0)
                words_m = None
                if any_words:
                    # the all-ones row: int32 -1, the uint32 bits 0xFFFFFFFF
                    ones = torch.full((nw,), -1, dtype=torch.int32, device=g.device)
                    words_m = torch.stack([
                        (ones if ew is None else ew) for ew in ew_rows
                    ] + [ones] * (rcap - R))
                nb, _ei, mk = neighbor_sample_batched(
                    seg, dstv, g.n, g.m, seeds_m, valid_m, keys.tolist(),
                    fanout=fanouts[0], edge_words=words_m, max_deg=max_deg)
                nb_h, mk_h = nb.cpu().numpy(), mk.cpu().numpy()
                self._bump("sample_coalesced_launches")
                for i, (r, _pg, ids) in enumerate(entries):
                    s = min(ids.size, cap)
                    try:
                        results[i] = pg._sample_rest(
                            ids[:s], nb_h[i, :s], mk_h[i, :s], list(fanouts),
                            int(r.seed_val), seg, dstv, max_deg, ew_rows[i])
                    except Exception as e:  # noqa: BLE001
                        results[i] = e
            except Exception as e:  # noqa: BLE001
                if pg.version != version and attempt < 2:
                    continue  # a concurrent mutation tore the view — retry
                results = [e] * R
                break
            if pg.version == version:
                stable = True
                break
        put_keys = []
        for (r, _pg, _ids), res in zip(entries, results):
            if isinstance(res, BaseException):
                r.future.set_exception(res)
                self._bump("errors")
            else:
                if stable and r.cache_key is not None:
                    self.result_cache.put(r.cache_key,
                                          (version, r.refs, res))
                    put_keys.append(r.cache_key)
                r.future.set_result(res)
                self._bump("completed")
            if r.trace is not None:
                self.traces.push(r.trace)
        if put_keys and pg.version != version:
            # the _serve_group put-then-purge guard: a write racing the put
            # may have purged before our entry became visible — drop ours
            for k in put_keys:
                self.result_cache.purge(lambda kk, vv, _k=k: kk == _k)

    def _on_mutation(self, name: str, pg) -> None:
        """Registry subscriber: drop result-cache entries the mutation can
        have changed.  Attribute-scoped events (``pg.last_mutation``) purge
        by OVERLAP with each entry's pattern footprint — a result cached at
        snapshot S survives writes that only grew the delta chain past S
        with attributes its pattern never reads.  Structural events (edge
        inserts/deletes, rebuilds, compaction, registration) and graphs
        without event info purge everything under the name (§11)."""
        ev = getattr(pg, "last_mutation", None)
        if ev is None or ev.structural:
            dropped = self.result_cache.purge(lambda k, v: k[0] == name)
        else:
            dropped = self.result_cache.purge(
                lambda k, v, _ev=ev: k[0] == name and overlaps(_ev, v[1]))
        self._bump("invalidation_events")
        if dropped:
            self._bump("invalidated_results", dropped)

    def _execute_batch(self, batch: List[_Request]) -> None:
        """MicroBatcher callback: group compatible requests, serve cache
        hits, run the rest coalesced.  Never raises — failures land on the
        affected futures."""
        self._bump("batches")
        self._bump("batched_requests", len(batch))
        samples = [r for r in batch if isinstance(r, _SampleRequest)]
        if samples:
            self._serve_samples(samples)
        groups: Dict[tuple, List[_Request]] = {}
        for req in batch:
            if isinstance(req, _SampleRequest):
                continue
            groups.setdefault((req.graph, req.impl), []).append(req)
        for (gname, impl), reqs in groups.items():
            try:
                pg = self.registry.get(gname)
            except KeyError as e:
                for r in reqs:
                    if r.future.set_running_or_notify_cancel():
                        r.future.set_exception(e)
                        self._bump("errors")
                        if r.trace is not None:
                            r.trace.annotate(error="KeyError")
                            self.traces.push(r.trace)
                continue
            # duplicate canonicals inside one window execute ONCE and fan
            # the result out (the multi-tenant hot-pattern case)
            by_canonical: Dict[str, List[_Request]] = {}
            canon_asts: Dict[str, Pattern] = {}
            for r in reqs:
                if not r.future.set_running_or_notify_cancel():
                    continue  # client cancelled while queued
                if r.canonical in by_canonical:
                    self._bump("dedup_hits")
                else:
                    canon_asts[r.canonical] = r.ast
                by_canonical.setdefault(r.canonical, []).append(r)
            if not by_canonical:
                continue
            traced = [r for rs in by_canonical.values() for r in rs
                      if r.trace is not None]
            t_batch = time.perf_counter()
            for r in traced:
                r.trace.add_span("batch.wait", r.t_enqueue, t_batch,
                                 batch_size=len(batch))
            timings: Optional[Dict[str, object]] = {} if traced else None
            outcomes = self._serve_group(pg, gname, impl, canon_asts,
                                         timings=timings)
            for canonical, rs in by_canonical.items():
                res = outcomes[canonical]
                for r in rs:
                    if r.trace is not None and timings is not None:
                        hits = timings.get("cache_hits", ())
                        for stage in ("cache", "plan", "execute"):
                            tt = timings.get(stage)
                            if tt is None:
                                continue
                            attrs = ({"hit": canonical in hits}
                                     if stage == "cache" else {})
                            r.trace.add_span(stage, tt[0], tt[1], **attrs)
                    if isinstance(res, BaseException):
                        r.future.set_exception(res)
                    else:
                        r.future.set_result(res)
                        self._bump("completed")
                    if r.trace is not None:
                        self.traces.push(r.trace)
