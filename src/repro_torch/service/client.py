"""pgd client — the lightweight Python side of the wire (ARCHITECTURE §9).

The paper's interactivity story (§III, §VI) depends on the client staying
thin: it holds no graph data, just names — every byte of real work happens
where the graphs and devices live.  ``PGClient`` speaks the ``wire`` frame
format over one TCP connection and exposes the same verbs as the
in-process ``Service`` plus the registry's mutators:

    with PGClient(port=p) as c:
        c.load_graph("social", "/data/social.pg")
        res = c.query("social", "(a:person)-[:follows]->(b:person)")
        res.vertex_mask, res.bindings()          # numpy, bitwise == match()

    # pipelined: all requests go out before any response is read, so the
    # server's micro-batcher sees them as ONE pressure wave and coalesces
    handles = [c.submit("social", p) for p in patterns]
    results = [h.result() for h in handles]      # same as query_batch(...)

The client's payloads are numpy: it holds no graph and builds no tensor,
and it speaks the reference package's frame format byte for byte, so it
talks to either package's server.

A ``PGClient`` is one session: requests carry monotone ids, responses may
arrive out of order (cache fastpath hits overtake executing batches) and
are matched back by id.  One OS thread per client — instances are NOT
thread-safe; concurrent client threads each open their own connection
(that is the multi-process tenancy model, and what ``pgserve``'s
``run_workload_net`` measures).
"""
from __future__ import annotations

import socket
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.trace import new_trace_id
from repro_torch.service import wire
from repro_torch.service.wire import WireMatchResult

__all__ = ["PGClient", "PGFuture", "PGSampleFuture"]


class PGFuture:
    """Handle for one pipelined request; ``result()`` blocks on its id.

    After ``result()`` returns, ``trace`` holds the server's span tree for
    this query (dict, rooted at the trace id this client minted) when the
    server has tracing enabled — ``None`` before resolution or when the
    server traced nothing."""

    def __init__(self, client: "PGClient", rid: int,
                 trace_id: Optional[str] = None):
        self._client = client
        self._rid = rid
        self.trace_id = trace_id
        self.trace: Optional[Dict] = None

    def result(self, timeout: Optional[float] = None) -> WireMatchResult:
        header, arrays = self._client._wait_frame(self._rid, timeout=timeout)
        self.trace = header.get("trace")
        if self.trace is not None:
            self._client.last_trace = self.trace
        if "result" in header:
            return wire.wire_to_result(header["result"], arrays)
        return header


class PGSampleFuture:
    """Handle for one pipelined ``sample`` request; ``result()`` → block
    list.  ``trace`` fills in after resolution like :class:`PGFuture`."""

    def __init__(self, client: "PGClient", rid: int,
                 trace_id: Optional[str] = None):
        self._client = client
        self._rid = rid
        self.trace_id = trace_id
        self.trace: Optional[Dict] = None

    def result(self, timeout: Optional[float] = None
               ) -> List[wire.WireSampledBlock]:
        header, arrays = self._client._wait_frame(self._rid, timeout=timeout)
        self.trace = header.get("trace")
        if self.trace is not None:
            self._client.last_trace = self.trace
        return wire.wire_to_blocks(header["sample"], arrays)


class PGClient:
    """Blocking + pipelined client for ``PGServer`` (module docstring)."""

    def __init__(self, host: str = "127.0.0.1", *, port: int,
                 connect_timeout: float = 30.0,
                 timeout: Optional[float] = 120.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._timeout = timeout
        self._sock.settimeout(timeout)
        self._next_id = 0
        self._broken: Optional[str] = None  # why the stream is unusable
        self._stash: Dict[int, tuple] = {}  # id → (header, arrays) arrived
        # while we were waiting for a different id (out-of-order responses)
        self.trace = True  # mint a trace id per query; the server's span
        # tree comes back on the handle (PGFuture.trace / last_trace)
        self.last_trace: Optional[Dict] = None  # most recent query's tree

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "PGClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- plumbing
    def _send(self, op: str, arrays: Sequence[np.ndarray] = (),
              **fields) -> int:
        if self._broken is not None:
            raise ConnectionError(f"client is unusable: {self._broken}")
        self._next_id += 1
        rid = self._next_id
        header = {"op": op, "id": rid, **fields}
        try:
            wire.send_msg(self._sock, header, arrays)
        except OSError as e:
            # a partial frame may be on the wire — the stream is desynced,
            # same fail-fast treatment as the read path
            self._broken = f"{type(e).__name__}: {e}"
            raise
        return rid

    def _wait_frame(self, rid: int, timeout: Optional[float] = None):
        """Read frames until ``rid``'s response arrives; other ids are
        stashed for their own waiters (pipelining).  Returns the raw
        ``(header, arrays)`` frame after the ok-check — the analytics
        verbs consume the array blobs directly.

        ``timeout`` overrides the connection default for THIS wait only
        (``None`` keeps the default).  A timeout mid-frame leaves the
        stream positioned mid-message, so the client is marked broken —
        every later call fails fast instead of misparsing bytes."""
        if self._broken is not None:
            raise ConnectionError(f"client is unusable: {self._broken}")
        if timeout is not None:
            self._sock.settimeout(timeout)
        try:
            while rid not in self._stash:
                try:
                    header, arrays = wire.recv_msg(self._sock)
                except (socket.timeout, wire.ProtocolError) as e:
                    self._broken = f"{type(e).__name__}: {e}"
                    raise
                self._stash[header["id"]] = (header, arrays)
        finally:
            if timeout is not None:
                self._sock.settimeout(self._timeout)
        header, arrays = self._stash.pop(rid)
        if not header.get("ok"):
            raise wire.wire_to_exc(header["error"])
        return header, arrays

    def _wait(self, rid: int, timeout: Optional[float] = None):
        header, arrays = self._wait_frame(rid, timeout=timeout)
        if "result" in header:
            return wire.wire_to_result(header["result"], arrays)
        return header

    def _call(self, op: str, arrays: Sequence[np.ndarray] = (), **fields):
        return self._wait(self._send(op, arrays, **fields))

    # -------------------------------------------------------------- queries
    def submit(self, graph: str, pattern: str, *,
               impl: Optional[str] = None) -> PGFuture:
        """Pipelined query: sends the request, returns without reading.

        Every handle should eventually be ``result()``-ed: a response whose
        handle is abandoned stays stashed on the client for the life of
        the connection (the stream has no way to un-receive it)."""
        tid = new_trace_id() if self.trace else None
        return PGFuture(self, self._send("query", graph=graph,
                                         pattern=pattern, impl=impl,
                                         trace=tid),
                        trace_id=tid)

    def query(self, graph: str, pattern: str, *,
              impl: Optional[str] = None) -> WireMatchResult:
        return self.submit(graph, pattern, impl=impl).result()

    def query_batch(self, graph: str, patterns: Sequence[str], *,
                    impl: Optional[str] = None) -> List[WireMatchResult]:
        """All requests on the wire before any response is read — the
        server's batching window sees the whole group.  Every handle is
        awaited even when one fails (their responses would otherwise pile
        up in the stash for the life of the connection); the first failure
        then raises, matching ``Service.query_batch``."""
        handles = [self.submit(graph, p, impl=impl) for p in patterns]
        results: List[WireMatchResult] = []
        first_err: Optional[BaseException] = None
        for h in handles:
            try:
                results.append(h.result())
            except ConnectionError:
                raise  # stream is dead/desynced: nothing more will arrive
            except BaseException as e:  # noqa: BLE001
                if first_err is None:
                    first_err = e
                results.append(None)
        if first_err is not None:
            raise first_err
        return results

    def explain(self, graph: str, pattern: str, *,
                impl: Optional[str] = None) -> str:
        return self._call("explain", graph=graph, pattern=pattern,
                          impl=impl)["explain"]

    # ------------------------------------------------------------- sampling
    def submit_sample(self, graph: str, seeds_or_pattern, fanouts, *,
                      pattern: Optional[str] = None, seed: int = 0,
                      deterministic: bool = True) -> "PGSampleFuture":
        """Pipelined fused neighborhood sample (ARCHITECTURE §15).

        ``seeds_or_pattern`` is either a Cypher-lite pattern string (seeds
        = its matched anchor vertices, selected server-side without the
        mask ever visiting this client) or an array of external vertex
        ids.  ``pattern`` filters which EDGES may be sampled; ``seed``
        keys the PRNG — with ``deterministic=True`` the result is bitwise
        reproducible (and server-cacheable), with ``deterministic=False``
        the server mixes in fresh entropy per request.  Handles returned
        before any ``result()`` call land in the server's batching window
        together and coalesce into one launch per (graph, fanouts,
        bucket) group."""
        fanouts = [int(f) for f in fanouts]
        tid = new_trace_id() if self.trace else None
        fields = dict(graph=graph, fanouts=fanouts, pattern=pattern,
                      seed=int(seed), deterministic=bool(deterministic),
                      trace=tid)
        if isinstance(seeds_or_pattern, str):
            rid = self._send("sample", seed_pattern=seeds_or_pattern,
                             **fields)
        else:
            rid = self._send(
                "sample", [np.asarray(seeds_or_pattern, np.int64)], **fields)
        return PGSampleFuture(self, rid, trace_id=tid)

    def sample(self, graph: str, seeds_or_pattern, fanouts, *,
               pattern: Optional[str] = None, seed: int = 0,
               deterministic: bool = True) -> List[wire.WireSampledBlock]:
        """Blocking fused sample → ``WireSampledBlock`` list (innermost
        layer first, ids in the server graph's internal space — bitwise
        the in-process ``PropGraph.sample`` blocks for the same key)."""
        return self.submit_sample(
            graph, seeds_or_pattern, fanouts, pattern=pattern, seed=seed,
            deterministic=deterministic).result()

    # ------------------------------------------------------------ analytics
    def shortest_paths(self, graph: str, seeds, *,
                       weight: Optional[str] = None,
                       pattern: Optional[str] = None,
                       undirected: bool = False,
                       max_iters: Optional[int] = None) -> np.ndarray:
        """Weighted multi-source shortest paths server-side: (n,) f32
        distances (+inf = unreachable), result-cached on the server under
        the pattern's refs plus the ``weight`` property."""
        _, arrays = self._wait_frame(self._send(
            "analytics", [np.asarray(seeds, np.int64)], analytic="shortest_paths",
            graph=graph, weight=weight, pattern=pattern,
            undirected=undirected, max_iters=max_iters))
        return arrays[0]

    def pagerank(self, graph: str, *, weight: Optional[str] = None,
                 pattern: Optional[str] = None, damping: float = 0.85,
                 iters: int = 20) -> np.ndarray:
        """PageRank over the server's (optionally pattern-filtered,
        optionally weighted) graph: (n,) f32 ranks."""
        _, arrays = self._wait_frame(self._send(
            "analytics", (), analytic="pagerank", graph=graph, weight=weight,
            pattern=pattern, damping=damping, iters=iters))
        return arrays[0]

    def communities(self, graph: str, *, pattern: Optional[str] = None,
                    max_iters: int = 64) -> np.ndarray:
        """Label-propagation communities server-side: (n,) i32 labels
        (-1 = outside the filter)."""
        _, arrays = self._wait_frame(self._send(
            "analytics", (), analytic="communities", graph=graph,
            pattern=pattern, max_iters=max_iters))
        return arrays[0]

    # ------------------------------------------------------------- registry
    def load_graph(self, name: str, path: str, *,
                   backend: Optional[str] = None, mesh: bool = False) -> Dict:
        """Server-side ``load_propgraph`` + register; returns {n, m, backend}."""
        return self._call("load_graph", name=name, path=path,
                          backend=backend, mesh=mesh)

    def graphs(self) -> Dict[str, int]:
        """Registered graph names → current versions."""
        return self._call("graphs")["graphs"]

    # ------------------------------------------------------------ mutations
    def add_edges_from(self, graph: str, src, dst) -> int:
        return self._call("mutate", [np.asarray(src), np.asarray(dst)],
                          graph=graph, action="add_edges_from")["version"]

    def add_node_labels(self, graph: str, nodes, labels) -> int:
        return self._call("mutate", [np.asarray(nodes)], graph=graph,
                          action="add_node_labels",
                          strings=list(map(str, labels)))["version"]

    def add_edge_relationships(self, graph: str, src, dst,
                               relationships) -> int:
        return self._call("mutate", [np.asarray(src), np.asarray(dst)],
                          graph=graph, action="add_edge_relationships",
                          strings=list(map(str, relationships)))["version"]

    def add_node_properties(self, graph: str, name: str, nodes, values,
                            fill=0) -> int:
        return self._call("mutate", [np.asarray(nodes), np.asarray(values)],
                          graph=graph, action="add_node_properties",
                          name=name, fill=fill)["version"]

    def add_edge_properties(self, graph: str, name: str, src, dst, values,
                            fill=0) -> int:
        return self._call(
            "mutate", [np.asarray(src), np.asarray(dst), np.asarray(values)],
            graph=graph, action="add_edge_properties", name=name, fill=fill,
        )["version"]

    def insert_edges(self, graph: str, src, dst) -> int:
        """Delta-path edge append (known endpoints, no rebuild)."""
        return self._call("mutate", [np.asarray(src), np.asarray(dst)],
                          graph=graph, action="insert_edges")["version"]

    def delete_vertices(self, graph: str, nodes) -> int:
        return self._call("mutate", [np.asarray(nodes)], graph=graph,
                          action="delete_vertices")["version"]

    def delete_edges(self, graph: str, src, dst) -> int:
        return self._call("mutate", [np.asarray(src), np.asarray(dst)],
                          graph=graph, action="delete_edges")["version"]

    def update_node_properties(self, graph: str, name: str, nodes,
                               values) -> int:
        return self._call("mutate", [np.asarray(nodes), np.asarray(values)],
                          graph=graph, action="update_node_properties",
                          name=name)["version"]

    def update_edge_properties(self, graph: str, name: str, src, dst,
                               values) -> int:
        return self._call(
            "mutate", [np.asarray(src), np.asarray(dst), np.asarray(values)],
            graph=graph, action="update_edge_properties", name=name,
        )["version"]

    # ------------------------------------------------------ snapshots / views
    def snapshot(self, graph: str, name: Optional[str] = None) -> str:
        """Pin a frozen snapshot of ``graph`` server-side; queries against
        the returned name are isolated from later writes to ``graph``."""
        return self._call("snapshot", graph=graph, name=name)["name"]

    def fork_view(self, graph: str, name: Optional[str] = None) -> str:
        """Register a writable copy-on-write fork of ``graph``."""
        return self._call("fork_view", graph=graph, name=name)["name"]

    def drop_view(self, name: str) -> None:
        self._call("drop_view", name=name)

    def compact(self, graph: str) -> Dict:
        """Merge ``graph``'s overlay into its base stores; returns the
        pre-compaction overlay stats."""
        return self._call("compact", graph=graph)["overlay"]

    # ---------------------------------------------------------------- admin
    def ping(self) -> bool:
        return bool(self.server_info()["pong"])

    def server_info(self) -> Dict:
        """The server's ping payload: ``{"pong": True, "devices": N}`` —
        ``devices`` is the SERVER process's accelerator count (what a mesh
        load will shard over), not this client's."""
        info = self._call("ping")
        return {k: v for k, v in info.items() if k not in ("id", "ok")}

    def stats(self) -> Dict:
        return self._call("stats")["stats"]

    def metrics(self) -> str:
        """Prometheus text exposition from the server (service registry +
        process-global wire/executor/compactor instruments) — feed it to a
        scraper or ``repro_torch.obs.parse_prometheus``."""
        return self._call("metrics")["metrics"]

    def traces(self) -> Dict:
        """Server-side observability rings: ``{"traces": [...], "slow":
        [...]}`` — recent per-query span trees and the slow-query log."""
        out = self._call("traces")
        return {"traces": out["traces"], "slow": out["slow"]}

    def drain(self) -> None:
        self._call("drain")

    def shutdown(self) -> None:
        """Graceful remote stop: drain, then the server releases itself."""
        self._call("shutdown")
