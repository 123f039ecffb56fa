"""pgd server — the network front-end over ``Service`` (ARCHITECTURE §9).

The paper's deployment model (§III) is Arkouda's: one persistent parallel
server owns the graphs and the devices; many lightweight Python
clients drive it with small framed messages.  ``PGServer`` is that loop
for the analytics service: a listener thread accepts connections, each
connection gets a session thread that decodes ``wire`` frames and maps
them onto the in-process ``Service`` — so every client process shares ONE
registry, ONE scheduler (whose micro-batching now coalesces across
processes, not just threads) and ONE pair of caches.

Request ops (header ``{"op": ..., "id": ...}`` + optional array blobs):

    ping / graphs / stats            server + service introspection
    metrics                          Prometheus text exposition of the
                                       service + process registries (§13)
    traces                           recent trace trees + slow-query log
    load_graph {name, path, backend, mesh}   registry.load from disk onto
                                       the server's device (a mesh
                                       raises: ROADMAP A10)
    query {graph, pattern, impl}     → Service.submit(); the response is
                                       written when the FUTURE resolves,
                                       so a pipelining client overlaps
                                       requests and the scheduler batches
                                       them into coalesced launches
    explain {graph, pattern, impl}   planner report (text)
    mutate {graph, action, ...}      add_edges_from / add_node_labels /
                                       add_edge_relationships /
                                       add_{node,edge}_properties /
                                       insert_edges / delete_vertices /
                                       delete_edges /
                                       update_{node,edge}_properties
    analytics {graph, analytic, ..}  shortest_paths / pagerank /
                                       communities through the semiring
                                       frontier engine (§12); the (n,)
                                       result vector rides back as an
                                       array blob
    sample {graph, fanouts, ...}     fused neighborhood sampling (§15):
                                       seeds as an id array or a
                                       ``seed_pattern``; async like query
                                       so the scheduler coalesces sample
                                       requests across sessions into one
                                       batched launch; blocks return as
                                       packed masks + index arrays
    snapshot {graph, name?}          pin a frozen snapshot, register it
    fork_view {graph, name?}         writable copy-on-write view
    drop_view {name}                 unregister a snapshot/fork
    compact {graph}                  merge the overlay into base stores
    drain                            stop accepting connections, wait for
                                       every in-flight request
    shutdown                         drain + release the server

Responses echo the request ``id`` (queries resolve out of order —
result-cache fastpath hits overtake executing batches); errors travel as
``{"ok": false, "error": {type, message}}`` and fail only their own
request.  A malformed frame kills just that session.

The frames are the reference package's, byte for byte, so either
package's client talks to this server.  Host code throughout: the device
work is the ``Service``'s (its scheduler thread launches B1 and B3), and
a query's masks pack on the card in the thread that completes its future.
"""
from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Dict, Optional

from repro_torch.core.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import Trace
from repro_torch.service import wire
from repro_torch.service.service import Service

__all__ = ["PGServer"]

_MUTATORS = (
    "add_edges_from",
    "add_node_labels",
    "add_edge_relationships",
    "add_node_properties",
    "add_edge_properties",
    "insert_edges",
    "delete_vertices",
    "delete_edges",
    "update_node_properties",
    "update_edge_properties",
)


class _Session:
    """One client connection: socket, a writer thread, in-flight futures.

    All responses go through the writer thread's queue.  Query responses
    are produced by the scheduler's ONE worker thread (future callbacks);
    if it wrote to sockets directly, a client that stops reading would
    block ``sendall`` once the TCP buffer fills and stall query execution
    for every session.  The queue decouples them: a slow consumer stalls
    only its own writer, and an overflowing queue (``maxsize``) marks the
    session dead instead of growing without bound."""

    _SENTINEL = object()

    def __init__(self, sock: socket.socket, peer):
        self.sock = sock
        self.peer = peer
        self.pending: Dict[int, object] = {}  # request id → Future
        self.dispatching = 0  # frames received but not yet registered in
        # pending — drain must count them as in-flight or a query caught
        # mid-Service.submit() would be dropped at close
        self.plock = threading.Lock()
        self.closed = False
        self._outq: "queue.Queue" = queue.Queue(maxsize=1024)
        self._writer = threading.Thread(
            target=self._write_loop, name=f"pgd-writer-{peer[1]}", daemon=True)
        self._writer.start()

    def send(self, header, arrays=()) -> None:
        if self.closed:
            return
        try:
            self._outq.put_nowait((header, arrays))
        except queue.Full:
            # consumer stopped reading long ago; kill the socket too so the
            # peer sees EOF instead of hanging on responses that were
            # silently dropped (and so our reader thread unblocks and
            # cleans the session up)
            self.closed = True
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _write_loop(self) -> None:
        while not self.closed:
            try:
                item = self._outq.get(timeout=1.0)
            except queue.Empty:
                continue
            try:
                if item is self._SENTINEL:
                    return
                try:
                    wire.send_msg(self.sock, *item)
                except OSError:
                    self.closed = True  # peer went away mid-response
            finally:
                self._outq.task_done()

    def flush(self, timeout: float) -> None:
        """Best-effort wait for queued responses to reach the socket.
        Watches ``unfinished_tasks`` (not ``empty()``) so a frame the
        writer has dequeued but is still sending counts as in flight —
        closing the socket mid-``sendall`` would truncate it."""
        deadline = time.monotonic() + timeout
        while self._outq.unfinished_tasks and not self.closed:
            if time.monotonic() >= deadline:
                return
            time.sleep(0.01)

    def stop_writer(self) -> None:
        self.closed = True
        try:
            self._outq.put_nowait(self._SENTINEL)
        except queue.Full:
            pass  # writer exits via the closed flag within its poll tick


class PGServer:
    """Threaded socket front-end for a ``Service``.

    ``start()`` binds and returns immediately (``.port`` is then real —
    bind with ``port=0`` for an OS-assigned one).  ``close(drain=True)``
    is graceful: no new connections, in-flight queries finish, sessions
    close.  The server owns neither the service nor its graphs — callers
    compose (and may keep using the service in-process alongside).
    ``device`` is where ``load_graph`` places graphs and what ``ping``
    counts: None means the CUDA card (raising without one), ``"cpu"``
    the CPU.
    """

    def __init__(self, service: Service, *, host: str = "127.0.0.1",
                 port: int = 0, backlog: int = 64, device=None):
        self.service = service
        self.device = resolve_device(device)
        self.host = host
        self._port = port
        self.backlog = backlog
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._sessions: set = set()
        self._slock = threading.Lock()
        self._closing = threading.Event()
        self._shutdown_requested = threading.Event()

    # ------------------------------------------------------------ lifecycle
    @property
    def port(self) -> int:
        return self._port

    def start(self) -> "PGServer":
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.host, self._port))
        ls.listen(self.backlog)
        self._port = ls.getsockname()[1]
        self._listener = ls
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="pgd-accept", daemon=True)
        self._accept_thread.start()
        return self

    def wait_shutdown(self, timeout: Optional[float] = None) -> bool:
        """Block until a client sends ``shutdown`` (the serve-mode CLI's
        foreground wait); returns False on timeout."""
        return self._shutdown_requested.wait(timeout)

    def drain(self, timeout: float = 30.0, *, caller: Optional[_Session] = None) -> None:
        """Stop accepting and wait until no session has in-flight futures.

        Re-samples until quiescent (bounded by ``timeout``): connected
        sessions keep dispatching while draining, so a one-shot snapshot
        would miss a query that arrived just after it — and its accepted
        request would be dropped at close.  ``caller`` is the session whose
        ``drain``/``shutdown`` frame asked for this: that frame is itself
        mid-dispatch, and counting it would make the drain wait out its
        whole timeout for itself (the reference's server does, 30 s a
        verb)."""
        self._stop_listening()
        deadline = time.monotonic() + timeout
        while True:
            with self._slock:
                sessions = list(self._sessions)
            futs, mid_dispatch = [], False
            for sess in sessions:
                with sess.plock:
                    futs.extend(sess.pending.values())
                    own = 1 if sess is caller else 0
                    mid_dispatch |= sess.dispatching - own > 0
            if (not futs and not mid_dispatch) or time.monotonic() >= deadline:
                return
            for f in futs:
                try:
                    f.result(timeout=max(0.0, deadline - time.monotonic()))
                except Exception:  # noqa: BLE001 — failures already routed
                    pass  # to their own responses; drain only waits
            if mid_dispatch:
                time.sleep(0.005)  # let the dispatch register its future

    def close(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        if drain:
            self.drain(timeout=timeout)
        self._closing.set()
        self._stop_listening()
        with self._slock:
            sessions = list(self._sessions)
        for sess in sessions:
            if drain:
                sess.flush(timeout=5.0)  # let queued responses leave first
            sess.stop_writer()
            try:
                sess.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sess.sock.close()
            except OSError:
                pass

    def _stop_listening(self) -> None:
        ls, self._listener = self._listener, None
        if ls is not None:
            # shutdown BEFORE close: the accept thread blocked in accept()
            # holds a kernel reference to the listening socket, so a bare
            # close() would leave it accepting; shutdown wakes it with an
            # error and the port actually stops listening
            try:
                ls.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                ls.close()
            except OSError:
                pass

    def __enter__(self) -> "PGServer":
        return self.start() if self._listener is None else self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- accepting
    def _accept_loop(self) -> None:
        ls = self._listener
        while ls is not None and not self._closing.is_set():
            try:
                sock, peer = ls.accept()
            except OSError:
                return  # listener closed (drain/shutdown)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sess = _Session(sock, peer)
            with self._slock:
                self._sessions.add(sess)
            threading.Thread(target=self._serve_session, args=(sess,),
                             name=f"pgd-session-{peer[1]}", daemon=True).start()
            ls = self._listener

    def _serve_session(self, sess: _Session) -> None:
        try:
            while not sess.closed:
                try:
                    header, arrays = wire.recv_msg(sess.sock)
                except (ConnectionError, OSError):
                    return  # client hung up
                except wire.ProtocolError:
                    return  # garbage on the socket: drop the session
                with sess.plock:
                    sess.dispatching += 1
                try:
                    self._dispatch(sess, header, arrays)
                finally:
                    with sess.plock:
                        sess.dispatching -= 1
        finally:
            sess.flush(timeout=5.0)  # in-flight responses drain before close
            sess.stop_writer()
            try:
                sess.sock.close()
            except OSError:
                pass
            with self._slock:
                self._sessions.discard(sess)

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, sess: _Session, header: Dict, arrays) -> None:
        op = header.get("op")
        rid = header.get("id")
        t0 = time.perf_counter()
        try:
            if op == "query":
                self._op_query(sess, rid, header)
                return  # response rides the future callback
            if op == "sample":
                self._op_sample(sess, rid, header, arrays)
                return  # response rides the future callback
            if op in ("drain", "shutdown"):
                self.drain(caller=sess)
                out_header, out_arrays = {"drained": True}, ()
            else:
                handler = getattr(self, f"_op_{op}", None)
                if handler is None:
                    raise ValueError(f"unknown op {op!r}")
                out_header, out_arrays = handler(header, arrays)
        except Exception as e:  # noqa: BLE001 — per-request isolation
            sess.send({"id": rid, "ok": False, "error": wire.exc_to_wire(e)})
            return
        finally:
            if obs_metrics.enabled():
                # per-op server latency; for "query" this covers submit +
                # fastpath only — device time lands on the trace instead
                obs_metrics.GLOBAL.histogram(
                    "pg_wire_op_ms", "server-side op handling latency",
                    op=str(op)).observe((time.perf_counter() - t0) * 1e3)
        out_header.update({"id": rid, "ok": True})
        sess.send(out_header, out_arrays)
        if op == "shutdown":
            self._shutdown_requested.set()

    def _op_query(self, sess: _Session, rid, header: Dict) -> None:
        # a client-minted trace id roots the server-side span tree; the
        # finished tree rides back in the response header so the client
        # can see where ITS query's time went (docs/ARCHITECTURE.md §13)
        tr = None
        tid = header.get("trace")
        if tid is not None and self.service.config.trace_buffer > 0:
            tr = Trace("query", trace_id=str(tid))
        fut = self.service.submit(header["graph"], header["pattern"],
                                  impl=header.get("impl"), trace=tr)
        with sess.plock:
            sess.pending[rid] = fut

        def _respond(f) -> None:
            with sess.plock:
                sess.pending.pop(rid, None)
            err = f.exception()
            if err is not None:
                hdr = {"id": rid, "ok": False, "error": wire.exc_to_wire(err)}
                if tr is not None:
                    hdr["trace"] = tr.finish().to_dict()
                sess.send(hdr)
                return
            t0 = time.perf_counter()
            meta, out = wire.result_to_wire(f.result())
            t1 = time.perf_counter()
            hdr = {"id": rid, "ok": True, "result": meta}
            if tr is not None:
                tr.add_span("serialize", t0, t1)
                tr.root.t1 = t1  # extend the root over serialization; the
                # service pushed this trace into its ring at resolve time,
                # and rings hold live objects, so the span is visible there
                hdr["trace"] = tr.to_dict()
            sess.send(hdr, out)

        fut.add_done_callback(_respond)

    def _op_sample(self, sess: _Session, rid, header: Dict, arrays) -> None:
        """Fused neighborhood sampling over the wire (§15).  Seeds arrive
        either as ``header["seed_pattern"]`` (Cypher-lite, matched
        server-side and fed to the sampler as a packed bitmap) or as the
        one request array of explicit vertex ids.  Async like ``query``:
        the future resolves when the scheduler's coalesced launch lands,
        so pipelined sample requests across sessions share ONE kernel
        launch per (graph, fanouts, bucket) group."""
        tr = None
        tid = header.get("trace")
        if tid is not None and self.service.config.trace_buffer > 0:
            tr = Trace("sample", trace_id=str(tid))
        seeds = header.get("seed_pattern")
        if seeds is None:
            if not arrays:
                raise ValueError("sample needs seed ids or a seed_pattern")
            seeds = arrays[0]
        fut = self.service.submit_sample(
            header["graph"], seeds, tuple(header["fanouts"]),
            pattern=header.get("pattern"), seed=int(header.get("seed", 0)),
            deterministic=bool(header.get("deterministic", True)), trace=tr)
        with sess.plock:
            sess.pending[rid] = fut

        def _respond(f) -> None:
            with sess.plock:
                sess.pending.pop(rid, None)
            err = f.exception()
            if err is not None:
                hdr = {"id": rid, "ok": False, "error": wire.exc_to_wire(err)}
                if tr is not None:
                    hdr["trace"] = tr.finish().to_dict()
                sess.send(hdr)
                return
            t0 = time.perf_counter()
            meta, out = wire.blocks_to_wire(f.result())
            t1 = time.perf_counter()
            hdr = {"id": rid, "ok": True, "sample": meta}
            if tr is not None:
                tr.add_span("serialize", t0, t1)
                tr.root.t1 = t1
                hdr["trace"] = tr.to_dict()
            sess.send(hdr, out)

        fut.add_done_callback(_respond)

    # sync ops: return (header fields, arrays) --------------------------------
    def _op_ping(self, header, arrays):
        import torch

        n = torch.cuda.device_count() if self.device.type == "cuda" else 1
        return {"pong": True, "devices": n}, ()

    def _op_graphs(self, header, arrays):
        reg = self.service.registry
        return {"graphs": {n: reg.version(n) for n in reg.names()}}, ()

    def _op_stats(self, header, arrays):
        return {"stats": self.service.stats()}, ()

    def _op_metrics(self, header, arrays):
        return {"metrics": self.service.metrics_text()}, ()

    def _op_traces(self, header, arrays):
        return {"traces": self.service.trace_log(),
                "slow": self.service.slow_queries()}, ()

    def _op_load_graph(self, header, arrays):
        if header.get("mesh"):
            raise NotImplementedError(
                "loading onto a multi-device mesh is not ported yet (ROADMAP A10)")
        self.service.load_graph(header["name"], header["path"],
                                backend=header.get("backend"), device=self.device)
        pg = self.service.registry.get(header["name"])
        return {"name": header["name"], "n": pg.n_vertices,
                "m": pg.n_edges, "backend": pg.backend}, ()

    def _op_explain(self, header, arrays):
        pg = self.service.registry.get(header["graph"])
        return {"explain": pg.explain(header["pattern"],
                                      impl=header.get("impl"))}, ()

    def _op_mutate(self, header, arrays):
        action = header["action"]
        if action not in _MUTATORS:
            raise ValueError(f"unknown mutate action {action!r}")
        pg = self.service.registry.get(header["graph"])
        if action == "add_edges_from":
            src, dst = arrays
            pg.add_edges_from(src, dst)
        elif action == "add_node_labels":
            pg.add_node_labels(arrays[0], header["strings"])
        elif action == "add_edge_relationships":
            src, dst = arrays
            pg.add_edge_relationships(src, dst, header["strings"])
        elif action == "add_node_properties":
            nodes, values = arrays
            pg.add_node_properties(header["name"], nodes, values,
                                   fill=header.get("fill", 0))
        elif action == "add_edge_properties":
            src, dst, values = arrays
            pg.add_edge_properties(header["name"], src, dst, values,
                                   fill=header.get("fill", 0))
        elif action == "insert_edges":
            src, dst = arrays
            pg.insert_edges(src, dst)
        elif action == "delete_vertices":
            pg.delete_vertices(arrays[0])
        elif action == "delete_edges":
            src, dst = arrays
            pg.delete_edges(src, dst)
        elif action == "update_node_properties":
            nodes, values = arrays
            pg.update_node_properties(header["name"], nodes, values)
        else:  # update_edge_properties
            src, dst, values = arrays
            pg.update_edge_properties(header["name"], src, dst, values)
        return {"version": pg.version}, ()

    def _op_analytics(self, header, arrays):
        """Semiring analytics over the wire: ``{"analytic": shortest_paths
        | pagerank | communities, "graph": ..., ...}``; seeds for
        shortest_paths ride as the one request array.  The (n,) result
        vector returns as a response array blob (f32 distances/ranks or
        i32 labels) — dense numeric payloads never go through the header."""
        analytic = header["analytic"]
        graph = header["graph"]
        if analytic == "shortest_paths":
            out = self.service.shortest_paths(
                graph, arrays[0], weight=header.get("weight"),
                pattern=header.get("pattern"),
                undirected=bool(header.get("undirected", False)),
                max_iters=header.get("max_iters"))
        elif analytic == "pagerank":
            out = self.service.pagerank(
                graph, weight=header.get("weight"),
                pattern=header.get("pattern"),
                damping=header.get("damping", 0.85),
                iters=header.get("iters", 20))
        elif analytic == "communities":
            out = self.service.communities(
                graph, pattern=header.get("pattern"),
                max_iters=header.get("max_iters", 64))
        else:
            raise ValueError(f"unknown analytic {analytic!r}")
        return {"analytic": analytic, "dtype": str(out.dtype)}, (out,)

    # overlay verbs: snapshot isolation over the wire --------------------------
    def _op_snapshot(self, header, arrays):
        name = self.service.snapshot_graph(header["graph"],
                                           name=header.get("name"))
        pg = self.service.registry.get(name)
        return {"name": name, "version": pg.version}, ()

    def _op_fork_view(self, header, arrays):
        name = self.service.fork_graph(header["graph"],
                                       name=header.get("name"))
        pg = self.service.registry.get(name)
        return {"name": name, "version": pg.version}, ()

    def _op_drop_view(self, header, arrays):
        self.service.drop_graph(header["name"])
        return {"dropped": header["name"]}, ()

    def _op_compact(self, header, arrays):
        stats = self.service.compact_graph(header["graph"])
        return {"compacted": header["graph"], "overlay": stats}, ()
