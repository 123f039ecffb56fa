"""Pattern queries from closed-loop clients through one in-process ``Service``.

Each of ``clients`` threads sends its next query only once it holds the
previous answer's vertex and edge counts on the host, so a request's time
runs from ``submit`` to the moment the device work behind it is done.  The
window admits requests until ``seconds`` have passed and closes when the
last admitted one is answered.  Each client keeps, per kind, one answer
drawn by reservoir from its seeded stream, and the run keeps each kind's
largest answer; those are compared with the reference once the program is
freed.
"""
from __future__ import annotations

import gc
import threading
import time

from cardbench import generator, profiled
from cardbench.reference import patterns as ref

GRAPH = "g"
TIMEOUT_S = 120.0


class Driver:
    def __init__(self, cfg: dict, mix: dict, data: dict, pg, seed: int, device):
        from repro_torch.service import Service, ServiceConfig

        self.cfg, self.mix, self.data, self.seed, self.device = cfg, mix, data, seed, device
        self.svc = Service(config=ServiceConfig(**mix.get("service_config", {})))
        self.svc.add_graph(GRAPH, pg)
        self.anchored = generator.anchors(mix, data, seed)
        self.kept: dict = {}
        self._largest: dict = {}
        self._lock = threading.Lock()
        self._b1_masks = None  # B1's (row bytes, masks) while a slice records
        self._b1_call = None

    # ------------------------------------------------------------ traffic
    def _client(self, client: int, stream: int, deadline: float, barrier, out: list,
                keep: bool):
        gen = generator.PatternStream(self.mix, self.seed, stream, client, self.anchored)
        pick = generator.rng(self.seed, generator.SAMPLE_STREAM, client)
        seen: dict = {}
        barrier.wait()
        while time.perf_counter() < deadline:
            kind, text = gen.next()
            res, err = None, None
            t0 = time.perf_counter()
            try:
                res = self.svc.submit(GRAPH, text).result(timeout=TIMEOUT_S)
                counts = (res.n_vertices(), res.n_edges())
            except Exception as e:  # a failed request counts against every limit
                err = f"{type(e).__name__}: {e}"
            t1 = time.perf_counter()
            out.append({"kind": kind, "t0": t0, "t1": t1, "ok": err is None, "error": err})
            if not keep or err is not None:
                continue
            seen[kind] = seen.get(kind, 0) + 1
            if pick.random() * seen[kind] < 1.0:  # reservoir of one per kind
                self.kept[(client, kind)] = (kind, text, res)
            with self._lock:
                if counts[1] > self._largest.get(kind, (-1,))[0]:
                    self._largest[kind] = (counts[1], kind, text, res)

    def _drive(self, seconds: float, stream: int, keep: bool, during=None):
        clients = int(self.mix["clients"])
        barrier = threading.Barrier(clients + 1)
        records: list = []
        start = time.perf_counter() + 0.05
        deadline = start + seconds
        threads = [threading.Thread(target=self._client, daemon=True,
                                    args=(c, stream, deadline, barrier, records, keep))
                   for c in range(clients)]
        for t in threads:
            t.start()
        barrier.wait()
        t_open = time.perf_counter()
        if during is not None:
            during(t_open)
        for t in threads:
            t.join()
        return records, t_open

    def warm(self, seconds: float):
        self._drive(seconds, generator.WARM_STREAM, keep=False)

    # --------------------------------------------------------------- window
    def run(self, seconds: float, profile: dict | None) -> dict:
        from repro_torch.kernels.bitmap_query import ops

        stats0 = self.svc.stats()
        gc0 = [g["collections"] for g in gc.get_stats()]
        launches0 = ops.launches[ops.PACKED]
        prof = {}

        def during(t_open):
            """Profile one slice early in the window; a slice whose kernel
            records fall short of the launch counter is taken again."""
            if profile is None:
                return
            time.sleep(max(0.0, t_open + profile["start_s"] - time.perf_counter()))
            for _ in range(profile.get("attempts", 3)):
                sl = profiled.Slice(profile["activities"])
                sl.start()
                # launches counted and their selects logged inside the recorded interval
                self._record_b1(ops)
                l0 = ops.launches[ops.PACKED]
                time.sleep(profile["seconds"])
                l1 = ops.launches[ops.PACKED]
                ops.bitmap_query_batched_packed = self._b1_call
                sl.stop()
                prof.update(slice=sl.summary, t0=sl.t0, t1=sl.t1, b1_launches=l1 - l0,
                            traces=self.svc.trace_log(), b1_masks=self._b1_masks)
                if _recorded_all(sl.summary, l1 - l0):
                    break

        records, t_open = self._drive(seconds, generator.WINDOW_STREAM, keep=True,
                                      during=during)
        t_close = max([r["t1"] for r in records], default=t_open)
        for _, kind, text, res in self._largest.values():
            self.kept[("largest", kind)] = (kind, text, res)
        stats1 = self.svc.stats()
        hist = "pg_sched_coalesce_width"
        extra = {"gc_collections": [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]}
        for key in ("result_hits", "dedup_hits", "batches", "completed"):
            if isinstance(stats1.get(key), (int, float)):
                extra[key] = stats1[key] - stats0.get(key, 0)
        m = {"records": records, "window": (t_open, t_close),
             "counters": {"b1_launches": ops.launches[ops.PACKED] - launches0,
                          "coalesce_sum": stats1[hist]["sum"] - stats0[hist]["sum"],
                          "coalesce_count": stats1[hist]["count"] - stats0[hist]["count"]},
             "extra": extra}
        if prof:
            in_slice = [r for r in records if prof["t0"] <= r["t1"] <= prof["t1"]]
            b1_bytes = sum(ref_bytes for ref_bytes in _selected_rows_bytes(prof["b1_masks"]))
            m["slice"] = dict(prof["slice"], requests=len(in_slice),
                              b1_launches=prof["b1_launches"], b1_bytes=b1_bytes,
                              complete=_recorded_all(prof["slice"], prof["b1_launches"]),
                              batch_wait_ms=[s["ms"] for t in prof["traces"]
                                             for s in t.get("spans", ())
                                             if s["name"] == "batch.wait"])
        return m

    def _record_b1(self, ops):
        """Wrap B1's batched entry (every packed launch goes through it) to
        keep each launch's selects and row width while the slice records."""
        self._b1_call = ops.bitmap_query_batched_packed
        self._b1_masks = []
        masks_log, call = self._b1_masks, self._b1_call

        def recording(plane, attr_masks):
            masks_log.append((plane.shape[1] * plane.element_size(), attr_masks))
            return call(plane, attr_masks)

        ops.bitmap_query_batched_packed = recording

    def close(self):
        self.svc.close()
        self.svc = None

    # ---------------------------------------------------------------- check
    def check(self) -> dict:
        """Every kept answer against the reference's, in mismatched entries."""
        g = ref.Graph(self.data, self.cfg, self.device)
        bits, kinds = 0, set()
        for kind, text, res in self.kept.values():
            got = {"vertex_mask": res.vertex_mask, "edge_mask": res.edge_mask,
                   "bindings": res.bindings()}
            bits += ref.mismatched_bits(got, ref.match(g, text))
            kinds.add(kind)
        return {"mismatched_bits": bits, "answers_compared": len(self.kept),
                "kinds_compared": len(kinds)}


B1_KERNEL = "bitmap_query_packed_kernel"


def _recorded_all(summary: dict, launches: int) -> bool:
    """The slice holds a record of every B1 launch the counter saw inside it
    (the counter is read within the recorded interval, so a whole profile
    has at least as many records; one that dropped records has fewer)."""
    return launches > 0 and profiled.device_launches(summary, B1_KERNEL) >= launches


def _selected_rows_bytes(log):
    """Per launch, the bytes B1 must move (a copy of
    ``chip_smoke.selected_rows_bytes``): the rows some query selects, each
    read once, the selects, and the output written once."""
    for row_bytes, masks in log or ():
        q, k = masks.shape
        rows = int(masks.any(dim=0).sum())
        yield rows * row_bytes + q * k + q * row_bytes
