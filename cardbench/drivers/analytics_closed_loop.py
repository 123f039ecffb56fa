"""Whole-graph analytics from one closed-loop client on ``PropGraph``'s verbs.

The client runs the mix's ``calls`` in order, one cycle after another, each
call ending when the device work behind its answer is done.  Cycles start
until ``seconds`` have passed; the window closes at the end of the last
one, so every window holds whole cycles.  A source is drawn per call from
the seed among the vertices with an out-edge.  A call counts as failed when
it stops at a cap it was given to reach the fixed point (``fails_capped``).
Per kind, a reservoir drawn from the seed keeps ``keep`` answers for the
reference.
"""
from __future__ import annotations

import time

import torch

from cardbench import generator, profiled
from cardbench.reference import analytics as ref


class Driver:
    def __init__(self, cfg: dict, mix: dict, data: dict, pg, seed: int, device):
        self.cfg, self.mix, self.data, self.pg, self.seed = cfg, mix, data, pg, seed
        self.device = torch.device(device)
        self._sources = torch.unique(data["esrc"]).cpu().numpy()  # vertices with an out-edge
        self._nodes = data["nodes"].cpu().numpy()
        self.kept: dict = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _call(self, spec: dict, source):
        from repro_torch.traverse import engine

        args = {k: (self.data["n"] if v == "n" else v) for k, v in spec.get("args", {}).items()}
        verb = getattr(self.pg, spec["verb"])
        capped0 = dict(engine.capped)
        if spec.get("source"):
            out = verb([int(self._nodes[source])], **args)
        else:
            out = verb(**args)
        self._sync()
        capped = engine.capped.get(spec["verb"], 0) > capped0.get(spec["verb"], 0)
        if spec["verb"] == "bfs":
            capped = bool(out.max() >= args.get("max_iters", 64))
        return out, capped and spec["kind"] in self.mix.get("fails_capped", ())

    def _cycles(self, seconds: float, stream: int, keep: bool, profile=None):
        calls = self.mix["calls"]
        draw = generator.rng(self.seed, stream)
        pick = generator.rng(self.seed, generator.SAMPLE_STREAM)
        seen: dict = {}
        records, prof, sl = [], {}, None
        t_open = time.perf_counter()
        deadline = t_open + seconds
        while time.perf_counter() < deadline:
            if profile is not None and sl is None and not prof \
                    and time.perf_counter() >= t_open + profile["start_s"]:
                sl = profiled.Slice(profile["activities"])
                prof["rounds0"] = self._rounds()
                sl.start()
            for spec in calls:
                source = (int(self._sources[draw.integers(len(self._sources))])
                          if spec.get("source") else None)
                t0 = time.perf_counter()
                err = None
                try:
                    out, failed = self._call(spec, source)
                    if failed:
                        err = "stopped at its cap before the fixed point"
                except Exception as e:
                    out, err = None, f"{type(e).__name__}: {e}"
                t1 = time.perf_counter()
                records.append({"kind": spec["kind"], "t0": t0, "t1": t1,
                                "ok": err is None, "error": err})
                if keep and out is not None:
                    seen[spec["kind"]] = n_seen = seen.get(spec["kind"], 0) + 1
                    slots = self.kept.setdefault(spec["kind"], [])
                    if len(slots) < self.mix["keep"]:
                        slots.append((source, out))
                    else:
                        j = int(pick.integers(n_seen))
                        if j < len(slots):
                            slots[j] = (source, out)
            if sl is not None and (time.perf_counter() >= sl.t0 + profile["seconds"]
                                   or time.perf_counter() >= deadline):
                sl.stop()
                prof.update(slice=sl.summary, t0=sl.t0, t1=sl.t1,
                            rounds=self._rounds() - prof["rounds0"])
                sl = None
        return records, t_open, prof

    @staticmethod
    def _rounds() -> int:
        from repro_torch.traverse import engine

        return sum(engine.rounds.values())

    def warm(self, seconds: float):
        """One cycle (each call's first run), then more until ``seconds``."""
        self._cycles(seconds, generator.WARM_STREAM, keep=False)

    def run(self, seconds: float, profile: dict | None) -> dict:
        rounds0 = self._rounds()
        records, t_open, prof = self._cycles(seconds, generator.WINDOW_STREAM, keep=True,
                                             profile=profile)
        m = {"records": records, "window": (t_open, max(r["t1"] for r in records)),
             "counters": {"rounds": self._rounds() - rounds0}}
        if prof:
            calls = [r for r in records if prof["t0"] <= r["t0"] and r["t1"] <= prof["t1"]]
            m["slice"] = dict(prof["slice"], calls=len(calls), rounds=prof["rounds"],
                              complete=profiled.device_launches(prof["slice"], "Memcpy DtoH")
                              >= prof["rounds"] > 0)
        return m

    def close(self):
        self.pg = None

    # ---------------------------------------------------------------- check
    def check(self) -> dict:
        """Every kept answer against the reference's."""
        d = self.data
        src, dst, n = d["esrc"], d["edst"], d["n"]
        w = d["eprops"]["w"]
        out = {"bfs_mismatches": 0, "wcc_mismatches": 0, "sssp_gap": 0.0, "pr_l1": 0.0,
               "cdlp_mismatches": 0}
        args = {spec["kind"]: spec.get("args", {}) for spec in self.mix["calls"]}
        once = {}  # the source-free answers, computed once

        def single(kind, fn):
            if kind not in once:
                once[kind] = fn()
            return once[kind]

        for kind, answers in self.kept.items():
            for source, got in answers:
                if kind == "bfs":
                    want = ref.bfs(src, dst, n, source)
                    out["bfs_mismatches"] += int((got.long() != want).sum())
                elif kind == "wcc":
                    want = single(kind, lambda: torch.from_numpy(
                        ref.components(src, dst, n)).to(src.device))
                    out["wcc_mismatches"] += int((got.long() != want).sum())
                elif kind == "sssp":
                    want = ref.shortest_paths(src, dst, n, w, source, torch.float64)
                    out["sssp_gap"] = max(out["sssp_gap"], ref.max_relative_gap(got, want))
                elif kind == "pr":
                    want = single(kind, lambda: ref.pagerank(
                        src, dst, n, torch.float64, damping=args[kind].get("damping", 0.85),
                        iters=args[kind].get("iters", 20)))
                    out["pr_l1"] = max(out["pr_l1"], ref.l1_gap(got, want))
                elif kind == "cdlp":
                    want = single(kind, lambda: ref.communities(
                        src, dst, n, max_iters=args[kind].get("max_iters", 64)))
                    out["cdlp_mismatches"] += int((got.long() != want).sum())
        out["answers_compared"] = sum(len(a) for a in self.kept.values())
        out["kinds_compared"] = len(self.kept)
        return out
