"""One profiled slice of a run's window, reduced to what the per-layer
metrics and the breakdown read.

``torch.profiler`` records the slice; its Chrome trace (written to
``TMPDIR`` and deleted) is read back: the device's kernels, copies and
fills, and the host's operators.  Device time is the union of the device
intervals; the window is the slice's host-clock length.  An idle gap is
named by the host operator that covers most of it.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}
TOP = 10


def reduce(events: list, window_s: float) -> dict:
    """``events``: Chrome-trace event dicts.  Returns ``busy_s``,
    ``window_s``, per-name device seconds and launch counts, and the
    longest idle gaps named by host activity."""
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    host = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    by_name, counts = defaultdict(float), defaultdict(int)
    for t0, t1, name in dev:
        by_name[name] += (t1 - t0) / 1e6
        counts[name] += 1
    merged = []
    for t0, t1, _ in dev:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy_s = sum(t1 - t0 for t0, t1 in merged) / 1e6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:TOP]:
        best, best_overlap = "no traced host operator", 0.0
        for h0, h1, name in host:
            overlap = min(h1, g1) - max(h0, g0)
            if overlap > best_overlap:
                best, best_overlap = name, overlap
        named.append([best, (g1 - g0) / 1e6])
    cats = defaultdict(int)
    for e in events:
        cats[str(e.get("cat"))] += 1
    return {"busy_s": busy_s, "window_s": window_s, "device_s_by_name": dict(by_name),
            "categories": dict(cats),
            "launches_by_name": dict(counts),
            "device_ops": sorted(([k, v] for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": named}


def device_seconds(summary: dict, needle: str) -> float:
    return sum(v for k, v in summary["device_s_by_name"].items() if needle in k)


def device_launches(summary: dict, needle: str) -> int:
    return sum(v for k, v in summary["launches_by_name"].items() if needle in k)


class Slice:
    """``start()`` … ``stop()`` under ``torch.profiler``; ``summary`` after.
    ``activities`` names what it records: "cuda" (the device's kernels,
    copies and fills, and the CUDA calls of every thread) and "cpu" (the
    operators of the thread that starts it)."""

    def __init__(self, activities):
        self.summary = None
        self.t0 = self.t1 = None
        self._activities = activities

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        acts = {"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}
        self._prof = profile(activities=[acts[a] for a in self._activities])
        self._prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        self.summary = reduce(events, self.t1 - self.t0)


def warm_up() -> None:
    """One short profiler run before the run's work: the profiler's first start
    in a process pays its own set-up (seconds), which must not fall into
    the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").sum().item()
