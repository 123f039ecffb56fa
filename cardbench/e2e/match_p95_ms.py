"""The 95th percentile of every admitted request's time, from ``submit``
until the client held the answer's counts; a failed request counts as
longer than any limit (nearest rank, so it is an observed time)."""
import math


def percentile(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def read(m):
    times = [(r["t1"] - r["t0"]) * 1e3 if r["ok"] else math.inf for r in m["records"]]
    return percentile(times, 0.95) if times else None
