"""Device time of the profiled slice per analytics call in it."""


def read(m):
    s = m.get("slice")
    if not s or not s["complete"] or "calls" not in s or not s["calls"]:
        return None
    return s["busy_s"] * 1e3 / s["calls"]
