"""Share of the profiled slice in which nothing ran on the device."""


def read(m):
    s = m.get("slice")
    if not s or not s["complete"] or "requests" not in s:
        return None
    return 1.0 - s["busy_s"] / s["window_s"]
