"""Device time of the profiled slice (kernels, copies and fills) per
request answered in it."""


def read(m):
    s = m.get("slice")
    if not s or not s["complete"] or "requests" not in s or not s["requests"]:
        return None
    return s["busy_s"] * 1e3 / s["requests"]
