"""Answered queries per second: every request admitted to the window, over
the window from its opening until the last of them was answered."""


def read(m):
    t0, t1 = m["window"]
    ok = sum(r["ok"] for r in m["records"])
    return ok / (t1 - t0) if ok and t1 > t0 else None
