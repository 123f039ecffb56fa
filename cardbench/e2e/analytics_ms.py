"""Milliseconds per completed analytics call: the whole window (whole
cycles of the mix) over the calls completed in it."""


def read(m):
    t0, t1 = m["window"]
    done = sum(r["ok"] for r in m["records"])
    return (t1 - t0) * 1e3 / done if done else None
