"""B1 launches (``kernels/bitmap_query/ops.launches``) per request over the
window."""


def read(m):
    n = len(m["records"])
    c = m["counters"]
    return c["b1_launches"] / n if n and "b1_launches" in c else None
