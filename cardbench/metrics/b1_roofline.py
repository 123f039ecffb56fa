"""B1's share of its roofline in the profiled slice: the bytes its launches
had to move (the selected rows read once, the selects, the output written
once) at the H100's 3.35 TB/s, over B1's own device time, in percent."""
from cardbench.peaks import H100_HBM_BYTES_PER_S
from cardbench.profiled import device_seconds

KERNEL = "bitmap_query_packed_kernel"


def read(m):
    s = m.get("slice")
    if not s or not s["complete"] or not s.get("b1_launches"):
        return None
    own = device_seconds(s, KERNEL)
    return 100.0 * s["b1_bytes"] / H100_HBM_BYTES_PER_S / own if own > 0 else None
