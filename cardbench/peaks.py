"""Published peaks of one NVIDIA H100 SXM (data sheet, 700 W)."""
H100_HBM_BYTES_PER_S = 3.35e12
