"""DI neighbourhood aggregation (SpMM) over a CSR layout (B5 ``seg_mm``)."""
from repro_torch.kernels.seg_mm import ops, ref
from repro_torch.kernels.seg_mm.ops import seg_mm

__all__ = ["ops", "ref", "seg_mm"]
