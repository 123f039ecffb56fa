"""repro_torch.traverse — the Boolean frontier engine the pattern executor
runs (frontier step, ≤k-hop expansion, fixed-point closure), and the
single-hop pattern filter that sampling uses."""
from repro_torch.traverse.analytics import single_hop_filters
from repro_torch.traverse.engine import (
    BOOLEAN,
    Semiring,
    frontier_step,
    khop_mask,
    reach_closure,
    semiring_relax,
)

__all__ = ["Semiring", "BOOLEAN", "semiring_relax", "frontier_step",
           "khop_mask", "reach_closure", "single_hop_filters"]
