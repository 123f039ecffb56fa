"""repro_torch.traverse — the semiring frontier engine: one masked relax,
generalized over a semiring (⊕ combine, ⊗ extend), that the pattern
executor's variable-length hops, ``PropGraph.khop`` / ``components`` and the
numeric analytics (``shortest_paths`` / ``pagerank`` / ``communities``) all
run through, and a CSR small-frontier fast path for k-hop.  The ``*_sharded``
entries run the relax shard by shard over an entity mesh."""
from repro_torch.traverse.analytics import (
    components_masked,
    label_propagation_masked,
    pagerank_masked,
    pagerank_sharded,
    shortest_paths_masked,
    shortest_paths_sharded,
    single_hop_filters,
)
from repro_torch.traverse.engine import (
    BOOLEAN,
    COUNTING,
    MINLABEL,
    TROPICAL,
    Semiring,
    frontier_step,
    khop_csr,
    khop_mask,
    khop_mask_sharded,
    reach_closure,
    reach_closure_sharded,
    semiring_relax,
    semiring_relax_sharded,
)

__all__ = [
    "Semiring",
    "BOOLEAN",
    "TROPICAL",
    "COUNTING",
    "MINLABEL",
    "semiring_relax",
    "frontier_step",
    "khop_mask",
    "khop_csr",
    "reach_closure",
    "semiring_relax_sharded",
    "khop_mask_sharded",
    "reach_closure_sharded",
    "components_masked",
    "shortest_paths_masked",
    "pagerank_masked",
    "shortest_paths_sharded",
    "pagerank_sharded",
    "label_propagation_masked",
    "single_hop_filters",
]
