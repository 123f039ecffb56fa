"""repro_torch.graph — graph substrate: segment ops, generators, sampling.
The analytics aliases (``algorithms.py``, ``typed_algorithms.py``) wait for
the frontier and semiring engine."""
from repro_torch.graph.generators import (
    PAPER_GRAPHS,
    attach_random_attributes,
    paper_graph,
    random_uniform_graph,
    rmat_graph,
)
from repro_torch.graph.sampler import (
    SampledBlock,
    block_shapes,
    layer_key,
    layer_keys_batch,
    local_block,
    sample_block,
    sample_layers,
)
from repro_torch.graph.segment_ops import (
    degree_norm,
    gather_scatter,
    segment_mean,
    segment_softmax,
    spmm_di,
)

__all__ = [
    "PAPER_GRAPHS",
    "attach_random_attributes",
    "paper_graph",
    "random_uniform_graph",
    "rmat_graph",
    "SampledBlock",
    "block_shapes",
    "layer_key",
    "layer_keys_batch",
    "local_block",
    "sample_block",
    "sample_layers",
    "degree_norm",
    "gather_scatter",
    "segment_mean",
    "segment_softmax",
    "spmm_di",
]
