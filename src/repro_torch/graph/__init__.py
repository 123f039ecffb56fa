"""repro_torch.graph — graph substrate: segment ops, generators, sampling,
analytics."""
from repro_torch.graph.algorithms import connected_components, pagerank, triangle_count
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
    "connected_components",
    "pagerank",
    "triangle_count",
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
