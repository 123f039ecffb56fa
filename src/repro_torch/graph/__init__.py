"""repro_torch.graph — graph substrate.  Ported so far: the layered
neighbor sampler."""
from repro_torch.graph.sampler import (
    SampledBlock,
    block_shapes,
    layer_key,
    layer_keys_batch,
    local_block,
    sample_block,
    sample_layers,
)

__all__ = [
    "SampledBlock",
    "block_shapes",
    "layer_key",
    "layer_keys_batch",
    "local_block",
    "sample_block",
    "sample_layers",
]
