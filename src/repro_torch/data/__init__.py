"""repro_torch.data — batch builders.  Ported so far: the graph batches of
``data/graph.py`` (``synthetic_graph_batch``, ``build_triplets``)."""
from repro_torch.data.graph import build_triplets, synthetic_graph_batch

__all__ = ["build_triplets", "synthetic_graph_batch"]
