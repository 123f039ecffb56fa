"""repro_torch.data — batch builders: the graph batches of ``data/graph.py``
(``synthetic_graph_batch``, ``build_triplets``, ``synthetic_gc_batch``,
``graphcast_sizes``), the DLRM batches of ``data/recsys.py``
(``dlrm_batch``) and the LM token batches of ``data/lm.py``
(``lm_batch``)."""
from repro_torch.data.graph import (build_triplets, graphcast_sizes, synthetic_gc_batch,
                                    synthetic_graph_batch)
from repro_torch.data.lm import lm_batch
from repro_torch.data.recsys import dlrm_batch

__all__ = ["build_triplets", "synthetic_graph_batch", "synthetic_gc_batch", "graphcast_sizes",
           "dlrm_batch", "lm_batch"]
