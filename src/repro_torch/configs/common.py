"""Shared config tables: the LM, GNN and recsys request shapes
(``LM_SHAPES``, ``GNN_SHAPES``, ``RECSYS_SHAPES``), the 512-row padding
rule (``pad512``) and the sizes a GNN shape gives a batch
(``_gnn_sizes``, ``minibatch_subgraph_sizes``).  The reference's spec
builders produce JAX shape structs; their port waits for ROADMAP A16."""
from __future__ import annotations

from repro_torch.data.graph import TRIPLET_CAP_FACTOR

__all__ = ["LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "PAD_QUANTUM", "pad512",
           "TRIPLET_CAP_FACTOR", "MINIBATCH_SUBGRAPH", "minibatch_subgraph_sizes"]

LM_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433, kind="train"),
    "minibatch_lg": dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                         fanout=(15, 10), d_feat=602, kind="train"),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100, kind="train"),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, kind="train"),
}

RECSYS_SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}

# Entity/edge arrays are padded to multiples of 512 (= lcm of every mesh-axis
# group they shard over: dp=16, dp·pod=32, dp·pod·model=512); masks carry
# validity.
PAD_QUANTUM = 512


def pad512(n: int) -> int:
    return -(-n // PAD_QUANTUM) * PAD_QUANTUM


def minibatch_subgraph_sizes(batch_nodes: int, fanout) -> tuple:
    """Static worst-case compacted-subgraph size for sampled training: the
    union of all sampler blocks, (nodes, edges)."""
    total_nodes, total_edges, frontier = batch_nodes, 0, batch_nodes
    for f in fanout:
        total_edges += frontier * f
        frontier = frontier * (f + 1)
        total_nodes = frontier
    return total_nodes, total_edges


MINIBATCH_SUBGRAPH = minibatch_subgraph_sizes  # alias


def _gnn_sizes(shape_name: str):
    """(nodes, edges, d_feat) of a GNN shape's batch, padded to 512."""
    sh = GNN_SHAPES[shape_name]
    if shape_name == "minibatch_lg":
        n, e = minibatch_subgraph_sizes(sh["batch_nodes"], sh["fanout"])
        return pad512(n), pad512(e), sh.get("d_feat")
    if shape_name == "molecule":
        b = sh["batch"]
        return pad512(sh["n_nodes"] * b), pad512(sh["n_edges"] * b), sh.get("d_feat")
    return pad512(sh["n_nodes"]), pad512(sh["n_edges"]), sh.get("d_feat")
