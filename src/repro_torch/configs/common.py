"""Shared config tables: the LM, GNN and recsys request shapes
(``LM_SHAPES``, ``GNN_SHAPES``, ``RECSYS_SHAPES``), the 512-row padding
rule (``pad512``), the sizes a GNN shape gives a batch (``_gnn_sizes``,
``minibatch_subgraph_sizes``), and the dry run's input specs per family
(``lm_input_specs``, ``gnn_graph_specs``, ``gc_specs``,
``recsys_input_specs``): trees of abstract tensors (``sds``: shape and
dtype on the ``meta`` device, never allocated), the reference's
ShapeDtypeStruct trees leaf for leaf.  The one difference: a decode cache's
``cur`` is the Python int the port's cache keeps
(``models/transformer.init_cache``), where the reference has a () int32."""
from __future__ import annotations

import torch

from repro_torch.data.graph import TRIPLET_CAP_FACTOR, graphcast_sizes

__all__ = ["LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "PAD_QUANTUM", "pad512", "sds",
           "lm_input_specs", "gnn_graph_specs", "gc_specs", "recsys_input_specs",
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


def sds(shape, dtype: torch.dtype) -> torch.Tensor:
    """An abstract tensor: ``shape`` and ``dtype`` on the ``meta`` device,
    no data (the reference's ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ------------------------------------------------------------------ LM specs
def lm_input_specs(cfg, shape_name: str):
    """(kind, specs).  (None, None) for long_500k on pure full-attention
    archs (the sub-quadratic gate)."""
    from repro_torch.models.transformer import init_cache

    sh = LM_SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    i32 = torch.int32
    if sh["kind"] == "train":
        return "train", {"tokens": sds((b, s), i32), "labels": sds((b, s), i32)}
    if sh["kind"] == "prefill":
        return "prefill", {"tokens": sds((b, s), i32)}
    # decode: one new token against a seq_len-deep KV cache
    if shape_name == "long_500k" and cfg.window is None:
        return None, None  # skipped: pure full-attention arch
    return "decode", {"tokens": sds((b, 1), i32), "cache": init_cache(cfg, b, s, device="meta")}


# ----------------------------------------------------------------- GNN specs
def gnn_graph_specs(shape_name: str, *, model: str, n_classes: int = 47, n_species: int = 16):
    """GraphBatch of abstract tensors per model family: gcn — dense
    features and node labels; mace/dimenet — species and positions (and
    dimenet's triplets), graph energies.  (graphcast takes ``gc_specs``.)"""
    from repro_torch.models.gnn_common import GraphBatch

    n, e, d_feat = _gnn_sizes(shape_name)
    n_graphs = GNN_SHAPES[shape_name].get("batch", 1) if shape_name == "molecule" else 1
    f32, i32 = torch.float32, torch.int32
    if model == "gcn":
        x, pos, species, tri = sds((n, d_feat or 128), f32), None, None, None
        labels = sds((n,), i32)
    else:
        x, pos, species = None, sds((n, 3), f32), sds((n,), i32)
        tri = sds((TRIPLET_CAP_FACTOR * e, 3), i32) if model == "dimenet" else None
        labels = sds((n_graphs,), f32)
    return GraphBatch(
        x=x, pos=pos, species=species,
        edge_src=sds((e,), i32), edge_dst=sds((e,), i32), edge_attr=tri,
        edge_mask=sds((e,), torch.bool), node_mask=sds((n,), torch.bool),
        labels=labels, graph_ids=sds((n,), i32),
        n_nodes=n, n_edges=e, n_graphs=n_graphs,
    )


def gc_specs(shape_name: str, *, n_vars: int, d_edge: int = 4):
    """GCBatch of abstract tensors at a GNN shape's sizes (``graphcast_sizes``)."""
    from repro_torch.models.graphcast import GCBatch

    n, e, _ = _gnn_sizes(shape_name)
    ng, nm, ne_g2m, ne_mesh, ne_m2g = graphcast_sizes(n, e)
    f32, i32 = torch.float32, torch.int32
    return GCBatch(
        grid_x=sds((ng, n_vars), f32),
        g2m_src=sds((ne_g2m,), i32), g2m_dst=sds((ne_g2m,), i32),
        g2m_attr=sds((ne_g2m, d_edge), f32),
        mesh_src=sds((ne_mesh,), i32), mesh_dst=sds((ne_mesh,), i32),
        mesh_attr=sds((ne_mesh, d_edge), f32),
        m2g_src=sds((ne_m2g,), i32), m2g_dst=sds((ne_m2g,), i32),
        m2g_attr=sds((ne_m2g, d_edge), f32),
        targets=sds((ng, n_vars), f32),
        n_grid=ng, n_mesh=nm, n_g2m=ne_g2m, n_mesh_e=ne_mesh, n_m2g=ne_m2g,
    )


# -------------------------------------------------------------- recsys specs
def recsys_input_specs(cfg, shape_name: str):
    """(kind, specs) of a DLRM shape."""
    sh = RECSYS_SHAPES[shape_name]
    b = sh["batch"]
    f32, i32 = torch.float32, torch.int32
    base = {"dense": sds((b, cfg.n_dense), f32),
            "sparse": sds((b, cfg.n_sparse, cfg.multi_hot), i32)}
    if sh["kind"] == "train":
        return "train", {**base, "labels": sds((b,), i32)}
    if sh["kind"] == "retrieval":
        return "retrieval", {**base, "candidates": sds((pad512(sh["n_candidates"]),
                                                        cfg.embed_dim), f32)}
    return "serve", base
