"""Sampled GNN training over a PROPERTY graph on the PyTorch/CUDA port:
pattern-seeded minibatches, GCN, AdamW.

    PYTHONPATH=src python examples/gnn_sampled_training_torch.py [--device cpu]

The port's twin of ``examples/gnn_sampled_training.py``, step for step:
build a labeled, attributed citation-style graph, select the training
population with a pattern, draw every GraphSAGE-style minibatch through
``PropGraph.sample`` (the seed mask and the ``cites`` edge filter go to the
sampler packed), compact the blocks into one subgraph and take an AdamW
step on the GCN's loss.  On the card (the default) the pattern's masks run
B1, the sampler B3, and the GCN's aggregation B5 forward and B5ᵀ backward;
``--device cpu`` runs their plain versions.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import PropGraph
from repro_torch.core.device import resolve_device
from repro_torch.graph.generators import random_uniform_graph
from repro_torch.models import gcn
from repro_torch.models.gnn_common import GraphBatch
from repro_torch.optim import AdamWConfig, apply_updates, init_state


def subgraph_batch(blocks, seed_int, feats, labels, device):
    """Union-of-blocks compacted subgraph (the minibatch_lg execution form).

    ``blocks[0].src_nodes`` is the widest frontier, a sorted superset of
    every id in the chain, so renumbering is one ``searchsorted`` per
    block.  Block ids are the graph's internal ids, which index ``feats``
    and ``labels`` directly."""
    sub = np.asarray(blocks[0].src_nodes)
    es_l, ed_l = [], []
    for b in blocks:
        sn, dn = np.asarray(b.src_nodes), np.asarray(b.dst_nodes)
        s, d = np.asarray(b.edge_src), np.asarray(b.edge_dst)
        keep = np.asarray(b.edge_mask)
        es_l.append(np.searchsorted(sub, sn[s[keep]]))
        ed_l.append(np.searchsorted(sub, dn[d[keep]]))
    e_src = np.concatenate(es_l).astype(np.int32)
    e_dst = np.concatenate(ed_l).astype(np.int32)
    order = np.argsort(e_src, kind="stable")
    nmask = np.zeros(len(sub), bool)
    nmask[np.searchsorted(sub, seed_int)] = True
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return GraphBatch(
        x=t(feats[sub]), pos=None, species=None,
        edge_src=t(e_src[order]), edge_dst=t(e_dst[order]), edge_attr=None,
        edge_mask=torch.ones(len(e_src), dtype=torch.bool, device=device),
        node_mask=t(nmask), labels=t(labels[sub]),
        graph_ids=torch.zeros(len(sub), dtype=torch.int32, device=device),
        n_nodes=len(sub), n_edges=len(e_src), n_graphs=1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--edges", type=int, default=50_000)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.default_rng(0)
    src, dst = random_uniform_graph(args.edges, seed=0)
    pg = PropGraph(device=device).add_edges_from(src, dst)
    nodes = pg.graph.node_map.cpu().numpy()
    n = pg.n_vertices
    pg.add_node_labels(nodes, rng.choice(["paper", "author"], size=n, p=[0.7, 0.3]))
    pg.add_node_properties("year", nodes, rng.integers(2000, 2026, n).astype(np.int32))
    es, ed = pg.graph.src.cpu().numpy(), pg.graph.dst.cpu().numpy()
    pg.add_edge_relationships(nodes[es], nodes[ed], rng.choice(["cites", "writes"], size=len(es)))
    print(f"graph: n={pg.n_vertices:,} m={pg.n_edges:,} on {device}")

    # the training population is a QUERY, not an id list: recent papers only
    seed_pattern = "(a:paper {year >= 2010})"
    edge_filter = "(a)-[:cites]->(b)"  # only citation edges may be sampled
    pool = np.flatnonzero(pg.match(seed_pattern).vertex_mask.cpu().numpy())
    print(f"seed pool |{seed_pattern}| = {len(pool):,} vertices")

    # one fully fused pattern→sample round trip: seeds never visit the host
    blocks = pg.sample(seed_pattern, [10, 5], pattern=edge_filter, seed=0)
    print("pattern-seeded blocks:", [(b.n_src, b.n_dst, b.n_edges) for b in blocks])

    d_feat, n_classes = 64, 7
    feats = rng.standard_normal((n, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n).astype(np.int32)

    cfg = gcn.GCNConfig(d_in=d_feat, d_hidden=16, n_classes=n_classes)
    params = gcn.init_params(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    opt_cfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=100)
    opt = init_state(params)

    for step in range(args.steps):
        seed_int = rng.choice(pool, min(256, len(pool)), replace=False)
        blocks = pg.sample(nodes[seed_int], [10, 5], pattern=edge_filter, seed=step)
        batch = subgraph_batch(blocks, seed_int, feats, labels, device)
        flat = [t.requires_grad_(True) for lp in params["layers"] for t in lp.values()]
        loss = gcn.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, flat)
        it = iter(grads)
        grads = {"layers": [{k: next(it) for k in lp} for lp in params["layers"]]}
        params, opt, _ = apply_updates(params, grads, opt, opt_cfg)
        if step % 5 == 0:
            print(f"step {step:3d}  sampled n={batch.n_nodes:5d} e={batch.n_edges:6d}  "
                  f"loss {loss.item():.4f}")
    print("OK")


if __name__ == "__main__":
    main()
