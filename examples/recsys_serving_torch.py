"""DLRM serving on the PyTorch/CUDA port: batched CTR scoring + graph-side
user context.

    PYTHONPATH=src python examples/recsys_serving_torch.py [--device cpu]

The port's twin of ``examples/recsys_serving.py``, step for step: online
scoring (the ``serve_p99`` regime), bulk scoring, retrieval (one query
against candidates, top-k), an interaction graph whose purchase edges a
pattern selects, and the fused sample+embed verb drawing each user's
purchases and pooling them into a context bag, whose nearest items follow
by dot product.  On the card (the default) the embedding lookup runs the
CUDA kernel B4 and the sampling B3; ``--device cpu`` runs their plain
versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import PropGraph, bitplane
from repro_torch.core.device import resolve_device
from repro_torch.data import dlrm_batch
from repro_torch.kernels.neighbor_sample import sample_embed
from repro_torch.models import dlrm


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    device = resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = dlrm.DLRMConfig(vocab_size=50_000, bot_mlp=(13, 128, 64, 32), embed_dim=32,
                          top_mlp=(128, 64, 1))
    gen = torch.Generator(device=device).manual_seed(0)
    params = dlrm.init_params(gen, cfg, device=device)
    n_params = sum(t.numel() for t in [params["tables"]]
                   + [v for lp in params["bot"] + params["top"] for v in lp.values()])
    print(f"DLRM: {n_params / 1e6:.1f}M params ({cfg.n_sparse} tables × "
          f"{cfg.vocab_size:,} rows) on {device}")

    def serve(b):
        return dlrm.forward(params, b["dense"], b["sparse"], cfg)

    with torch.inference_mode():
        # --- online scoring (serve_p99 shape regime) -----------------------------
        serve(dlrm_batch(0, batch=512, vocab=cfg.vocab_size, device=device))
        sync()
        batches = [dlrm_batch(step, batch=512, vocab=cfg.vocab_size, device=device)
                   for step in range(1, 6)]
        t0 = time.perf_counter()
        for b in batches:
            serve(b)
            sync()
        dt = (time.perf_counter() - t0) / len(batches)
        print(f"online scoring: batch=512 in {dt * 1e3:.2f} ms  ({512 / dt:,.0f} req/s)")

        # --- bulk offline scoring (serve_bulk regime, scaled) ---------------------
        b = dlrm_batch(7, batch=16384, vocab=cfg.vocab_size, device=device)
        t0 = time.perf_counter()
        scores = serve(b)
        sync()
        assert scores.shape == (16384,) and bool(torch.isfinite(scores).all())
        print(f"bulk scoring: 16,384 rows in {(time.perf_counter() - t0) * 1e3:.1f} ms")

        # --- retrieval (1 query vs 100k candidates, matvec + top-k) ---------------
        cands = torch.randn((100_000, cfg.embed_dim), generator=gen, device=device)
        q = dlrm_batch(9, batch=1, vocab=cfg.vocab_size, device=device)
        dlrm.retrieval_scores(params, q["dense"], q["sparse"], cands, cfg, top_k=10)
        sync()
        t0 = time.perf_counter()
        vals, _ids = dlrm.retrieval_scores(params, q["dense"], q["sparse"], cands, cfg,
                                           top_k=10)
        sync()
        print(f"retrieval: top-10 of 100,000 candidates in "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
        print("top scores:", [round(float(v), 3) for v in vals[:3]])

        # --- graph-side user context: pattern → sample → embed --------------------
        rng = np.random.default_rng(0)
        n_users, n_items, m = 2_000, 8_000, 40_000
        u = rng.integers(0, n_users, m)
        i = n_users + rng.integers(0, n_items, m)
        pg = PropGraph(device=device).add_edges_from(u, i)
        nodes = pg.graph.node_map.cpu().numpy()
        pg.add_node_labels(nodes, np.where(nodes < n_users, "user", "item"))
        es, ed = pg.graph.src.cpu().numpy(), pg.graph.dst.cpu().numpy()
        pg.add_edge_relationships(nodes[es], nodes[ed],
                                  rng.choice(["clicked", "bought"], size=len(es)))
        print(f"interaction graph: n={pg.n_vertices:,} m={pg.n_edges:,}")

        # one (n, d) table covering users and items; the packed mask of
        # "(u)-[:bought]->(i)" restricts sampling to purchase edges in B3
        table = torch.randn((pg.n_vertices, cfg.embed_dim), generator=gen, device=device)
        bought = bitplane.pack_mask(pg.match("(u)-[:bought]->(i)").edge_mask)
        users = np.flatnonzero(
            pg.match("(a:user)").vertex_mask.cpu().numpy())[:512].astype(np.int32)

        def context():
            return sample_embed(pg.graph.seg, pg.graph.dst, pg.n_vertices, pg.n_edges, users,
                                3, table, fanout=8, edge_words=bought,
                                max_deg=int(pg.graph.max_deg))

        context()
        sync()
        t0 = time.perf_counter()
        bags, _nbrs, _eids, mask = context()
        sync()
        dt = time.perf_counter() - t0
        print(f"fused sample+embed: {len(users)} users → {int(mask.sum())} purchases → "
              f"{tuple(bags.shape)} bags in {dt * 1e3:.2f} ms")

        # the bag IS the user's context vector: nearest items by dot product
        item_rows = table[n_users:]
        top = torch.topk(bags @ item_rows.T, 5).indices
        print("user 0 recommended items:", (n_users + top[0].cpu().numpy()).tolist())
    print("OK")


if __name__ == "__main__":
    main()
