"""Quickstart on the PyTorch/CUDA port: the paper's property-graph workflow
end to end (§V + §VI).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--edges 100000]

The port's twin of steps 1–6 and 9 of ``examples/quickstart.py``: a
Tab.-I-regime random graph, labels and relationships from 50-value pools,
OR-semantics queries on all three DIP backends, a typed subgraph with
property-filtered BFS and PageRank, ``match()``/``explain()``,
variable-length patterns with k-hop (``impl='csr'``) and components, a
save/load round trip under another backend, and the overlay (streaming
``insert_edges``, a pinned snapshot, a what-if fork that deletes hubs,
``compact()`` with answers unchanged).  On the card (the default) label and
relationship masks run the CUDA kernel B1; ``--device cpu`` runs its plain
version.  Steps 7–8 of the reference (meshes, the service) wait for their
ports.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import PropGraph
from repro_torch.core.device import resolve_device
from repro_torch.core.io import load_propgraph, save_propgraph
from repro_torch.core.queries import induce_edge_mask_directed
from repro_torch.graph import pagerank, random_uniform_graph


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--edges", type=int, default=100_000, help="graph1 of Tab. I")
    args = ap.parse_args()
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # -- 1. ingest: edges in bulk -------------------------------------------------
    src, dst = random_uniform_graph(args.edges, seed=0)  # graph1 regime: n ≈ 0.865 m
    pg = PropGraph(backend="arr", device=device).add_edges_from(src, dst)
    print(f"graph: n={pg.n_vertices:,} vertices, m={pg.n_edges:,} edges on {device}")

    # -- 2. attributes: labels + relationships from 50-value pools ---------------
    nodes = pg.graph.node_map.cpu().numpy()
    labels = rng.choice([f"label{i}" for i in range(50)], size=len(nodes))
    pg.add_node_labels(nodes, labels)
    es, ed = pg.graph.src.cpu().numpy(), pg.graph.dst.cpu().numpy()
    rels = rng.choice([f"rel{i}" for i in range(50)], size=len(es))
    pg.add_edge_relationships(nodes[es], nodes[ed], rels)
    pg.add_node_properties("score", nodes, rng.random(len(nodes)).astype(np.float32))
    print(f"attributes: {len(pg.label_set())} labels, {len(pg.relationship_set())} "
          "relationships")

    # -- 3. queries (OR semantics, §VI) -------------------------------------------
    vmask = pg.query_labels(["label1", "label2", "label3"])
    emask = pg.query_relationships(["rel7", "rel8"])
    print(f"query: {int(vmask.sum()):,} vertices, {int(emask.sum()):,} edges matched")
    for be in ("list", "listd"):
        pg2 = PropGraph(backend=be, device=device).add_edges_from(src, dst)
        pg2.add_node_labels(nodes, labels)
        assert pg2.query_labels(["label1", "label2", "label3"]).equal(vmask), be
    print("backend agreement: arr == list == listd ✓")

    # -- 4. subgraph induction + analytics on the typed subgraph ------------------
    sub, kept = pg.subgraph(labels=["label1", "label2", "label3"],
                            relationships=["rel7", "rel8"])
    print(f"induced subgraph: n={sub.n:,}, m={sub.m:,}")
    depths = pg.bfs(nodes[:8], relationships=["rel7", "rel8"])
    print(f"property-filtered BFS from 8 sources reached {int((depths >= 0).sum()):,} vertices")
    pr = pagerank(pg.graph, edge_mask=emask).cpu().numpy()
    top = np.argsort(pr)[-3:][::-1]
    print(f"typed-edge PageRank top vertices: {[int(nodes[i]) for i in top]}")

    # -- 5. declarative patterns: match() / explain() -----------------------------
    pg.add_node_properties("age", nodes, rng.integers(0, 90, len(nodes)).astype(np.int32))
    pattern = "(a:label1|label2|label3 {age > 30})-[f:rel7|rel8]->(b:label4|label5|label6)"
    print(pg.explain(pattern))
    res = pg.match(pattern)
    print(f"match: {res.n_vertices():,} vertices, {res.n_edges():,} edges in full matches")
    binds = res.bindings()
    print(f"bindings: a={int(binds['a'].sum()):,} f={int(binds['f'].sum()):,} "
          f"b={int(binds['b'].sum()):,}")
    msub, _ = res.subgraph(pg.graph)
    halo = res.expand(pg.graph, 2)
    print(f"match subgraph: n={msub.n:,}, m={msub.m:,}; 2-hop halo: {int(halo.sum()):,}")
    vm_a = (pg.query_labels(["label1", "label2", "label3"])
            & pg.vertex_predicate_mask("age", ">", 30))
    vm_b = pg.query_labels(["label4", "label5", "label6"])
    hand = induce_edge_mask_directed(pg.graph, vm_a, vm_b,
                                     pg.query_relationships(["rel7", "rel8"]), 1)
    assert res.edge_mask.equal(hand)
    print("match == hand-composed pipeline ✓")

    # -- 5b. reachability: variable-length patterns + frontier analytics ----------
    vres = pg.match("(a:label1)-[:rel7*1..3]->(b:label2)")
    print(f"variable-length match (*1..3): {vres.n_vertices():,} vertices, "
          f"{vres.n_edges():,} edges on matched walks")
    halo3 = pg.khop(nodes[:8], 3, pattern="(a)-[:rel7|rel8]->(b)", impl="csr")
    assert pg.khop(nodes[:8], 3, pattern="(a)-[:rel7|rel8]->(b)").equal(halo3)
    print(f"k-hop: {int(halo3.sum()):,} vertices within 3 typed hops of 8 seeds "
          "(impl='csr' gathers only the frontier's adjacency ≡ frontier path)")
    comp = pg.components("(a)-[:rel7]->(b)").cpu().numpy()
    sizes = np.bincount(comp[comp >= 0])
    print(f"components of the rel7 subgraph: {int((sizes > 0).sum()):,} components, "
          f"largest = {int(sizes.max()):,} vertices")

    # -- 6. persistence: ingest once, reload in seconds ---------------------------
    path = save_propgraph(os.path.join(tempfile.mkdtemp(), "quickstart_pg"), pg)
    pg_l = load_propgraph(path, backend="listd", device=device)  # another backend
    assert pg_l.query_labels(["label1", "label2", "label3"]).equal(vmask)
    assert pg_l.match(pattern).edge_mask.equal(res.edge_mask)
    print(f"save/load round-trip (arr → listd) ✓  ({path})")

    # -- 7.–8. -----------------------------------------------------------------------
    print("7. sharded execution: waits for the multi-GPU port (ROADMAP A10)")
    print("8. serving: waits for the service layer's port (ROADMAP A9)")

    # -- 9. streaming ingest: LSM overlay, snapshots, what-if forks ------------------
    # The first query sealed the DIP stores; from here on, writes append to an
    # overlay delta instead of re-running the §V ingest pipeline
    # (docs/ARCHITECTURE.md §11).  snapshot() pins an immutable version for
    # readers; fork() branches a writable copy-on-write view; compact() folds
    # the overlay back into sorted base stores (equal to a from-scratch build).
    snap = pg.snapshot()  # zero-copy: shares the sealed stores
    pinned = snap.query_labels(["label1"])
    bs, bd = nodes[:512], nodes[512:1024]  # a late-arriving edge batch
    pg.insert_edges(bs, bd)  # O(batch): no re-sort, no rebuild
    pg.add_edge_relationships(bs, bd, ["rel7"] * 512)
    assert snap.query_labels(["label1"]).equal(pinned)
    print(f"streamed {pg.delta_stats()['delta_edges']:,} delta edges; "
          f"snapshot still answers from the pinned version ✓")
    what_if = pg.fork()  # private overlay over the shared base
    what_if.delete_vertices(nodes[np.argsort(pr)[-4:]])  # tombstones; parent untouched
    c_now = pg.components("(a)-[:rel7]->(b)").cpu().numpy()
    c_wo = what_if.components("(a)-[:rel7]->(b)").cpu().numpy()
    print(f"what-if fork: rel7 subgraph has {int((np.bincount(c_wo[c_wo >= 0]) > 0).sum()):,} "
          f"components without the top-PageRank vertices "
          f"(vs {int((np.bincount(c_now[c_now >= 0]) > 0).sum()):,} live) — "
          f"parent version {pg.version}, fork version {what_if.version}")
    before = pg.match(pattern).vertex_mask
    pg.compact()  # merge: overlay → fresh base stores
    assert not pg.has_overlay() and pg.match(pattern).vertex_mask.equal(before)
    print("compaction folded the overlay in; answers unchanged ✓")
    if device.type == "cuda":
        torch.cuda.synchronize()
    print("OK")


if __name__ == "__main__":
    main()
