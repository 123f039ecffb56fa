"""A configuration's data, made from the seed, and its ingest into the program.

The generators follow the port's ``graph/generators.py``
(``random_uniform_graph``, ``rmat_graph``, ``attach_random_attributes``),
drawn on the device with ``torch.Generator`` so that set-up stays short;
they are the harness's own, so a later change to the program does not
change the yardstick.
``ingest`` follows ``chip_smoke.build_graph``: the port's normal ingest
path, each step timed.

The harness numbers the graph itself, as the paper's DI structure does:
vertices are the sorted distinct endpoint ids, edges the distinct
(src, dst) pairs in lexicographic order.  The reference reads only these
arrays; the program gets the same inputs in original ids.
"""
from __future__ import annotations

import time

import numpy as np
import torch


def _gen(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of one seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % 2**63)


def uniform_edges(cfg: dict, seed: int, device):
    """§VII-A: (src, dst) uniform over a pool of ``vertex_pool`` ids."""
    g = _gen(seed, 0, device)
    m, pool = cfg["edges"], cfg["vertex_pool"]
    return tuple(torch.randint(0, pool, (m,), generator=g, device=device) for _ in range(2))


def kronecker_edges(cfg: dict, seed: int, device):
    """Graph500 Kronecker (R-MAT) edges: 2**scale ids, edge_factor·2**scale
    edges, quadrant probabilities a, b, c (d the rest); vertex ids permuted
    and the edge list shuffled from the seed, as the Graph500 generator
    specifies."""
    g = _gen(seed, 0, device)
    scale, a, b, c = cfg["scale"], cfg["a"], cfg["b"], cfg["c"]
    m = cfg["edge_factor"] << scale
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for lvl in range(scale):
        r = torch.rand(m, generator=g, device=device)
        src |= (r > (a + b)).long() << lvl
        dst |= (((r > a) & (r <= a + b)) | (r > (a + b + c))).long() << lvl
    perm = torch.randperm(1 << scale, generator=g, device=device)
    order = torch.randperm(m, generator=g, device=device)
    return perm[src[order]], perm[dst[order]]


GENERATORS = {"uniform": uniform_edges, "kronecker": kronecker_edges}


def attributes(n_entities: int, n_attrs: int, coverage: float, g, device):
    """§VII-A: each drawn entity takes one of ``n_attrs`` attributes, drawn
    with replacement (some entities get several, some none)."""
    cnt = int(n_entities * coverage)
    return (torch.randint(0, n_entities, (cnt,), generator=g, device=device),
            torch.randint(0, n_attrs, (cnt,), generator=g, device=device))


def _simple_undirected(s, d):
    """Each edge's two directions, self-loops dropped: the edge list of an
    undirected simple graph as a directed store holds it."""
    keep = s != d
    s, d = s[keep], d[keep]
    return torch.cat([s, d]), torch.cat([d, s])


def make(cfg: dict, seed: int, device) -> dict:
    """The configuration's graph from ``seed``, made on ``device`` in a few
    large calls: raw edges, the harness's own numbering, labels,
    relationships and the typed columns (all tensors on ``device``).

    With ``undirected`` each edge is stored in both directions, self-loops
    dropped, and the two directions carry one edge's relationship and
    values."""
    s, d = GENERATORS[cfg["generator"]](cfg, seed, device)
    undirected = bool(cfg.get("undirected", False))
    if undirected:
        s, d = _simple_undirected(s, d)
    nodes = torch.unique(torch.cat([s, d]))
    si, di = torch.searchsorted(nodes, s), torch.searchsorted(nodes, d)
    n = int(nodes.numel())
    keys = torch.unique(si * n + di)
    m = int(keys.numel())
    esrc, edst = keys // n, keys % n
    out = {"src": s, "dst": d, "n": n, "m": m, "nodes": nodes, "esrc": esrc, "edst": edst}
    if undirected:
        # an edge's attributes are drawn once, over the pairs src < dst
        pair = torch.nonzero(esrc < edst).squeeze(1)
        twin = torch.searchsorted(keys, edst * n + esrc)
        owner = torch.minimum(torch.arange(m, device=keys.device), twin)
        own = torch.searchsorted(pair, owner)
    else:
        pair, own = None, None
    lab, rel = cfg["labels"], cfg["relationships"]
    out["label_ent"], out["label_id"] = attributes(n, lab["count"], lab["coverage"],
                                                   _gen(seed, 1, device), device)
    rel_ent, rel_id = attributes(m if pair is None else len(pair), rel["count"],
                                 rel["coverage"], _gen(seed, 2, device), device)
    if pair is not None:
        ent = pair[rel_ent]
        rel_ent, rel_id = torch.cat([ent, twin[ent]]), torch.cat([rel_id, rel_id])
    out["rel_ent"], out["rel_id"] = rel_ent, rel_id
    g = _gen(seed, 3, device)
    out["vprops"], out["eprops"] = {}, {}
    for kind, size, specs in (("vprops", n, cfg["vertex_properties"]),
                              ("eprops", m if pair is None else len(pair),
                               cfg["edge_properties"])):
        for name, spec in specs.items():
            if spec["dtype"] == "int64":
                vals = torch.randint(spec["low"], spec["high"], (size,), generator=g,
                                     device=device)
            else:
                vals = spec["low"] + (spec["high"] - spec["low"]) * torch.rand(
                    size, generator=g, device=device, dtype=torch.float64)
            out[kind][name] = vals if kind == "vprops" or pair is None else vals[own]
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def ingest(cfg: dict, data: dict, device):
    """The port's normal ingest of ``data`` on ``device``; returns the
    sealed graph and the seconds of each step (its inputs made before its
    clock starts)."""
    from repro_torch.core import PropGraph

    steps = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        sync(device)
        steps[name] = time.perf_counter() - t0

    host = {k: data[k].cpu().numpy() for k in ("src", "dst", "nodes", "esrc", "edst",
                                                  "label_ent", "label_id", "rel_ent", "rel_id")}
    nodes = host["nodes"]
    es, ed = nodes[host["esrc"]], nodes[host["edst"]]
    lab, rel = cfg["labels"], cfg["relationships"]
    label_names = np.array([f"{lab['prefix']}{i}" for i in range(lab["count"])])
    rel_names = np.array([f"{rel['prefix']}{i}" for i in range(rel["count"])])
    pg = PropGraph(backend=cfg["backend"], device=device)
    timed("edges", pg.add_edges_from, host["src"], host["dst"])
    timed("labels", pg.add_node_labels, nodes[host["label_ent"]],
          label_names[host["label_id"]])
    rel_ent = host["rel_ent"]
    timed("relationships", pg.add_edge_relationships, es[rel_ent], ed[rel_ent],
          rel_names[host["rel_id"]])
    for name, vals in data["vprops"].items():
        timed(f"vertex_column.{name}", pg.add_node_properties, name, nodes, vals.cpu().numpy())
    for name, vals in data["eprops"].items():
        timed(f"edge_column.{name}", pg.add_edge_properties, name, es, ed, vals.cpu().numpy())
    timed("seal", lambda: (pg._vstore.finalize(), pg._estore.finalize()))
    return pg, steps
