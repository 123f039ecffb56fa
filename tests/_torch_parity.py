"""Shared graph constructors for the port's parity tests (tests/test_torch_*.py).

The same seeded raw inputs go through the reference package (``repro``) and
the port (``repro_torch``, on the CPU); results are compared as numpy
arrays.  Packed words are uint32 in the reference and int32 (same bits) in
the port, so comparisons go through ``as_np``, which views words as uint32.
"""
import numpy as np
import torch

LABELS = ("rare", "mid", "common")
RELS = ("follows", "likes", "knows")


def as_np(x, words: bool = False) -> np.ndarray:
    """Host copy of a torch tensor or an array of the reference package."""
    a = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return a.view(np.uint32) if words and a.dtype == np.int32 else a


def raw_inputs(seed: int, n_pool: int = 60, m: int = 300) -> dict:
    """Edges, labels (some vertices several, some none), relationships
    (some edges several, some none), an int64 vertex column and a float64
    edge column that cover part of their universe."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_pool, m)
    dst = rng.integers(0, n_pool, m)
    nodes = np.unique(np.concatenate([src, dst]))
    pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
    lab_nodes = rng.choice(nodes, size=len(nodes) + len(nodes) // 3)
    ei = rng.choice(len(pairs), size=len(pairs) + len(pairs) // 4)
    age_nodes = rng.choice(nodes, size=int(0.8 * len(nodes)), replace=False)
    w_idx = rng.choice(len(pairs), size=int(0.7 * len(pairs)), replace=False)
    return {
        "src": src, "dst": dst,
        "lab_nodes": lab_nodes,
        "labels": rng.choice(LABELS, size=len(lab_nodes), p=[0.1, 0.3, 0.6]),
        "rel_src": pairs[ei, 0], "rel_dst": pairs[ei, 1],
        "rels": rng.choice(RELS, size=len(ei), p=[0.2, 0.6, 0.2]),
        "age_nodes": age_nodes, "ages": rng.integers(0, 60, len(age_nodes)),
        "w_src": pairs[w_idx, 0], "w_dst": pairs[w_idx, 1], "ws": rng.random(len(w_idx)),
    }


def ingest(pg, raw: dict):
    """Run the raw inputs through ``pg``'s ingest API and seal its stores
    (the layout is captured when a store seals)."""
    pg.add_edges_from(raw["src"], raw["dst"])
    pg.add_node_labels(raw["lab_nodes"], raw["labels"])
    pg.add_edge_relationships(raw["rel_src"], raw["rel_dst"], raw["rels"])
    pg.add_node_properties("age", raw["age_nodes"], raw["ages"])
    pg.add_edge_properties("w", raw["w_src"], raw["w_dst"], raw["ws"])
    pg._vstore.finalize()
    pg._estore.finalize()
    return pg


def build_pair(raw: dict, byte: bool = False):
    """(reference PropGraph, port PropGraph on the CPU) from ``raw``, both
    packed or both byte."""
    from repro.core import PropGraph as RefPG
    from repro.core import bitplane as ref_bitplane
    from repro_torch.core import PropGraph as PortPG
    from repro_torch.core import bitplane as port_bitplane

    with ref_bitplane.byte_masks(byte), port_bitplane.byte_masks(byte):
        return ingest(RefPG(backend="arr"), raw), ingest(PortPG(device="cpu"), raw)


def ref_state(pg) -> dict:
    """The reference graph's state in the layout ``PropGraph.from_arrays``
    takes, pulled out with ``np.asarray``."""
    g = pg.graph

    def store(s):
        st = s.finalize()
        return {"values": s.amap.values, "bitmap": np.asarray(st.bitmap), "k": st.k,
                "n": st.n, "packed": st.packed}

    def cols(props):
        return {k: (np.asarray(c), np.asarray(v)) for k, (c, v) in props.items()}

    return {
        "graph": {"src": np.asarray(g.src), "dst": np.asarray(g.dst), "seg": np.asarray(g.seg),
                  "node_map": np.asarray(g.node_map), "n": g.n, "m": g.m, "max_deg": g.max_deg},
        "vstore": store(pg._vstore), "estore": store(pg._estore),
        "vertex_props": cols(pg.vertex_props), "edge_props": cols(pg.edge_props),
    }


def assert_same_match(ref_res, port_res) -> None:
    """Masks, per-slot masks and bindings equal bit for bit."""
    np.testing.assert_array_equal(as_np(port_res.vertex_mask), as_np(ref_res.vertex_mask))
    np.testing.assert_array_equal(as_np(port_res.edge_mask), as_np(ref_res.edge_mask))
    assert len(port_res.node_masks) == len(ref_res.node_masks)
    for a, b in zip(port_res.node_masks + port_res.edge_masks,
                    ref_res.node_masks + ref_res.edge_masks):
        np.testing.assert_array_equal(as_np(a), as_np(b))
    rb, pb = ref_res.bindings(), port_res.bindings()
    assert set(rb) == set(pb)
    for k in rb:
        np.testing.assert_array_equal(as_np(pb[k]), as_np(rb[k]))


def random_csr(seed: int, n: int, w: int, *, zero_share: float = 0.25):
    """A random CSR (seg (n+1,), dst (m,) int32) whose out-degrees run
    past ``w`` (windows are cut) with a ``zero_share`` of degree-0
    vertices, and m % 32 != 0 (a ragged last edge word), plus a random
    packed edge filter (uint32 words) and its bool form."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, w + 5, n)
    deg[rng.random(n) < zero_share] = 0
    if deg.sum() % 32 == 0:
        deg[0] += 1
    seg = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    m = int(seg[-1])
    dst = rng.integers(0, n, m).astype(np.int32)
    edge_ok = rng.random(m) < 0.6
    words = np.packbits(np.concatenate([edge_ok, np.zeros(-m % 32, bool)]),
                        bitorder="little").view("<u4").astype(np.uint32)
    return seg, dst, edge_ok, words


BATCH_FIELDS = ("x", "pos", "species", "edge_src", "edge_dst", "edge_attr", "edge_mask",
                "node_mask", "labels", "graph_ids")


def port_batch(ref_batch):
    """The port's ``GraphBatch`` on the CPU holding the same arrays as a
    reference ``GraphBatch``."""
    from repro_torch.models.gnn_common import GraphBatch

    arrays = {f: None if getattr(ref_batch, f) is None
              else torch.from_numpy(np.array(getattr(ref_batch, f))) for f in BATCH_FIELDS}
    return GraphBatch(**arrays, n_nodes=ref_batch.n_nodes, n_edges=ref_batch.n_edges,
                      n_graphs=ref_batch.n_graphs)


def with_padded_edges(ref_batch, seed: int, share: float = 0.2):
    """``ref_batch`` with a seeded ``share`` of its edges marked padding
    (``edge_mask`` False), as a sampled minibatch's unused slots are."""
    import dataclasses

    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    keep = rng.random(ref_batch.n_edges) >= share
    return dataclasses.replace(ref_batch, edge_mask=jnp.asarray(keep))


def fixed_shape_edges(seed: int, n: int, m: int):
    """m distinct (src, dst) pairs over exactly n vertices (every vertex is
    the source of one pair), so every seed gives a graph of the same (n, m)
    and the reference's jitted loops compile once per shape, not per seed."""
    rng = np.random.default_rng(seed)
    first = np.arange(n) * n + rng.integers(0, n, n)
    rest = np.setdiff1d(np.arange(n * n), first)
    codes = np.concatenate([first, rng.choice(rest, m - n, replace=False)])
    codes = codes[rng.permutation(m)]
    return codes // n, codes % n


def analytics_pair(seed: int, n: int = 24, m: int = 80, backend: str = "arr",
                   partial_w: int = 0):
    """(reference PropGraph, port PropGraph on the CPU, meta) on
    ``fixed_shape_edges`` with x/y/z labels, r/s relationships and an f32
    ``w`` edge weight in [0.5, 2); ``partial_w`` > 0 also defines ``w2`` on
    only the first ``partial_w`` DI edges (the others have no value, hence
    are not traversable).  ``meta`` holds the DI arrays, per-vertex labels,
    per-edge relationships and weights in DI order."""
    from repro.core import PropGraph as RefPG
    from repro_torch.core import PropGraph as PortPG

    rng = np.random.default_rng(seed + 1000)
    src, dst = fixed_shape_edges(seed, n, m)
    ref = RefPG(backend=backend).add_edges_from(src, dst)
    port = PortPG(backend=backend, device="cpu").add_edges_from(src, dst)
    nodes = np.asarray(ref.graph.node_map)
    es, ed = np.asarray(ref.graph.src), np.asarray(ref.graph.dst)
    lab = rng.choice(["x", "y", "z"], size=len(nodes))
    rel = rng.choice(["r", "s"], size=len(es))
    w = rng.uniform(0.5, 2.0, len(es)).astype(np.float32)
    for pg in (ref, port):
        pg.add_node_labels(nodes, lab)
        pg.add_edge_relationships(nodes[es], nodes[ed], rel)
        pg.add_edge_properties("w", nodes[es], nodes[ed], w)
        if partial_w:
            pg.add_edge_properties("w2", nodes[es[:partial_w]], nodes[ed[:partial_w]],
                                   w[:partial_w] * np.float32(2))
    meta = {"nodes": nodes, "es": es, "ed": ed, "labels": lab, "rels": rel, "w": w,
            "n": ref.graph.n, "m": ref.graph.m}
    return ref, port, meta


# ------------------------------------------------------------------ overlay
OV_PATTERNS = (  # the six request kinds of chip_smoke.py, over the overlay graphs' attributes
    ("fused_1hop", "(a:l1|l2)-[:follows]->(b:l3)"),
    ("two_hop", "(a:l1)-[:follows]->(b)-[:likes|mentions]->(c:l2)"),
    ("predicates", "(a:l1 {age > 20})-[e:follows {w < 0.5}]->(b:l2|zz)"),
    ("reversed", "(a:l1)<-[:follows]-(b:l2)"),
    ("bounded", "(a:l3)-[:follows*1..3]->(b)"),
    ("unbounded", "(a:l2)-[:follows|likes*]->(b:l3)"),
)


def overlay_pair(seed: int, backend: str = "arr", n: int = 40, m: int = 160):
    """(reference PropGraph, port PropGraph on the CPU, meta) on
    ``fixed_shape_edges(seed, n, m)`` (every seed gives the same (n, m), so
    the reference compiles once per shape) with l1/l2/l3 labels,
    follows/likes relationships, an int64 ``age`` and a float64 ``w``; both
    stores sealed by one ``match()``."""
    from repro.core import PropGraph as RefPG
    from repro_torch.core import PropGraph as PortPG

    rng = np.random.default_rng(seed + 2000)
    src, dst = fixed_shape_edges(seed, n, m)
    ref = RefPG(backend=backend).add_edges_from(src, dst)
    port = PortPG(backend=backend, device="cpu").add_edges_from(src, dst)
    nodes = np.asarray(ref.graph.node_map)
    es, ed = np.asarray(ref.graph.src), np.asarray(ref.graph.dst)
    lab = rng.choice(["l1", "l2", "l3"], size=len(nodes))
    rel = rng.choice(["follows", "likes"], size=len(es), p=[0.7, 0.3])
    age = rng.integers(0, 60, len(nodes))
    w = rng.random(len(es))
    for pg in (ref, port):
        pg.add_node_labels(nodes, lab)
        pg.add_edge_relationships(nodes[es], nodes[ed], rel)
        pg.add_node_properties("age", nodes, age)
        pg.add_edge_properties("w", nodes[es], nodes[ed], w)
        pg.match(OV_PATTERNS[0][1])  # seal both stores
    meta = {"nodes": nodes, "src": nodes[es], "dst": nodes[ed], "labels": lab, "rels": rel}
    return ref, port, meta


def overlay_stream(seed: int, meta: dict) -> list:
    """A seeded mutation stream of every overlay write kind, as
    ``(method, args)`` steps (and the markers ``("snapshot",)`` and
    ``("fork",)``): inserts with base duplicates (dedup), relationships and
    labels with values first seen after the seal, base and delta edge
    deletes, revivals with relationships on the revived edges, vertex
    deletes, property updates (delta edges included), then, on a fork,
    more inserts, labels and a delete.  Every endpoint exists and is alive,
    and every insert's fresh-pair count is fixed, so all seeds give graphs
    of the same shapes."""
    rng = np.random.default_rng(seed + 3000)
    nodes = meta["nodes"]
    base = list(zip(meta["src"].tolist(), meta["dst"].tolist()))
    seen = set(base)
    dead_v = set()

    def pick(seq, k):
        return [seq[i] for i in rng.choice(len(seq), k, replace=False)]

    def fresh(k):
        alive = [u for u in nodes.tolist() if u not in dead_v]
        out = []
        while len(out) < k:
            p = (int(rng.choice(alive)), int(rng.choice(alive)))
            if p not in seen:
                seen.add(p)
                out.append(p)
        return out

    def cols(pairs):
        return np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])

    ops = []
    new = fresh(12)
    ops.append(("insert_edges", cols(new + pick(base, 3))))
    rel_pairs = pick(new, 8) + pick(base, 6)
    ops.append(("add_edge_relationships",
                (*cols(rel_pairs), rng.choice(["follows", "likes", "mentions"], len(rel_pairs)))))
    ops.append(("add_node_labels",
                (rng.choice(nodes, 10, replace=False), rng.choice(["l1", "l2", "l3", "zz"], 10))))
    ops.append(("snapshot",))
    gone_base, gone_delta = pick(base, 5), pick(new, 2)
    ops.append(("delete_edges", cols(gone_base + gone_delta)))
    revived = gone_base[:2] + gone_delta[:1]
    ops.append(("insert_edges", cols(revived)))
    ops.append(("add_edge_relationships", (*cols(revived), np.array(["likes"] * 3))))
    dv = rng.choice(nodes, 2, replace=False)
    dead_v.update(dv.tolist())
    ops.append(("delete_vertices", (dv,)))
    ops.append(("update_node_properties",
                ("age", rng.choice(nodes, 6, replace=False), rng.integers(0, 60, 6))))
    upd = pick([p for p in base if p not in gone_base], 3) + pick(new[2:], 3)
    ops.append(("update_edge_properties", ("w", *cols(upd), rng.random(6))))
    ops.append(("fork",))
    ops.append(("insert_edges", cols(fresh(6))))
    ops.append(("add_node_labels", (rng.choice(nodes, 5, replace=False), np.array(["zz"] * 5))))
    ops.append(("delete_vertices", (rng.choice([u for u in nodes if u not in dead_v], 1),)))
    return ops


def assert_same_counts(ref, port) -> None:
    """Label and relationship counts, and both stores' per-attribute stats
    with their dtype, equal the reference's (tombstones subtracted)."""
    assert port.label_counts() == ref.label_counts()
    assert port.relationship_counts() == ref.relationship_counts()
    for store, dead in (("_vstore", "_dead_vertex_ids"), ("_estore", "_dead_edge_ids")):
        for kw in ({}, {"dead_ids": getattr(ref, dead)()}):
            got = getattr(port, store).attr_counts(**kw)
            want = getattr(ref, store).attr_counts(**kw)
            assert got.dtype == want.dtype and np.array_equal(got, want), (store, kw)


def assert_same_overlay(ref, port, kinds=OV_PATTERNS) -> None:
    """The request kinds' matches (bitwise, the effective edge universe in
    the same base ++ delta order), counts, sizes and overlay stats agree."""
    assert (port.n_vertices, port.n_edges) == (ref.n_vertices, ref.n_edges)
    assert port.delta_stats() == ref.delta_stats()
    for _, text in kinds:
        assert_same_match(ref.match(text), port.match(text))
    assert_same_counts(ref, port)


def flat_state(pg) -> dict:
    """A graph's whole state on the host in ``to_arrays``' layout, for any
    backend and either package: the DI fields, each store's values and
    distinct (entity, attribute) pairs, and the typed columns."""
    g = pg.graph

    def store(s):
        ent, att = s.all_pairs()
        keys = np.unique((np.asarray(ent, np.int64) << 31) | np.asarray(att, np.int64))
        return {"values": list(s.amap.values), "n": s.n, "keys": keys}

    def cols(kind, props):
        if hasattr(pg, "host_columns"):  # the port holds uint32 columns as int64
            return pg.host_columns(kind)
        return {k: (as_np(c), as_np(v)) for k, (c, v) in props.items()}

    return {"graph": {f: as_np(getattr(g, f)) for f in ("src", "dst", "seg", "node_map")},
            "nm": (g.n, g.m, g.max_deg), "vstore": store(pg._vstore), "estore": store(pg._estore),
            "vertex_props": cols("node", pg.vertex_props),
            "edge_props": cols("edge", pg.edge_props)}


def assert_same_flat(a: dict, b: dict) -> None:
    assert a["nm"] == b["nm"]
    for f in a["graph"]:
        np.testing.assert_array_equal(a["graph"][f], b["graph"][f])
    for s in ("vstore", "estore"):
        assert a[s]["values"] == b[s]["values"] and a[s]["n"] == b[s]["n"]
        np.testing.assert_array_equal(a[s]["keys"], b[s]["keys"])
    for p in ("vertex_props", "edge_props"):
        assert set(a[p]) == set(b[p])
        for name in a[p]:
            for x, y in zip(a[p][name], b[p][name]):
                assert x.dtype == y.dtype, (p, name)
                np.testing.assert_array_equal(x, y)


class DictRegistry:
    """A dict-backed graph registry: what the overlay's ``Compactor`` sweeps
    (``names()``/``get(name)``; the service's registry comes with its port)."""

    def __init__(self, **graphs):
        self._graphs = dict(graphs)

    def register(self, name, pg):
        self._graphs[name] = pg

    def names(self):
        return list(self._graphs)

    def get(self, name):
        return self._graphs[name]


# ----------------------------------------------------------- the service (A9)
SERVE_PATTERNS = (  # the reference service tests' mix, over pgserve's tenant graphs
    "(a:l1|l2)-[:follows]->(b:l3)",
    "(a:l0 {age > 30})-[:likes]->(b)",
    "(a)<-[:likes]-(b:l4|l5)",
    "(a:l6)-[:follows]->(b)-[:likes]->(c:l7)",
)


def service_pkg(name: str):
    """The service-layer modules of one package, under one set of names:
    ``"ref"`` (JAX) or ``"port"`` (torch, graphs on the CPU).  ``build``
    makes ``pgserve.build_tenant_graph``'s tenant, ``server`` a ``PGServer``
    over a service, on the CPU for the port."""
    from types import SimpleNamespace

    if name == "ref":
        from repro import obs
        from repro.launch import pgserve
        from repro.overlay import compactor
        from repro.service import PGClient, PGServer, Service, ServiceConfig, wire

        def build(backend, m, seed):
            return pgserve.build_tenant_graph(backend, m, seed=seed)

        def server(svc):
            return PGServer(svc, port=0)
    else:
        from repro_torch import obs
        from repro_torch.launch import pgserve
        from repro_torch.overlay import compactor
        from repro_torch.service import PGClient, PGServer, Service, ServiceConfig, wire

        def build(backend, m, seed):
            return pgserve.build_tenant_graph(backend, m, seed=seed, device="cpu")

        def server(svc):
            return PGServer(svc, port=0, device="cpu")
    return SimpleNamespace(name=name, obs=obs, pgserve=pgserve, Compactor=compactor.Compactor,
                           Service=Service, ServiceConfig=ServiceConfig, PGServer=PGServer,
                           PGClient=PGClient, wire=wire, build=build, server=server)


def assert_same_blocks(a, b) -> None:
    """Two sampled block lists equal field by field, layer by layer (either
    package's ``SampledBlock`` or the wire's)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("src_nodes", "dst_nodes", "edge_src", "edge_dst", "edge_mask"):
            u, v = as_np(getattr(x, f)), as_np(getattr(y, f))
            assert u.shape == v.shape and np.array_equal(u, v), f
