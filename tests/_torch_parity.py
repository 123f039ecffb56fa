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
