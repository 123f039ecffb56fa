"""The port's overlay (``repro_torch.overlay``, ``PropGraph``'s writes after a
seal, tombstones, snapshots, forks and compaction) against the reference's
on the CPU — the contracts of ``tests/test_overlay.py`` in the port's terms.

The same inputs go through both packages; every comparison is bitwise
(masks, words as uint32, ids, labels, counts with their dtype, min-plus
distances), PageRank within ``PR_ATOL``.  Graphs and mutation streams come
from ``_torch_parity`` (``overlay_pair``, ``overlay_stream``); the
randomized streams over seeds 0..30 are in ``test_torch_overlay_streams.py``
and the threaded cases in ``test_torch_overlay_threads.py``.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (
    OV_PATTERNS,
    DictRegistry,
    as_np,
    assert_same_counts,
    assert_same_flat,
    assert_same_match,
    assert_same_overlay,
    flat_state,
    overlay_pair,
    overlay_stream,
    ref_state,
)
from repro.core import PropGraph as RefPG
from repro.graph import sampler as ref_sampler
from repro_torch.core import PropGraph
from repro_torch.graph import sampler
from repro_torch.kernels.neighbor_sample import ops as ns_ops

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BACKENDS = ("arr", "list", "listd")
PATTERN = OV_PATTERNS[0][1]
PR_ATOL = 1e-6  # f32 sums in another order (test_torch_semiring.py)


def same(a, b) -> bool:
    a, b = as_np(a), as_np(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def both(pair, method, *args, **kwargs):
    """Run one call on both packages of ``pair`` (ref, port)."""
    return tuple(getattr(pg, method)(*args, **kwargs) for pg in pair)


def _edge_pair_set(pg, emask):
    """Edge mask → external (u, v) pairs, so masks over differently ORDERED
    edge lists (base ++ delta view vs a sorted rebuild) compare."""
    g = pg._require_graph()
    em = as_np(emask)
    nm = as_np(g.node_map)
    return set(zip(nm[as_np(g.src)[em]].tolist(), nm[as_np(g.dst)[em]].tolist()))


def _fresh_pairs(meta, k, seed, pg=None):
    """``k`` (src, dst) pairs of existing vertices that are not edges (nor
    tombstoned vertices of ``pg``)."""
    rng = np.random.default_rng(seed)
    have = set(zip(meta["src"].tolist(), meta["dst"].tolist()))
    nodes = meta["nodes"]
    if pg is not None and pg._dead_v is not None:
        nodes = nodes[~pg._dead_v[pg._vertex_internal(nodes)]]
    out = []
    while len(out) < k:
        p = (int(rng.choice(nodes)), int(rng.choice(nodes)))
        if p not in have:
            have.add(p)
            out.append(p)
    return np.array([p[0] for p in out]), np.array([p[1] for p in out])


# ----------------------------------------------------------- delta queries
@pytest.mark.parametrize("backend", BACKENDS)
def test_sealed_label_delta_query_parity(backend):
    """Labels written after the seal land in the delta — values first seen
    after it too — and every query and count equals the reference's."""
    ref, port, meta = overlay_pair(0, backend)
    nodes = meta["nodes"]
    for batch in ((nodes[:12], ["zz"] * 12), (nodes[12:20], ["l1"] * 8)):
        both((ref, port), "add_node_labels", *batch)
    assert port._vstore.sealed and port._vstore._delta.size == 20
    for q in (["l1"], ["zz"], ["l1", "zz"], ["l2"], [], ["nope"]):
        assert same(port.query_labels(q), ref.query_labels(q)), q
        for impl in ({"arr": "scan", "list": None, "listd": "budget"}[backend], None):
            assert same(port._vstore.query_any(q, impl=impl), ref._vstore.query_any(q, impl=impl))
    if backend == "arr":
        qs = [["l1"], ["zz", "l3"], []]
        assert same(as_np(port._vstore.query_any_batched_words(qs), words=True),
                    ref._vstore.query_any_batched_words(qs))
        assert same(port._vstore.query_any_batched(qs), ref._vstore.query_any_batched(qs))
        assert same(as_np(port._vstore.query_any_words(["zz"]), words=True),
                    ref._vstore.query_any_words(["zz"]))
    assert_same_counts(ref, port)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sealed_relationship_delta_query_parity(backend):
    ref, port, meta = overlay_pair(1, backend)
    batch = (meta["src"][:30], meta["dst"][:30], ["mentions"] * 30)
    both((ref, port), "add_edge_relationships", *batch)
    assert port._estore._delta.size == 30
    for q in (["follows"], ["mentions"], ["follows", "mentions"], ["likes"]):
        assert same(port.query_relationships(q), ref.query_relationships(q)), q
    assert_same_counts(ref, port)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sealed_delta_match_parity(backend):
    """Full declarative matches read the delta through the mask union."""
    ref, port, meta = overlay_pair(2, backend)
    before = port.match(PATTERN)
    both((ref, port), "add_node_labels", meta["nodes"][:25], ["l1"] * 25)
    assert_same_overlay(ref, port)
    assert not same(port.match(PATTERN).vertex_mask, before.vertex_mask)  # the write shows


# ------------------------------------------------------------- delta edges
@pytest.mark.parametrize("backend", BACKENDS)
def test_insert_edges_match_khop_components_parity(backend):
    ref, port, meta = overlay_pair(3, backend)
    m_base = port.n_edges
    bs, bd = _fresh_pairs(meta, 24, 11)
    for pg in (ref, port):
        pg.insert_edges(bs, bd)
        pg.add_edge_relationships(bs, bd, ["follows"] * 24)
    assert port.delta_stats()["delta_edges"] == 24 and port.n_edges == m_base + 24
    assert port._require_graph().unsorted
    assert_same_overlay(ref, port)
    seeds = meta["nodes"][:6]
    for pattern in (None, "(a)-[:follows]->(b)", "(a:l1|l2)-[:follows]->(b:l3)",
                    "(a:l1)<-[:follows]-(b)"):
        for impl in (None, "frontier", "csr"):
            for k in (1, 3):
                assert same(port.khop(seeds, k, pattern=pattern, impl=impl),
                            ref.khop(seeds, k, pattern=pattern, impl=impl)), (pattern, impl, k)
        assert same(port.khop(seeds, 2, pattern=pattern, undirected=True),
                    ref.khop(seeds, 2, pattern=pattern, undirected=True))
        assert same(port.components(pattern), ref.components(pattern)), pattern
    # csr degrades to the frontier step on the combined view: same answer
    assert same(port.khop(seeds, 3, impl="csr"), port.khop(seeds, 3))


@pytest.mark.parametrize("backend", BACKENDS)
def test_weighted_analytics_on_an_overlay(backend):
    """shortest_paths, pagerank and communities on a graph with delta edges
    (whose ``w`` postdates the column until updated), tombstones and delta
    labels."""
    ref, port, meta = overlay_pair(4, backend)
    bs, bd = _fresh_pairs(meta, 16, 12)
    for pg in (ref, port):
        pg.insert_edges(bs, bd)
        pg.add_edge_relationships(bs, bd, ["follows"] * 16)
        pg.update_edge_properties("w", bs[:8], bd[:8], np.linspace(0.1, 0.9, 8))
        pg.delete_vertices(meta["nodes"][5:7])
        pg.delete_edges(meta["src"][:4], meta["dst"][:4])
        pg.add_node_labels(meta["nodes"][:10], ["zz"] * 10)
    seeds = meta["nodes"][[0, 5, 9]]  # 5 is dead: it drops out
    for pattern in (None, "(a)-[:follows]->(b)", "(a:l1|zz)-[:follows|likes]->(b)"):
        for weight in (None, "w"):
            for und in (False, True):
                assert same(port.shortest_paths(seeds, weight=weight, pattern=pattern,
                                                undirected=und),
                            ref.shortest_paths(seeds, weight=weight, pattern=pattern,
                                               undirected=und)), (pattern, weight, und)
            got = as_np(port.pagerank(pattern=pattern, weight=weight))
            want = as_np(ref.pagerank(pattern=pattern, weight=weight))
            assert got.dtype == want.dtype and np.allclose(got, want, rtol=0, atol=PR_ATOL)
        assert same(port.communities(pattern), ref.communities(pattern)), pattern
        assert same(port.components(pattern), ref.components(pattern)), pattern
    from repro.query.weights import edge_weight_values as ref_weights
    from repro_torch.query.weights import edge_weight_values

    for got, want in zip(edge_weight_values(port, "w"), ref_weights(ref, "w")):
        assert same(got, want)  # the padding branch: delta edges beyond the column


def test_insert_edges_dedup_and_unknown_endpoints():
    ref, port, meta = overlay_pair(5)
    v0 = port.version
    # re-inserting existing base edges is a no-op (DI: one edge per (u, v))
    both((ref, port), "insert_edges", meta["src"][:10], meta["dst"][:10])
    assert port.version == v0 and not port.has_overlay()
    # duplicates within the delta collapse too
    n = meta["nodes"]
    pair = _fresh_pairs(meta, 1, 3)
    both((ref, port), "insert_edges", np.repeat(pair[0], 3), np.repeat(pair[1], 3))
    assert port.delta_stats() == ref.delta_stats() and port.delta_stats()["delta_edges"] == 1
    for pg in (ref, port):
        with pytest.raises(ValueError, match="add_edges_from"):
            pg.insert_edges([10**9], [n[0]])
    assert _event(port.last_mutation) == _event(ref.last_mutation)


def _event(ev):
    return ev.kind, ev.structural, ev.labels, ev.rels, ev.props


# -------------------------------------------------------------- tombstones
def test_tombstone_vertex_blocks_traversal():
    ref = RefPG(backend="arr").add_edges_from([0, 1], [1, 2])
    port = PropGraph(device="cpu").add_edges_from([0, 1], [1, 2])
    both((ref, port), "delete_vertices", [1])
    assert same(port.khop([0], 2), ref.khop([0], 2))
    assert as_np(port.khop([0], 2)).tolist() == [True, False, False]
    assert same(port.components(), ref.components())
    assert as_np(port.components()).tolist() == [0, -1, 2]
    assert not as_np(port.query_labels([])).any()
    assert port.last_mutation.kind == "delete_vertices" and port.last_mutation.structural


def test_tombstone_edge_and_revival_semantics():
    port = PropGraph(device="cpu").add_edges_from([0, 1], [1, 2])
    port.delete_edges([1], [2])
    assert as_np(port.khop([0], 2)).tolist() == [True, True, False]
    v = port.version
    port.delete_edges([1], [2])  # already dead: no-op
    port.delete_edges([2], [0])  # never existed: no-op
    assert port.version == v


@pytest.mark.parametrize("backend", BACKENDS)
def test_tombstones_match_the_reference(backend):
    """Masked query surfaces and every request kind under vertex and edge
    tombstones, and the alive masks themselves."""
    ref, port, meta = overlay_pair(6, backend)
    for pg in (ref, port):
        pg.delete_vertices(meta["nodes"][5:9])
        pg.delete_edges(meta["src"][:7], meta["dst"][:7])
    assert same(port._alive_vertex_mask(), ref._alive_vertex_mask())
    assert same(port._alive_edge_mask(), ref._alive_edge_mask())
    assert same(port._dead_edge_ids(), ref._dead_edge_ids())
    assert same(port._dead_vertex_ids(), ref._dead_vertex_ids())
    assert same(port.query_labels(["l1"]), ref.query_labels(["l1"]))
    assert same(port.query_relationships(["follows"]), ref.query_relationships(["follows"]))
    assert same(port.vertex_predicate_mask("age", ">", 20), ref.vertex_predicate_mask("age", ">", 20))
    assert same(port.edge_predicate_mask("w", "<", 0.5), ref.edge_predicate_mask("w", "<", 0.5))
    assert_same_overlay(ref, port)
    for pg in (ref, port):
        sub, kept = pg.subgraph(labels=["l1", "l2"], relationships=["follows"])
        assert as_np(kept).tolist() == as_np(ref.subgraph(labels=["l1", "l2"],
                                                          relationships=["follows"])[1]).tolist()
    assert same(port.bfs(meta["nodes"][:3], relationships=["follows"]),
                ref.bfs(meta["nodes"][:3], relationships=["follows"]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_insert_after_delete_edge_revives_bare(backend):
    """delete_edges → insert_edges behaves exactly like the same sequence
    with compact() in between: the pair is back as a fresh BARE edge."""
    src, dst = np.array([0, 1, 2, 3]), np.array([1, 2, 3, 0])

    def build(cls, **kw):
        pg = cls(backend=backend, **kw).add_edges_from(src, dst)
        pg.add_edge_relationships([0], [1], ["follows"])
        pg.add_node_labels([0, 1], ["person", "person"])
        return pg

    for pg in (build(RefPG), build(PropGraph, device="cpu")):
        pg.delete_edges([0], [1])
        v0 = pg.version
        pg.insert_edges([0], [1])
        assert pg.version > v0
    a = build(PropGraph, device="cpu")
    a.delete_edges([0], [1])
    a.insert_edges([0], [1])
    b = build(PropGraph, device="cpu")
    b.delete_edges([0], [1])
    b.compact()
    b.insert_edges([0], [1])
    r = build(RefPG)
    r.delete_edges([0], [1])
    r.insert_edges([0], [1])
    for pat in ("(x)-[:follows]->(y)", "(x:person)-[]->(y)"):
        assert_same_match(r.match(pat), a.match(pat))
        assert same(a.match(pat).vertex_mask, b.match(pat).vertex_mask)
        assert _edge_pair_set(a, a.match(pat).edge_mask) == _edge_pair_set(b, b.match(pat).edge_mask)
    a.compact()
    b.compact()
    r.compact()
    assert_same_flat(flat_state(a), flat_state(b))
    assert_same_flat(flat_state(a), flat_state(r))
    assert a.n_edges == 4 and not as_np(a.query_relationships(["follows"])).any()
    # writes on the revived pair address the LIVE edge; deleting it again
    # kills the revived edge, not the old tombstone
    for c in (build(RefPG), build(PropGraph, device="cpu")):
        c.delete_edges([0], [1])
        c.insert_edges([0], [1])
        c.add_edge_relationships([0], [1], ["likes"])
        assert c.relationship_counts()["likes"] == 1
        c.delete_edges([0], [1])
        assert c.relationship_counts()["likes"] == 0
        c.compact()
        assert c.n_edges == 3


@pytest.mark.parametrize("backend", BACKENDS)
def test_insert_edges_tombstoned_endpoint_raises(backend):
    src, dst = np.array([0, 1, 2, 3]), np.array([1, 2, 3, 0])
    pre = PropGraph(backend=backend, device="cpu").add_edges_from(src, dst).delete_vertices([2])
    post = PropGraph(backend=backend, device="cpu").add_edges_from(src, dst)
    post.delete_vertices([2]).compact()
    for pg in (pre, post):
        with pytest.raises(ValueError):
            pg.insert_edges([1], [2])
        with pytest.raises(ValueError):
            pg.insert_edges([2], [3])


@pytest.mark.parametrize("backend", BACKENDS)
def test_counts_subtract_tombstones(backend):
    """label_counts / relationship_counts agree with the tombstone-masked
    queries, equal the reference's (dtype included), and stay consistent
    after compaction."""
    ref, port, meta = overlay_pair(7, backend)
    both((ref, port), "delete_vertices", meta["nodes"][:12])
    assert port.label_counts() == {
        lab: int(port.query_labels([lab]).sum()) for lab in port.label_set()}
    both((ref, port), "delete_edges", meta["src"][:25], meta["dst"][:25])
    assert port.relationship_counts() == {
        r: int(port.query_relationships([r]).sum()) for r in port.relationship_set()}
    assert_same_counts(ref, port)
    both((ref, port), "compact")
    assert port.label_counts() == {
        lab: int(port.query_labels([lab]).sum()) for lab in port.label_set()}
    assert_same_counts(ref, port)


@pytest.mark.parametrize("backend", BACKENDS)
def test_new_value_on_dead_or_unknown_entities_keeps_stats_exact(backend):
    """A write that interns a value but stores no pair (every target is a
    tombstoned edge or an unknown vertex) still widens the attribute set:
    the next plans and counts answer at the new width, as the reference's."""
    ref, port, meta = overlay_pair(23, backend)
    pair = (ref, port)
    s, d = meta["src"][:6], meta["dst"][:6]
    both(pair, "delete_edges", s, d)
    both(pair, "delete_vertices", meta["nodes"][:3])
    for _, text in OV_PATTERNS:
        assert_same_match(*both(pair, "match", text))
    assert port.label_counts() == ref.label_counts()
    assert port.relationship_counts() == ref.relationship_counts()
    both(pair, "add_edge_relationships", s, d, ["r_new"] * len(s))
    both(pair, "add_node_labels", np.array([10**6, 10**6 + 1]), ["l_new"] * 2)
    for _, text in OV_PATTERNS + (("new", "(a:l_new)-[:r_new]->(b)"),):
        assert_same_match(*both(pair, "match", text))
    assert_same_counts(ref, port)
    assert "r_new" in port.relationship_counts() and "l_new" in port.label_counts()


def test_alive_edge_and_refuses_a_mask_of_another_length():
    """An edge mask that does not cover the effective edges raises instead
    of letting tombstoned edges through."""
    _, port, meta = overlay_pair(24)
    port.delete_edges(meta["src"][:2], meta["dst"][:2])
    m = port.n_edges
    assert int(port._and_alive_edges(torch.ones(m, dtype=torch.bool)).sum()) == m - 2
    with pytest.raises(RuntimeError, match="alive edges"):
        port._and_alive_edges(torch.ones(m + 1, dtype=torch.bool))


def test_dead_attr_counts_are_cached_per_tombstone_set():
    """The planner's tombstone-exact stats are computed once per version:
    reads between writes get the same arrays, and any write (a new value on
    no stored pair included) makes the next read recompute them."""
    _, port, meta = overlay_pair(8)
    port.delete_vertices(meta["nodes"][:5])
    ids = port._dead_vertex_ids()
    assert port._dead_vertex_ids() is ids
    first = port._attr_counts("node")
    port.match(PATTERN)
    assert port._attr_counts("node") is first
    port.add_node_labels(np.array([10**6]), ["zz"])  # unknown vertex: no pair lands
    second = port._attr_counts("node")
    assert second is not first and second.shape == (first.shape[0] + 1,)
    port.delete_vertices(meta["nodes"][5:6])
    assert port._dead_vertex_ids() is not ids and port._attr_counts("node") is not second


# -------------------------------------------------------- snapshots / forks
def test_snapshot_pins_state_and_freezes_mutators():
    ref, port, meta = overlay_pair(9)
    nodes = meta["nodes"]
    before = port.match(PATTERN)
    snap = port.snapshot()
    assert snap.frozen and not port.frozen
    pair = _fresh_pairs(meta, 8, 4)
    port.add_node_labels(nodes[:20], ["l1"] * 20)
    port.insert_edges(*pair)
    port.delete_vertices(nodes[:1])
    port.add_node_properties("age2", nodes, np.arange(len(nodes)))
    port.update_node_properties("age", nodes[:3], [99, 99, 99])
    got = snap.match(PATTERN)
    assert same(got.vertex_mask, before.vertex_mask) and same(got.edge_mask, before.edge_mask)
    assert snap.n_edges == before.edge_mask.shape[0]
    for call in (
        lambda: snap.add_edges_from([0], [1]),
        lambda: snap.insert_edges(nodes[:1], nodes[1:2]),
        lambda: snap.add_node_labels(nodes[:1], ["x"]),
        lambda: snap.add_edge_relationships(nodes[:1], nodes[1:2], ["r"]),
        lambda: snap.add_node_properties("p", nodes[:1], [1]),
        lambda: snap.add_edge_properties("p", nodes[:1], nodes[1:2], [1]),
        lambda: snap.update_node_properties("age", nodes[:1], [1]),
        lambda: snap.update_edge_properties("w", meta["src"][:1], meta["dst"][:1], [1.0]),
        lambda: snap.delete_vertices(nodes[:1]),
        lambda: snap.delete_edges(nodes[:1], nodes[1:2]),
        lambda: snap.compact(),
    ):
        with pytest.raises(RuntimeError, match="frozen"):
            call()
    branch = snap.fork()  # a fork OF the snapshot is writable again
    branch.add_node_labels(nodes[:2], ["x"] * 2)
    assert not branch.frozen


def test_snapshot_of_graph_with_live_overlay():
    """The pinned state includes the delta chain as of the snapshot, in both
    packages."""
    ref, port, meta = overlay_pair(10)
    a, b = _fresh_pairs(meta, 12, 5)
    nodes = meta["nodes"]
    for pg in (ref, port):
        pg.insert_edges(a[:6], b[:6])
        pg.add_node_labels(nodes[:10], ["l1"] * 10)
    snaps = both((ref, port), "snapshot")
    want = port.match(PATTERN)
    for pg in (ref, port):
        pg.insert_edges(a[6:], b[6:])  # grows PAST the snapshot
        pg.add_node_labels(nodes[10:30], ["l1"] * 20)
    assert_same_match(want, snaps[1].match(PATTERN))
    assert_same_overlay(*snaps)
    assert snaps[1].delta_stats()["delta_edges"] == 6


def test_fork_what_if_delete_hub():
    ref, port, meta = overlay_pair(11)
    hub = meta["nodes"][np.argmax(np.bincount(as_np(port.graph.src), minlength=len(meta["nodes"])))]
    comps = port.components()
    v0 = port.version
    forks = both((ref, port), "fork")
    for f in forks:
        f.delete_vertices([hub])
    assert same(forks[1].components(), forks[0].components())
    assert not same(forks[1].components(), comps)  # the hub held something together
    assert same(port.components(), comps)  # the parent never noticed
    assert port.version == v0 and not port.has_overlay() and forks[1].version == v0 + 1


MUTATORS = {  # name -> call on a graph of overlay_pair with its meta
    "add_node_labels": lambda pg, m: pg.add_node_labels(m["nodes"][:9], ["l2"] * 9),
    "add_edge_relationships": lambda pg, m: pg.add_edge_relationships(
        m["src"][:9], m["dst"][:9], ["follows"] * 9),
    "add_node_properties": lambda pg, m: pg.add_node_properties("age", m["nodes"],
                                                                np.zeros(len(m["nodes"]))),
    "add_edge_properties": lambda pg, m: pg.add_edge_properties("w", m["src"], m["dst"],
                                                                np.zeros(len(m["src"]))),
    "update_node_properties": lambda pg, m: pg.update_node_properties(
        "age", m["nodes"][:9], np.full(9, 59)),
    "update_edge_properties": lambda pg, m: pg.update_edge_properties(
        "w", m["src"][:9], m["dst"][:9], np.full(9, 0.01)),
    "insert_edges": lambda pg, m: pg.insert_edges(*_fresh_pairs(m, 9, 6, pg)),
    "delete_vertices": lambda pg, m: pg.delete_vertices(m["nodes"][:4]),
    "delete_edges": lambda pg, m: pg.delete_edges(m["src"][:9], m["dst"][:9]),
    "compact": lambda pg, m: (pg.delete_edges(m["src"][9:12], m["dst"][9:12]), pg.compact()),
}


def _pinned(pg):
    """Everything of ``pg`` a write on another view could corrupt: its
    columns, alive masks, store answers, words and request answers, as
    host copies."""
    out = {"cols": {k: (as_np(c).copy(), as_np(v).copy())
                    for props in (pg.vertex_props, pg.edge_props) for k, (c, v) in props.items()},
           "av": None if pg._alive_vertex_mask() is None else as_np(pg._alive_vertex_mask()).copy(),
           "ae": None if pg._alive_edge_mask() is None else as_np(pg._alive_edge_mask()).copy(),
           "words": as_np(pg._vstore.query_any_words(["l1", "l2"])).copy(),
           "counts": (pg.label_counts(), pg.relationship_counts()),
           "n": (pg.n_vertices, pg.n_edges)}
    for name, text in OV_PATTERNS:
        res = pg.match(text)
        out[name] = (as_np(res.vertex_mask).copy(), as_np(res.edge_mask).copy())
    return out


def _assert_pinned(pg, want) -> None:
    got = _pinned(pg)
    assert got["n"] == want["n"] and got["counts"] == want["counts"]
    for key in want:
        if key in ("n", "counts"):
            continue
        if key == "cols":
            for name, (c, v) in want["cols"].items():
                assert np.array_equal(got["cols"][name][0], c), name
                assert np.array_equal(got["cols"][name][1], v), name
        elif want[key] is None:
            assert got[key] is None, key
        elif isinstance(want[key], tuple):
            assert all(np.array_equal(x, y) for x, y in zip(got[key], want[key])), key
        else:
            assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("on", ["parent", "fork"])
@pytest.mark.parametrize("mutator", sorted(MUTATORS))
def test_snapshot_is_isolated_from_every_mutator(mutator, on):
    """Torch tensors are mutable where the reference's arrays are not: a
    snapshot's columns, alive masks, words and answers must not move when
    any mutator runs on its parent or on a fork of it (the graph already
    carries an overlay, so cached alive masks and padded columns exist)."""
    _, port, meta = overlay_pair(12)
    a, b = _fresh_pairs(meta, 4, 8)
    port.insert_edges(a, b)
    port.update_edge_properties("w", a, b, np.full(4, 0.2))
    port.delete_vertices(meta["nodes"][-2:])
    port.delete_edges(meta["src"][-3:], meta["dst"][-3:])
    port.add_node_labels(meta["nodes"][20:30], ["zz"] * 10)
    snap = port.snapshot()
    want = _pinned(snap)
    parent_before = _pinned(port)
    target = port if on == "parent" else port.fork()
    MUTATORS[mutator](target, meta)
    _assert_pinned(snap, want)
    if on == "fork":
        _assert_pinned(port, parent_before)


def test_update_properties_match_the_reference_and_pad():
    ref, port, meta = overlay_pair(13)
    nodes = meta["nodes"]
    snap = port.snapshot()
    pinned = as_np(snap.vertex_props["age"][0]).copy()
    both((ref, port), "update_node_properties", "age", nodes[:4], [77.9, 3, -2, 10**3])
    assert same(port.host_columns("node")["age"][0], ref.vertex_props["age"][0])
    assert same(port.vertex_props["age"][1], ref.vertex_props["age"][1])
    assert np.array_equal(as_np(snap.vertex_props["age"][0]), pinned)
    assert as_np(port.vertex_props["age"][0])[port._vertex_internal(nodes[:1])][0] == 77
    for pg in (ref, port):
        with pytest.raises(KeyError, match="unknown vertex property"):
            pg.update_node_properties("nope", nodes[:1], [1])
        with pytest.raises(KeyError, match="unknown edge property"):
            pg.update_edge_properties("nope", nodes[:1], nodes[:1], [1])
    a, b = _fresh_pairs(meta, 5, 9)
    both((ref, port), "insert_edges", a, b)
    both((ref, port), "update_edge_properties", "w", a, b, [3.0] * 5)
    col, valid = port.edge_props["w"]
    assert col.shape[0] == port.n_edges
    for got, want in zip(port.host_columns("edge")["w"], ref.edge_props["w"]):
        assert same(got, want)
    assert _event(port.last_mutation) == _event(ref.last_mutation)


# -------------------------------------------------------------- compaction
@pytest.mark.parametrize("backend", BACKENDS)
def test_compact_equals_the_reference_and_a_from_scratch_build(backend):
    """After writes of every kind, compact() answers exactly like the
    reference's compaction (the whole state bitwise) and like a
    from-scratch ingest of the surviving state: the DI arrays, every
    attribute value's mask, the columns and every request kind."""
    ref, port, meta = overlay_pair(14, backend)
    for op in overlay_stream(14, meta):
        if op[0] in ("snapshot", "fork"):
            continue
        both((ref, port), op[0], *op[1])
    scratch = chip_smoke.from_scratch(port, "cpu")  # phase 3g's graph1 check
    both((ref, port), "compact")
    assert not port.has_overlay() and port._vstore._pairs_e and not port._vstore.sealed
    assert_same_flat(flat_state(port), flat_state(ref))
    assert (scratch.n_vertices, scratch.n_edges) == (port.n_vertices, port.n_edges)
    for f in ("src", "dst", "seg", "node_map"):
        assert same(getattr(scratch.graph, f), getattr(port.graph, f))
    for value in port.label_set():
        assert same(scratch.query_labels([value]), port.query_labels([value])), value
    for value in port.relationship_set():
        assert same(scratch.query_relationships([value]), port.query_relationships([value]))
    for kind in ("node", "edge"):
        for name, cols in scratch.host_columns(kind).items():
            for x, y in zip(cols, port.host_columns(kind)[name]):
                assert same(x, y), (kind, name)
    for _, text in OV_PATTERNS:
        assert_same_match(scratch.match(text), port.match(text))
    assert_same_overlay(ref, port)
    seeds = as_np(port.graph.node_map)[:6]
    for impl in ("frontier", "csr"):
        assert same(port.khop(seeds, 3, impl=impl), ref.khop(seeds, 3, impl=impl))
    assert same(port.components("(a)-[:follows]->(b)"), ref.components("(a)-[:follows]->(b)"))
    if backend == "arr":
        a, b = port.to_arrays(), ref_state(ref)
        for key in ("src", "dst", "seg", "node_map"):
            assert same(a["graph"][key], b["graph"][key])
        for s in ("vstore", "estore"):
            assert np.array_equal(a[s]["bitmap"], b[s]["bitmap"]) and a[s]["values"] == b[s]["values"]


def test_compact_is_noop_without_overlay():
    _, port, _ = overlay_pair(15)
    v0 = port.version
    port.compact()
    assert port.version == v0


def test_to_arrays_flattens_an_overlay_on_a_private_fork():
    _, port, meta = overlay_pair(16)
    port.insert_edges(*_fresh_pairs(meta, 5, 1))
    port.add_node_labels(meta["nodes"][:4], ["zz"] * 4)
    stats = port.delta_stats()
    arrays = port.to_arrays()
    assert port.delta_stats() == stats
    flat = port.fork()
    flat.compact()
    want = flat.to_arrays()
    for key in ("src", "dst", "node_map"):
        assert np.array_equal(arrays["graph"][key], want["graph"][key])
    assert np.array_equal(arrays["vstore"]["bitmap"], want["vstore"]["bitmap"])


@pytest.mark.parametrize("step", ["labels", "edges", "tombstones", "updates"])
def test_plane_only_graph_equals_an_ingested_graph_on_the_overlay(step):
    """A graph sealed from planes (``from_arrays``: no raw pairs — its pairs
    are read off the plane's bits) and the ingested graph it came from
    answer the same overlay requests, counts and compaction."""
    _, port, meta = overlay_pair(17)
    plane = PropGraph.from_arrays(port.to_arrays(), device="cpu")
    assert plane._vstore.plane_only
    a, b = _fresh_pairs(meta, 8, 2)
    for pg in (port, plane):
        pg.add_node_labels(meta["nodes"][:10], ["zz"] * 5 + ["l1"] * 5)
        if step in ("edges", "tombstones", "updates"):
            pg.insert_edges(a, b)
            pg.add_edge_relationships(a, b, ["follows"] * 8)
        if step in ("tombstones", "updates"):
            pg.delete_vertices(meta["nodes"][3:5])
            pg.delete_edges(meta["src"][:6], meta["dst"][:6])
        if step == "updates":
            pg.update_edge_properties("w", a, b, np.full(8, 0.1))
    assert_same_overlay(port, plane)
    assert np.array_equal(port._vstore.base_keys(), plane._vstore.base_keys())
    port.compact()
    plane.compact()
    assert_same_flat(flat_state(port), flat_state(plane))
    a1, a2 = port.to_arrays(), plane.to_arrays()
    for s in ("vstore", "estore"):
        assert np.array_equal(a1[s]["bitmap"], a2[s]["bitmap"])


def test_noop_mutations_keep_version():
    """Empty batches must not bump the version — all nine mutators fed
    nothing."""
    _, port, _ = overlay_pair(18)
    v0 = port.version
    empty = np.zeros(0, np.int64)
    port.add_edges_from(empty, empty)
    port.add_node_labels(empty, [])
    port.add_edge_relationships(empty, empty, [])
    port.add_node_properties("p_new", empty, empty)
    port.add_edge_properties("q_new", empty, empty, empty)
    port.insert_edges(empty, empty)
    port.delete_vertices(empty)
    port.delete_edges(empty, empty)
    port.update_node_properties("age", empty, empty)
    port.update_edge_properties("w", empty, empty, empty)
    assert port.version == v0 and "p_new" not in port.vertex_props


# -------------------------------------------------------------- compactor
def test_background_compactor_sweeps_by_threshold():
    import time

    from repro_torch.overlay import Compactor

    reg = DictRegistry()
    _, pg, meta = overlay_pair(19)
    reg.register("g", pg)
    pg.insert_edges(*_fresh_pairs(meta, 20, 3))
    assert pg.has_overlay()
    comp = Compactor(reg, threshold=4, interval=0.01)
    comp.start()
    deadline = time.monotonic() + 60
    while pg.has_overlay() and time.monotonic() < deadline:
        time.sleep(0.01)
    comp.stop()
    assert not pg.has_overlay() and comp.compactions >= 1 and not comp.is_alive()
    # frozen snapshots are never compacted; small overlays are left alone
    pg.insert_edges(*_fresh_pairs({**meta, "src": as_np(pg.graph.node_map)[as_np(pg.graph.src)],
                                   "dst": as_np(pg.graph.node_map)[as_np(pg.graph.dst)],
                                   "nodes": as_np(pg.graph.node_map)}, 2, 4))
    snap = pg.snapshot()
    reg.register("s", snap)
    assert Compactor(reg, threshold=1000).sweep() == 0 and pg.has_overlay()
    assert Compactor(reg, threshold=1).sweep() == 1
    assert not pg.has_overlay() and snap.has_overlay()


def test_compactor_records_failures_and_skips():
    from repro_torch.obs import metrics
    from repro_torch.overlay import Compactor

    reg = DictRegistry()
    _, pg, meta = overlay_pair(20)
    reg.register("g", pg)
    pg.insert_edges(*_fresh_pairs(meta, 8, 5))
    comp = Compactor(reg, threshold=1)
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("kaboom")

    failures = metrics.GLOBAL.counter("pg_compact_failures", "background compaction failures")
    before = failures.value()
    pg.compact = boom  # an instance attribute shadows the real method
    for _ in range(comp.MAX_FAILURES + 2):
        assert comp.sweep() == 0
    assert len(calls) == comp.MAX_FAILURES  # then skipped, not retried
    assert comp.errors == comp.MAX_FAILURES and "kaboom" in comp.last_error
    assert comp.stats()["failing_graphs"] == {"g": comp.MAX_FAILURES}
    assert failures.value() - before == comp.MAX_FAILURES
    del pg.compact
    pg.compact()  # a manual drain
    assert comp.sweep() == 0 and comp.stats()["failing_graphs"] == {}
    pg.insert_edges(*_fresh_pairs({"nodes": as_np(pg.graph.node_map),
                                   "src": as_np(pg.graph.node_map)[as_np(pg.graph.src)],
                                   "dst": as_np(pg.graph.node_map)[as_np(pg.graph.dst)]}, 4, 6))
    assert comp.sweep() == 1


def test_compactor_backs_off_when_the_registry_fails():
    import time

    from repro_torch.overlay import Compactor

    class Broken:
        def names(self):
            raise OSError("registry down")

    comp = Compactor(Broken(), threshold=1, interval=0.01)
    comp.start()
    deadline = time.monotonic() + 30
    while comp.errors < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    comp.stop()
    assert comp.errors >= 2 and comp.last_error.startswith("sweep: OSError")


# ------------------------------------------------------------- persistence
@pytest.mark.parametrize("backend", BACKENDS)
def test_save_flattens_overlay_and_roundtrips_across_packages(backend, tmp_path):
    """save compacts a private fork (the caller's overlay stays), each
    package loads the other's save of the same stream on every backend,
    and a second save picks up a later overlay too."""
    from repro.core import io as ref_io
    from repro_torch.core import io as port_io

    ref, port, meta = overlay_pair(21, backend)
    for op in overlay_stream(21, meta)[:8]:
        if op[0] != "snapshot":
            both((ref, port), op[0], *op[1])
    stats = port.delta_stats()
    p_path = port_io.save_propgraph(str(tmp_path / "port"), port)
    r_path = ref_io.save_propgraph(str(tmp_path / "ref"), ref)
    assert port.delta_stats() == stats and port.has_overlay()
    flat = port.fork()
    flat.compact()
    for b2 in BACKENDS:
        from_ref = port_io.load_propgraph(r_path, backend=b2, device="cpu")
        from_port = ref_io.load_propgraph(p_path, backend=b2)
        own = port_io.load_propgraph(p_path, backend=b2, device="cpu")
        for got in (from_ref, own):
            assert (got.n_vertices, got.n_edges) == (flat.n_vertices, flat.n_edges)
            for _, text in OV_PATTERNS:
                assert_same_match(from_port.match(text), got.match(text))
                assert same(got.match(text).vertex_mask, flat.match(text).vertex_mask)
        assert same(own.query_labels(["zz"]), flat.query_labels(["zz"]))
    port.insert_edges(*_fresh_pairs(meta, 6, 7, port))
    port_io.save_propgraph(p_path, port)
    flat2 = port.fork()
    flat2.compact()
    again = port_io.load_propgraph(p_path, backend=backend, device="cpu")
    assert again.n_edges == flat2.n_edges
    assert same(again.match(PATTERN).edge_mask, flat2.match(PATTERN).edge_mask)


# --------------------------------------------------- delta, events, views
def test_delta_buffers_match_the_reference():
    from repro.overlay import delta as ref_delta
    from repro_torch.overlay import delta

    rng = np.random.default_rng(0)
    ents, atts = rng.integers(0, 70, 90), rng.integers(0, 6, 90)
    ours, theirs = delta.AttrDelta(), ref_delta.AttrDelta()
    for lo in (0, 30, 60):
        for d in (ours, theirs):
            d.append(ents[lo:lo + 30], atts[lo:lo + 30])
    base = np.unique(delta.pair_keys(ents[:20], atts[:20]))
    assert same(ours.counts(6, base), theirs.counts(6, base))
    for ids in ([1], [0, 5], [], [9]):
        ids = np.array(ids, np.int32)
        for out_n in (70, 95, 96, 97):
            assert same(ours.mask(ids, out_n), theirs.mask(ids, out_n))
            assert same(as_np(ours.mask_words(ids, out_n), words=True),
                        theirs.mask_words(ids, out_n))
    frozen = ours.frozen_copy()
    ours.append([1], [2])
    assert frozen.size == 90 and ours.size == 91
    e1, e2 = delta.EdgeDelta(10), ref_delta.EdgeDelta(10)
    for d in (e1, e2):
        assert d.append([1, 2, 1, 3], [2, 3, 2, 4]) == 3
        assert d.append([1, 5], [2, 6], dead=np.array([10])) == 2  # (1, 2) revives
    assert same(e1.lookup([1, 2, 9], [2, 3, 9]), e2.lookup([1, 2, 9], [2, 3, 9]))
    for a, b in zip(e1.cat(), e2.cat()):
        assert same(a, b)


def test_mutation_events_and_pattern_refs_match_the_reference():
    from repro.overlay import delta as ref_delta
    from repro.query import parse as ref_parse
    from repro_torch.overlay import delta
    from repro_torch.query import parse

    for text in [t for _, t in OV_PATTERNS] + ["(a:x {p > 1})-[e:r|s {q < 2}]->(b:y)"]:
        got, want = delta.pattern_refs(parse(text)), ref_delta.pattern_refs(ref_parse(text))
        assert got == want
        for ev in ("structural_event", "labels_event", "rels_event", "props_event"):
            arg = {"structural_event": "insert_edges", "labels_event": ["l1", "zz"],
                   "rels_event": ["follows"], "props_event": "age"}[ev]
            ours, theirs = getattr(delta.MutationEvent, ev)(arg), getattr(
                ref_delta.MutationEvent, ev)(arg)
            assert (ours.kind, ours.structural, ours.labels, ours.rels, ours.props) == (
                theirs.kind, theirs.structural, theirs.labels, theirs.rels, theirs.props)
            assert delta.overlaps(ours, got) == ref_delta.overlaps(theirs, want)


def test_word_bits_or_into_words_as_the_reference_scatters():
    from repro_torch.overlay.delta import word_bits

    ents = np.array([0, 31, 32, 33, 31, 95, 1000])
    wid, bits = word_bits(ents)
    words = np.zeros(40, np.uint32)
    np.bitwise_or.at(words, ents >> 5, np.uint32(1) << (ents & 31).astype(np.uint32))
    dense = np.zeros(40, np.uint32)
    dense[wid] = bits.view(np.uint32)
    assert np.array_equal(dense, words) and np.unique(wid).size == wid.size


def test_khop_csr_refuses_an_unsorted_view():
    from repro_torch.traverse import khop_csr

    _, port, meta = overlay_pair(22)
    port.insert_edges(*_fresh_pairs(meta, 3, 9))
    with pytest.raises(ValueError, match="unsorted"):
        khop_csr(port._require_graph(), [0], k=2)


# ---------------------------------------------------------------- sampling
def _reference_draws(monkeypatch, seed: int, layers: int):
    keys = {sampler.layer_key(seed, li): ref_sampler.layer_key(seed, li)
            for li in range(layers)}

    def draw(key, shape, device):
        return torch.from_numpy(np.array(jax.random.uniform(keys[int(key)], shape))).to(device)

    monkeypatch.setattr(ns_ops, "_draw_priorities", draw)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("edge_filter", [None, "(a)-[e:follows {w < 0.5}]->(b:l1|l3)"])
@pytest.mark.parametrize("seeds_kind", ["ids", "pattern"])
def test_sample_on_the_overlay_view_matches_the_reference(backend, edge_filter, seeds_kind,
                                                          monkeypatch):
    """The re-sorted sampling view (seg, dst, max degree, perm) equals the
    reference's, and the blocks sampled over it — delta edges in, dead
    edges and seeds out — equal the reference's on the same priorities."""
    ref, port, meta = overlay_pair(23, backend)
    for op in overlay_stream(23, meta):
        if op[0] not in ("snapshot", "fork"):
            both((ref, port), op[0], *op[1])
    for got, want in zip(port._sampling_view(), ref._sampling_view()):
        assert same(got, want) if not isinstance(want, int) else got == want
    assert port._sampling_view() is port._sampling_view()  # one sort per view
    seeds = {"ids": np.concatenate([meta["nodes"][:20], [10**6]]), "pattern": "(a:l2|zz)"}[seeds_kind]
    _reference_draws(monkeypatch, 5, 2)
    got = port.sample(seeds, [3, 2], seed=5, pattern=edge_filter)
    want = ref.sample(seeds, [3, 2], seed=5, pattern=edge_filter)
    assert len(got) == len(want)
    for bg, bw in zip(got, want):
        for f in ("src_nodes", "dst_nodes", "edge_src", "edge_dst", "edge_mask"):
            assert same(getattr(bg, f), getattr(bw, f)), f
    assert got[-1].edge_mask.any()
