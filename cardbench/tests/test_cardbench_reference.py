"""The benchmark's plain references against the port, on tiny graphs on the
CPU: every request kind of the pattern mix and every Graphalytics kernel
of the analytics mix."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from cardbench import generator, graphdata  # noqa: E402
from cardbench.run import load_json  # noqa: E402
from cardbench.reference import analytics, cypher, patterns  # noqa: E402

SMALL = {"labels": {"count": 4, "prefix": "l", "coverage": 1.0},
         "relationships": {"count": 4, "prefix": "r", "coverage": 1.0}}


def small_cfg(name: str, **over) -> dict:
    cfg = load_json(f"cardbench/configs/{name}.json")
    cfg.update(SMALL, **over)
    return cfg


def small_mix() -> dict:
    mix = load_json("cardbench/traffic/match_serve.json")
    for p in mix["params"]:
        if p["match"] in ("L[0-9]+", "R[0-9]+"):
            p["range"] = [0, 4]
    return mix


@pytest.fixture(scope="module")
def uniform():
    cfg = small_cfg("graph3", edges=3000, vertex_pool=1500)
    data = graphdata.make(cfg, 11, "cpu")
    pg, _ = graphdata.ingest(cfg, data, "cpu")
    return cfg, data, pg


@pytest.fixture(scope="module")
def kronecker():
    cfg = small_cfg("graph500-s20", scale=9)
    data = graphdata.make(cfg, 2**31 + 5, "cpu")
    pg, _ = graphdata.ingest(cfg, data, "cpu")
    return cfg, data, pg


KINDS = [t["kind"] for t in load_json("cardbench/traffic/match_serve.json")["templates"]]


@pytest.mark.parametrize("kind", KINDS)
def test_pattern_kind_matches_port(uniform, kind):
    cfg, data, pg = uniform
    mix = small_mix()
    mix["templates"] = [t for t in mix["templates"] if t["kind"] == kind]
    g = patterns.Graph(data, cfg, "cpu")
    stream = generator.PatternStream(mix, 3, generator.WINDOW_STREAM, 0,
                                     generator.anchors(mix, data, 3))
    matched = 0
    for _ in range(6):
        _, text = stream.next()
        res = pg.match(text)
        got = {"vertex_mask": res.vertex_mask, "edge_mask": res.edge_mask,
               "bindings": res.bindings()}
        want = patterns.match(g, text)
        assert patterns.mismatched_bits(got, want) == 0, text
        matched += int(want["edge_mask"].sum())
    assert matched > 0  # the graph is dense enough for real answers


def test_pattern_reader():
    c = cypher.parse("(a:l1|l2 {age > 5})<-[e:r0|r3*2.. {w < 0.25}]-(b)-[*]->(c:l0)")
    assert [n.var for n in c.nodes] == ["a", "b", "c"]
    assert c.nodes[0].alts == ("l1", "l2") and c.nodes[0].preds == (("age", ">", 5),)
    h0, h1 = c.hops
    assert (h0.direction, h0.lo, h0.hi, h0.alts) == (-1, 2, None, ("r0", "r3"))
    assert h0.preds == (("w", "<", 0.25),)
    assert (h1.direction, h1.lo, h1.hi, h1.alts) == (1, 1, None, ())
    assert cypher.parse("(a)-[:r1*3]->(b)").hops[0].hi == 3
    with pytest.raises(ValueError):
        cypher.parse("(a)<-[:r1]->(b)")


def _sources(data, count=3):
    """Vertices with an out-edge, drawn as the analytics driver draws them."""
    has_out = torch.unique(data["esrc"]).numpy()
    return has_out[generator.rng(7, generator.WINDOW_STREAM).integers(len(has_out), size=count)]


@pytest.mark.parametrize("kind", ["bfs", "wcc", "sssp", "pr", "cdlp"])
def test_analytics_kernel_matches_port(kronecker, kind):
    cfg, data, pg = kronecker
    src, dst, n = data["esrc"], data["edst"], data["n"]
    nodes = data["nodes"].numpy()
    w = data["eprops"]["w"]
    if kind == "bfs":
        for s in _sources(data):
            want = analytics.bfs(src, dst, n, int(s))
            assert torch.equal(pg.bfs([nodes[s]], max_iters=n).long(), want)
            assert int(want.max()) >= 2
    elif kind == "wcc":
        want = analytics.components(src, dst, n)
        assert np.array_equal(pg.components(max_iters=n).numpy(), want)
    elif kind == "sssp":
        for s in _sources(data):
            want = analytics.shortest_paths(src, dst, n, w, int(s), torch.float64)
            got = pg.shortest_paths([nodes[s]], weight="w")
            assert analytics.max_relative_gap(got, want) < 1e-6
    elif kind == "pr":
        want = analytics.pagerank(src, dst, n, torch.float64)
        assert analytics.l1_gap(pg.pagerank(damping=0.85, iters=20), want) < 1e-5
    else:
        want = analytics.communities(src, dst, n, max_iters=64)
        assert torch.equal(pg.communities(max_iters=64).long(), want)


def test_shortest_paths_reference_against_scipy(kronecker):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    _, data, _ = kronecker
    src, dst, n = data["esrc"], data["edst"], data["n"]
    w = data["eprops"]["w"]
    adj = coo_matrix((w.numpy(), (src.numpy(), dst.numpy())), shape=(n, n)).tocsr()
    for s in _sources(data):
        want = dijkstra(adj, indices=int(s))
        got = analytics.shortest_paths(src, dst, n, w, int(s), torch.float64)
        assert np.allclose(got.numpy(), want, rtol=1e-12, atol=0)


def test_communities_cap_is_part_of_the_answer():
    # a 4-cycle oscillates under synchronous updates: the cap decides the answer
    src, dst = torch.tensor([0, 1, 2, 3]), torch.tensor([1, 2, 3, 0])
    one = analytics.communities(src, dst, 4, max_iters=1)
    two = analytics.communities(src, dst, 4, max_iters=2)
    assert one.tolist() == [1, 0, 1, 0] and two.tolist() == [0, 1, 0, 1]
