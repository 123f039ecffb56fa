"""Port ``repro_torch.query`` against ``repro.query``: parse round trips and
errors, ``explain()`` text, and ``match()`` masks and bindings on seeded
random patterns (fixed, reversed, predicate, ``*lo..hi`` and ``*`` hops),
packed and byte layouts, bitwise; and the documented error contracts."""
import numpy as np
import pytest

from _torch_parity import LABELS, RELS, assert_same_match, build_pair, raw_inputs
from repro.query import ParseError as RefParseError
from repro.query import parse as ref_parse
from repro_torch.core import PropGraph
from repro_torch.query import EdgePattern, NodePattern, ParseError, Pattern, Predicate, parse

# the texts of tests/test_query_engine.py
TEXTS = [
    "(a)",
    "(a:person)",
    "(:person|place)",
    "(a:person {age > 30})",
    '(a:person {age >= 30, name == "bob"})',
    "(a:person)-[:follows]->(b:person)",
    "(a)<-[r:follows|likes]-(b:place {x < -3})",
    "(a:l1)-[:r1]->(b)-[e2:r2 {w != 0.5}]->(c:l2|l3)",
    "(a {score <= 1.5})",
    "(a:x)-[:r*1..3]->(b)",
    "(a)-[v:r|s*]->(b:y)",
    "(a)<-[:r*2..]-(b)",
    "(a)-[:r*3 {w > 0.5}]->(b)",
    "(a)-[:r*0..2]->(b)",
    "(a)-[:r*..4]->(b)",
    "(a {x > 1.})",
    "(a)<-[:r]-(b {x = 3})",
]
BAD = [
    "(a", "(a)-(b)", "(a)-[:r]-(b)", "(a)->[:r]->(b)", "(a{x~3})",
    "(a)-[:r*3..1]->(b)", "(a)-[:r*1.5]->(b)", "(a)-[:r*-2]->(b)", "(a:x*2)-[:r]->(b)",
    "(a)-[:r]->(a)", "(a)-[x:r]->(b)<-[x:s]-(c)", "(v)-[v:r]->(b)", "", "(a)-[:r]->",
]


@pytest.mark.parametrize("text", TEXTS)
def test_parse_round_trip_matches_reference(text):
    pat = parse(text)
    assert parse(pat.to_text()) == pat
    assert pat.to_text() == ref_parse(text).to_text()


@pytest.mark.parametrize("text", BAD)
def test_parse_errors_match_reference(text):
    with pytest.raises(RefParseError) as ref_err:
        ref_parse(text)
    with pytest.raises(ParseError) as err:
        parse(text)
    assert str(err.value) == str(ref_err.value)  # same message, same position


def _random_pattern(rng) -> Pattern:
    """A random chain of 1–3 hops over the fixture's vocabulary."""
    hops = int(rng.integers(1, 4))
    names = iter("abcdefgh")

    def labels():
        k = int(rng.integers(0, 3))
        return tuple(rng.choice(LABELS, size=k, replace=False))

    def node():
        preds = ()
        if rng.random() < 0.3:
            preds = (Predicate("age", str(rng.choice(["<", ">=", "!="])), int(rng.integers(0, 60))),)
        return NodePattern(var=next(names) if rng.random() < 0.7 else None,
                           labels=labels(), predicates=preds)

    def edge():
        rels = tuple(rng.choice(RELS, size=int(rng.integers(0, 3)), replace=False))
        preds = ()
        if rng.random() < 0.25:
            preds = (Predicate("w", str(rng.choice(["<", ">"])), float(np.round(rng.random(), 2))),)
        kind = rng.random()
        lo, hi = 1, 1
        if kind < 0.25:
            lo = int(rng.integers(0, 3))
            hi = lo + int(rng.integers(0, 3))
        elif kind < 0.4:
            lo, hi = int(rng.integers(0, 2)), None
        return EdgePattern(var=next(names) if rng.random() < 0.5 else None, rels=rels,
                           predicates=preds, direction=int(rng.choice([1, -1])), lo=lo, hi=hi)

    nodes = [node()]
    edges = []
    for _ in range(hops):
        edges.append(edge())
        nodes.append(node())
    return Pattern(nodes=tuple(nodes), edges=tuple(edges))


FIXED = [
    "(a:rare)-[:follows]->(b:common)",
    "(a:rare)<-[:likes]-(b:mid|common)",
    "(a)-[:follows]->(b:rare)<-[:follows]-(c)",
    "(a:common)-[f:follows|likes]->(b:rare)",
    "(a:rare|mid {age > 30})-[:likes]->(b)",
    "(a:rare {age <= 20})",
    "(a)",
    "(a:nope)-[:follows]->(b)",
    "(a:mid)-[e:likes {w < 0.5}]->(b)-[:knows*1..3]->(c:rare)",
    "(a:rare)-[:likes*]->(b:common)",
    "(a:common)<-[v:follows|knows*0..2]-(b)",
    "(a)-[:likes*1]->(b:mid)-[:follows*0..]->(c)",
]


@pytest.fixture(scope="module", params=[False, True], ids=["packed", "byte"])
def graphs(request):
    return build_pair(raw_inputs(11), byte=request.param)


@pytest.mark.parametrize("text", FIXED)
def test_match_fixed_patterns_bitwise(graphs, text):
    ref, port = graphs
    assert port.explain(text) == ref.explain(text)
    assert_same_match(ref.match(text), port.match(text))


@pytest.mark.parametrize("seed", range(12))
def test_match_random_patterns_bitwise(graphs, seed):
    ref, port = graphs
    text = _random_pattern(np.random.default_rng(seed)).to_text()
    assert port.explain(text) == ref.explain(text), text
    assert_same_match(ref.match(text), port.match(text))


@pytest.mark.parametrize("impl", ["scan", "matvec", "kernel"])
def test_match_impl_override_bitwise(graphs, impl):
    ref, port = graphs
    text = "(a:rare|mid)-[:likes]->(b:common)<-[:follows*1..2]-(c)"
    assert port.explain(text, impl=impl) == ref.explain(text, impl=impl)
    assert_same_match(ref.match(text, impl=impl), port.match(text, impl=impl))


def test_match_result_helpers(graphs):
    ref, port = graphs
    text = "(a:rare)-[f:follows|likes]->(b:common)"
    r, p = ref.match(text), port.match(text)
    assert (p.n_vertices(), p.n_edges()) == (r.n_vertices(), r.n_edges())
    (rs, rk), (ps, pk) = r.subgraph(ref.graph), p.subgraph(port.graph)
    np.testing.assert_array_equal(pk, rk)
    assert (ps.n, ps.m) == (rs.n, rs.m)


def test_error_contracts(graphs):
    _, port = graphs
    with pytest.raises(RuntimeError, match="add_edges_from"):
        PropGraph(device="cpu").match("(a:x)")
    with pytest.raises(RuntimeError, match="add_edges_from"):
        PropGraph(device="cpu").query_labels(["x"])
    with pytest.raises(KeyError):
        port.match("(a {height > 3})")
    with pytest.raises(TypeError, match="labels/relationships"):
        port.match('(a {age != "old"})')
    with pytest.raises(TypeError, match="age"):
        port.explain('(a {age != "old"})')
    with pytest.raises(ParseError):
        port.match("(a)-[:r]-(b)")
    with pytest.raises(ValueError, match="MAX_VARLEN"):
        port.match("(a)-[:likes*1..40]->(b)")
    with pytest.raises(ValueError, match="lower bound"):
        port.match("(a)-[:likes*2..]->(b)")
