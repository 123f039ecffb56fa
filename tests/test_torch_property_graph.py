"""Port ``repro_torch.core.PropGraph`` (one device) against
``repro.core.PropGraph``: ingest, label/relationship queries, predicate
masks on int64 and float64 columns, counts, subgraphs and BFS from the same
seeded raw inputs, bitwise; ``from_arrays`` fed the reference graph's
state; and on every backend (arr, list, listd) ``chip_smoke.py``'s phase-3
request kinds, every listd impl, ``explain()`` and the counts."""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import (
    LABELS,
    RELS,
    as_np,
    assert_same_match,
    build_pair,
    ingest,
    raw_inputs,
    ref_state,
)
from repro_torch.core import PropGraph
from repro_torch.core import queries as tq

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(params=[(0, False), (1, False), (0, True)], ids=["packed0", "packed1", "byte0"])
def pair(request):
    seed, byte = request.param
    return build_pair(raw_inputs(seed), byte=byte)


def test_ingest_state_matches_reference(pair):
    ref, port = pair
    state = ref_state(ref)
    got = port.to_arrays()
    for f in ("src", "dst", "seg", "node_map", "n", "m", "max_deg"):
        np.testing.assert_array_equal(got["graph"][f], state["graph"][f], err_msg=f)
    for s in ("vstore", "estore"):
        for f in ("values", "k", "n", "packed"):
            assert got[s][f] == state[s][f], (s, f)
        np.testing.assert_array_equal(got[s]["bitmap"], state[s]["bitmap"])
    for props in ("vertex_props", "edge_props"):
        assert set(got[props]) == set(state[props])
        for name, (col, valid) in state[props].items():
            np.testing.assert_array_equal(got[props][name][0], col)
            assert got[props][name][0].dtype == col.dtype  # narrowed as the reference
            np.testing.assert_array_equal(got[props][name][1], valid)


def test_label_and_relationship_queries(pair):
    ref, port = pair
    queries = [[], ["nope"], ["rare"], ["mid", "common"], list(LABELS), ["rare", "nope"]]
    for impl in (None, "scan", "matvec", "kernel"):
        for q in queries:
            np.testing.assert_array_equal(as_np(port.query_labels(q, impl=impl)),
                                          as_np(ref.query_labels(q, impl=impl)))
        for q in [[], ["follows"], ["likes", "knows"], list(RELS)]:
            np.testing.assert_array_equal(as_np(port.query_relationships(q, impl=impl)),
                                          as_np(ref.query_relationships(q, impl=impl)))
    batched = [["rare"], ["mid", "common"], ["nope"]]
    np.testing.assert_array_equal(as_np(port._vstore.query_any_batched(batched)),
                                  as_np(ref._vstore.query_any_batched(batched)))
    if port._vstore.packed:
        np.testing.assert_array_equal(
            as_np(port._vstore.query_any_batched_words(batched), words=True),
            as_np(ref._vstore.query_any_batched_words(batched)))
        np.testing.assert_array_equal(
            as_np(port._estore.query_any_words(["likes"]), words=True),
            as_np(ref._estore.query_any_words(["likes"])))


@pytest.mark.parametrize("op", ["==", "!=", "<", "<=", ">", ">="])
@pytest.mark.parametrize("value", [30, 29.5, -1, 0.5])
def test_predicate_masks_int64_and_float64_columns(pair, op, value):
    ref, port = pair
    np.testing.assert_array_equal(as_np(port.vertex_predicate_mask("age", op, value)),
                                  as_np(ref.vertex_predicate_mask("age", op, value)))
    np.testing.assert_array_equal(as_np(port.edge_predicate_mask("w", op, value)),
                                  as_np(ref.edge_predicate_mask("w", op, value)))


def test_float64_column_narrows_like_reference():
    """0.1 is not a float32: compared after narrowing, ``w == 0.1`` holds
    for the narrowed value exactly as in the reference."""
    raw = raw_inputs(3)
    raw["ws"] = np.full(len(raw["ws"]), 0.1)
    ref, port = build_pair(raw)
    for op in ("==", ">", "<"):
        np.testing.assert_array_equal(as_np(port.edge_predicate_mask("w", op, 0.1)),
                                      as_np(ref.edge_predicate_mask("w", op, 0.1)))
    assert as_np(port.edge_predicate_mask("w", "==", 0.1)).any()


@pytest.mark.parametrize("value", [2**31, 2**33, -2**33])
def test_out_of_range_integer_literal_raises_like_reference(value):
    """An int64 column is an int32 column on the device; a literal outside
    int32 is refused by both packages instead of wrapping."""
    ref, port = build_pair(raw_inputs(0))
    for pg in (ref, port):
        with pytest.raises(OverflowError):
            pg.vertex_predicate_mask("age", "<", value)
        with pytest.raises(OverflowError):
            pg.match(f"(a {{age < {value}}})")


def _uint32_pair():
    ref, port = build_pair(raw_inputs(0))
    nodes = as_np(ref.graph.node_map)
    vals = (np.arange(len(nodes), dtype=np.uint64) * 2654435761 % 2**32).astype(np.uint32)
    vals[:3] = (0, 2**32 - 3, 2**32 - 1)
    ref.add_node_properties("u", nodes, vals)
    port.add_node_properties("u", nodes, vals)
    return ref, port


def _same_or_both_overflow(ref_fn, port_fn) -> None:
    try:
        want = as_np(ref_fn())
    except OverflowError:
        with pytest.raises(OverflowError):
            port_fn()
        return
    np.testing.assert_array_equal(as_np(port_fn()), want)


def test_uint32_column_negative_literal_splits_from_reference():
    """ROADMAP C.4, repaired: on a uint32 column the reference wraps a
    negative literal into uint32 (``u > -3`` is ``u > 4294967293``), and
    so does the port now."""
    ref, port = _uint32_pair()
    np.testing.assert_array_equal(as_np(port.vertex_predicate_mask("u", ">", -3)),
                                  as_np(ref.vertex_predicate_mask("u", ">", -3)))
    assert as_np(port.vertex_predicate_mask("u", ">", -3)).sum() == 1
    assert port.to_arrays()["vertex_props"]["u"][0].dtype == np.uint32


@pytest.mark.parametrize("value", [-2**31 - 1, -2**31, -3, -1, 0, 2**31 - 1, 2**32 - 1, 2**32,
                                   2**33])
def test_uint32_column_literal_sweep_matches_reference(value):
    """Each literal either compares as the reference's (wrapped into
    uint32) or raises ``OverflowError`` in both — through the predicate
    mask and through ``match()``."""
    ref, port = _uint32_pair()
    for op in ("==", "!=", "<", "<=", ">", ">="):
        _same_or_both_overflow(lambda: ref.vertex_predicate_mask("u", op, value),
                               lambda: port.vertex_predicate_mask("u", op, value))
        text = f"(a {{u {op} {value}}})"
        _same_or_both_overflow(lambda: ref.match(text).vertex_mask,
                               lambda: port.match(text).vertex_mask)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.uint16, np.uint64])
def test_narrow_integer_columns_wrap_literals_like_reference(dtype):
    ref, port = build_pair(raw_inputs(1))
    nodes = as_np(ref.graph.node_map)
    vals = np.arange(len(nodes)).astype(dtype)
    ref.add_node_properties("c", nodes, vals)
    port.add_node_properties("c", nodes, vals)
    for value in (-3, -1, 0, 7, 255, 256, 2**16, 2**31):
        for op in ("==", ">", "<"):
            _same_or_both_overflow(lambda: ref.vertex_predicate_mask("c", op, value),
                                   lambda: port.vertex_predicate_mask("c", op, value))


def test_counts_and_sets(pair):
    ref, port = pair
    assert port.label_counts() == ref.label_counts()
    assert port.relationship_counts() == ref.relationship_counts()
    assert port.label_set() == ref.label_set()
    assert port.relationship_set() == ref.relationship_set()
    assert (port.n_vertices, port.n_edges) == (ref.n_vertices, ref.n_edges)
    assert port._vstore.nnz == ref._vstore.nnz


def test_subgraph_and_bfs(pair):
    ref, port = pair
    rs, rk = ref.subgraph(labels=["mid", "common"], relationships=["likes"])
    ps, pk = port.subgraph(labels=["mid", "common"], relationships=["likes"])
    np.testing.assert_array_equal(pk, rk)
    for f in ("src", "dst", "seg", "node_map"):
        np.testing.assert_array_equal(as_np(getattr(ps, f)), as_np(getattr(rs, f)))
    srcs = as_np(ref.graph.node_map)[:3]
    np.testing.assert_array_equal(as_np(port.bfs(srcs)), as_np(ref.bfs(srcs)))
    np.testing.assert_array_equal(as_np(port.bfs(srcs, labels=["common"], relationships=["likes"])),
                                  as_np(ref.bfs(srcs, labels=["common"], relationships=["likes"])))


def test_connected_entities_matches_reference(pair):
    from repro.core import queries as rq
    import jax.numpy as jnp

    ref, port = pair
    seed = np.zeros(port.n_vertices, bool)
    seed[:2] = True
    em = port.query_relationships(["follows"])
    got = tq.connected_entities(port.graph, torch.from_numpy(seed), edge_allowed=em)
    want = rq.connected_entities(ref.graph, jnp.asarray(seed),
                                 edge_allowed=ref.query_relationships(["follows"]))
    np.testing.assert_array_equal(as_np(got), as_np(want))


@pytest.mark.parametrize("byte", [False, True])
def test_from_arrays_of_reference_state(byte):
    """The reference graph's state, pulled out with np.asarray, imports into
    a port graph equal field for field to one the port built itself, and
    matches bitwise."""
    from _torch_parity import assert_same_match

    ref, port = build_pair(raw_inputs(4), byte=byte)
    imported = PropGraph.from_arrays(ref_state(ref), device="cpu")
    a, b = imported.to_arrays(), port.to_arrays()
    for f in a["graph"]:
        np.testing.assert_array_equal(a["graph"][f], b["graph"][f])
        if f in ("src", "dst", "seg", "node_map"):
            assert getattr(imported.graph, f).dtype == getattr(port.graph, f).dtype
    for s in ("vstore", "estore"):
        assert {k: v for k, v in a[s].items() if k != "bitmap"} == \
               {k: v for k, v in b[s].items() if k != "bitmap"}
        np.testing.assert_array_equal(a[s]["bitmap"], b[s]["bitmap"])
    assert imported.label_counts() == port.label_counts()
    for props in ("vertex_props", "edge_props"):
        for name in b[props]:
            for x, y in zip(a[props][name], b[props][name]):
                np.testing.assert_array_equal(x, y)
    for text in ("(a:rare)-[:follows]->(b:common)",
                 "(a {age > 20})-[e:likes {w < 0.5}]->(b)<-[:knows*1..2]-(c:mid)"):
        assert_same_match(ref.match(text), imported.match(text))
    # and the port's own state round-trips
    again = PropGraph.from_arrays(port.to_arrays(), device="cpu")
    assert_same_match(port.match("(a:mid)-[:likes*]->(b:rare)"),
                      again.match("(a:mid)-[:likes*]->(b:rare)"))


def test_unported_parts_raise(tmp_path):
    with pytest.raises(ValueError, match="save_propgraph"):  # planes are arr-only
        PropGraph(backend="list", device="cpu").add_edges_from([1], [2]).to_arrays()
    with pytest.raises(ValueError, match="backend"):
        PropGraph(backend="nope", device="cpu")
    # meshes are ported (tests/test_torch_shard_pg.py); what is not a mesh raises
    with pytest.raises(TypeError, match="mesh"):
        PropGraph(mesh=object(), device="cpu")
    from repro_torch.core.io import save_propgraph
    from repro_torch.service import GraphRegistry

    _, port = build_pair(raw_inputs(0))
    with pytest.raises(TypeError, match="mesh"):  # the service's sharded reopen
        GraphRegistry().load("g", save_propgraph(str(tmp_path / "g"), port), mesh=object())
    # the overlay is ported: a write after the seal lands in the delta, and
    # a snapshot refuses writes
    port.add_node_labels(as_np(port.graph.node_map)[:2], "late")
    assert port._vstore.sealed and port._vstore._delta.size == 2
    assert int(port.query_labels(["late"]).sum()) == 2
    with pytest.raises(RuntimeError, match="frozen"):
        port.snapshot().add_node_labels(as_np(port.graph.node_map)[:1], "later")


def test_version_and_mutation_hooks():
    seen = []
    pg = PropGraph(device="cpu").on_mutation(lambda g: seen.append(g.version))
    pg.add_edges_from([1, 2], [2, 3])
    pg.add_node_labels([1], ["x"])
    pg.add_node_labels([], [])  # no-op: no bump
    assert seen == [1, 2] and pg.version == 2


# ------------------------------------------------------------ every backend
BACKENDS = ("arr", "list", "listd")


def _phase3_raw(seed: int) -> dict:
    """The parity graph in ``chip_smoke.py``'s vocabulary (labels l0–l3,
    relationships r0–r2, ages 0–99), so its request kinds apply as written."""
    raw = raw_inputs(seed)
    rng = np.random.default_rng(seed + 50)
    raw["labels"] = rng.choice([f"l{i}" for i in range(4)], size=len(raw["labels"]))
    raw["rels"] = rng.choice([f"r{i}" for i in range(3)], size=len(raw["rels"]))
    raw["ages"] = rng.integers(0, 100, len(raw["ages"]))
    return raw


@functools.lru_cache(maxsize=None)
def _backend_pair(backend: str, seed: int):
    """(reference PropGraph, port PropGraph on the CPU) on ``backend``."""
    from repro.core import PropGraph as RefPG

    raw = _phase3_raw(seed)
    return (ingest(RefPG(backend=backend), raw),
            ingest(PropGraph(backend=backend, device="cpu"), raw))


@pytest.fixture(params=[(b, s) for b in BACKENDS for s in (0, 1)],
                ids=[f"{b}{s}" for b in BACKENDS for s in (0, 1)])
def backend_pair(request):
    return _backend_pair(*request.param)


REQUEST_KINDS = chip_smoke.requests(6)


@pytest.mark.parametrize("kind, text", REQUEST_KINDS, ids=[k for k, _ in REQUEST_KINDS])
def test_request_kinds_match_reference_on_every_backend(backend_pair, kind, text):
    ref, port = backend_pair
    assert port.explain(text) == ref.explain(text)
    assert_same_match(ref.match(text), port.match(text))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("impl", ["linked", "inverted", "budget"])
def test_listd_impls_match_reference(impl, seed):
    ref, port = _backend_pair("listd", seed)
    for _, text in REQUEST_KINDS:
        assert port.explain(text, impl=impl) == ref.explain(text, impl=impl)
        assert_same_match(ref.match(text, impl=impl), port.match(text, impl=impl))
    for q in ([], ["nope"], ["l0"], ["l1", "l3"], ["l0", "l1", "l2", "l3"]):
        np.testing.assert_array_equal(as_np(port.query_labels(q, impl=impl)),
                                      as_np(ref.query_labels(q, impl=impl)))
    np.testing.assert_array_equal(as_np(port.query_relationships(["r1", "r2"], impl=impl)),
                                  as_np(ref.query_relationships(["r1", "r2"], impl=impl)))


def test_counts_and_queries_match_reference_on_every_backend(backend_pair):
    """listd counts keep repeated pairs (its ``a_off``), list and arr count
    each pair once: the counts, ``nnz`` and the planner's estimates follow."""
    ref, port = backend_pair
    assert port.label_counts() == ref.label_counts()
    assert port.relationship_counts() == ref.relationship_counts()
    assert (port._vstore.nnz, port._estore.nnz) == (ref._vstore.nnz, ref._estore.nnz)
    assert port._vstore.packed == ref._vstore.packed
    batched = [["l0"], ["l1", "l2"], ["nope"], []]
    np.testing.assert_array_equal(as_np(port._vstore.query_any_batched(batched)),
                                  as_np(ref._vstore.query_any_batched(batched)))
    for q in ([], ["l2"], ["l0", "l3"]):
        np.testing.assert_array_equal(as_np(port.query_labels(q)), as_np(ref.query_labels(q)))


def test_listd_counts_keep_repeated_pairs():
    """A label given twice to one vertex counts twice on listd, once on the
    others — as in the reference."""
    from repro.core import PropGraph as RefPG

    for backend, want in (("arr", 1), ("list", 1), ("listd", 2)):
        graphs = [g.add_edges_from([1, 2], [2, 3]).add_node_labels([1, 1], ["x", "x"])
                  for g in (RefPG(backend=backend), PropGraph(backend=backend, device="cpu"))]
        assert graphs[1].label_counts() == graphs[0].label_counts() == {"x": want}


@pytest.mark.parametrize("backend", ["list", "listd"])
def test_words_and_planes_are_arr_only(backend):
    port = ingest(PropGraph(backend=backend, device="cpu"), _phase3_raw(0))
    assert not port._vstore.packed and not port._estore.packed
    with pytest.raises(ValueError, match="packed"):
        port._vstore.query_any_words(["l0"])
    with pytest.raises(ValueError, match="packed"):
        port._estore.query_any_batched_words([["r0"]])
    with pytest.raises(ValueError, match="save_propgraph"):
        port.to_arrays()


@pytest.mark.parametrize("backend", ["list", "listd"])
def test_list_graphs_take_the_bool_combine(backend, monkeypatch):
    """The executor's packed combine is for arr stores only: a list or
    listd graph takes the bool combine even where its stores would claim
    packed planes."""
    from repro_torch.core import property_graph
    from repro_torch.query import executor

    port = ingest(PropGraph(backend=backend, device="cpu"), _phase3_raw(0))
    assert not port._vstore.packed and not port._estore.packed
    ref_res = ingest(PropGraph(backend="arr", device="cpu"), _phase3_raw(0)).match(
        REQUEST_KINDS[2][1])

    def refuse(*_):
        raise AssertionError("a list/listd graph took the packed combine")

    monkeypatch.setattr(executor, "_execute_plan_packed", refuse)
    monkeypatch.setattr(property_graph._AttrStore, "packed", property(lambda self: True))
    assert_same_match(ref_res, port.match(REQUEST_KINDS[2][1]))


@pytest.mark.parametrize("backend", ["list", "listd"])
def test_sample_on_every_backend_equals_arr(backend):
    """The same key draws the same blocks whichever store answered the seed
    pattern and the edge filter."""
    raw = _phase3_raw(0)
    arr = ingest(PropGraph(backend="arr", device="cpu"), raw)
    other = ingest(PropGraph(backend=backend, device="cpu"), raw)
    for seeds, flt in (("(a:l0)", None), ("(a:l1 {age > 50})", "(a)-[e:r1 {w < 0.5}]->(b)")):
        want = arr.sample(seeds, [3, 2], key=7, pattern=flt)
        got = other.sample(seeds, [3, 2], key=7, pattern=flt)
        assert chip_smoke.same_blocks(got, want)
        assert any(b.edge_mask.any() for b in got)


@pytest.mark.parametrize("backend", BACKENDS)
def test_default_device_is_the_card(backend, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PropGraph(backend=backend)
