"""Port ``repro_torch.graph.algorithms`` and ``graph.typed_algorithms``
against the reference's, on the CPU: the engine aliases
(``connected_components``, ``pagerank``), ``triangle_count``,
``degree_histogram``, ``khop_typed``, ``label_histogram``,
``typed_components`` and ``attribute_assortativity``.  Bitwise, but
PageRank within the float-sum tolerance of ``test_torch_semiring.py`` and
the assortativity ratio, which both packages round once in f32."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import analytics_pair, as_np
from repro.graph import algorithms as ra
from repro.graph import typed_algorithms as rta
from repro_torch.graph import algorithms as pa
from repro_torch.graph import typed_algorithms as pta

PR_ATOL = 1e-6  # f32 sums in another order (see test_torch_semiring.py)


def same(a, b) -> bool:
    a, b = as_np(a), as_np(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_aliases_match_reference(seed):
    ref, port, meta = analytics_pair(seed)
    assert same(pa.connected_components(port.graph), ra.connected_components(ref.graph))
    assert same(pa.connected_components(port.graph, max_iters=1),
                ra.connected_components(ref.graph, max_iters=1))
    em = meta["rels"] == "r"
    for kw in ({}, {"edge_mask": em}, {"damping": 0.7, "iters": 7}):
        pkw = {**kw, "edge_mask": torch.from_numpy(em)} if "edge_mask" in kw else kw
        rkw = {**kw, "edge_mask": jnp.asarray(em)} if "edge_mask" in kw else kw
        got, want = as_np(pa.pagerank(port.graph, **pkw)), as_np(ra.pagerank(ref.graph, **rkw))
        assert got.dtype == want.dtype and np.allclose(got, want, rtol=0, atol=PR_ATOL)
    # the alias is the PropGraph verb with no filter
    assert same(pa.pagerank(port.graph), port.pagerank())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangle_count_and_degree_histogram(seed):
    # dense enough for triangles: 60 distinct pairs over 12 vertices
    ref, port, _ = analytics_pair(seed, n=12, m=60)
    max_deg = ref.graph.max_deg
    want = ra.triangle_count(ref.graph, max_deg=max_deg)
    assert int(want) > 0
    assert same(pa.triangle_count(port.graph, max_deg=max_deg), want)
    # fewer lanes than the widest window: both count only the lanes they read
    assert same(pa.triangle_count(port.graph, max_deg=2), ra.triangle_count(ref.graph, max_deg=2))
    # no lanes at all (ROADMAP C.17): an int32 zero, not a reshape error
    assert same(pa.triangle_count(port.graph, max_deg=0), ra.triangle_count(ref.graph, max_deg=0))
    # the edgeless graph at its own widest window, which is 0
    from repro.core.di import build_di as ref_build_di
    from repro_torch.core.di import build_di as port_build_di

    eg_ref, eg_port = ref_build_di([], []), port_build_di([], [], device="cpu")
    assert eg_port.max_deg == eg_ref.max_deg == 0
    assert same(pa.triangle_count(eg_port, max_deg=eg_port.max_deg),
                ra.triangle_count(eg_ref, max_deg=eg_ref.max_deg))
    for n_bins in (3, 64):
        assert same(pa.degree_histogram(port.graph, n_bins=n_bins),
                    ra.degree_histogram(ref.graph, n_bins=n_bins))


@pytest.mark.parametrize("seed", [0, 1])
def test_typed_algorithms_match_reference(seed):
    ref, port, meta = analytics_pair(seed)
    n = meta["n"]
    em = meta["rels"] == "s"
    for seeds in ([0, 3], [n - 1, -1, n, -n - 2]):  # ids outside [0, n): wrap or drop
        for k in (1, 3):
            assert same(pta.khop_typed(port.graph, torch.tensor(seeds), torch.from_numpy(em), k=k),
                        rta.khop_typed(ref.graph, jnp.asarray(seeds), jnp.asarray(em), k=k))
    (pc, pl), (rc, rl) = pta.label_histogram(port), rta.label_histogram(ref)
    assert same(pc, rc) and pl == rl
    for rels, mi in ((["r"], 64), (["s"], 2), (["r", "s"], 64)):
        assert same(pta.typed_components(port, rels, max_iters=mi),
                    rta.typed_components(ref, rels, max_iters=mi))
    for labels in (["x"], ["x", "y"], ["nope"]):
        assert pta.attribute_assortativity(port, labels) == rta.attribute_assortativity(
            ref, labels)


@pytest.mark.parametrize("backend", ["arr", "list", "listd"])
@pytest.mark.parametrize("seed", [0, 1])
def test_label_histogram_and_attr_counts_keep_the_reference_dtype(backend, seed):
    """The per-attribute statistics equal the reference's in dtype and
    values on every store (ROADMAP C.18: listd's are int32, read off
    ``a_off``; arr's and list's int64)."""
    ref, port, _ = analytics_pair(seed, backend=backend)
    (pc, pl), (rc, rl) = pta.label_histogram(port), rta.label_histogram(ref)
    assert same(pc, rc) and pl == rl
    for store in ("_vstore", "_estore"):
        assert same(getattr(port, store).attr_counts(), getattr(ref, store).attr_counts())


@pytest.mark.parametrize("k", [1, 2])
def test_match_result_expand_matches_reference(k):
    """``MatchResult.expand``: the k-hop halo of a match, through
    ``khop_typed``."""
    ref, port, meta = analytics_pair(2)
    pattern = "(a:x)-[:r]->(b:y)"
    em = meta["rels"] == "s"
    assert same(port.match(pattern).expand(port.graph, k), ref.match(pattern).expand(ref.graph, k))
    assert same(port.match(pattern).expand(port.graph, k, edge_allowed=torch.from_numpy(em)),
                ref.match(pattern).expand(ref.graph, k, edge_allowed=jnp.asarray(em)))
