"""Port ``repro_torch.traverse`` (semirings, relax, the masked analytics)
and the ``PropGraph`` analytics against ``repro.traverse``, on the CPU.

Bitwise where the reference is exact: the Boolean, tropical and min-label
relaxes, components, shortest paths (NaN, -inf and negative-cycle weights
under ``max_iters`` included) and label propagation.  PageRank and the
counting relax sum floats in another order: they are held within
``PR_ATOL``.  Then the three invariants the reference's own property tests
(``tests/test_semiring.py``, hypothesis-driven) state, over seeds 0..30 on
both packages: zero-vector absorption, seed-permutation invariance and
pattern-reorientation invariance.

Every graph of a kind has one shape (``analytics_pair``), so the
reference's jitted loops compile once, not once per seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.traverse as rt
import repro_torch.traverse as pt
from _torch_parity import analytics_pair, as_np
from repro.core import PropGraph as RefPG
from repro.core.di import DIGraph as RefDI
from repro.core.di import build_di as ref_build_di
from repro_torch.core import PropGraph as PortPG
from repro_torch.core.di import DIGraph as PortDI
from repro_torch.core.di import build_di as port_build_di
from repro_torch.traverse import engine

# PageRank: ranks of at most 1 summed over 20 iterations in another order
# differ by a few f32 ulp (1.5e-7 observed at n = 24): 1e-6 leaves room
# without admitting a wrong contribution (1/n = 0.04 here)
PR_ATOL = 1e-6
SEEDS31 = range(31)
BACKENDS = ("arr", "list", "listd")


def same(a, b) -> bool:
    """Equal shape, dtype and values; NaNs equal NaNs where they stand."""
    a, b = as_np(a), as_np(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))


def close(a, b, atol=PR_ATOL) -> bool:
    a, b = as_np(a), as_np(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.allclose(a, b, rtol=0, atol=atol)


def di_pair(seed: int, n: int = 24, m: int = 80):
    """The DI graphs of ``analytics_pair``'s edges in both packages."""
    from _torch_parity import fixed_shape_edges

    src, dst = fixed_shape_edges(seed, n, m)
    return ref_build_di(src, dst), port_build_di(src, dst, device="cpu")


def both(arr):
    """(jax array, torch tensor) of one numpy array."""
    return jnp.asarray(arr), torch.from_numpy(np.array(arr))


# ------------------------------------------------------------ relax algebra
def test_semiring_instances():
    assert len({pt.BOOLEAN, pt.TROPICAL, pt.COUNTING, pt.MINLABEL}) == 4
    for a, b in ((pt.BOOLEAN, rt.BOOLEAN), (pt.TROPICAL, rt.TROPICAL),
                 (pt.COUNTING, rt.COUNTING), (pt.MINLABEL, rt.MINLABEL)):
        assert (a.name, a.scatter) == (b.name, b.scatter)
        assert a.zero == b.zero


def _relax_inputs(sr_name: str, seed: int, n: int, m: int):
    rng = np.random.default_rng(seed)
    if sr_name == "boolean":
        return rng.random(n) < 0.4, rng.random(m) < 0.7
    if sr_name == "minlabel":
        x = rng.integers(0, n, n).astype(np.int32)
        x[rng.random(n) < 0.3] = np.iinfo(np.int32).max
        return x, rng.random(m) < 0.7
    x = rng.uniform(0, 3, n).astype(np.float32)
    if sr_name == "tropical":
        x[rng.random(n) < 0.3] = np.inf
        return x, np.where(rng.random(m) < 0.7, rng.uniform(0.5, 2, m), np.inf).astype(np.float32)
    return x, np.where(rng.random(m) < 0.7, rng.uniform(0.5, 2, m), 0).astype(np.float32)


@pytest.mark.parametrize("sr", ["boolean", "tropical", "counting", "minlabel"])
@pytest.mark.parametrize("direction,undirected", [(1, False), (-1, False), (1, True)])
def test_relax_matches_reference(sr, direction, undirected):
    rg, pg = di_pair(3)
    x, ev = _relax_inputs(sr, 5, rg.n, rg.m)
    (xr, xp), (er, ep) = both(x), both(ev)
    rsr, psr = getattr(rt, sr.upper()), getattr(pt, sr.upper())
    want = rt.semiring_relax(rg, xr, er, rsr, direction=direction, undirected=undirected)
    got = pt.semiring_relax(pg, xp, ep, psr, direction=direction, undirected=undirected)
    assert (close if sr == "counting" else same)(got, want)


@pytest.mark.parametrize("w", ["nan", "-inf"])
def test_tropical_relax_nan_messages(w):
    """A NaN message (NaN weight; -inf weight meeting an +inf tail) makes
    its head NaN, as the reference's scatter-min does."""
    rg, pg = di_pair(4)
    x, ev = _relax_inputs("tropical", 6, rg.n, rg.m)
    ev[::7] = float(w)
    (xr, xp), (er, ep) = both(x), both(ev)
    want = rt.semiring_relax(rg, xr, er, rt.TROPICAL, undirected=True)
    assert np.isnan(as_np(want)).any()
    assert same(pt.semiring_relax(pg, xp, ep, pt.TROPICAL, undirected=True), want)


# ----------------------------------------------------- the masked analytics
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_iters", [1, 2, 128])
def test_components_masked_matches_reference(seed, max_iters):
    rg, pg = di_pair(seed)
    rng = np.random.default_rng(seed)
    vm, em = rng.random(rg.n) < 0.8, rng.random(rg.m) < 0.6
    assert same(pt.components_masked(pg, max_iters=max_iters),
                rt.components_masked(rg, max_iters=max_iters))
    (vr, vp), (er, ep) = both(vm), both(em)
    assert same(pt.components_masked(pg, vp, ep, max_iters=max_iters),
                rt.components_masked(rg, vr, er, max_iters=max_iters))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shortest_paths_masked_matches_reference(seed):
    rg, pg = di_pair(seed)
    rng = np.random.default_rng(seed)
    seeds, em = rng.random(rg.n) < 0.1, rng.random(rg.m) < 0.7
    w = rng.uniform(0.5, 2.0, rg.m).astype(np.float32)
    (sr, sp), (er, ep), (wr, wp) = both(seeds), both(em), both(w)
    for kw in ({}, {"direction": -1}, {"undirected": True}, {"max_iters": 2}):
        assert same(pt.shortest_paths_masked(pg, sp, None, None, **kw),
                    rt.shortest_paths_masked(rg, sr, None, None, **kw)), kw
        assert same(pt.shortest_paths_masked(pg, sp, wp, ep, **kw),
                    rt.shortest_paths_masked(rg, sr, wr, er, **kw)), kw


ODD_WEIGHTS = {"nan": np.nan, "-inf": -np.inf, "negative_cycle": -5.0, "+inf": np.inf}


@pytest.mark.parametrize("odd", list(ODD_WEIGHTS))
@pytest.mark.parametrize("max_iters", [3, 10])
def test_shortest_paths_odd_weights(odd, max_iters):
    """A NaN, -inf, +inf or negative-cycle weight on the cycle 0→1→2→3→0
    (with a chord 1→3), ``max_iters`` set: the answers are the reference's,
    NaN for NaN."""
    src, dst = np.array([0, 1, 2, 3, 1]), np.array([1, 2, 3, 0, 3])
    rg, pg = ref_build_di(src, dst), port_build_di(src, dst, device="cpu")
    w = np.ones(5, np.float32)
    w[1] = ODD_WEIGHTS[odd]
    (wr, wp), (sr, sp) = both(w), both(np.array([True, False, False, False]))
    (er, ep) = both(np.array([True, True, False, True, True]))
    for undirected in (False, True):
        for e in ((None, None), (er, ep)):
            want = rt.shortest_paths_masked(rg, sr, wr, e[0], undirected=undirected,
                                            max_iters=max_iters)
            got = pt.shortest_paths_masked(pg, sp, wp, e[1], undirected=undirected,
                                           max_iters=max_iters)
            assert same(got, want), (undirected, e[0] is not None, as_np(got), as_np(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_pagerank_masked_matches_reference(seed):
    rg, pg = di_pair(seed)
    rng = np.random.default_rng(seed)
    vm, em = rng.random(rg.n) < 0.7, rng.random(rg.m) < 0.6
    w = rng.uniform(0.5, 2.0, rg.m).astype(np.float32)
    (vr, vp), (er, ep), (wr, wp) = both(vm), both(em), both(w)
    cases = [((None, None, None), {}), ((vr, None, None), {}), ((None, er, None), {}),
             ((None, None, wr), {}), ((vr, er, wr), {"direction": -1}),
             ((None, None, None), {"damping": 0.7, "iters": 7})]
    for (v, e, ww), kw in cases:
        pv, pe, pw = (None if a is None else torch.from_numpy(np.array(a)) for a in (v, e, ww))
        want = rt.pagerank_masked(rg, v, e, ww, **kw)
        got = pt.pagerank_masked(pg, pv, pe, pw, **kw)
        assert close(got, want), (v is not None, e is not None, ww is not None, kw)
    r = as_np(pt.pagerank_masked(pg))
    assert abs(r.sum() - 1.0) < 1e-5


def test_pagerank_empty_vertex_filter():
    rg, pg = di_pair(0)
    assert same(pt.pagerank_masked(pg, torch.zeros(pg.n, dtype=torch.bool)),
                rt.pagerank_masked(rg, jnp.zeros(rg.n, bool)))
    assert not as_np(pt.pagerank_masked(pg, torch.zeros(pg.n, dtype=torch.bool))).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_iters", [1, 3, 64])
def test_label_propagation_matches_reference(seed, max_iters):
    rg, pg = di_pair(seed)
    rng = np.random.default_rng(seed)
    (vr, vp), (er, ep) = both(rng.random(rg.n) < 0.8), both(rng.random(rg.m) < 0.6)
    assert same(pt.label_propagation_masked(pg, max_iters=max_iters),
                rt.label_propagation_masked(rg, max_iters=max_iters))
    assert same(pt.label_propagation_masked(pg, vp, ep, max_iters=max_iters),
                rt.label_propagation_masked(rg, vr, er, max_iters=max_iters))


@pytest.mark.parametrize("cap,want", [(64, [0, 1]), (7, [1, 0])])
def test_two_cycle_oscillates_to_the_cap(cap, want):
    """Synchronous LPA swaps a 2-cycle's labels every round: the cap picks
    the answer, on both packages."""
    ref = RefPG().add_edges_from(np.array([0, 1]), np.array([1, 0]))
    port = PortPG(device="cpu").add_edges_from(np.array([0, 1]), np.array([1, 0]))
    assert as_np(ref.communities(max_iters=cap)).tolist() == want
    engine.reset_rounds()
    assert same(port.communities(max_iters=cap), ref.communities(max_iters=cap))
    assert engine.rounds["communities"] == cap and engine.capped["communities"] == 1


def _empty_graphs():
    g0 = (ref_build_di(np.zeros(0, np.int64), np.zeros(0, np.int64)),
          port_build_di(np.zeros(0, np.int64), np.zeros(0, np.int64), device="cpu"))
    m0 = (RefDI(src=jnp.zeros(0, jnp.int32), dst=jnp.zeros(0, jnp.int32),
                seg=jnp.zeros(4, jnp.int32), node_map=jnp.arange(3, dtype=jnp.int32),
                n=3, m=0, max_deg=0),
          PortDI(src=torch.zeros(0, dtype=torch.int32), dst=torch.zeros(0, dtype=torch.int32),
                 seg=torch.zeros(4, dtype=torch.int32),
                 node_map=torch.arange(3, dtype=torch.int32), n=3, m=0, max_deg=0))
    return {"n0": g0, "m0": m0}


@pytest.mark.parametrize("which", ["n0", "m0"])
def test_empty_graphs(which):
    """n = 0 and m = 0: every analytic answers as the reference does
    (PageRank's n = 0 raises ZeroDivisionError in both: its teleport
    divides by the host integer n)."""
    rg, pg = _empty_graphs()[which]
    sr, sp = both(np.arange(rg.n) == 0)
    vr, vp = both(np.arange(rg.n) != 1)
    for f in (lambda m, g: m.components_masked(g),
              lambda m, g: m.label_propagation_masked(g),
              lambda m, g: m.khop_csr(g, [0, -1], k=3)):
        assert same(f(pt, pg), f(rt, rg))
    assert same(pt.shortest_paths_masked(pg, sp), rt.shortest_paths_masked(rg, sr))
    assert same(pt.khop_mask(pg, sp, k=3), rt.khop_mask(rg, sr, k=3))
    assert same(pt.label_propagation_masked(pg, vp), rt.label_propagation_masked(rg, vr))
    if which == "n0":
        with pytest.raises(ZeroDivisionError):
            rt.pagerank_masked(rg)
        with pytest.raises(ZeroDivisionError):
            pt.pagerank_masked(pg)
    else:
        assert close(pt.pagerank_masked(pg), rt.pagerank_masked(rg))
        assert close(pt.pagerank_masked(pg, vp), rt.pagerank_masked(rg, vr))


# ------------------------------------------------------ PropGraph analytics
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_propgraph_analytics_match_reference(backend, seed):
    ref, port, meta = analytics_pair(seed, backend=backend, partial_w=20)
    seeds = meta["nodes"][:3]
    for pattern in (None, "(a)-[:r]->(b)", "(a:x)-[:r]->(b)", "(a)<-[:r]-(b)",
                    "(a:x)-[:r]->(b:y)", "(v:x|y)"):
        for kw in ({}, {"weight": "w"}, {"weight": "w2"}, {"weight": "w", "undirected": True}):
            assert same(port.shortest_paths(seeds, pattern=pattern, **kw),
                        ref.shortest_paths(seeds, pattern=pattern, **kw)), (pattern, kw)
        assert same(port.components(pattern), ref.components(pattern)), pattern
        assert same(port.communities(pattern), ref.communities(pattern)), pattern
        for kw in ({}, {"weight": "w"}, {"weight": "w2", "damping": 0.6, "iters": 9}):
            assert close(port.pagerank(pattern=pattern, **kw),
                         ref.pagerank(pattern=pattern, **kw)), (pattern, kw)
    assert same(port.shortest_paths(seeds, max_iters=2), ref.shortest_paths(seeds, max_iters=2))
    assert same(port.components(max_iters=1), ref.components(max_iters=1))
    assert same(port.communities(max_iters=2), ref.communities(max_iters=2))
    with pytest.raises(KeyError, match="nope"):
        port.shortest_paths(seeds, weight="nope")
    with pytest.raises(ValueError, match="single-hop"):
        port.components("(a)-[:r]->(b)-[:s]->(c)")


def test_edge_weight_values_matches_reference():
    from repro.query import edge_weight_values as ref_ewv
    from repro_torch.query import edge_weight_values as port_ewv

    ref, port, _ = analytics_pair(0, partial_w=20)
    for name in ("w", "w2"):
        for a, b in zip(port_ewv(port, name), ref_ewv(ref, name)):
            assert same(a, b)
    with pytest.raises(KeyError, match="nope"):
        port_ewv(port, "nope")


# --------------------------------- the invariants the reference leaves unchecked
def _absorption_holds(mod, g, w, bool_ones, f_zeros, b_zeros, inf_vec) -> bool:
    out_t = as_np(mod.semiring_relax(g, inf_vec, w, mod.TROPICAL))
    out_b = as_np(mod.semiring_relax(g, b_zeros, bool_ones, mod.BOOLEAN))
    out_c = as_np(mod.semiring_relax(g, f_zeros, w, mod.COUNTING))
    return bool(np.isinf(out_t).all() and not out_b.any() and not out_c.any())


@pytest.mark.parametrize("seed", SEEDS31)
def test_relax_absorption_randomized(seed):
    """Zero-vector absorption on random graphs (one shape: the reference
    compiles its relax once), both packages."""
    rg, pg = di_pair(seed, n=20, m=60)
    w = np.random.default_rng(seed).uniform(0, 5, rg.m).astype(np.float32)
    (wr, wp) = both(w)
    assert _absorption_holds(rt, rg, wr, jnp.ones(rg.m, bool), jnp.zeros(rg.n, jnp.float32),
                             jnp.zeros(rg.n, bool), jnp.full(rg.n, np.inf, jnp.float32))
    assert _absorption_holds(pt, pg, wp, torch.ones(pg.m, dtype=torch.bool),
                             torch.zeros(pg.n), torch.zeros(pg.n, dtype=torch.bool),
                             torch.full((pg.n,), float("inf")))


@pytest.mark.parametrize("seed", SEEDS31)
def test_shortest_paths_seed_permutation_invariance(seed):
    """Distances are a function of the seed SET: order and duplicates in
    the seed list change nothing (bitwise), on both packages."""
    ref, port, meta = analytics_pair(seed, n=20, m=60)
    seeds = meta["nodes"][:4]
    shuffled = list(seeds[::-1]) + [int(seeds[0])]
    for pg in (ref, port):
        assert same(pg.shortest_paths(list(seeds), weight="w"),
                    pg.shortest_paths(shuffled, weight="w"))
    assert same(port.shortest_paths(shuffled, weight="w"), ref.shortest_paths(seeds, weight="w"))


@pytest.mark.parametrize("seed", SEEDS31)
def test_pattern_reorientation_invariance(seed):
    """``(a:x)-[:r]->(b:y)`` and ``(b:y)<-[:r]-(a:x)`` denote one edge set:
    undirected shortest paths and communities are bitwise equal under
    either, on both packages.  PageRank is not: ``<-`` walks the edges
    dst→src, so rank flows the other way (the reference's own statement of
    this invariant includes PageRank and fails on the reference; ROADMAP
    C.3).  There the port holds the reference's answer under each
    orientation."""
    ref, port, meta = analytics_pair(seed, n=20, m=60)
    fwd, rev = "(a:x)-[:r]->(b:y)", "(b:y)<-[:r]-(a:x)"
    seeds = meta["nodes"][:4]
    for pg in (ref, port):
        assert same(pg.shortest_paths(seeds, weight="w", pattern=fwd, undirected=True),
                    pg.shortest_paths(seeds, weight="w", pattern=rev, undirected=True))
        assert same(pg.communities(fwd), pg.communities(rev))
    for pattern in (fwd, rev):
        assert close(port.pagerank(pattern=pattern), ref.pagerank(pattern=pattern))
