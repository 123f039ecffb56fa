"""Port ``repro_torch.core.di`` against ``repro.core.di``: the same seeded
endpoint arrays through both packages, every field bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np
from repro.core import di as rdi
from repro_torch.core import di as tdi


def _edges(seed, pool=50, m=400):
    rng = np.random.default_rng(seed)
    return rng.integers(0, pool, m), rng.integers(0, pool, m)


def _assert_same_graph(port, ref):
    for f in ("src", "dst", "seg", "node_map"):
        a, b = as_np(getattr(port, f)), as_np(getattr(ref, f))
        assert a.dtype == b.dtype == np.int32, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (port.n, port.m, port.max_deg) == (ref.n, ref.m, ref.max_deg)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dedupe", [True, False])
def test_build_di_matches_reference(seed, normalize, dedupe):
    src, dst = _edges(seed)
    if not normalize:  # ids must already be dense
        src, dst = src % 37, dst % 37
    ref = rdi.build_di(src, dst, normalize=normalize, dedupe=dedupe)
    port = tdi.build_di(src, dst, normalize=normalize, dedupe=dedupe, device="cpu")
    _assert_same_graph(port, ref)
    _assert_same_graph(tdi.build_reverse_di(port), rdi.build_reverse_di(ref))
    for a, b in zip(tdi.degrees(port), rdi.degrees(ref)):
        np.testing.assert_array_equal(as_np(a), as_np(b))
    assert tdi.max_degree(port) == rdi.max_degree(ref)


def test_build_di_n_override_and_errors():
    src, dst = _edges(5)
    ref = rdi.build_di(src, dst, n=60)
    port = tdi.build_di(src, dst, n=60, device="cpu")
    _assert_same_graph(port, ref)
    with pytest.raises(ValueError, match="smaller than distinct"):
        tdi.build_di(src, dst, n=3, device="cpu")
    with pytest.raises(ValueError, match="equal-length"):
        tdi.build_di(src, dst[:-1], device="cpu")


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("max_deg_known", [True, False])
def test_edge_lookup_matches_reference_with_misses(seed, max_deg_known):
    src, dst = _edges(seed)
    ref = rdi.build_di(src, dst)
    port = tdi.build_di(src, dst, device="cpu")
    if not max_deg_known:  # the conservative ⌈log₂ m⌉ trip count
        ref = rdi.DIGraph(ref.src, ref.dst, ref.seg, ref.node_map, ref.n, ref.m)
        port = tdi.DIGraph(port.src, port.dst, port.seg, port.node_map, port.n, port.m)
    rng = np.random.default_rng(seed + 10)
    eu = rng.integers(0, port.n, 500).astype(np.int32)
    ev = rng.integers(0, port.n, 500).astype(np.int32)
    eu[:100], ev[:100] = as_np(port.src)[:100], as_np(port.dst)[:100]  # hits
    got = as_np(tdi.edge_lookup(port, torch.from_numpy(eu), torch.from_numpy(ev)))
    np.testing.assert_array_equal(got, as_np(rdi.edge_lookup(ref, jnp.asarray(eu), jnp.asarray(ev))))
    assert (got[:100] >= 0).all() and (got == -1).any()
    # every answer is right: a hit names the pair, a miss has no such edge
    s, d = as_np(port.src), as_np(port.dst)
    pairs = set(zip(s.tolist(), d.tolist()))
    for u, v, e in zip(eu, ev, got):
        assert (e >= 0) == ((u, v) in pairs)
        if e >= 0:
            assert (s[e], d[e]) == (u, v)


def test_edge_lookup_empty_graph():
    g = tdi.build_di(np.zeros(0, np.int64), np.zeros(0, np.int64), device="cpu")
    assert g.n == 0 and g.m == 0
    got = tdi.edge_lookup(g, torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32))
    assert (got == -1).all()


@pytest.mark.parametrize("max_deg", [1, 4, 9])
def test_neighbors_padded_matches_reference(max_deg):
    src, dst = _edges(7)
    ref = rdi.build_di(src, dst)
    port = tdi.build_di(src, dst, device="cpu")
    u = np.arange(port.n, dtype=np.int32)
    rn, rv = rdi.neighbors_padded(ref, jnp.asarray(u), max_deg=max_deg)
    pn, pv = tdi.neighbors_padded(port, torch.from_numpy(u), max_deg=max_deg)
    np.testing.assert_array_equal(as_np(pn), as_np(rn))
    np.testing.assert_array_equal(as_np(pv), as_np(rv))
