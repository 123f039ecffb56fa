"""Port k-hop against the reference, on the CPU: ``khop_csr`` ==
``khop_mask`` == ``repro.traverse`` at k ∈ {0, 1, 3, 7}; ``PropGraph.khop``
under every filter layer (relationship, edge predicate, endpoint labels,
node-only, reversed hop, undirected), with ``impl="csr"`` and its degrade
cases (``direction=-1``, ``undirected``), on all three backends; seed ids
outside [0, n) as the reference takes them; and the round counters.  All
bitwise.  Last, ``examples/quickstart_torch.py`` end to end on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.traverse as rt
import repro_torch.traverse as pt
from _torch_parity import analytics_pair, as_np, fixed_shape_edges
from repro.core.di import build_di as ref_build_di
from repro_torch.core.di import build_di as port_build_di
from repro_torch.traverse import engine


def same(a, b) -> bool:
    a, b = as_np(a), as_np(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def di_pair(seed: int, n: int = 25, m: int = 90):
    src, dst = fixed_shape_edges(seed, n, m)
    return ref_build_di(src, dst), port_build_di(src, dst, device="cpu")


@pytest.mark.parametrize("k", [0, 1, 3, 7])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_khop_csr_equals_khop_mask_equals_reference(k, seed):
    rg, pg = di_pair(seed)
    rng = np.random.default_rng(k + 10 * seed)
    e_ok = rng.random(rg.m) > 0.4
    seeds = rng.integers(0, rg.n, 3)
    seed_mask = np.zeros(rg.n, bool)
    seed_mask[seeds] = True
    want = rt.khop_mask(rg, jnp.asarray(seed_mask), jnp.asarray(e_ok), k=k)
    e_p, s_p = torch.from_numpy(e_ok), torch.from_numpy(seed_mask)
    assert same(pt.khop_mask(pg, s_p, e_p, k=k), want)
    assert same(pt.khop_csr(pg, seeds, e_p, k=k), want)
    assert same(pt.khop_csr(pg, seeds, e_p, k=k), rt.khop_csr(rg, seeds, jnp.asarray(e_ok), k=k))
    for kw in ({"direction": -1}, {"undirected": True}):
        assert same(pt.khop_mask(pg, s_p, e_p, k=k, **kw),
                    rt.khop_mask(rg, jnp.asarray(seed_mask), jnp.asarray(e_ok), k=k, **kw))
    if k == 7:
        assert same(pt.reach_closure(pg, s_p, e_p),
                    rt.reach_closure(rg, jnp.asarray(seed_mask), jnp.asarray(e_ok)))


def test_khop_csr_max_deg_cuts_windows():
    """An explicit ``max_deg`` below the widest window reads only that many
    lanes of each window, as the reference's padded gather does."""
    rg, pg = di_pair(3)
    seeds = np.arange(6)
    for max_deg in (1, 2):
        assert same(pt.khop_csr(pg, seeds, None, k=3, max_deg=max_deg),
                    rt.khop_csr(rg, seeds, None, k=3, max_deg=max_deg))


@pytest.mark.parametrize("ids", [[25], [30], [-1], [-27], [-25], [-26], [0, -1], [2**31 - 1],
                                 [-2**31], [3, 3, 40, -2]])
def test_out_of_range_seed_ids(ids):
    """Seeds outside [0, n) passed straight to ``khop_csr`` (n = 25): the
    reference marks them as its ``.at[ids].set`` scatter does (wrap in
    [-n, -1], drop the rest) and expands the windows ``seg[ids]`` reads
    (wrap in [-(n+1), -1], clamp the rest) — so -1 marks vertex n-1 without
    expanding it and -n marks vertex 0 but expands vertex 1.  The port
    answers the same."""
    rg, pg = di_pair(0)
    for k in (1, 2, 4):
        assert same(pt.khop_csr(pg, ids, None, k=k), rt.khop_csr(rg, ids, None, k=k)), k


@pytest.mark.parametrize("backend", ["arr", "list", "listd"])
def test_propgraph_khop_every_filter_layer(backend):
    ref, port, meta = analytics_pair(11, n=30, m=120, backend=backend)
    rng = np.random.default_rng(5)
    nodes, es, ed = meta["nodes"], meta["es"], meta["ed"]
    ages = rng.integers(0, 60, len(nodes)).astype(np.int32)
    for pg in (ref, port):
        pg.add_node_properties("age", nodes, ages)
    seeds = nodes[:4]
    patterns = [None, "(a)-[:r]->(b)", "(a)-[:r {w > 1.0}]->(b:y)", "(a:x {age > 20})-[:s]->(b)",
                "(a)<-[:r]-(b)", "(v:x)", "(v:x|y {age < 40})", "(a:x)<-[:r|s {w < 1.5}]-(b:z)"]
    for pattern in patterns:
        for k in (1, 3):
            want = ref.khop(seeds, k, pattern=pattern)
            for impl in (None, "frontier", "csr"):
                assert same(port.khop(seeds, k, pattern=pattern, impl=impl), want), (pattern, impl)
                # undirected: csr degrades to the frontier step
                assert same(port.khop(seeds, k, pattern=pattern, impl=impl, undirected=True),
                            ref.khop(seeds, k, pattern=pattern, undirected=True)), (pattern, impl)
    # unknown and absent seeds drop out; duplicates change nothing
    assert same(port.khop([int(nodes[0]), 10**9, int(nodes[0])], 2),
                ref.khop([int(nodes[0]), 10**9, int(nodes[0])], 2))
    with pytest.raises(ValueError, match="unknown impl"):
        port.khop(seeds, 2, impl="bitmap")
    with pytest.raises(ValueError, match="single-hop"):
        port.khop(seeds, 2, pattern="(a)-[:r]->(b)-[:s]->(c)")
    with pytest.raises(ValueError, match="variable-length"):
        port.khop(seeds, 2, pattern="(a)-[:r*1..2]->(b)")


def test_round_counters():
    """``engine.rounds`` counts the rounds each loop ran; ``capped`` the
    calls that stopped at their cap still changing."""
    _, port, meta = analytics_pair(0)
    seeds = meta["nodes"][:2]
    engine.reset_rounds()
    port.khop(seeds, 1)
    port.khop(seeds, 2, impl="csr")
    assert engine.rounds["khop"] == 1 and engine.capped["khop"] == 1
    assert 1 <= engine.rounds["khop_csr"] <= 2
    port.components()
    port.pagerank(iters=5)
    assert engine.rounds["pagerank"] == 5 and engine.rounds["components"] >= 1
    assert "components" not in engine.capped
    engine.reset_rounds()
    assert engine.rounds == {} and engine.capped == {}


def test_quickstart_example_runs_on_cpu():
    """The torch twin of ``examples/quickstart.py`` (steps 1–6), end to end
    at a small graph."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, str(root / "examples" / "quickstart_torch.py"),
                           "--device", "cpu", "--edges", "20000"], capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK"
    assert "backend agreement" in proc.stdout and "k-hop:" in proc.stdout
