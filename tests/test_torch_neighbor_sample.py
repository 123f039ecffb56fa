"""The port's neighbor_sample (B3's plain version and the sampling entries)
against the reference package on the CPU.

The same numpy priorities go to both sides, so the selection is held
bitwise; the reference's Pallas kernel is not the oracle (it calls
``pl.load``, which this JAX lacks), its XLA lowering ``_window_select`` and
the numpy ``select_by_priority_ref`` are.  Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np, random_csr
from repro.graph import sampler as ref_sampler
from repro.kernels.neighbor_sample import ops as ref_ops
from repro.kernels.neighbor_sample.ref import select_by_priority_ref as np_select
from repro_torch.core import bitplane
from repro_torch.graph import sampler
from repro_torch.kernels.neighbor_sample import ops, ref

N = 40  # vertices of the random CSR
S = 24  # seed rows, the last 4 of them pad rows


def _inputs(seed: int, w: int, ties: bool):
    seg, dst, edge_ok, words = random_csr(seed, N, w)
    rng = np.random.default_rng(seed + 1)
    zero = np.flatnonzero(np.diff(seg) == 0)
    seeds = rng.integers(0, N, S).astype(np.int32)
    seeds[:2] = zero[:2]  # degree-0 seeds
    valid = np.arange(S) < S - 4
    u = rng.random((S, w)).astype(np.float32)
    if ties:  # three distinct values: most lanes tie with others
        u = (np.floor(u * 3) / 3).astype(np.float32)
    return seg, dst, edge_ok, words, seeds, valid, u


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_words(words):
    return None if words is None else _t(words.view(np.int32))


def _jax_uniform(keys: dict):
    """A ``_draw_priorities`` stand-in returning the reference's uniforms
    for the reference key that ``keys`` maps the port's key to."""
    def draw(key, shape, device):
        return _t(np.asarray(jax.random.uniform(keys[int(key)], shape))).to(device)
    return draw


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("w", [8, 16, 64])
@pytest.mark.parametrize("fanout", [1, 3, 8])
def test_window_select_matches_reference(fanout, w, filtered, ties):
    seg, dst, edge_ok, words, seeds, valid, u = _inputs(fanout * 100 + w, w, ties)
    words = words if filtered else None
    m = len(dst)
    got = ops._window_select(_t(seg), _t(dst), m, N, _t(seeds), _t(valid), _port_words(words),
                             _t(u), fanout)
    want = ref_ops._window_select(
        jnp.asarray(seg), jnp.asarray(dst), m, N, jnp.asarray(seeds), jnp.asarray(valid),
        None if words is None else jnp.asarray(words), jnp.asarray(u), fanout)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(as_np(g), np.asarray(r))
        assert as_np(g).dtype == np.asarray(r).dtype
    # and the numpy oracle on the real rows
    nb, ei, mk = np_select(seg, dst, seeds[valid], edge_ok if filtered else None, u[valid],
                           fanout)
    np.testing.assert_array_equal(as_np(got[0])[valid], nb)
    np.testing.assert_array_equal(as_np(got[1])[valid], ei)
    np.testing.assert_array_equal(as_np(got[2])[valid], mk)
    assert not as_np(got[2])[~valid].any() and (as_np(got[0])[~valid] == -1).all()


@pytest.mark.parametrize("filtered", [False, True])
def test_window_select_ref_takes_start_and_degree(filtered):
    """The kernel's contract: degrees past W are cut to the window and a
    zero degree masks the row, whatever its start."""
    seg, dst, edge_ok, words, seeds, valid, u = _inputs(3, 16, ties=True)
    start = seg[seeds]
    deg = np.where(valid, seg[seeds + 1] - start, 0).astype(np.int32)
    got = ops.window_select(_t(start), _t(deg), _t(dst), _port_words(words if filtered else None),
                            _t(u), fanout=5)
    want = np_select(seg, dst, seeds, edge_ok if filtered else None, u, 5)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(as_np(g)[valid], r[valid])
    assert not as_np(got[2])[~valid].any()


def _mixed_csr(seed: int):
    """A CSR mixing the window sizes one call of the card's kernel meets:
    Poisson(1) out-degrees, mid-size windows (9-32 edges), hubs (40-1,000)
    with the largest as the last vertex (its window ends at m), degree-0
    vertices, and an edge filter that forbids every edge of some windows."""
    rng = np.random.default_rng(seed)
    n = 200
    deg = rng.poisson(1.0, n)
    pick = rng.random(n)
    deg = np.where(pick < 0.08, rng.integers(9, 33, n), deg)
    deg = np.where(pick > 0.95, rng.integers(40, 1001, n), deg)
    deg[-1] = 1000
    seg = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    m = int(seg[-1])
    dst = rng.integers(0, n, m).astype(np.int32)
    edge_ok = rng.random(m) < 0.5
    blocked = rng.choice(n, 20, replace=False)
    for v in blocked:
        edge_ok[seg[v]:seg[v + 1]] = False
    words = np.packbits(np.concatenate([edge_ok, np.zeros(-m % 32, bool)]),
                        bitorder="little").view("<u4").astype(np.uint32)
    hubs = np.flatnonzero(deg >= 40)
    busy = np.intersect1d(blocked, np.flatnonzero(deg > 0))
    return seg, dst, edge_ok, words, hubs, busy


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("w", [16, 1024])
@pytest.mark.parametrize("fanout", [1, 10, 15])
@pytest.mark.parametrize("r", [1, 8])
def test_window_select_mixed_windows_match_reference(r, fanout, w, ties):
    """Small windows, hubs and fully filtered windows in one call, R rows
    of seeds with one edge-word row each: every row equals the reference's
    ``_window_select`` and the numpy oracle, on the same priorities."""
    seg, dst, edge_ok, words, hubs, busy = _mixed_csr(r * 1000 + w + fanout)
    rng = np.random.default_rng(w + fanout)
    s, n, m = 48, len(seg) - 1, len(dst)
    seeds = rng.integers(0, n, (r, s)).astype(np.int32)
    seeds[:, 0], seeds[:, 1], seeds[:, 2] = n - 1, hubs[0], busy[0]
    valid = rng.random((r, s)) < 0.9
    u = rng.random((r, s, w)).astype(np.float32)
    if ties:
        u = (np.floor(u * 3) / 3).astype(np.float32)
    row_ok = np.stack([edge_ok if i % 2 == 0 else ~edge_ok for i in range(r)])
    row_words = np.stack([words if i % 2 == 0 else ~words for i in range(r)])
    row_words[:, -1] &= np.uint32((1 << (m % 32)) - 1) if m % 32 else np.uint32(0xFFFFFFFF)
    for ew, oks in ((None, [None] * r), (words, [edge_ok] * r), (row_words, row_ok)):
        got = ops._window_select(_t(seg), _t(dst), m, n, _t(seeds), _t(valid),
                                 None if ew is None else _t(ew.view(np.int32)), _t(u), fanout)
        for i in range(r):
            row = None if ew is None else (ew if ew.ndim == 1 else ew[i])
            want = ref_ops._window_select(
                jnp.asarray(seg), jnp.asarray(dst), m, n, jnp.asarray(seeds[i]),
                jnp.asarray(valid[i]), None if row is None else jnp.asarray(row),
                jnp.asarray(u[i]), fanout)
            for g, ref_out in zip(got, want):
                np.testing.assert_array_equal(as_np(g)[i], np.asarray(ref_out))
            keep = valid[i]
            oracle = np_select(seg, dst, seeds[i][keep], oks[i], u[i][keep], fanout)
            for g, o in zip(got, oracle):
                np.testing.assert_array_equal(as_np(g)[i][keep], o)


def test_window_select_checks_its_inputs():
    seg, dst, _ok, words, seeds, valid, u = _inputs(0, 8, ties=False)
    start = _t(seg[seeds])
    deg = _t(np.diff(seg)[seeds].astype(np.int32))
    with pytest.raises(ValueError, match="fanout"):
        ops.window_select(start, deg, _t(dst), None, _t(u), fanout=9)
    with pytest.raises(TypeError, match="float32"):
        ops.window_select(start, deg, _t(dst), None, _t(u).double(), fanout=2)
    with pytest.raises(TypeError, match="int32"):
        ops.window_select(start.long(), deg, _t(dst), None, _t(u), fanout=2)
    with pytest.raises(ValueError, match="cover"):
        ops.window_select(start, deg, _t(dst), _port_words(words)[:1], _t(u), fanout=2)
    with pytest.raises(ValueError, match=r"\(R, S\)"):
        ops.window_select(start, deg, _t(dst), _port_words(np.stack([words] * 2)), _t(u),
                          fanout=2)
    ops.reset_launches()
    ops.window_select(start, deg, _t(dst), None, _t(u), fanout=2)
    assert ops.launches[ops.WINDOW_SELECT] == 0  # the CPU runs the plain version


def test_empty_edge_set_masks_every_slot():
    seg = torch.zeros(4, dtype=torch.int32)
    dst = torch.zeros(0, dtype=torch.int32)
    nb, ei, mk = ops._window_select(seg, dst, 0, 3, torch.tensor([0, 2], dtype=torch.int32),
                                    torch.tensor([True, True]), None,
                                    torch.rand((2, 8)), 3)
    assert not mk.any() and (nb == -1).all() and (ei == -1).all()
    nb, _ei, mk = ops.neighbor_sample(torch.zeros(1, dtype=torch.int32), dst, 0, 0, [0], 1,
                                      fanout=2)
    assert nb.shape == (16, 2) and not mk.any()


def test_batched_rows_equal_solo_runs():
    """Row r of one batched call draws from key r and reads its own edge
    words only: it equals the request run alone (the port's own draws)."""
    seg, dst, edge_ok, words, _s, _v, _u = _inputs(5, 16, ties=False)
    rng = np.random.default_rng(11)
    R, cap = 3, 16
    seeds = rng.integers(0, N, (R, cap)).astype(np.int32)
    counts = [16, 9, 1]
    valid = np.arange(cap)[None, :] < np.array(counts)[:, None]
    row_words = np.stack([words, ~words & words, np.full_like(words, 0xFFFFFFFF)])
    row_words[2] = bitplane.pack_bits_host(np.ones(len(dst), bool))
    keys = [101, 202, 2**62 + 3]
    got = ops.neighbor_sample_batched(_t(seg), _t(dst), N, len(dst), seeds, valid, keys,
                                      fanout=4, edge_words=row_words.view(np.int32))
    for r in range(R):
        solo = ops.neighbor_sample(_t(seg), _t(dst), N, len(dst), seeds[r, :counts[r]], keys[r],
                                   fanout=4, edge_words=row_words[r])
        for g, s in zip(got, solo):
            np.testing.assert_array_equal(as_np(g[r]), as_np(s))


def test_batched_matches_reference_given_its_priorities(monkeypatch):
    seg, dst, _ok, words, _s, _v, _u = _inputs(6, 16, ties=False)
    R, cap = 4, 16
    rng = np.random.default_rng(12)
    seeds = rng.integers(0, N, (R, cap)).astype(np.int32)
    valid = rng.random((R, cap)) < 0.8
    row_words = np.stack([words, np.roll(words, 1), words, ~words])
    jkeys = ref_sampler.layer_keys_batch(jnp.arange(R), 0)
    keys = [int(k) for k in sampler.layer_keys_batch(np.arange(R), 0)]
    monkeypatch.setattr(ops, "_draw_priorities",
                        _jax_uniform({k: jkeys[i] for i, k in enumerate(keys)}))
    got = ops.neighbor_sample_batched(_t(seg), _t(dst), N, len(dst), seeds, valid, keys,
                                      fanout=5, edge_words=row_words.view(np.int32))
    want = ref_ops.neighbor_sample_batched(jnp.asarray(seg), jnp.asarray(dst), N, len(dst),
                                           seeds, valid, jkeys, fanout=5,
                                           edge_words=jnp.asarray(row_words))
    for g, r in zip(got, want):
        np.testing.assert_array_equal(as_np(g), np.asarray(r))


@pytest.mark.parametrize("filtered", [False, True])
def test_from_words_matches_reference(monkeypatch, filtered):
    seg, dst, _ok, words, _s, _v, _u = _inputs(7, 16, ties=False)
    seed_mask = np.random.default_rng(13).random(N) < 0.4
    jkey = jax.random.PRNGKey(4)
    monkeypatch.setattr(ops, "_draw_priorities", _jax_uniform({99: jkey}))
    ew = words if filtered else None
    got = ops.neighbor_sample_from_words(
        _t(seg), _t(dst), N, len(dst), bitplane.pack_mask(_t(seed_mask)), int(seed_mask.sum()),
        99, fanout=3, edge_words=ew)
    want = ref_ops.neighbor_sample_from_words(
        jnp.asarray(seg), jnp.asarray(dst), N, len(dst),
        jnp.asarray(bitplane.pack_bits_host(seed_mask)), int(seed_mask.sum()), jkey, fanout=3,
        edge_words=None if ew is None else jnp.asarray(ew))
    for g, r in zip(got, want):
        np.testing.assert_array_equal(as_np(g), np.asarray(r))


def test_sample_embed_matches_reference(monkeypatch):
    """Means are sums in another order: atol 1e-6 on unit-normal rows."""
    seg, dst, _ok, words, _s, _v, _u = _inputs(8, 16, ties=False)
    table = np.random.default_rng(14).standard_normal((N, 16)).astype(np.float32)
    seeds = np.arange(0, 30, dtype=np.int32)
    jkey = jax.random.PRNGKey(6)
    monkeypatch.setattr(ops, "_draw_priorities", _jax_uniform({6: jkey}))
    got = ops.sample_embed(_t(seg), _t(dst), N, len(dst), seeds, 6, _t(table), fanout=5,
                           edge_words=words)
    want = ref_ops.sample_embed(jnp.asarray(seg), jnp.asarray(dst), N, len(dst), seeds, jkey,
                                jnp.asarray(table), fanout=5, edge_words=jnp.asarray(words))
    np.testing.assert_allclose(as_np(got[0]), np.asarray(want[0]), rtol=0, atol=1e-6)
    for g, r in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(as_np(g), np.asarray(r))
    dead = ~as_np(got[3]).any(1)
    assert dead.any() and (as_np(got[0])[dead] == 0).all()


def test_bucket_functions_match_reference():
    for v in list(range(0, 70)) + [100, 127, 128, 129, 1000, 4095, 4097, 2**20 + 1]:
        assert ops.bucketed_seeds(v) == ref_ops.bucketed_seeds(v)
        assert ops.bucketed_window(v) == ref_ops.bucketed_window(v)
        if v >= 1:
            assert ops.bucketed_requests(v) == ref_ops.bucketed_requests(v)
    for mod in (ops, ref_ops):
        with pytest.raises(ValueError):
            mod.bucketed_requests(0)
    assert (ops.SEED_BUCKET_MIN, ops.WINDOW_BUCKET_MIN, ops.REQUEST_BUCKETS) == \
           (ref_ops.SEED_BUCKET_MIN, ref_ops.WINDOW_BUCKET_MIN, ref_ops.REQUEST_BUCKETS)


def test_shape_counter_counts_distinct_shapes():
    seg, dst, *_ = _inputs(9, 8, ties=False)
    before = ops.sample_compile_count()
    for s in (3, 5, 16, 17):  # two capacity buckets
        ops.neighbor_sample(_t(seg), _t(dst), N, len(dst), np.arange(s), 1, fanout=2)
    assert ops.sample_compile_count() - before <= 2


@pytest.mark.parametrize("filtered", [False, True])
def test_own_draws_pass_the_oracle_and_reproduce(filtered):
    seg, dst, edge_ok, words, *_ = _inputs(10, 16, ties=False)
    seeds = np.arange(N, dtype=np.int32)
    ew = words if filtered else None
    a = ops.neighbor_sample(_t(seg), _t(dst), N, len(dst), seeds, 5, fanout=6, edge_words=ew)
    b = ops.neighbor_sample(_t(seg), _t(dst), N, len(dst), seeds, 5, fanout=6, edge_words=ew)
    c = ops.neighbor_sample(_t(seg), _t(dst), N, len(dst), seeds, 6, fanout=6, edge_words=ew)
    for x, y in zip(a, b):
        assert x.equal(y)
    assert not a[1].equal(c[1])
    ref.check_sample(seg, dst, seeds, edge_ok if filtered else None, 6,
                     *(as_np(x)[:N] for x in a))


def test_uniformity_chi_square_and_filtered_exclusion():
    """One hub, 64 out-edges, half filtered out.  2048 draws of fanout=1
    in ONE batched call: the 32 allowed lanes must be uniform (chi-square,
    31 dof: 99.9th percentile ≈ 61.1) and the forbidden lanes never
    appear."""
    deg = 64
    seg = np.array([0, deg] + [deg] * deg, np.int32)
    dst = np.arange(1, deg + 1, dtype=np.int32)
    eok = dst % 2 == 0
    words = bitplane.pack_bits_host(eok)
    R = 2048
    cap = ops.bucketed_seeds(1)
    seeds = np.zeros((R, cap), np.int32)
    valid = np.zeros((R, cap), bool)
    valid[:, 0] = True
    keys = sampler.layer_keys_batch(np.arange(R), 0)
    nb, _ei, mk = ops.neighbor_sample_batched(
        _t(seg), _t(dst), deg + 1, deg, seeds, valid, keys, fanout=1,
        edge_words=np.stack([words] * R))
    picks = as_np(nb)[:, 0, 0]
    assert as_np(mk)[:, 0, 0].all()
    allowed = set(dst[eok].tolist())
    assert set(picks.tolist()) <= allowed
    counts = np.bincount(picks, minlength=deg + 1)[sorted(allowed)]
    expected = R / len(allowed)
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 61.1, chi2
