"""Port ``repro_torch.core.dip_listd`` against ``repro.core.dip_listd``: the
same seeded insertion-ordered (entity, attribute) pairs through both
packages — with repeated pairs, attributes no entity holds, no pairs at
all and entity ids outside [0, n) — every field of the build (the chains
the reference replays pair by pair, here computed at once) and every query
impl (``linked``, ``inverted``, ``budget`` at an exact, a padded and a
too-small budget), bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np
from repro.core import dip_listd as rdd
from repro_torch.core import dip_listd as tdd

FIELDS = ("entity", "attr", "prev", "nxt", "last_tracker", "a_off", "a_ent")


def _case(name: str, seed: int):
    """(entity ids, attribute ids, k, n) of one named input."""
    rng = np.random.default_rng(seed)
    n, k = 61, 8
    if name == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), k, n
    nnz = 500
    ent = rng.integers(0, n, nnz)
    att = rng.integers(0, k - 2, nnz)  # attributes k-2, k-1 stay empty
    if name == "duplicates":  # few distinct pairs, each inserted many times
        ent, att = rng.integers(0, 6, nnz), rng.integers(0, 3, nnz)
    elif name == "entity_out_of_range":  # [-n, -1] wraps, the rest drops
        ent = rng.integers(-n - 5, n + 5, nnz)
    return ent, att, k, n


CASES = ["random", "duplicates", "empty", "entity_out_of_range"]


def _pair(name, seed):
    ent, att, k, n = _case(name, seed)
    return (rdd.build_dip_listd(ent, att, k=k, n=n),
            tdd.build_dip_listd(ent, att, k=k, n=n, device="cpu"))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CASES)
def test_build_matches_reference(name, seed):
    ref, port = _pair(name, seed)
    assert (port.k, port.n, port.nnz) == (ref.k, ref.n, ref.nnz)
    for f in FIELDS:
        got, want = as_np(getattr(port, f)), as_np(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_duplicate_pairs_stay_nodes():
    """Each insertion is a node: the repeated pair (0, 1) is two of them."""
    port = tdd.build_dip_listd([0, 0, 1, 2, 0], [1, 1, 0, 1, 0], k=2, n=3, device="cpu")
    want = {"prev": [-1, 0, -1, 1, 2], "nxt": [1, 3, 4, -1, -1], "last_tracker": [4, 3],
            "a_off": [0, 2, 5], "a_ent": [1, 0, 0, 0, 2]}
    for f, w in want.items():
        np.testing.assert_array_equal(as_np(getattr(port, f)), w, err_msg=f)


def _masks(k, seed):
    rng = np.random.default_rng(seed)
    return [rng.random(k) < 0.4, np.zeros(k, bool), np.ones(k, bool)] + \
        [np.eye(k, dtype=bool)[a] for a in range(k)]


@pytest.mark.parametrize("impl", ["linked", "inverted"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CASES)
def test_query_matches_reference(name, seed, impl):
    ref, port = _pair(name, seed)
    for mask in _masks(ref.k, seed + 10):
        got = as_np(tdd.query_any(port, torch.from_numpy(mask), impl=impl))
        np.testing.assert_array_equal(got, as_np(rdd.query_any(ref, jnp.asarray(mask), impl=impl)))


def _budgets(ref, ids):
    """Exact (the selected segments' total), padded to 128 and too small."""
    a_off = as_np(ref.a_off)
    sel = ids[(ids >= 0) & (ids < ref.k)]
    exact = int((a_off[sel + 1] - a_off[sel]).sum())
    return {"exact": exact, "padded": max(-(-exact // 128) * 128, 128),
            "too_small": max(exact - 7, 0)}


@pytest.mark.parametrize("budget", ["exact", "padded", "too_small"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CASES)
def test_budget_matches_reference(name, seed, budget):
    ref, port = _pair(name, seed)
    rng = np.random.default_rng(seed + 20)
    for ids in ([0], [2, 0], [1, -1, 3], [-1], [ref.k - 1, 0], [ref.k + 2, 1, -5],
                list(rng.permutation(ref.k))):
        ids = np.asarray(ids, np.int32)
        b = _budgets(ref, ids)[budget]
        got = as_np(tdd.query_any_budget(port, torch.from_numpy(ids), budget=b))
        np.testing.assert_array_equal(
            got, as_np(rdd.query_any_budget(ref, jnp.asarray(ids), budget=b)), err_msg=str(ids))


def test_too_small_budget_truncates():
    """Only the first ``budget`` slots of the segments laid end to end are
    marked: with budget 2 over attribute 0's segment [3, 4, 5], entity 5
    is not."""
    ent, att = [3, 4, 5], [0, 0, 0]
    ref = rdd.build_dip_listd(ent, att, k=1, n=6)
    port = tdd.build_dip_listd(ent, att, k=1, n=6, device="cpu")
    got = as_np(tdd.query_any_budget(port, torch.tensor([0]), budget=2))
    np.testing.assert_array_equal(got, as_np(rdd.query_any_budget(ref, jnp.asarray([0]), budget=2)))
    np.testing.assert_array_equal(got, [False, False, False, True, True, False])


@pytest.mark.parametrize("ents, want", [([-1], [False, False, True]),
                                        ([-3], [True, False, False]),
                                        ([-4], [False, False, False]),
                                        ([3], [False, False, False])])
def test_out_of_range_entities_wrap_or_drop_in_every_impl(ents, want):
    ref = rdd.build_dip_listd(ents, [0], k=1, n=3)
    port = tdd.build_dip_listd(ents, [0], k=1, n=3, device="cpu")
    mask = torch.tensor([True])
    for got in (tdd.query_any(port, mask, impl="linked"), tdd.query_any(port, mask, impl="inverted"),
                tdd.query_any_budget(port, torch.tensor([0]), budget=4)):
        np.testing.assert_array_equal(as_np(got), want)
    np.testing.assert_array_equal(
        as_np(rdd.query_any(ref, jnp.asarray([True]), impl="linked")), want)


@pytest.mark.parametrize("att, exc", [([0, 2], IndexError), ([0, -3], IndexError),
                                      ([-1, 3], IndexError), ([0, -1], ValueError)])
def test_bad_attribute_ids_raise_like_reference(att, exc):
    with pytest.raises(exc):
        rdd.build_dip_listd([0, 1], att, k=2, n=3)
    with pytest.raises(exc):
        tdd.build_dip_listd([0, 1], att, k=2, n=3, device="cpu")


def test_linked_walk_takes_the_longest_selected_chain(monkeypatch):
    """One step per node of the longest selected chain, and no more: the
    walk never reads back whether its heads are done."""
    port = tdd.build_dip_listd([0, 1, 2, 3, 4, 0], [0, 0, 0, 1, 1, 2], k=3, n=5, device="cpu")
    steps = []
    real = torch.Tensor.index_fill_
    monkeypatch.setattr(torch.Tensor, "index_fill_",
                        lambda self, *a: (steps.append(1), real(self, *a))[1])
    for mask, n_steps, want in (([True, False, False], 3, [1, 1, 1, 0, 0]),
                                ([False, True, True], 2, [1, 0, 0, 1, 1]),
                                ([False, False, False], 0, [0, 0, 0, 0, 0])):
        steps.clear()
        got = tdd.query_any_linked(port, torch.tensor(mask))
        assert len(steps) == n_steps
        np.testing.assert_array_equal(as_np(got), np.array(want, bool))


def test_unknown_impl_raises():
    _, port = _pair("random", 0)
    with pytest.raises(ValueError, match="impl"):
        tdd.query_any(port, torch.ones(port.k, dtype=torch.bool), impl="scan")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdd.build_dip_listd([0], [0], k=1, n=1)
