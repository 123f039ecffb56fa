"""Port ``repro_torch.core.dip_list`` against ``repro.core.dip_list``: the
same seeded (entity, attribute) pairs through both packages — with repeated
pairs, attributes no entity holds, no pairs at all, attribute ids outside
[0, k) and entity ids ≥ n — every field of the build and every query,
bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np
from repro.core import dip_list as rdl
from repro_torch.core import dip_list as tdl

FIELDS = ("off", "val", "slot_entity")


def _case(name: str, seed: int):
    """(entity ids, attribute ids, k, n) of one named input."""
    rng = np.random.default_rng(seed)
    n, k = 57, 9
    if name == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), k, n
    nnz = 400
    ent = rng.integers(0, n, nnz)
    att = rng.integers(0, k - 3, nnz)  # attributes k-3 .. k-1 stay empty
    if name == "attr_out_of_range":  # ids the reference's gather wraps or clamps
        att = rng.integers(-k - 3, k + 4, nnz)
    elif name == "entity_out_of_range":  # entities ≥ n keep slots, get no offsets
        ent = rng.integers(0, n + 6, nnz)
    return ent, att, k, n


CASES = ["random", "empty", "attr_out_of_range", "entity_out_of_range"]


def _pair(name, seed, dedupe=True):
    ent, att, k, n = _case(name, seed)
    return (rdl.build_dip_list(ent, att, k=k, n=n, dedupe=dedupe),
            tdl.build_dip_list(ent, att, k=k, n=n, dedupe=dedupe, device="cpu"))


@pytest.mark.parametrize("dedupe", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CASES)
def test_build_matches_reference(name, seed, dedupe):
    ref, port = _pair(name, seed, dedupe)
    assert (port.k, port.n, port.nnz) == (ref.k, ref.n, ref.nnz)
    for f in FIELDS:
        got, want = as_np(getattr(port, f)), as_np(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(as_np(tdl.entity_of_slot(port)), as_np(rdl.entity_of_slot(ref)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CASES)
def test_query_matches_reference(name, seed):
    ref, port = _pair(name, seed)
    rng = np.random.default_rng(seed + 10)
    masks = [rng.random(ref.k) < 0.4, np.zeros(ref.k, bool), np.ones(ref.k, bool)]
    masks += [np.eye(ref.k, dtype=bool)[a] for a in range(ref.k)]
    for mask in masks:
        np.testing.assert_array_equal(as_np(tdl.query_any(port, torch.from_numpy(mask))),
                                      as_np(rdl.query_any(ref, jnp.asarray(mask))))


@pytest.mark.parametrize("name", CASES)
def test_attrs_of_entity_padded_matches_reference(name):
    ref, port = _pair(name, 3)
    for e in (-ref.n - 5, -1, 0, 7, ref.n - 1, ref.n, ref.n + 9):
        for max_k in (1, 4, 12):
            want = rdl.attrs_of_entity_padded(ref, jnp.int32(e), max_k=max_k)
            got = tdl.attrs_of_entity_padded(port, e, max_k=max_k)
            for g, w in zip(got, want):
                assert as_np(g).dtype == as_np(w).dtype
                np.testing.assert_array_equal(as_np(g), as_np(w), err_msg=f"e={e}")


@pytest.mark.parametrize("ent, att, mask, want", [
    # attribute id 3 ≥ k = 2 reads mask[1], as the reference's gather clamps
    ([0, 1, 2], [0, 3, 1], [False, True], [False, True, True]),
    # entity 5 ≥ n = 3 keeps its slot and drops its hit
    ([0, 1, 5, 2], [1, 0, 1, 1], [False, True], [True, False, True]),
    # attribute -1 wraps to k - 1; -3 < -k reads mask[0]
    ([0, 1, 2], [0, -1, -3], [False, True], [False, True, False]),
])
def test_out_of_range_ids_answer_as_reference(ent, att, mask, want):
    ref = rdl.build_dip_list(ent, att, k=2, n=3)
    port = tdl.build_dip_list(ent, att, k=2, n=3, device="cpu")
    got = as_np(tdl.query_any(port, torch.tensor(mask)))
    np.testing.assert_array_equal(got, as_np(rdl.query_any(ref, jnp.asarray(mask))))
    np.testing.assert_array_equal(got, want)


def test_entity_beyond_n_leaves_off_short():
    port = tdl.build_dip_list([0, 1, 5, 2], [1, 0, 1, 1], k=2, n=3, device="cpu")
    np.testing.assert_array_equal(as_np(port.off), [0, 1, 2, 3])
    np.testing.assert_array_equal(as_np(port.slot_entity), [0, 1, 2, 5])
    assert port.nnz == 4


def test_duplicate_entities_never_lose_a_hit():
    """Many slots of one entity, only one of them a hit: the OR holds."""
    ent = np.zeros(300, np.int64)
    att = np.zeros(300, np.int64)
    att[150] = 1
    port = tdl.build_dip_list(ent, att, k=2, n=2, dedupe=False, device="cpu")
    np.testing.assert_array_equal(as_np(tdl.query_any(port, torch.tensor([False, True]))),
                                  [True, False])


def test_negative_entity_raises_like_reference():
    with pytest.raises(ValueError):
        rdl.build_dip_list([0, -1], [0, 1], k=2, n=3)
    with pytest.raises(ValueError):
        tdl.build_dip_list([0, -1], [0, 1], k=2, n=3, device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdl.build_dip_list([0], [0], k=1, n=1)
