"""The port's DLRM batches (``data/recsys.py``) and recsys shape table
(``configs/common.py``) against the reference's contract on the CPU.

The port draws with a ``torch.Generator`` and cannot give JAX's threefry
bits, so the batches are held to the reference's shapes, dtypes, ranges
and step-addressed determinism, not to its values.
"""
import numpy as np
import pytest
import torch

from repro.configs import common as ref_common
from repro.data import dlrm_batch as ref_dlrm_batch
from repro_torch.configs import common
from repro_torch.data import dlrm_batch
from repro_torch.data.recsys import batch_seed


@pytest.mark.parametrize("batch,n_dense,n_sparse,vocab,mh", [
    (512, 13, 26, 1_000_000, 1), (64, 13, 26, 500, 3), (1, 5, 2, 7, 2), (0, 13, 26, 10, 1)])
def test_shapes_dtypes_and_ranges_follow_the_reference(batch, n_dense, n_sparse, vocab, mh):
    got = dlrm_batch(3, batch=batch, n_dense=n_dense, n_sparse=n_sparse, vocab=vocab,
                     multi_hot=mh, seed=1, device="cpu")
    want = ref_dlrm_batch(3, batch=batch, n_dense=n_dense, n_sparse=n_sparse, vocab=vocab,
                          multi_hot=mh, seed=1)
    assert set(got) == set(want) == {"dense", "sparse", "labels"}
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == np.dtype(want[k].dtype).name
    if batch:
        assert 0 <= int(got["sparse"].min()) and int(got["sparse"].max()) < vocab
        assert set(got["labels"].unique().tolist()) <= {0, 1}


def test_distributions():
    b = dlrm_batch(0, batch=65536, vocab=1000, device="cpu")
    assert abs(float(b["dense"].mean())) < 0.01 and abs(float(b["dense"].std()) - 1) < 0.01
    assert abs(float(b["labels"].float().mean()) - 0.3) < 0.01
    counts = torch.bincount(b["sparse"].reshape(-1).long(), minlength=1000)
    assert int(counts.min()) > 0 and abs(float(counts.float().mean()) - 65536 * 26 / 1000) < 1


def test_same_seed_and_step_give_the_same_batch_and_steps_differ():
    a = dlrm_batch(5, batch=256, seed=7, device="cpu")
    b = dlrm_batch(5, batch=256, seed=7, device="cpu")
    assert all(a[k].equal(b[k]) for k in a)
    for other in (dlrm_batch(6, batch=256, seed=7, device="cpu"),
                  dlrm_batch(5, batch=256, seed=8, device="cpu")):
        assert not a["dense"].equal(other["dense"]) and not a["sparse"].equal(other["sparse"])
    assert len({batch_seed(s, t) for s in range(4) for t in range(50)}) == 200


def test_defaults_to_the_card_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dlrm_batch(0, batch=4)


def test_recsys_shapes_equal_the_reference():
    assert common.RECSYS_SHAPES == ref_common.RECSYS_SHAPES
    assert common.PAD_QUANTUM == ref_common.PAD_QUANTUM
    for n in (0, 1, 511, 512, 513, 1_000_000):
        assert common.pad512(n) == ref_common.pad512(n)
