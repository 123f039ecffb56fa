"""The port's rowwise-AdaGrad table updates (``optim/sparse_tables.py``)
against the reference on the CPU: the same numpy-seeded tables, indices
and pulled gradients through both packages' ``sparse_table_update`` and
``dense_rowwise_update`` (rtol 1e-6), the reference's cases of
``tests/test_optim_sparse.py`` on the port (sparse ≡ dense, untouched rows
bitwise unchanged, duplicates summed), ids outside [0, V) dropped, and the
VJP case: gradients pulled from the port's DLRM through autograd."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import sparse_tables as ref_st
from repro_torch.optim.sparse_tables import (dense_rowwise_update, init_rowwise_state,
                                             sparse_table_update)

TOL = dict(rtol=1e-6, atol=1e-7)


def _setup(B=8, F=3, MH=2, V=50, D=4, seed=0, low=0):
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((F, V, D)).astype(np.float32)
    idx = rng.integers(low, V, (B, F, MH)).astype(np.int32)
    pulled = rng.standard_normal((B, F, MH, D)).astype(np.float32)
    acc = (rng.random((F, V)) * (rng.random((F, V)) < 0.3)).astype(np.float32)
    return tables, idx, pulled, acc


def _dense_grad_from_pulled(idx, pulled, V):
    B, F, MH, D = pulled.shape
    dense = np.zeros((F, V, D), np.float32)
    for b, f, h in np.ndindex(B, F, MH):
        if 0 <= idx[b, f, h] < V:
            dense[f, idx[b, f, h]] += pulled[b, f, h]
    return dense


T = torch.from_numpy


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("lr", [0.05, 1.0])
def test_sparse_and_dense_match_reference(seed, lr):
    tables, idx, pulled, acc = _setup(seed=seed)
    want_t, want_a = ref_st.sparse_table_update(jnp.asarray(tables), jnp.asarray(acc),
                                                jnp.asarray(idx), jnp.asarray(pulled), lr=lr)
    got_t, got_a = sparse_table_update(T(tables), T(acc), T(idx), T(pulled), lr=lr)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
    dense = _dense_grad_from_pulled(idx, pulled, tables.shape[1])
    want_t, want_a = ref_st.dense_rowwise_update(jnp.asarray(tables), jnp.asarray(acc),
                                                 jnp.asarray(dense), lr=lr)
    got_t, got_a = dense_rowwise_update(T(tables), T(acc), T(dense), lr=lr)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


def test_ids_outside_the_table_are_dropped_as_in_the_reference():
    tables, idx, pulled, acc = _setup(seed=5, low=-6, V=20)
    idx[0, 0, 0], idx[1, 2, 1] = 20, 400
    want_t, want_a = ref_st.sparse_table_update(jnp.asarray(tables), jnp.asarray(acc),
                                                jnp.asarray(idx), jnp.asarray(pulled))
    got_t, got_a = sparse_table_update(T(tables), T(acc), T(idx), T(pulled))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


def test_init_rowwise_state():
    acc = init_rowwise_state(torch.zeros((3, 7, 5)))
    assert acc.shape == (3, 7) and acc.dtype == torch.float32 and not acc.any()


# the reference's tests/test_optim_sparse.py cases, on the port
def test_sparse_matches_dense_reference():
    tables, idx, pulled, _ = _setup()
    acc = init_rowwise_state(T(tables))
    t_sp, a_sp = sparse_table_update(T(tables), acc, T(idx), T(pulled), lr=0.05)
    dense = T(_dense_grad_from_pulled(idx, pulled, tables.shape[1]))
    t_dn, a_dn = dense_rowwise_update(T(tables), acc, dense, lr=0.05)
    np.testing.assert_allclose(t_sp.numpy(), t_dn.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a_sp.numpy(), a_dn.numpy(), rtol=1e-5, atol=1e-6)


def test_untouched_rows_unchanged():
    tables, idx, pulled, _ = _setup()
    acc = init_rowwise_state(T(tables))
    t_new, a_new = sparse_table_update(T(tables), acc, T(idx), T(pulled))
    touched = np.zeros(tables.shape[:2], bool)
    for b, f, h in np.ndindex(*idx.shape):
        touched[f, idx[b, f, h]] = True
    np.testing.assert_array_equal(t_new.numpy()[~touched], tables[~touched])
    assert (a_new.numpy()[~touched] == 0).all()


def test_duplicate_indices_accumulate():
    tables = torch.ones((1, 10, 2))
    acc = init_rowwise_state(tables)
    idx = torch.tensor([[[3]], [[3]]], dtype=torch.int32)
    pulled = torch.tensor([[[[1.0, 0.0]]], [[[1.0, 0.0]]]])
    t_new, _ = sparse_table_update(tables, acc, idx, pulled, lr=1.0)
    assert float(t_new[0, 3, 0]) == pytest.approx(1.0 - np.sqrt(2.0), rel=1e-4)
    assert float(t_new[0, 3, 1]) == pytest.approx(1.0)


def test_end_to_end_with_vjp():
    """Gradients of the gathered rows pulled through the port's DLRM by
    autograd feed the sparse update; the loss falls, as in the reference's
    case."""
    from repro_torch.models import dlrm
    from repro_torch.models.gnn_common import mlp_stack

    cfg = dlrm.DLRMConfig(vocab_size=100, bot_mlp=(13, 16, 8, 4), embed_dim=4,
                          top_mlp=(16, 8, 1))
    params = dlrm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    acc = init_rowwise_state(params["tables"])
    rng = np.random.default_rng(0)
    dense = T(rng.standard_normal((16, 13)).astype(np.float32))
    sparse_idx = T(rng.integers(0, 100, (16, 26, 1)).astype(np.int32))
    labels = T(rng.integers(0, 2, 16).astype(np.int32))
    field = torch.arange(26).view(1, 26, 1)

    def loss_from_rows(rows):
        s = rows.mean(dim=2)
        d = mlp_stack(params["bot"], dense, final_act=True)
        logit = mlp_stack(params["top"], torch.cat([d, dlrm._interact(d, s)], -1))[:, 0]
        y = labels.float()
        return torch.mean(torch.clamp(logit, min=0) - logit * y
                          + torch.log1p(torch.exp(-logit.abs())))

    losses = []
    for _ in range(12):
        rows = params["tables"][field, sparse_idx.long()].requires_grad_(True)
        loss = loss_from_rows(rows)
        (g_rows,) = torch.autograd.grad(loss, rows)
        params["tables"], acc = sparse_table_update(params["tables"], acc, sparse_idx, g_rows,
                                                    lr=0.5)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
