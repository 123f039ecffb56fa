"""The port's DLRM (``models/dlrm.py``, ``configs/dlrm_rm2.py``) against the
reference package on the CPU.

The reference's params (drawn with its own key) go through
``params_from_reference``; the batch is built with numpy and handed to
both.  ``forward``, ``loss_fn`` and ``retrieval_scores`` agree at
rtol = atol = 1e-5 (sums in another order) at ``smoke_config`` and a
multi-hot variant (MH = 3), with the reference on ``embed_impl='take'``
(its Pallas kernel does not run on this JAX, ROADMAP C.1) and the port on
both ``take`` and ``kernel`` (on CPU tensors B4's wrapper runs its plain
version).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as ref_rm2
from repro.models import dlrm as ref_dlrm
from repro_torch.configs import dlrm_rm2
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.models import dlrm

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]


def _case(mh, impl, seed=0, batch=32):
    ref_cfg = dataclasses.replace(ref_rm2.smoke_config(), multi_hot=mh)
    cfg = dataclasses.replace(dlrm_rm2.smoke_config(), multi_hot=mh, embed_impl=impl)
    ref_params = ref_dlrm.init_params(jax.random.PRNGKey(seed), ref_cfg)
    params = dlrm.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((batch, cfg.n_dense)).astype(np.float32)
    sparse = rng.integers(0, cfg.vocab_size, (batch, cfg.n_sparse, mh)).astype(np.int32)
    labels = (rng.random(batch) < 0.3).astype(np.int32)
    return ref_cfg, ref_params, cfg, params, dense, sparse, labels


@pytest.mark.parametrize("mh", [1, 3])
@pytest.mark.parametrize("impl", ["take", "kernel"])
def test_forward_and_loss_match_reference(mh, impl):
    ref_cfg, ref_params, cfg, params, dense, sparse, labels = _case(mh, impl)
    eb_ops.reset_launches()
    got = dlrm.forward(params, torch.from_numpy(dense), torch.from_numpy(sparse), cfg)
    assert eb_ops.launches[eb_ops.EMBEDDING_BAG] == 0  # CPU tensors: the plain version
    want = np.asarray(ref_dlrm.forward(ref_params, jnp.asarray(dense), jnp.asarray(sparse),
                                       ref_cfg))
    assert got.shape == (len(dense),) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    loss = dlrm.loss_fn(params, torch.from_numpy(dense), torch.from_numpy(sparse),
                        torch.from_numpy(labels), cfg)
    np.testing.assert_allclose(
        float(loss), float(ref_dlrm.loss_fn(ref_params, jnp.asarray(dense), jnp.asarray(sparse),
                                            jnp.asarray(labels), ref_cfg)), **TOL)


@pytest.mark.parametrize("mh", [1, 3])
@pytest.mark.parametrize("impl", ["take", "kernel"])
def test_retrieval_scores_match_reference(mh, impl):
    ref_cfg, ref_params, cfg, params, dense, sparse, _ = _case(mh, impl, seed=1, batch=1)
    cands = np.random.default_rng(2).standard_normal((4000, cfg.embed_dim)).astype(np.float32)
    vals, ids = dlrm.retrieval_scores(params, torch.from_numpy(dense), torch.from_numpy(sparse),
                                      torch.from_numpy(cands), cfg, top_k=25)
    rvals, rids = ref_dlrm.retrieval_scores(ref_params, jnp.asarray(dense), jnp.asarray(sparse),
                                            jnp.asarray(cands), ref_cfg, top_k=25)
    assert vals.shape == (25,) and vals.dtype == torch.float32
    np.testing.assert_allclose(vals.numpy(), np.asarray(rvals), **TOL)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))


def test_wrapped_and_out_of_range_sparse_ids_follow_the_reference():
    """A batch row with a wrapped index scores as the reference does; a
    row with an out-of-range index is NaN in both."""
    ref_cfg, ref_params, cfg, params, dense, sparse, _ = _case(1, "kernel", seed=3, batch=4)
    sparse[1, 5, 0] = -7
    sparse[2, 0, 0] = cfg.vocab_size
    got = dlrm.forward(params, torch.from_numpy(dense), torch.from_numpy(sparse), cfg).numpy()
    want = np.asarray(ref_dlrm.forward(ref_params, jnp.asarray(dense), jnp.asarray(sparse),
                                       ref_cfg))
    np.testing.assert_array_equal(np.isnan(got), [False, False, True, False])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[[0, 1, 3]], want[[0, 1, 3]], **TOL)


def test_interaction_order_matches_reference():
    rng = np.random.default_rng(4)
    d = rng.standard_normal((5, 8)).astype(np.float32)
    s = rng.standard_normal((5, 26, 8)).astype(np.float32)
    got = dlrm._interact(torch.from_numpy(d), torch.from_numpy(s))
    assert got.shape == (5, 27 * 26 // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_dlrm._interact(d, s)), **TOL)
    z = np.concatenate([d[:, None], s], axis=1)
    np.testing.assert_allclose(got[:, 1].numpy(), (z[:, 0] * z[:, 2]).sum(-1), rtol=1e-5)
    np.testing.assert_allclose(got[:, 26].numpy(), (z[:, 1] * z[:, 2]).sum(-1), rtol=1e-5)


@pytest.mark.parametrize("which", ["full_config", "smoke_config"])
def test_configs_equal_the_reference(which):
    """Field by field and the derived widths; nothing is allocated."""
    ref_cfg, cfg = getattr(ref_rm2, which)(), getattr(dlrm_rm2, which)()
    ref_fields, fields = dataclasses.asdict(ref_cfg), dataclasses.asdict(cfg)
    assert np.dtype(ref_fields.pop("dtype")).name == str(fields.pop("dtype")).split(".")[-1]
    assert fields == ref_fields
    assert (cfg.n_interact, cfg.top_in) == (ref_cfg.n_interact, ref_cfg.top_in)
    assert (dlrm_rm2.FAMILY, dlrm_rm2.ARCH_ID) == (ref_rm2.FAMILY, ref_rm2.ARCH_ID)


def test_params_from_reference_rejects_mismatched_shapes():
    ref_cfg, ref_params, cfg, *_ = _case(1, "take")
    host = jax.tree.map(np.asarray, ref_params)
    bad_tables = {**host, "tables": host["tables"][:, :-1]}
    with pytest.raises(ValueError, match="tables"):
        dlrm.params_from_reference(bad_tables, cfg, "cpu")
    bad_top = {**host, "top": host["top"][:-1]}
    with pytest.raises(ValueError, match="top"):
        dlrm.params_from_reference(bad_top, cfg, "cpu")
    bot = [dict(lp) for lp in host["bot"]]
    bot[1]["w"] = bot[1]["w"][:, :-1]
    with pytest.raises(ValueError, match="bot layer 1"):
        dlrm.params_from_reference({**host, "bot": bot}, cfg, "cpu")
    with pytest.raises(ValueError, match="tables"):
        dlrm.params_from_reference(host, dataclasses.replace(cfg, vocab_size=501), "cpu")


def test_init_params_shapes_scale_and_reproducibility():
    cfg = dlrm_rm2.smoke_config()
    p = dlrm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert p["tables"].shape == (cfg.n_sparse, cfg.vocab_size, cfg.embed_dim)
    assert abs(float(p["tables"].std()) - cfg.embed_dim ** -0.5) < 0.02
    assert [tuple(lp["w"].shape) for lp in p["bot"]] == [(13, 32), (32, 16), (16, 8)]
    assert [tuple(lp["w"].shape) for lp in p["top"]] == [(cfg.top_in, 16), (16, 1)]
    q = dlrm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(a.equal(b) for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(q)))
    with pytest.raises(ValueError, match="embed_impl"):
        dlrm.forward(p, torch.zeros((1, 13)), torch.zeros((1, 26, 1), dtype=torch.int32),
                     dataclasses.replace(cfg, embed_impl="pallas"))


@pytest.mark.parametrize("impl", ["take", "kernel"])
def test_every_lookup_goes_through_b4s_wrapper(monkeypatch, impl):
    """Both ``embed_impl`` values call ``embedding_bag_fields``, which sends
    CUDA tensors to B4: the model has no route to the plain gather of its
    own."""
    _, _, cfg, params, dense, sparse, _ = _case(1, impl)
    calls = []
    real = eb_ops.embedding_bag_fields
    monkeypatch.setattr(eb_ops, "embedding_bag_fields",
                        lambda t, i, **kw: calls.append(i.shape) or real(t, i, **kw))
    dlrm.forward(params, torch.from_numpy(dense), torch.from_numpy(sparse), cfg)
    dlrm.retrieval_scores(params, torch.from_numpy(dense[:1]), torch.from_numpy(sparse[:1]),
                          torch.zeros((10, cfg.embed_dim)), cfg, top_k=3)
    assert calls == [sparse.shape, (1, *sparse.shape[1:])]


def test_recsys_serving_example_runs_on_cpu():
    """The torch twin of ``examples/recsys_serving.py``, end to end."""
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "recsys_serving_torch.py"),
                           "--device", "cpu"], capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK"
    assert "recommended items" in proc.stdout
