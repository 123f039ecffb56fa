"""The port's dense transformer (``models/transformer.py``, the LM configs,
``launch/serve.py``) against the reference package on the CPU.

The reference's params (drawn with its own key) go through
``params_from_reference``; token ids are drawn with numpy and handed to
both.  At the smoke configs of gemma2-9b (local/global windows, softcaps,
post-norms, tied embeddings), starcoder2-7b (full attention, plain GELU
FFN, G = 2) and qwen2-72b (QKV bias): ``forward``, ``loss_fn``,
``prefill`` and every step of a 24-step ``decode_step`` loop (past the
gemma smoke window of 16, so its ring buffer wraps), and the same at the
mixture-of-experts smoke configs of mixtral-8x22b (top-2 of 4 experts,
softmax over the top logits, window 16) and dbrx-132b (top-2 of 4 after
the full softmax; decode routes each step's B tokens at capacity 8), agree at rtol 1e-5
and atol 1e-5 of the largest magnitude compared (``close``: f32 matmuls
sum in another order than XLA's, and two layers of norms carry that into
the smallest entries), and 8 greedy tokens equal the reference's.  Token
ids out of range read the rows the reference's ``embed[tokens]`` reads.
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

from repro.configs import dbrx_132b as ref_dbrx
from repro.configs import gemma2_9b as ref_gemma
from repro.configs import mixtral_8x22b as ref_mixtral
from repro.configs import qwen2_72b as ref_qwen
from repro.configs import starcoder2_7b as ref_star
from repro.models import transformer as RT
from repro_torch.configs import dbrx_132b, gemma2_9b, mixtral_8x22b, qwen2_72b, starcoder2_7b
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import transformer as T

TOL = 1e-5


def close(got, want, tol=TOL):
    """rtol ``tol``, atol ``tol`` times the largest |want| (at least 1)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"gemma2-9b": (ref_gemma, gemma2_9b), "starcoder2-7b": (ref_star, starcoder2_7b),
         "qwen2-72b": (ref_qwen, qwen2_72b), "mixtral-8x22b": (ref_mixtral, mixtral_8x22b),
         "dbrx-132b": (ref_dbrx, dbrx_132b)}


def _models(arch, seed=0, **overrides):
    ref_mod, mod = ARCHS[arch]
    ref_cfg = dataclasses.replace(ref_mod.smoke_config(), **overrides)
    cfg = dataclasses.replace(mod.smoke_config(), **overrides)
    ref_params = RT.init_params(jax.random.PRNGKey(seed), ref_cfg)
    params = T.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    return ref_cfg, ref_params, cfg, params


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_loss_and_prefill_match_reference(arch):
    ref_cfg, ref_params, cfg, params = _models(arch)
    toks = _tokens(1, (2, 40), cfg.vocab)
    labels = _tokens(2, (2, 40), cfg.vocab)
    h_ref, aux_ref = RT.forward(ref_params, jnp.asarray(toks), ref_cfg)
    h, aux = T.forward(params, torch.from_numpy(toks), cfg)
    close(h.numpy(), np.asarray(h_ref))
    close(float(aux), float(aux_ref))
    assert (float(aux_ref) > 0) == bool(cfg.n_experts)
    loss = T.loss_fn(params, torch.from_numpy(toks), torch.from_numpy(labels), cfg)
    want = RT.loss_fn(ref_params, jnp.asarray(toks), jnp.asarray(labels), ref_cfg)
    close(float(loss), float(want))
    lg = T.prefill(params, torch.from_numpy(toks), cfg)
    assert lg.shape == (2, 1, cfg.vocab)
    close(lg.numpy(), np.asarray(RT.prefill(ref_params, jnp.asarray(toks), ref_cfg)))


@pytest.mark.parametrize("impl", ["auto", "chunked", "flash"])
def test_attention_impls_through_the_model(impl):
    """gemma's smoke config with each ``attn_impl`` (20 tokens, past the
    window of 16): the same function as the reference's."""
    ref_cfg, ref_params, cfg, params = _models("gemma2-9b", attn_impl=impl, attn_chunk=8)
    toks = _tokens(3, (1, 20), cfg.vocab)
    ops.reset_launches()
    h, _ = T.forward(params, torch.from_numpy(toks), cfg)
    assert ops.launches[ops.FLASH_ATTENTION] == 0
    h_ref, _ = RT.forward(ref_params, jnp.asarray(toks), ref_cfg)
    close(h.numpy(), np.asarray(h_ref))


def test_init_cache_has_the_reference_shapes():
    ref_cfg, _, cfg, _ = _models("gemma2-9b")
    for max_len in (8, 30):
        want = RT.init_cache(ref_cfg, 3, max_len)
        got = T.init_cache(cfg, 3, max_len, device="cpu")
        assert set(got) == set(want)
        for k in want:
            if k == "cur":
                assert got[k] == int(want[k]) == 0
                continue
            for kv in ("k", "v"):
                assert tuple(got[k][kv].shape) == tuple(want[k][kv].shape)
                assert got[k][kv].dtype == torch.float32 and not got[k][kv].any()


def _ref_decode(ref_params, ref_cfg, toks, max_len):
    cache = RT.init_cache(ref_cfg, toks.shape[0], max_len)
    dec = jax.jit(RT.decode_step, static_argnames="cfg")
    out = []
    for t in range(toks.shape[1]):
        lg, cache = dec(ref_params, cache, jnp.asarray(toks[:, t:t + 1]), ref_cfg)
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, 1)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_loop_matches_reference_past_the_window(arch):
    ref_cfg, ref_params, cfg, params = _models(arch)
    toks = _tokens(4, (2, 24), cfg.vocab)
    want = _ref_decode(ref_params, ref_cfg, toks, 30)
    cache = T.init_cache(cfg, 2, 30, device="cpu")
    if cfg.window:
        assert cache["pos0"]["k"].shape[2] == cfg.window  # a ring buffer, wrapped below
    got = []
    for t in range(24):
        lg, cache = T.decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]), cfg)
        got.append(lg[:, 0].numpy())
    assert cache["cur"] == 24
    close(np.stack(got, 1), want)


def test_decode_matches_forward():
    """The reference's ``test_lm_decode_matches_forward``, on the port."""
    _, _, cfg, params = _models("gemma2-9b")
    toks = torch.from_numpy(_tokens(5, (2, 20), cfg.vocab))
    h, _ = T.forward(params, toks, cfg)
    full = T._logits(params, h, cfg)
    cache = T.init_cache(cfg, 2, 24, device="cpu")
    steps = []
    for t in range(20):
        lg, cache = T.decode_step(params, cache, toks[:, t:t + 1], cfg)
        steps.append(lg[:, 0])
    close(torch.stack(steps, 1).numpy(), full.numpy())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_greedy_tokens_equal_the_reference(arch):
    ref_cfg, ref_params, cfg, params = _models(arch, seed=1)
    prompt, n_gen = _tokens(6, (3, 8), cfg.vocab), 8
    max_len = prompt.shape[1] + n_gen
    ref_toks, toks = prompt.copy(), torch.from_numpy(prompt.copy())
    ref_cache = RT.init_cache(ref_cfg, 3, max_len)
    cache = T.init_cache(cfg, 3, max_len, device="cpu")
    dec = jax.jit(RT.decode_step, static_argnames="cfg")
    for t in range(max_len - 1):
        lg_ref, ref_cache = dec(ref_params, ref_cache, jnp.asarray(ref_toks[:, t:t + 1]),
                                ref_cfg)
        lg, cache = T.decode_step(params, cache, toks[:, t:t + 1], cfg)
        if t >= prompt.shape[1] - 1:
            ref_toks = np.concatenate(
                [ref_toks, np.asarray(jnp.argmax(lg_ref[:, 0], -1))[:, None].astype(np.int32)], 1)
            toks = torch.cat([toks, torch.argmax(lg[:, 0], -1)[:, None].to(torch.int32)], 1)
    assert toks.shape == (3, max_len)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)


def test_causality():
    """The reference's ``test_lm_causality``: a later token leaves earlier
    hidden states unchanged."""
    _, _, cfg, params = _models("qwen2-72b")
    toks = torch.from_numpy(_tokens(7, (1, 16), cfg.vocab))
    h1, _ = T.forward(params, toks, cfg)
    toks2 = toks.clone()
    toks2[0, 10] = (toks2[0, 10] + 1) % cfg.vocab
    h2, _ = T.forward(params, toks2, cfg)
    np.testing.assert_allclose(h1[:, :10].numpy(), h2[:, :10].numpy(), atol=1e-5)
    assert not np.allclose(h1[:, 10:].numpy(), h2[:, 10:].numpy(), atol=1e-5)


def test_out_of_range_token_ids_read_the_reference_rows():
    """Ids ≥ V read row V-1, ids in [-V, -1] wrap, ids below -V read row 0
    (ROADMAP C.9), in forward and in decode."""
    ref_cfg, ref_params, cfg, params = _models("gemma2-9b")
    v = cfg.vocab
    toks = np.array([[-1, v - 1, v, v + 7, -v, -v - 1, -10**6, 7, 10**6]], np.int32)
    h_ref, _ = RT.forward(ref_params, jnp.asarray(toks), ref_cfg)
    h, _ = T.forward(params, torch.from_numpy(toks), cfg)
    close(h.numpy(), np.asarray(h_ref))
    emb = T._embed(params, torch.from_numpy(toks), cfg)
    rows = params["embed"][[v - 1, v - 1, v - 1, v - 1, 0, 0, 0, 7, v - 1]]
    assert torch.equal(emb[0], rows * np.sqrt(cfg.d_model))
    want = _ref_decode(ref_params, ref_cfg, toks, 12)
    cache = T.init_cache(cfg, 1, 12, device="cpu")
    got = []
    for t in range(toks.shape[1]):
        lg, cache = T.decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]), cfg)
        got.append(lg[:, 0].numpy())
    close(np.stack(got, 1), want)


def test_init_params_mirror_the_reference_tree():
    """Same tree and shapes as the reference's init; matrices in
    ``cfg.dtype`` (bf16 here), norm scales in f32 and ones."""
    ref_cfg, ref_params, cfg, _ = _models("qwen2-72b")
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    p = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_params)
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: np.zeros(t.shape), p, is_leaf=torch.is_tensor))}
    assert {jax.tree_util.keystr(k): np.shape(a) for k, a in ref_leaves} == {
        k: v.shape for k, v in got.items()}
    assert p["final_norm"]["scale"].dtype == torch.float32
    assert p["groups"][0]["ln1"]["scale"].equal(torch.ones(2, cfg.d_model))
    assert p["groups"][0]["wq"]["w"].dtype == torch.bfloat16
    assert p["groups"][0]["wq"]["b"].dtype == torch.bfloat16 and not p["groups"][0]["wq"]["b"].any()
    assert 0.015 < float(p["embed"].float().std()) < 0.025


def test_params_from_reference_checks_shapes():
    _, ref_params, cfg, _ = _models("starcoder2-7b")
    tree = jax.tree.map(np.asarray, ref_params)
    tree["groups"][0]["wq"]["w"] = tree["groups"][0]["wq"]["w"][:, :, :-1]
    with pytest.raises(ValueError, match=r"groups\[0\].wq.w"):
        T.params_from_reference(tree, cfg, "cpu")
    tree = jax.tree.map(np.asarray, ref_params)
    del tree["lm_head"]
    with pytest.raises(ValueError, match="keys"):
        T.params_from_reference(tree, cfg, "cpu")


def test_moe_layers_take_the_reference_tree():
    """A MoE config's layers hold ``"moe"`` (router, experts) in place of
    ``"mlp"``, with the reference's shapes, also with ``virtual_split``."""
    for split in (1, 2):
        ref_cfg, ref_params, cfg, params = _models("mixtral-8x22b", moe_virtual_split=split)
        p = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        shapes = jax.tree.map(lambda t: tuple(t.shape), p, is_leaf=torch.is_tensor)
        assert shapes == jax.tree.map(lambda a: tuple(a.shape), ref_params)
        assert "mlp" not in p["groups"][0] and set(p["groups"][0]["moe"]) == {
            "router", "up", "down", "gate"}
        assert 0.8 < float(p["groups"][0]["moe"]["down"].std()) * cfg.d_ff ** 0.5 < 1.2
        toks = _tokens(10, (2, 20), cfg.vocab)
        h_ref, _ = RT.forward(ref_params, jnp.asarray(toks), ref_cfg)
        close(T.forward(params, torch.from_numpy(toks), cfg)[0].numpy(), np.asarray(h_ref))


def test_config_counts_match_the_reference():
    for arch, (ref_mod, mod) in ARCHS.items():
        ref_cfg, cfg = ref_mod.full_config(), mod.full_config()
        assert (cfg.n_params, cfg.n_active_params, cfg.n_groups) == (
            ref_cfg.n_params, ref_cfg.n_active_params, ref_cfg.n_groups), arch
        for f in dataclasses.fields(ref_cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), (arch, f.name)
    assert gemma2_9b.full_config().dtype == torch.bfloat16
    assert gemma2_9b.full_config().layer_window("local") == 4096


def test_module_wraps_the_functions():
    _, _, cfg, params = _models("gemma2-9b")
    model = T.Transformer(cfg, params)
    toks = torch.from_numpy(_tokens(8, (2, 10), cfg.vocab))
    assert torch.equal(model(toks), T.forward(params, toks, cfg)[0])
    assert torch.equal(model.prefill(toks), T.prefill(params, toks, cfg))
    cache = model.init_cache(2, 12)
    lg, cache = model.decode_step(cache, toks[:, :1])
    assert lg.shape == (2, 1, cfg.vocab) and cache["cur"] == 1


def test_serve_cli_runs_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "4", "--gen", "3"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "generated (2, 3)" in out.stdout and "tokens [[" in out.stdout


def test_serve_demo_returns_the_steps():
    from repro_torch.launch import serve

    out = serve.serve_demo("starcoder2-7b", batch=2, prompt_len=4, gen=3, device="cpu",
                           greedy=False)
    assert out["tokens"].shape == (2, 3) and out["prompts"].shape == (2, 4)
    assert out["logits"].shape == (2, 6, 512) and len(out["step_ms"]) == 6
    assert int(out["tokens"].min()) >= 0 and int(out["tokens"].max()) < 512
    with pytest.raises(SystemExit, match="not an LM"):
        serve.serve_demo("gcn-cora", batch=1, prompt_len=2, gen=1, device="cpu")
    out = serve.serve_demo("dbrx-132b", batch=2, prompt_len=4, gen=3, device="cpu")
    assert out["tokens"].shape == (2, 3) and bool(torch.isfinite(out["logits"]).all())
