"""The port's AdamW (``optim/adamw.py``) and gradient compression
(``optim/compression.py``) against the reference on the CPU.

The same numpy-seeded params and gradients go through both packages:
after 5 steps of AdamW (cosine and constant schedules, with and without
clipping, f32 and bf16 params) params, moments, ``grad_norm`` and ``lr``
agree at rel 1e-6; the schedules agree at every step checked.  Compression:
``q`` and ``scale`` bitwise, the residual within 1e-7.  Plus the
reference's own cases of ``tests/test_optim.py`` on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro_torch.optim import AdamWConfig, apply_updates, cosine_schedule, init_state
from repro_torch.optim import adamw, compression
from repro_torch.optim.tree import flatten_with_paths, leaves, tree_map

REL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"b": [rng.standard_normal(5).astype(np.float32) * scale,
                  rng.standard_normal((3, 2)).astype(np.float32) * scale],
            "a": {"w": rng.standard_normal((4, 6)).astype(np.float32) * scale},
            "s": np.float32(rng.standard_normal()) * np.ones((), np.float32) * scale}


def _ref(cfg_kw):
    return ref_adamw.AdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)


def _np(tree):
    return [np.asarray(x, np.float32) if not torch.is_tensor(x) else x.float().numpy()
            for x in leaves(tree)]


CONFIGS = {
    "cosine_clip": dict(lr=0.01, warmup_steps=2, total_steps=8, clip_norm=1.0),
    "cosine_noclip": dict(lr=0.01, warmup_steps=2, total_steps=8, clip_norm=None),
    "constant_wd0": dict(lr=0.05, warmup_steps=3, schedule="constant", weight_decay=0.0),
    "long_warmup": dict(lr=3e-4, warmup_steps=100, total_steps=10_000, b2=0.999, eps=1e-6),
}


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("donate", [False, True])
def test_adamw_five_steps_match_reference(name, donate):
    ref_cfg, cfg = _ref(CONFIGS[name])
    params = _tree(0)
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_s = ref_adamw.init_state(ref_p)
    p = tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    s = init_state(p)
    for k in range(5):
        g = _tree(10 + k, scale=3.0 if k % 2 else 0.1)
        ref_p, ref_s, ref_m = ref_adamw.apply_updates(ref_p, jax.tree.map(jnp.asarray, g), ref_s,
                                                      ref_cfg)
        p, s, m = apply_updates(p, tree_map(lambda a: torch.from_numpy(np.array(a)), g), s, cfg,
                                donate=donate)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), **REL)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]), **REL)
    for got, want in [(p, ref_p), (s["m"], ref_s["m"]), (s["v"], ref_s["v"])]:
        for a, b in zip(_np(got), _np(want)):
            np.testing.assert_allclose(a, b, **REL)
    assert int(s["count"]) == int(ref_s["count"]) == 5 and s["count"].dtype == torch.int32


def test_adamw_bf16_params_are_written_back_in_bf16():
    ref_cfg, cfg = _ref(dict(lr=0.01, warmup_steps=1))
    rng = np.random.default_rng(1)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    g = rng.standard_normal((8, 4)).astype(np.float32)
    ref_p = {"w": jnp.asarray(w, jnp.bfloat16)}
    ref_p, ref_s, _ = ref_adamw.apply_updates(ref_p, {"w": jnp.asarray(g, jnp.bfloat16)},
                                              ref_adamw.init_state(ref_p), ref_cfg)
    p = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    p, s, _ = apply_updates(p, {"w": torch.from_numpy(g).to(torch.bfloat16)}, init_state(p), cfg)
    assert p["w"].dtype == torch.bfloat16 and s["m"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(p["w"].float().numpy(),
                                  np.asarray(ref_p["w"].astype(jnp.float32)))
    np.testing.assert_allclose(s["v"]["w"].numpy(), np.asarray(ref_s["v"]["w"]), **REL)


@pytest.mark.parametrize("kind", ["cosine", "constant"])
def test_schedules_match_reference(kind):
    ref_cfg, cfg = _ref(dict(lr=0.7, warmup_steps=10, total_steps=100, min_lr_ratio=0.1))
    ref_fn = ref_adamw.cosine_schedule if kind == "cosine" else ref_adamw.constant_schedule
    fn = cosine_schedule if kind == "cosine" else adamw.constant_schedule
    for step in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 101, 1000):
        want = float(ref_fn(ref_cfg, jnp.int32(step)))
        np.testing.assert_allclose(float(fn(cfg, step)), want, rtol=1e-6)
        np.testing.assert_allclose(float(fn(cfg, torch.tensor(step, dtype=torch.int32))), want,
                                   rtol=1e-6)


def test_apply_updates_leaves_its_inputs_alone_unless_donated():
    cfg = AdamWConfig(lr=0.1, warmup_steps=1)
    p = {"w": torch.ones(4)}
    s = init_state(p)
    new_p, new_s, _ = apply_updates(p, {"w": torch.ones(4)}, s, cfg)
    assert torch.equal(p["w"], torch.ones(4)) and not s["m"]["w"].any()
    assert not torch.equal(new_p["w"], p["w"])
    donated, donated_s, _ = apply_updates(p, {"w": torch.ones(4)}, s, cfg, donate=True)
    assert donated["w"] is p["w"] and torch.equal(p["w"], new_p["w"])
    assert donated_s["m"]["w"] is s["m"]["w"]


def test_apply_updates_works_through_slices(monkeypatch):
    """A leaf larger than ``CHUNK`` is updated a slice at a time, with the
    same bits as in one piece."""
    cfg = AdamWConfig(lr=0.1, warmup_steps=1)
    rng = np.random.default_rng(2)
    p = {"w": torch.from_numpy(rng.standard_normal((10, 7)).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal(3).astype(np.float32))}
    g = tree_map(lambda t: t * 0.5 + 1, p)
    whole, _, _ = apply_updates(p, g, init_state(p), cfg)
    monkeypatch.setattr(adamw, "CHUNK", 8)
    sliced, _, _ = apply_updates(p, g, init_state(p), cfg)
    assert all(torch.equal(a, b) for a, b in zip(leaves(whole), leaves(sliced)))


# the reference's tests/test_optim.py cases, on the port
def test_adamw_reduces_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_state(params)
    for _ in range(100):
        params, state, _ = apply_updates(params, tree_map(lambda w: 2 * w, params), state, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_clip_norm():
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=1)
    params = {"w": torch.zeros(4)}
    _, _, metrics = apply_updates(params, {"w": torch.full((4,), 100.0)}, init_state(params), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_tree_paths_are_the_references():
    from repro.checkpoint import manager as ref_manager

    tree = ({"layers": [{"w": 1, "b": 2}], "z": (3, None, 4)}, {"m": {"layers": [{"w": 5}]}})
    ref_paths, _ = ref_manager._flatten_with_paths(tree)
    assert [p for p, _ in flatten_with_paths(tree)[0]] == [p for p, _ in ref_paths]


# ----------------------------------------------------------------- compression
def test_compression_matches_reference_bitwise():
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal(1000).astype(np.float32),
         "b": [rng.standard_normal((7, 9)).astype(np.float32) * 1e-3,
               np.zeros(4, np.float32)]}
    ref_err = ref_comp.init_error_state(jax.tree.map(jnp.asarray, g))
    g_t = tree_map(lambda a: torch.from_numpy(a), g)
    err = compression.init_error_state(g_t)
    for step in range(4):  # error feedback carried across steps
        scaled = jax.tree.map(lambda a: a * (1.0 + step), g)
        ref_c, ref_err = ref_comp.compress_with_feedback(jax.tree.map(jnp.asarray, scaled),
                                                         ref_err)
        comp, err = compression.compress_with_feedback(
            tree_map(lambda a: torch.from_numpy(a), scaled), err)
        for a, b in zip(leaves(comp.q), jax.tree.leaves(ref_c.q)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(leaves(comp.scale), jax.tree.leaves(ref_c.scale)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(leaves(err), jax.tree.leaves(ref_err)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
        for a, b in zip(leaves(compression.decompress(comp)),
                        jax.tree.leaves(ref_comp.decompress(ref_c))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_round_half_to_even_as_the_reference():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 127.0, -127.0], np.float32)
    ref_c, _ = ref_comp.compress_with_feedback({"x": jnp.asarray(x)},
                                               {"x": jnp.zeros(7, jnp.float32)})
    comp, _ = compression.compress_with_feedback({"x": torch.from_numpy(x)},
                                                 {"x": torch.zeros(7)})
    np.testing.assert_array_equal(comp.q["x"].numpy(), np.asarray(ref_c.q["x"]))


def test_compression_roundtrip_accuracy():
    g = {"a": torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))}
    comp, _ = compression.compress_with_feedback(g, compression.init_error_state(g))
    back = compression.decompress(comp)
    amax = float(g["a"].abs().max())
    assert float((back["a"] - g["a"]).abs().max()) <= amax / 127 + 1e-6
    assert comp.q["a"].dtype == torch.int8


def test_error_feedback_unbiased_over_time():
    rng = np.random.default_rng(1)
    g_true = torch.from_numpy((rng.standard_normal(64) * 1e-3).astype(np.float32))
    err = compression.init_error_state({"w": g_true})
    total = torch.zeros(64)
    for _ in range(32):
        comp, err = compression.compress_with_feedback({"w": g_true}, err)
        total = total + compression.decompress(comp)["w"]
    assert float((total - 32 * g_true).abs().max()) <= float(g_true.abs().max()) + 1e-5
