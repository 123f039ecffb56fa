"""The port's checkpoints (``checkpoint/manager.py``) and fault-tolerant
loop (``ft/controller.py``) on the CPU.

Checkpoints cross between the packages bitwise: one written by the
reference restores in the port and one written by the port restores in the
reference, a ``(params, opt)`` training state included, with the same leaf
paths and manifest.  A reference checkpoint with bf16 leaves restores in
the port (the reference cannot restore it itself: ROADMAP C.22).  Then the
cases of ``tests/test_ft.py`` on the port: round trip, atomicity,
retention, bitwise restart, async save, restore onto a device, and
gradient accumulation with a drop mask (against the reference's).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_ckpt
from repro.ft import controller as ref_ft
from repro_torch.checkpoint import CheckpointManager, latest_step, restore, save
from repro_torch.ft import FailureInjector, TrainController, accumulate_grads
from repro_torch.optim import init_state
from repro_torch.optim.tree import leaves, tree_map


def _toy_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 8), generator=g), "step_count": torch.zeros((), dtype=torch.int32)}


def _toy_step(state, step):
    w = state["w"]
    w = w - 0.01 * (w + step * 0.001)
    return {"w": w, "step_count": state["step_count"] + 1}, {"loss": torch.sum(w * w)}


def _train_state(seed=0):
    """A (params, opt) training state as numpy: the layout ``launch/train``
    checkpoints."""
    rng = np.random.default_rng(seed)
    params = {"layers": [{"w": rng.standard_normal((4, 3)).astype(np.float32),
                          "b": rng.standard_normal(3).astype(np.float32)} for _ in range(2)]}
    opt = {"m": jax.tree.map(lambda a: a * 0.1, params), "v": jax.tree.map(np.square, params),
           "count": np.int32(7)}
    return params, opt


def _same(a, b):
    a = [x.numpy() if torch.is_tensor(x) else np.asarray(x) for x in a]
    b = [np.asarray(x) for x in b]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _train_state()
    ref_ckpt.save(str(tmp_path), 3, jax.tree.map(jnp.asarray, state), extra={"k": 1})
    like = tree_map(lambda a: torch.zeros(np.shape(a)), state)
    back = restore(str(tmp_path), 3, like)
    _same(leaves(back), jax.tree.leaves(state))
    assert latest_step(str(tmp_path)) == 3


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    params, opt = _train_state(1)
    port_state = tree_map(lambda a: torch.from_numpy(np.array(a)), (params, opt))
    save(str(tmp_path), 5, port_state, extra={"note": "port"})
    like = jax.tree.map(jnp.asarray, (params, opt))
    back = ref_ckpt.restore(str(tmp_path), 5, like)
    _same(leaves(port_state), jax.tree.leaves(back))
    assert ref_ckpt.latest_step(str(tmp_path)) == 5


def test_both_packages_write_the_same_manifest_and_keys(tmp_path):
    state = _train_state(2)
    ref_ckpt.save(str(tmp_path / "ref"), 9, jax.tree.map(jnp.asarray, state), extra={"a": 2})
    save(str(tmp_path / "port"), 9, tree_map(lambda a: torch.from_numpy(np.array(a)), state),
         extra={"a": 2})
    manifests = [json.loads((tmp_path / w / "step_000000009" / "manifest.json").read_text())
                 for w in ("ref", "port")]
    assert manifests[0] == manifests[1]
    assert "0/layers/0/w" in manifests[0]["leaves"] and "1/m/layers/1/b" in manifests[0]["leaves"]
    keys = [sorted(np.load(tmp_path / w / "step_000000009" / "shard_p0.npz").files)
            for w in ("ref", "port")]
    assert keys[0] == keys[1]


def test_bf16_leaves_cross_as_their_bits(tmp_path):
    """bf16 leaves are kept as their 2-byte values under dtype ``bfloat16``:
    a reference checkpoint with bf16 leaves restores in the port bit for
    bit, and the port writes the same file contents."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((5, 4)).astype(np.float32)
    tree = {"w": jnp.asarray(w, jnp.bfloat16), "s": jnp.asarray(w[0])}
    ref_ckpt.save(str(tmp_path / "ref"), 1, tree)
    back = restore(str(tmp_path / "ref"), 1, {"w": torch.zeros(1), "s": torch.zeros(1)})
    assert back["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["w"].float().numpy(),
                                  np.asarray(tree["w"].astype(jnp.float32)))
    save(str(tmp_path / "port"), 1, back)
    manifests = [json.loads((tmp_path / w / "step_000000001" / "manifest.json").read_text())
                 for w in ("ref", "port")]
    assert manifests[0] == manifests[1] and manifests[1]["leaves"]["w"]["dtype"] == "bfloat16"
    raw = [np.load(tmp_path / w / "step_000000001" / "shard_p0.npz")["w"] for w in ("ref", "port")]
    assert raw[0].tobytes() == raw[1].tobytes()
    again = restore(str(tmp_path / "port"), 1, back)
    assert torch.equal(again["w"], back["w"])


def test_c22_the_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """ROADMAP C.22: ``np.load`` hands the reference a raw ``V2`` array,
    which ``jnp.asarray`` refuses; the port reads the manifest's dtype."""
    tree = {"w": jnp.ones((2, 2), jnp.bfloat16)}
    ref_ckpt.save(str(tmp_path), 1, tree)
    with pytest.raises(TypeError):
        ref_ckpt.restore(str(tmp_path), 1, tree)
    assert restore(str(tmp_path), 1, {"w": torch.zeros(1)})["w"].dtype == torch.bfloat16


# the reference's tests/test_ft.py cases, on the port
def test_checkpoint_roundtrip(tmp_path):
    st = _toy_state()
    save(str(tmp_path), 7, st)
    assert latest_step(str(tmp_path)) == 7
    back = restore(str(tmp_path), 7, st)
    assert torch.equal(back["w"], st["w"]) and back["step_count"].dtype == torch.int32


def test_checkpoint_atomicity(tmp_path):
    save(str(tmp_path), 5, _toy_state())
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert latest_step(str(tmp_path)) == 5
    CheckpointManager(str(tmp_path))
    assert not (tmp_path / "step_000000009.tmp").exists()


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_sync(s, _toy_state())
    assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == [3, 4]


@pytest.mark.parametrize("fail_at", [[13], [3, 13, 17]])
def test_bitwise_restart(tmp_path, fail_at):
    def run(fail):
        ckpt = CheckpointManager(str(tmp_path / ("a" if fail else "b")), keep=3)
        ctrl = TrainController(ckpt=ckpt, step_fn=_toy_step, ckpt_every=5)
        return ctrl.run(_toy_state(), 20, injector=FailureInjector(fail_at) if fail else None)

    sa, sb = run(True), run(False)
    assert torch.equal(sa["w"], sb["w"]) and int(sa["step_count"]) == 20


def test_restart_matches_the_reference_loop(tmp_path):
    """The same toy step in both packages, each with a failure at 13: the
    same final state."""
    def ref_step(state, step):
        w = state["w"] - 0.01 * (state["w"] + step * 0.001)
        return {"w": w, "step_count": state["step_count"] + 1}, {}

    w0 = np.random.default_rng(4).standard_normal((6, 6)).astype(np.float32)
    ref_ctrl = ref_ft.TrainController(ckpt=ref_ckpt.CheckpointManager(str(tmp_path / "r")),
                                      step_fn=ref_step, ckpt_every=5)
    want = ref_ctrl.run({"w": jnp.asarray(w0), "step_count": jnp.zeros((), jnp.int32)}, 20,
                        injector=ref_ft.FailureInjector([13]))
    ctrl = TrainController(ckpt=CheckpointManager(str(tmp_path / "p")), step_fn=_toy_step,
                           ckpt_every=5)
    got = ctrl.run({"w": torch.from_numpy(w0), "step_count": torch.zeros((), dtype=torch.int32)},
                   20, injector=FailureInjector([13]))
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=1e-6, atol=1e-7)


def test_restart_survives_a_step_that_writes_into_its_state(tmp_path):
    """A donating step (in place, as ``launch/train``'s) must not corrupt
    the state a restart without a checkpoint resumes from."""
    def step_fn(state, step):
        state["w"].mul_(0.5).add_(step)
        return state, {}

    def run(fail):
        ctrl = TrainController(ckpt=CheckpointManager(str(tmp_path / str(fail))),
                               step_fn=step_fn, ckpt_every=100)
        return ctrl.run({"w": torch.ones(3)}, 6, injector=FailureInjector([4]) if fail else None)

    assert torch.equal(run(True)["w"], run(False)["w"])


def test_async_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st = _toy_state()
    before = st["w"].clone()
    mgr.save_async(3, st)
    st["w"].add_(1.0)  # the host copy was taken at the call
    mgr.wait()
    assert latest_step(str(tmp_path)) == 3
    assert torch.equal(restore(str(tmp_path), 3, st)["w"], before)


def test_restore_onto_devices(tmp_path):
    """``shardings`` is a tree of devices; without it each leaf goes to its
    ``like_tree`` leaf's device, and the controller puts a restored state
    back where it ran."""
    st = {"w": torch.arange(16.0).reshape(4, 4)}
    save(str(tmp_path), 1, st)
    back = restore(str(tmp_path), 1, st, shardings={"w": torch.device("cpu")})
    assert back["w"].device == torch.device("cpu") and torch.equal(back["w"], st["w"])
    meta = restore(str(tmp_path), 1, {"w": torch.empty((4, 4), device="meta")},
                   shardings={"w": "cpu"})
    assert meta["w"].device.type == "cpu"
    with pytest.raises(ValueError, match="devices"):
        restore(str(tmp_path), 1, st, shardings={"w": "cpu", "x": "cpu"})


def test_accumulate_grads_drop_mask():
    params = {"w": torch.ones(4)}

    def loss(p, mb):
        return torch.sum(p["w"] * mb)

    mbs = torch.stack([torch.full((4,), 1.0), torch.full((4,), 3.0), torch.full((4,), 100.0)])
    g_all, losses = accumulate_grads(loss, params, mbs)
    g_drop, _ = accumulate_grads(loss, params, mbs, drop_mask=torch.tensor([True, True, False]))
    np.testing.assert_allclose(g_drop["w"].numpy(), np.full(4, 2.0))
    np.testing.assert_allclose(g_all["w"].numpy(), np.full(4, 104.0 / 3), rtol=1e-6)
    assert losses.shape == (3,) and not params["w"].requires_grad


@pytest.mark.parametrize("mask", [None, [True, False, True, True], [False] * 4])
def test_accumulate_grads_matches_the_reference(mask):
    rng = np.random.default_rng(5)
    p = {"a": rng.standard_normal((3, 2)).astype(np.float32),
         "b": [rng.standard_normal(2).astype(np.float32)]}
    mbs = {"x": rng.standard_normal((4, 5, 3)).astype(np.float32)}

    def ref_loss(p, mb):
        return jnp.sum(jnp.tanh(mb["x"] @ p["a"] + p["b"][0]) ** 2)

    def loss(p, mb):
        return torch.sum(torch.tanh(mb["x"] @ p["a"] + p["b"][0]) ** 2)

    want, want_l = ref_ft.accumulate_grads(ref_loss, jax.tree.map(jnp.asarray, p),
                                           jax.tree.map(jnp.asarray, mbs),
                                           None if mask is None else jnp.asarray(mask))
    got, got_l = accumulate_grads(loss, tree_map(torch.from_numpy, p),
                                  tree_map(torch.from_numpy, mbs),
                                  None if mask is None else torch.tensor(mask))
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-5)


def test_training_state_round_trips_through_the_reference(tmp_path):
    """The port's (params, AdamW state) saved, restored by the reference,
    saved again by it and restored by the port: the same bits."""
    params = {"layers": [{"w": torch.randn(3, 2), "b": torch.zeros(2)}]}
    state = (params, init_state(params))
    save(str(tmp_path / "a"), 2, state)
    like = jax.tree.map(lambda t: jnp.zeros(tuple(t.shape)), tree_map(lambda t: t, state),
                        is_leaf=torch.is_tensor)
    ref_back = ref_ckpt.restore(str(tmp_path / "a"), 2, like)
    ref_ckpt.save(str(tmp_path / "b"), 2, ref_back)
    back = restore(str(tmp_path / "b"), 2, state)
    _same(leaves(back), leaves(state))
