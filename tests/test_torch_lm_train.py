"""LM training in the port against the reference package on the CPU.

For each LM smoke config (gemma2-9b: local/global windows, softcaps,
post-norms, tied embeddings; qwen2-72b: QKV bias; starcoder2-7b: plain
GELU FFN; mixtral-8x22b and dbrx-132b: mixture-of-experts FFNs, whose aux
loss adds 0.01·aux and whose routing the recompute repeats), the reference's params (drawn with its own key) go through
``params_from_reference`` and numpy tokens and labels go to both; the
port's ``loss_fn`` and its gradients by autograd are held to ``jax.grad``
of the reference's ``loss_fn`` with ``remat`` off, ``"full"`` and
``"dots"`` on both sides, at rtol 1e-4 and atol 1e-4 of the largest
|gradient| of each leaf (f32 sums in other orders than XLA's through two
layers of norms).  Rematerialization changes no bit of the port's loss or
gradients.  gemma2-9b's smoke training with a failure mid-run ends with
the unbroken run's bits.  Then the trainer CLI for gemma2-9b and
``examples/train_lm_torch.py`` run on the CPU, the example for 3 steps with
a failure at step 2 (whether its loss improves is asserted from 40 steps,
and its ``--check-restart``, which ``chip_smoke.py`` runs on the card).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
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
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim.tree import flatten_with_paths, leaves, unflatten

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"gemma2-9b": (ref_gemma, gemma2_9b), "starcoder2-7b": (ref_star, starcoder2_7b),
         "qwen2-72b": (ref_qwen, qwen2_72b), "mixtral-8x22b": (ref_mixtral, mixtral_8x22b),
         "dbrx-132b": (ref_dbrx, dbrx_132b)}
REMAT = {"off": dict(remat=False), "full": dict(remat=True, remat_policy="full"),
         "dots": dict(remat=True, remat_policy="dots")}
TOL = 1e-4
B, S = 2, 40  # past gemma's smoke window of 16


def _batch(seed, vocab):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _port_grads(params, cfg, toks, labels):
    pairs, spec = flatten_with_paths(params)
    flat = [p.detach().requires_grad_(True) for _, p in pairs]
    value = T.loss_fn(unflatten(spec, flat), torch.from_numpy(toks), torch.from_numpy(labels), cfg)
    grads = torch.autograd.grad(value, flat)
    return value.detach(), {name: g for (name, _), g in zip(pairs, grads)}


def _models(arch, remat):
    ref_mod, mod = ARCHS[arch]
    ref_cfg = dataclasses.replace(ref_mod.smoke_config(), **REMAT[remat])
    cfg = dataclasses.replace(mod.smoke_config(), **REMAT[remat])
    ref_params = RT.init_params(jax.random.PRNGKey(7), ref_cfg)
    params = T.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    return ref_cfg, ref_params, cfg, params


@pytest.mark.parametrize("remat", sorted(REMAT))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_gradients_match_the_reference(arch, remat):
    ref_cfg, ref_params, cfg, params = _models(arch, remat)
    toks, labels = _batch(len(arch), cfg.vocab)
    want_l, want = jax.jit(jax.value_and_grad(RT.loss_fn), static_argnums=3)(
        ref_params, toks, labels, ref_cfg)
    got_l, got = _port_grads(params, cfg, toks, labels)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=TOL)
    want_pairs, _ = flatten_with_paths(jax.tree.map(np.asarray, want))
    assert [name for name, _ in want_pairs] == list(got)
    for name, w in want_pairs:
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(got[name].numpy(), w, rtol=TOL,
                                   atol=TOL * max(1e-3, float(np.abs(w).max())), err_msg=name)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_changes_no_bit(arch):
    results = {}
    for remat in REMAT:
        _, _, cfg, params = _models(arch, remat)
        results[remat] = _port_grads(params, cfg, *_batch(1, cfg.vocab))
    base_l, base = results["off"]
    for remat in ("full", "dots"):
        loss, grads = results[remat]
        assert torch.equal(loss, base_l), remat
        assert all(torch.equal(grads[k], base[k]) for k in base), remat


def test_remat_policy_is_checked():
    """An unknown policy is refused when the config is built, before any
    gradient is taken."""
    with pytest.raises(ValueError, match="remat_policy"):
        dataclasses.replace(gemma2_9b.smoke_config(), remat=True, remat_policy="nothing")
    with pytest.raises(ValueError, match="remat_policy"):
        dataclasses.replace(gemma2_9b.smoke_config(), remat=False, remat_policy="dot")


def _run(args, timeout=600):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def test_train_cli_trains_gemma_on_cpu():
    out = _run(["-m", "repro_torch.launch.train", "--arch", "gemma2-9b", "--steps", "12",
                "--ckpt-every", "4", "--fail-at", "6", "--batch", "2", "--seq", "32",
                "--device", "cpu"])
    assert "done: 14 steps" in out


def test_lm_restart_end_to_end_is_bitwise(tmp_path):
    """gemma2-9b's smoke config, a failure injected at 5 of 8 steps
    (checkpoints every 3): the run restarts from step 3 and ends with the
    unbroken run's bits."""
    def run(fail_at, where):
        return train.run_training("gemma2-9b", steps=8, batch=2, seq=32,
                                  ckpt_dir=str(tmp_path / where), ckpt_every=3, fail_at=fail_at,
                                  log_every=100, device="cpu")

    (broken, broken_losses), (whole, whole_losses) = run((5,), "a"), run((), "b")
    assert broken_losses == whole_losses[:5] + whole_losses[3:]
    assert all(torch.equal(a, b) for a, b in zip(leaves(broken), leaves(whole)))


def test_lm_example_runs_on_cpu():
    out = _run([str(ROOT / "examples" / "train_lm_torch.py"), "--device", "cpu", "--steps",
                "3", "--ckpt-every", "2"])
    assert "survived 1 injected failure" in out and out.strip().endswith("OK")
