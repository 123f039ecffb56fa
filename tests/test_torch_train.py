"""The port's training launcher (``launch/train.py``) and arch registry
(``configs/registry.py``) against the reference on the CPU.

For each of the registry's ten archs the reference's initial params are
carried across by ``params_from_reference`` and both packages'
``make_smoke_step`` take 3 steps on the same batches (the reference's
``lm_batch``/``dlrm_batch`` handed to the port; the GNNs' seeded numpy
batches are the same in both): loss, ``grad_norm`` and ``lr`` within 1e-4
relative at each step (3e-2 for graphcast, whose smoke config runs in bf16:
one bf16 rounding of its activations), parameters within 2·Σ lr absolute
(an AdamW step moves a parameter by about lr whatever its gradient's size,
so a near-zero gradient whose sign the two roundings split can move it that
far).  Then restarts end to end (a failure injected, bitwise the unbroken
run) for the GCN, the MoE LMs and the science models, the CLI, the
sampled-training example and the registry.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data import dlrm_batch as ref_dlrm_batch
from repro.data import lm_batch as ref_lm_batch
from repro.launch import train as ref_train
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.optim.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["mixtral-8x22b", "dbrx-132b", "gemma2-9b", "qwen2-72b", "starcoder2-7b", "gcn-cora",
         "mace", "dimenet", "graphcast", "dlrm-rm2"]
BATCH, SEQ, STEPS = 2, 16, 3
RTOL = {"graphcast": 3e-2}  # bf16 activations; every other smoke config is f32: 1e-4


def _port_params(arch, ref_params, cfg):
    from repro_torch.models import dimenet, dlrm, gcn, graphcast, mace
    from repro_torch.models import transformer as T

    tree = jax.tree.map(np.asarray, ref_params)
    mod = registry.get_arch(arch)
    if mod.FAMILY == "gnn":
        model = {"gcn": gcn, "mace": mace, "dimenet": dimenet, "graphcast": graphcast}[mod.MODEL]
    else:
        model = {"lm": T, "recsys": dlrm}[mod.FAMILY]
    return model.params_from_reference(tree, cfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_steps_match_reference(arch, monkeypatch):
    def as_torch(b):
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    monkeypatch.setattr(train, "lm_batch", lambda step, *, device=None, **kw:
                        as_torch(ref_lm_batch(step, **kw)))
    monkeypatch.setattr(train, "dlrm_batch", lambda step, *, device=None, **kw:
                        as_torch(ref_dlrm_batch(step, **kw)))
    (ref_p, ref_opt), ref_step, ref_cfg = ref_train.make_smoke_step(arch, batch=BATCH, seq=SEQ)
    (_, _), step_fn, cfg = train.make_smoke_step(arch, batch=BATCH, seq=SEQ, device="cpu")
    params = _port_params(arch, ref_p, cfg)
    state = (params, train.init_state(params))
    ref_state = (ref_p, ref_opt)
    lr_sum = 0.0
    for step in range(STEPS):
        ref_state, ref_m = ref_step(ref_state, step)
        state, m = step_fn(state, step)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=RTOL.get(arch, 1e-4),
                                       err_msg=f"{arch} step {step} {k}")
        lr_sum += float(ref_m["lr"])
    got = [t.detach().float().numpy() for t in leaves(state[0])]
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(ref_state[0])]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr_sum)
    assert int(state[1]["count"]) == STEPS


def test_gcn_restart_end_to_end_is_bitwise(tmp_path):
    """A failure injected at 6 of 12 steps (checkpoints every 4): the run
    restarts from step 4 and ends with the unbroken run's bits."""
    def run(fail_at, where):
        state, losses = train.run_training("gcn-cora", steps=12, batch=4, seq=16,
                                           ckpt_dir=str(tmp_path / where), ckpt_every=4,
                                           fail_at=fail_at, log_every=100, device="cpu")
        return state, losses

    broken, broken_losses = run((6,), "a")
    whole, whole_losses = run((), "b")
    assert len(broken_losses) == 14 and len(whole_losses) == 12
    assert broken_losses[6:] == whole_losses[4:] and all(np.isfinite(broken_losses))
    assert all(torch.equal(a, b) for a, b in zip(leaves(broken), leaves(whole)))
    assert sorted(os.listdir(tmp_path / "a")) == ["step_000000008", "step_000000012"]


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dimenet", "mace", "graphcast", "dbrx-132b"])
def test_restart_end_to_end_is_bitwise(arch, tmp_path):
    """The MoE LMs and the science models: a failure injected at 5 of 8
    steps (checkpoints every 3) restarts from step 3 and ends with the
    unbroken run's bits."""
    def run(fail_at, where):
        return train.run_training(arch, steps=8, batch=2, seq=16, ckpt_dir=str(tmp_path / where),
                                  ckpt_every=3, fail_at=fail_at, log_every=100, device="cpu")

    (broken, broken_losses), (whole, whole_losses) = run((5,), "a"), run((), "b")
    assert broken_losses == whole_losses[:5] + whole_losses[3:]
    assert all(np.isfinite(whole_losses))
    assert all(torch.equal(a, b) for a, b in zip(leaves(broken), leaves(whole)))


@pytest.mark.parametrize("arch", ["gcn-cora", "dlrm-rm2", "starcoder2-7b", "mixtral-8x22b",
                                  "graphcast"])
def test_train_cli_runs_on_cpu(arch):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
                          "--steps", "12", "--ckpt-every", "4", "--fail-at", "6", "--batch", "2",
                          "--seq", "16", "--device", "cpu"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done: 14 steps" in out.stdout


def test_sampled_training_example_runs_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "gnn_sampled_training_torch.py"),
                          "--device", "cpu", "--edges", "20000", "--steps", "12"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("OK") and "step  10" in out.stdout


def test_registry_resolves_the_ported_archs_and_names_the_rest():
    """Every arch of the reference's registry resolves in the port, to a
    module of the same family (and GNN model); nothing is pending."""
    from repro.configs import registry as ref_registry

    assert list(registry.ARCHS) == list(ref_registry.ARCHS) == ARCHS
    assert not hasattr(registry, "PENDING")
    for arch in ARCHS:
        mod, ref_mod = registry.get_arch(arch), ref_registry.get_arch(arch)
        assert mod.FAMILY == ref_mod.FAMILY and mod.ARCH_ID == arch
        assert getattr(mod, "MODEL", None) == getattr(ref_mod, "MODEL", None)
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("gpt-5")


def test_make_train_step_reports_its_split():
    params = {"w": torch.ones(3)}
    step_fn = train.make_train_step(lambda p, b: torch.sum(p["w"] * b), lambda step: torch.ones(3),
                                    train.SMOKE_OPT, sync=lambda: None)
    (params, opt), m = step_fn((params, train.init_state(params)), 0)
    assert set(m["ms"]) == {"batch", "forward", "backward", "update"}
    assert int(opt["count"]) == 1 and not torch.equal(params["w"], torch.ones(3))
