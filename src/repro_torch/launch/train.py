"""Training launcher: any ported --arch, restartable.

The port of ``src/repro/launch/train.py``.  It runs the arch's smoke
config end to end: real AdamW steps with checkpoints and failure recovery,
on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
        --steps 12 --ckpt-every 4 --fail-at 6 [--device cpu]

Families: ``lm`` (the dense LMs), ``recsys`` (``dlrm-rm2``) and ``gnn``
(``gcn-cora``; the science models wait for ROADMAP A14).  On the card the
GCN's aggregation runs B5 forward and B5ᵀ backward, DLRM's lookup B4
forward with its backward on B5, and every LM layer's attention B6 forward
(with its row log-sum-exp) and B6's backward kernels (``flash_attention_bwd.cu``),
each pattern group rematerialized as the config's ``remat`` says.

Fault tolerance: the ``TrainController`` checkpoints every ``--ckpt-every``
steps and resumes from the newest checkpoint; ``--fail-at`` injects a
simulated crash, after which the loop restarts from the last checkpoint.
Without ``--ckpt-dir`` the checkpoints go to a fresh temporary directory,
removed at the end.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_arch
from repro_torch.core.device import resolve_device
from repro_torch.data import dlrm_batch, lm_batch, synthetic_graph_batch
from repro_torch.ft import FailureInjector, TrainController
from repro_torch.optim import AdamWConfig, apply_updates, init_state
from repro_torch.optim.tree import flatten, unflatten

__all__ = ["SMOKE_OPT", "make_train_step", "make_smoke_step", "run_training", "main"]

SMOKE_OPT = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=10_000)


def make_train_step(loss: Callable, batch_fn: Callable[[int], object], opt_cfg: AdamWConfig, *,
                    sync: Optional[Callable[[], None]] = None):
    """step_fn(state, step) -> (state, metrics): one AdamW step of
    ``loss(params, batch_fn(step))`` on state (params, opt), written into
    the state's tensors (as the reference's jit donates them).  With
    ``sync`` (e.g. ``torch.cuda.synchronize``) the metrics gain "ms": the
    host time of batch, forward, backward and update, each ended by
    ``sync()``."""
    def step_fn(state, step):
        params, opt = state
        flat, spec = flatten(params)
        ps = [p.detach().requires_grad_(True) for p in flat]
        marks = [time.perf_counter()]

        def mark():
            if sync is not None:
                sync()
                marks.append(time.perf_counter())

        b = batch_fn(step)
        mark()
        with torch.enable_grad():
            value = loss(unflatten(spec, ps), b)
            mark()
            grads = torch.autograd.grad(value, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]
        mark()
        params, opt, metrics = apply_updates(unflatten(spec, ps), unflatten(spec, grads), opt,
                                             opt_cfg, donate=True)
        mark()
        metrics = {"loss": value.detach(), **metrics}
        if sync is not None:
            metrics["ms"] = {k: (b_ - a) * 1e3 for k, a, b_ in
                             zip(("batch", "forward", "backward", "update"), marks, marks[1:])}
        return (params, opt), metrics

    return step_fn


def make_smoke_step(arch_id: str, *, batch: int, seq: int, seed: int = 0, device=None):
    """((params, opt_state), step_fn(state, step) -> (state, metrics), cfg)
    on the smoke config of ``arch_id``, deterministic per (seed, step)."""
    mod = get_arch(arch_id)
    cfg = mod.smoke_config()
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    if mod.FAMILY == "lm":
        from repro_torch.models import transformer as T

        params = T.init_params(gen, cfg, device=device)

        def loss(p, b):
            return T.loss_fn(p, b["tokens"], b["labels"], cfg)

        def batch_fn(step):
            return lm_batch(step, batch=batch, seq=seq, vocab=cfg.vocab, seed=seed, device=device)

    elif mod.FAMILY == "recsys":
        from repro_torch.models import dlrm as M

        params = M.init_params(gen, cfg, device=device)

        def loss(p, b):
            return M.loss_fn(p, b["dense"], b["sparse"], b["labels"], cfg)

        def batch_fn(step):
            return dlrm_batch(step, batch=batch, vocab=cfg.vocab_size, multi_hot=cfg.multi_hot,
                              seed=seed, device=device)

    elif getattr(mod, "MODEL", None) == "gcn":
        from repro_torch.models import gcn

        params = gcn.init_params(gen, cfg, device=device)
        gb = synthetic_graph_batch(n_nodes=128, n_edges=512, d_feat=cfg.d_in,
                                   n_classes=cfg.n_classes, seed=seed, device=device)

        def loss(p, b):
            return gcn.loss_fn(p, b, cfg)

        def batch_fn(step):
            return gb

    else:
        raise NotImplementedError(f"{arch_id}: the {mod.FAMILY} model "
                                  f"{getattr(mod, 'MODEL', '?')} is not ported yet (ROADMAP A14)")

    return (params, init_state(params)), make_train_step(loss, batch_fn, SMOKE_OPT), cfg


def run_training(arch_id: str, *, steps: int, batch: int, seq: int,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 25, fail_at=(),
                 seed: int = 0, log_every: int = 10, device=None):
    """Train ``steps`` steps under the ``TrainController``; returns (state,
    losses).  Without ``ckpt_dir`` the checkpoints live in a temporary
    directory removed at the end."""
    state, step_fn, _ = make_smoke_step(arch_id, batch=batch, seq=seq, seed=seed, device=device)
    own_dir = ckpt_dir is None
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_") if own_dir else ckpt_dir
    try:
        ckpt = CheckpointManager(ckpt_dir, keep=2)
        controller = TrainController(ckpt=ckpt, step_fn=step_fn, ckpt_every=ckpt_every)
        injector = FailureInjector(fail_at) if fail_at else None
        t0 = time.time()
        losses = []

        def log(step: int, metrics: Dict):
            losses.append(float(metrics["loss"]))
            if step % log_every == 0:
                print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"lr {float(metrics['lr']):.2e}  ({time.time() - t0:.1f}s)", flush=True)

        state = controller.run(state, steps, injector=injector, log=log)
    finally:
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None, help="default: a temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    _, losses = run_training(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, fail_at=tuple(args.fail_at), seed=args.seed,
        device=args.device)
    print(f"done: {len(losses)} steps, loss {losses[0]:.4f} → {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
