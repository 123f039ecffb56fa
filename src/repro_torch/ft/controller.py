"""Fault-tolerant training controller: restart, failure injection, stragglers.

The port of ``src/repro/ft/controller.py``:

* ``TrainController.run`` steps a ``step_fn`` with periodic checkpoints; on
  start, and after a failure, it resumes from the newest checkpoint (crash,
  relaunch, continue).  With a deterministic step and step-addressed data
  the restarted run ends bit for bit where an unbroken one does.
* ``FailureInjector`` raises a simulated fault at chosen steps (once each);
  the loop turns it into a restart.
* ``accumulate_grads`` averages gradients over microbatches with a
  ``drop_mask``: late microbatches are dropped and the mean renormalized.

The initial state is kept as a host copy (the reference copies it to the
host too), because a step may write into its input (the reference's jit
donates it).  Restoring into that copy alone would leave a
restarted run on the CPU, so each leaf's device is recorded and the state
is put back there, unless ``run`` is handed other ``shardings``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import host_copy
from repro_torch.optim.tree import flatten, tree_map, unflatten

__all__ = ["FailureInjector", "TrainController", "accumulate_grads"]


class FailureInjector:
    """Raises ``SimulatedFailure`` at the scheduled global steps (once each)."""

    class SimulatedFailure(RuntimeError):
        pass

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise self.SimulatedFailure(f"injected failure at step {step}")


def accumulate_grads(loss_fn: Callable, params, microbatches, drop_mask=None):
    """Mean gradients (f32) over the microbatches (their leading axis),
    skipping dropped ones, and the (n_micro,) losses.  ``drop_mask``:
    (n_micro,) bool, True where a microbatch contributes."""
    mb_flat, mb_spec = flatten(microbatches)
    n = mb_flat[0].shape[0]
    flat_p, spec = flatten(params)
    device = flat_p[0].device
    keep = (torch.ones((n,), dtype=torch.bool, device=device) if drop_mask is None
            else torch.as_tensor(drop_mask, device=device))
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat_p]
    denom = torch.zeros((), dtype=torch.float32, device=device)
    losses = []
    for i in range(n):
        mb = unflatten(mb_spec, [x[i] for x in mb_flat])
        ps = [p.detach().requires_grad_(True) for p in flat_p]
        with torch.enable_grad():
            loss = loss_fn(unflatten(spec, ps), mb)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        w = keep[i].to(torch.float32)
        with torch.no_grad():
            acc = [a + w * (g.to(torch.float32) if g is not None else torch.zeros_like(a))
                   for a, g in zip(acc, grads)]
        denom = denom + w
        losses.append(loss.detach())
    denom = torch.clamp(denom, min=1.0)
    return unflatten(spec, [a / denom for a in acc]), torch.stack(losses)


def _devices(tree):
    return tree_map(lambda x: x.device if torch.is_tensor(x) else torch.device("cpu"), tree)


def _placed(tree, devices):
    """A copy of ``tree`` with each leaf on its entry of ``devices``."""
    return tree_map(lambda x, d: x.to(d, copy=True) if torch.is_tensor(x) else x, tree, devices)


@dataclasses.dataclass
class TrainController:
    """Generic restartable step loop.

    step_fn(state, step) -> (state, metrics); ``state`` is a tree of tensors.
    """

    ckpt: CheckpointManager
    step_fn: Callable[[Any, int], Tuple[Any, Dict]]
    ckpt_every: int = 50
    max_restarts: int = 8

    def run(self, state, n_steps: int, *, injector: Optional[FailureInjector] = None,
            shardings=None, log: Optional[Callable[[int, Dict], None]] = None):
        """Run to ``n_steps`` global steps, surviving injected failures by
        restoring the newest checkpoint (the external scheduler's restart
        path folded into one process).  ``shardings``: a tree of devices
        to restore onto; by default each leaf's own."""
        restarts = 0
        devices = _devices(state) if shardings is None else shardings
        init_snapshot = host_copy(state)
        while True:
            start, state = self._resume(init_snapshot, devices)
            try:
                for step in range(start, n_steps):
                    if injector is not None:
                        injector.check(step)
                    state, metrics = self.step_fn(state, step)
                    if log is not None:
                        log(step, metrics)
                    nxt = step + 1
                    if nxt % self.ckpt_every == 0 or nxt == n_steps:
                        self.ckpt.save_sync(nxt, state)
                return state
            except FailureInjector.SimulatedFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                # fall through: the next pass restores the newest checkpoint

    def _resume(self, like_state, devices):
        step, state = self.ckpt.restore_latest(like_state, shardings=devices)
        return (0, _placed(like_state, devices)) if step is None else (step, state)
