"""AdamW with decoupled weight decay, global-norm clipping and LR schedules.

The port of ``src/repro/optim/adamw.py``: functional over the same trees
(dicts, lists, tuples of tensors; ``optim/tree.py``), under
``torch.no_grad``.  Moments and the update are f32 and each parameter is
written back in its own dtype.  The scalars (learning rate, bias
corrections) are computed on the host in numpy float32, as the reference
computes them in f32 on its device; the element-wise work is torch ops,
``torch._foreach_*`` over the leaves, in the reference's order of
operations.  The reference leaves this to XLA, so there is no hand kernel.

``apply_updates(..., donate=True)`` writes the new parameters and moments
into the old ones' storage, as the reference's training step donates its
state to ``jit``; it then works through the leaves a slice at a time, so
no full-size temporary is made (``dlrm-rm2``'s tables are 6.66 GB).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.tree import flatten, leaves, tree_map, unflatten

__all__ = ["AdamWConfig", "init_state", "apply_updates", "cosine_schedule", "constant_schedule"]

_F = np.float32
CHUNK = 1 << 26  # elements updated at once: bounds the temporaries (256 MB in f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"          # 'cosine' | 'constant'
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _step(step) -> int:
    return int(step.item()) if torch.is_tensor(step) else int(step)


def _warm(cfg: AdamWConfig, step: int) -> np.float32:
    return np.minimum(_F(step) / _F(max(cfg.warmup_steps, 1)), _F(1.0))


def cosine_schedule(cfg: AdamWConfig, step) -> np.float32:
    """Linear warmup, then a cosine from ``lr`` to ``min_lr_ratio · lr``
    (f32, as the reference computes it; ``step`` an int or a 0-d tensor)."""
    step = _step(step)
    t = np.clip(_F(step - cfg.warmup_steps) / _F(max(cfg.total_steps - cfg.warmup_steps, 1)),
                _F(0), _F(1))
    cos = _F(cfg.min_lr_ratio) + _F((1 - cfg.min_lr_ratio) * 0.5) * (
        _F(1) + np.cos(_F(np.pi) * t))
    return _F(cfg.lr) * _warm(cfg, step) * cos


def constant_schedule(cfg: AdamWConfig, step) -> np.float32:
    return _F(cfg.lr) * _warm(cfg, _step(step))


def init_state(params) -> Dict:
    """{"m", "v": f32 zeros shaped as ``params``, "count": int32 0} on the
    params' devices."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    flat = leaves(params)
    device = flat[0].device if flat else torch.device("cpu")
    return {"m": zeros, "v": tree_map(torch.zeros_like, zeros),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    total = None
    for g in grads:
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s.to(total.device)
    return torch.sqrt(total) if total is not None else torch.zeros(())


def _slices(t: torch.Tensor) -> List[torch.Tensor]:
    flat = t.view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def _batches(groups: List[Tuple[torch.Tensor, ...]]):
    """Lists of same-index slices of (p, g, m, v), each batch at most
    ``CHUNK`` elements in all."""
    batch, size = [], 0
    for group in groups:
        for piece in zip(*(_slices(t) for t in group)):
            if batch and size + piece[0].numel() > CHUNK:
                yield [list(x) for x in zip(*batch)]
                batch, size = [], 0
            batch.append(piece)
            size += piece[0].numel()
    if batch:
        yield [list(x) for x in zip(*batch)]


def _update(P, G, M, V, scale, cfg: AdamWConfig, lr, b1c, b2c) -> None:
    """One AdamW step on lists of same-shaped slices, in place on P, M, V,
    in the reference's order of operations."""
    f = lambda x: float(_F(x))  # noqa: E731  (a Python float holding the f32 value)
    g = [x.to(torch.float32) for x in G]
    if scale is not None:
        g = torch._foreach_mul(g, scale)
    t = torch._foreach_mul(g, f(1 - cfg.b1))
    torch._foreach_mul_(M, f(cfg.b1))
    torch._foreach_add_(M, t)                                # m2 = b1·m + (1-b1)·g
    t = torch._foreach_mul(g, f(1 - cfg.b2))
    torch._foreach_mul_(t, g)
    torch._foreach_mul_(V, f(cfg.b2))
    torch._foreach_add_(V, t)                                # v2 = b2·v + (1-b2)·g·g
    den = torch._foreach_div(V, float(b2c))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, f(cfg.eps))
    step = torch._foreach_div(M, float(b1c))
    torch._foreach_div_(step, den)                           # (m2/b1c) / (√(v2/b2c) + eps)
    p32 = [x.to(torch.float32) for x in P]
    t = torch._foreach_mul(p32, f(cfg.weight_decay))
    torch._foreach_add_(t, step)
    torch._foreach_mul_(t, float(lr))                        # lr·(step + wd·p)
    if all(x.dtype == torch.float32 for x in P):
        torch._foreach_sub_(P, t)
    else:
        for x, a, b in zip(P, p32, t):
            x.copy_(a - b)


def _owned(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def apply_updates(params, grads, state: Dict, cfg: AdamWConfig, *,
                  donate: bool = False) -> Tuple[Any, Dict, Dict]:
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}: 0-d f32
    tensors).  ``donate``: the new params and moments are written into the
    given ones' storage (which must be contiguous) and returned."""
    with torch.no_grad():
        flat_p, spec = flatten(params)
        flat_g = [g.detach() for g in leaves(grads)]
        flat_m, flat_v = leaves(state["m"]), leaves(state["v"])
        if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
            raise ValueError("apply_updates: params, grads and moments differ in structure")
        count = _step(state["count"]) + 1
        gnorm = _global_norm(flat_g)
        scale = None
        if cfg.clip_norm is not None:
            clip = torch.full((), cfg.clip_norm, dtype=torch.float32, device=gnorm.device)
            scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = (cosine_schedule if cfg.schedule == "cosine" else constant_schedule)(cfg, count)
        b1c = _F(1) - _F(cfg.b1) ** _F(count)
        b2c = _F(1) - _F(cfg.b2) ** _F(count)
        if donate:
            if not all(t.is_contiguous() for t in flat_p + flat_m + flat_v):
                raise ValueError("apply_updates(donate=True): params and moments must be "
                                 "contiguous")
            new_p, new_m, new_v = flat_p, flat_m, flat_v
        else:
            new_p, new_m, new_v = ([_owned(t) for t in ts] for ts in (flat_p, flat_m, flat_v))
        for p, g in zip(new_p, flat_g):
            if p.shape != g.shape:
                raise ValueError(f"apply_updates: gradient {tuple(g.shape)} for a parameter "
                                 f"{tuple(p.shape)}")
        groups = [(p, g.reshape(-1), m, v) for p, g, m, v in zip(new_p, flat_g, new_m, new_v)]
        for P, G, M, V in _batches(groups):
            _update(P, G, M, V, scale, cfg, lr, b1c, b2c)
        m_spec, v_spec = flatten(state["m"])[1], flatten(state["v"])[1]
        new_state = {"m": unflatten(m_spec, new_m), "v": unflatten(v_spec, new_v),
                     "count": torch.full((), count, dtype=torch.int32,
                                         device=state["count"].device)}
        metrics = {"grad_norm": gnorm, "lr": torch.tensor(lr, dtype=torch.float32)}
        return unflatten(spec, new_p), new_state, metrics
