"""Shared neural-net layers — functional (init/apply), params as plain dicts.

Every layer is ``init_*(generator, ...) -> params`` plus a pure apply
function, so params compose into nested dicts of tensors.  Computation runs
in the input's dtype (bf16 on the card for the LM stack) with f32
normalization, as the reference does: weights are cast to ``x.dtype`` at
each use and norm scales are read in f32.  ``gelu`` is the tanh form, which
is the reference's (its gelu defaults to the tanh approximation).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.core.device import holds_data, resolve_device
from repro_torch.nn.partition import unsplit

__all__ = [
    "init_linear",
    "linear",
    "matmul",
    "init_rmsnorm",
    "rmsnorm",
    "init_layernorm",
    "layernorm",
    "init_mlp",
    "mlp",
    "rope",
    "softcap",
    "label_logits",
]


def init_linear(generator: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
                scale: Optional[float] = None,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """{"w": (d_in, d_out) normal · scale (default 1/sqrt(d_in)), "b": zeros}
    drawn from ``generator`` on the generator's device."""
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=generator, dtype=dtype,
                    device=generator.device) * scale
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return p


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., D_in) and w (D_in, D_out).  On DTensors each
    rank multiplies its shards as Megatron's parallel layers do (``w``'s
    placement on ``model`` says which): ``Shard(1)`` column-parallel (x
    whole there, the output split on its last dim), ``Shard(0)``
    row-parallel (x split on its last dim, the output a partial sum),
    ``Replicate()`` whole.  ``w`` is gathered over the data-parallel axes
    (FSDP) and its gradient comes back there as a partial sum; x keeps its
    batch split."""
    if not isinstance(w, DTensor):
        return x @ w
    mesh, last = w.device_mesh, x.dim() - 1
    w_model = w.placements[mesh.mesh_dim_names.index("model")]
    row, col = w_model == Shard(0), w_model == Shard(1)
    x_pl, x_grad, w_pl, w_grad, out_pl = [], [], [], [], []
    for name, xp in zip(mesh.mesh_dim_names, x.placements):
        if name == "model":
            x_pl.append(Shard(last) if row else Replicate())
            x_grad.append(Shard(last) if row else Partial() if col else Replicate())
            w_pl.append(w_model)
            w_grad.append(w_model)
            out_pl.append(Partial() if row else Shard(last) if col else Replicate())
        else:  # a data-parallel axis: the batch split (or not) as x has it
            split = xp == Shard(0)
            x_pl.append(Shard(0) if split else Replicate())
            x_grad.append(x_pl[-1])
            w_pl.append(Replicate())
            w_grad.append(Partial() if split else Replicate())
            out_pl.append(x_pl[-1])
    return local_map(torch.matmul, out_placements=(tuple(out_pl),),
                     in_placements=(tuple(x_pl), tuple(w_pl)),
                     in_grad_placements=(tuple(x_grad), tuple(w_grad)), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def init_rmsnorm(d: int, dtype: torch.dtype = torch.float32,
                 device=None) -> Dict[str, torch.Tensor]:
    """{"scale": ones} on ``device`` (``None``: the card, as everywhere in
    the port; raises without one)."""
    return {"scale": torch.ones((d,), dtype=dtype, device=resolve_device(device))}


def rmsnorm(p: Dict[str, torch.Tensor], x: torch.Tensor, *, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = p["scale"].to(torch.float32)
    s = 1.0 + s if plus_one else s  # gemma convention stores scale-1
    return (y * s).to(x.dtype)


def init_layernorm(d: int, dtype: torch.dtype = torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
    """{"scale": ones, "bias": zeros} on ``device`` (``None``: the card;
    raises without one)."""
    device = resolve_device(device)
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Dict[str, torch.Tensor], x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim; a DTensor is made whole along it first
    (``nn/partition.unsplit``)."""
    xf = unsplit(x, -1).to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)).to(x.dtype)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")  # the reference's default
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "relu":
        return torch.relu(x)
    raise ValueError(name)


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, *, gated: bool,
             act: str = "silu", dtype: torch.dtype = torch.float32) -> Dict:
    """{"up", "down"[, "gate"]} linears; ``act`` is applied by ``mlp``."""
    del act  # a static choice of ``mlp``, not a parameter
    p = {"up": init_linear(generator, d_model, d_ff, dtype=dtype),
         "down": init_linear(generator, d_ff, d_model, dtype=dtype)}
    if gated:
        p["gate"] = init_linear(generator, d_model, d_ff, dtype=dtype)
    return p


def mlp(p: Dict, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    h = linear(p["up"], x)
    if "gate" in p:
        h = _act(act, linear(p["gate"], x)) * h
    else:
        h = _act(act, h)
    return linear(p["down"], h)


def _rope_table(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE's (half,) f32 frequencies, computed on the host and moved to
    ``device``: the card's ``exp`` may round an entry one ulp away from
    the CPU's, and at position p an angle moves by p ulps of the entry
    (at p = 4,607 a 1-ulp nudge of 8 of 128 entries moves the logits by
    ~1e-3); the same table on every device keeps the angles bitwise equal."""
    freq = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32) / half)
    return freq.to(device)


_rope_freq = functools.lru_cache(maxsize=None)(_rope_table)  # one table per device


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding.  x: (..., seq, n_heads, d_head); positions
    broadcastable to (..., seq).  Rotates the two halves (GPT-NeoX layout);
    angles in f32, the result cast back to ``x.dtype``."""
    d = x.shape[-1]
    half = d // 2
    # a dry run's fake tensors get a table of their own: a cached one is of another mode
    freq = (_rope_freq if holds_data(x) else _rope_table)(half, float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * freq  # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap·tanh(x/cap) in f32, cast back.
    None ⇒ identity."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def label_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., label]`` for each label, as the reference's
    ``take_along_axis`` reads it (fill mode): a label in [-C, -1] wraps, any
    other label outside [0, C) gives NaN, so its loss is NaN.  No label is
    ignored (torch's ``ignore_index`` has no counterpart there)."""
    c = logits.shape[-1]
    lb = labels.to(torch.int64)
    lb = torch.where(lb < 0, lb + c, lb)
    ok = (lb >= 0) & (lb < c)
    true = torch.gather(logits, -1, torch.where(ok, lb, 0)[..., None])[..., 0]
    return true.masked_fill(~ok, float("nan"))
