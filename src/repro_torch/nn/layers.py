"""Shared neural-net layers — functional (init/apply), params as plain dicts.

Every layer is ``init_*(generator, ...) -> params`` plus a pure apply
function, so params compose into nested dicts of tensors.  Ported so far:
``init_linear`` / ``linear``, which the GNN models need; the norms, MLP,
RoPE and softcap wait for the LM stack.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

__all__ = ["init_linear", "linear"]


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
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y
