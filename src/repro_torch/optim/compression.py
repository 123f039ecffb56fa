"""Gradient compression for the data-parallel all-reduce, with error feedback.

The port of ``src/repro/optim/compression.py``: int8 with a per-tensor
scale (``max|x| / 127``), and the residual the quantizer dropped carried to
the next step (Seide et al. 2014; EF-SGD, Karimireddy et al. 2019), so the
sum of decompressed gradients tracks the sum of true ones.  The rounding
is ``torch.round``'s, half to even, as ``jnp.round``'s; every division is
a tensor by a tensor, an IEEE division on the card too (a Python divisor
would let CUDA multiply by its reciprocal).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.tree import flatten, tree_map, unflatten

__all__ = ["CompressedGrads", "init_error_state", "compress_with_feedback", "decompress"]


class CompressedGrads(NamedTuple):
    q: Any      # tree of int8 tensors
    scale: Any  # tree of f32 per-tensor scales (0-d)


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax / torch.full((), 127.0, device=x.device), min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_with_feedback(grads, err_state) -> Tuple[CompressedGrads, Any]:
    """int8-quantize (grads + carried error); returns the compressed grads
    and the new error state (the residual the quantizer dropped)."""
    with torch.no_grad():
        corrected = tree_map(lambda g, e: g.to(torch.float32) + e, grads, err_state)
        flat, spec = flatten(corrected)
        qs = [_quantize(c) for c in flat]
        q = unflatten(spec, [t[0] for t in qs])
        scale = unflatten(spec, [t[1] for t in qs])
        new_err = unflatten(spec, [c - qq.to(torch.float32) * s for c, (qq, s) in zip(flat, qs)])
    return CompressedGrads(q=q, scale=scale), new_err


def decompress(comp: CompressedGrads):
    return tree_map(lambda q, s: q.to(torch.float32) * s, comp.q, comp.scale)
