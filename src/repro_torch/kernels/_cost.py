"""Cost hooks of the hand kernels: each launch charged by formula while a
cost counter is active.

``launch/hlo_analysis.CostCounter`` counts the torch operations a step
dispatches; a hand kernel is one ctypes call that it cannot see.  While a
counter is active (``counter`` is set) each wrapper charges its kernel's
work to it by formula, from shapes alone (each ops module's ``*_cost``):
B6's FLOPs from the (query head, key) pairs its masks keep, B4's and B5's
bytes from the bound that phase 5 of ``chip_smoke.py`` gives them.  With no
counter a wrapper's launch path reads ``counter`` and is otherwise
unchanged.

Under a counter a wrapper given real CUDA tensors launches its kernel as
always and charges each launch where it counts it.  Given tensors that hold
no data (fake or meta: ``core.device.holds_data``) it returns empty
outputs of the right shape and dtype; given real CPU tensors it runs its
plain version with counting paused.  Either way it charges what the card's
launch would be charged, forward and, through ``charged``'s autograd
Function, backward, once each; nothing inside a plain version is counted.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.device import holds_data

__all__ = ["Charge", "counter", "charge", "paused", "launches_kernel", "charged"]

counter = None  # the active cost counter (launch/hlo_analysis.CostCounter), else None


@dataclasses.dataclass(frozen=True)
class Charge:
    """One launch's work.  ``rows_from_shape``: the bound needs the data
    (B4's distinct (field, row) pairs, B5's distinct rows of x), so every
    row gathered is charged instead."""

    name: str
    flops: float
    bytes: float
    rows_from_shape: bool = False


def charge(c: Charge) -> None:
    if counter is not None:
        counter.charge(c)


@contextlib.contextmanager
def paused():
    """Nothing dispatched inside is counted (a plain version under a counter)."""
    if counter is None:
        yield
    else:
        with counter.paused():
            yield


def launches_kernel(t: torch.Tensor) -> bool:
    """A real CUDA tensor: its wrapper launches the kernel."""
    return t.device.type == "cuda" and holds_data(t)


@dataclasses.dataclass(frozen=True)
class _Call:
    plain: Callable  # the plain version, on the call's inputs
    empty: Callable  # an empty output of the right shape and dtype, on the call's inputs
    forward: Charge
    backward: Optional[Charge]
    backward_needs: Optional[int]  # the backward launches only if this input needs a gradient
    keep: Callable  # (inputs, output) -> the tensors the card's autograd Function saves


class _Charged(torch.autograd.Function):
    """A charged call that a gradient flows through: the forward charged in
    ``forward``, the backward in ``backward``, once each.  With no data it
    keeps what the card's Function keeps for its backward (so a counter's
    live bytes see them) and returns empty gradients; with data it keeps the
    inputs and differentiates the plain version, run again, in the
    backward (as a recompute would, so a checkpoint's hooks see only the
    inputs)."""

    @staticmethod
    def forward(ctx, call: _Call, *inputs):
        charge(call.forward)
        ctx.call = call
        ctx.likes = [(t.shape, t.dtype) if torch.is_tensor(t) else None for t in inputs]
        ctx.abstract = not all(holds_data(t) for t in inputs if torch.is_tensor(t))
        if ctx.abstract:
            out = call.empty(*inputs)
            ctx.save_for_backward(*call.keep(inputs, out))
            return out
        ctx.slots = [i for i, t in enumerate(inputs) if torch.is_tensor(t)]
        ctx.n_inputs = len(inputs)
        ctx.save_for_backward(*(inputs[i] for i in ctx.slots))
        with paused():
            return call.plain(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        call, needs = ctx.call, ctx.needs_input_grad[1:]
        if call.backward is not None and (call.backward_needs is None
                                          or needs[call.backward_needs]):
            charge(call.backward)
        if ctx.abstract:
            return (None, *(grad_out.new_empty(like[0], dtype=like[1]) if need else None
                            for like, need in zip(ctx.likes, needs)))
        inputs = [None] * ctx.n_inputs
        for i, t in zip(ctx.slots, ctx.saved_tensors):
            inputs[i] = t.detach().requires_grad_(needs[i])
        wanted = [t for t, need in zip(inputs, needs) if need]
        with paused(), torch.enable_grad():
            got = iter(torch.autograd.grad(call.plain(*inputs), wanted, grad_out,
                                           allow_unused=True))
        return (None, *(next(got) if need else None for need in needs))


def _keep_nothing(inputs, out):
    return ()


def charged(plain: Callable, inputs: Sequence, *, empty: Callable, forward: Charge,
            backward: Optional[Charge] = None, backward_needs: Optional[int] = 0,
            keep: Callable = _keep_nothing):
    """``plain(*inputs)`` as the kernel computes it, charged ``forward``
    (and ``backward`` when a gradient flows back and input ``backward_needs``
    needs one; None: whenever one flows): ``empty(*inputs)`` when the
    inputs hold no data, else the plain version with counting paused."""
    call = _Call(plain, empty, forward, backward, backward_needs, keep)
    if torch.is_grad_enabled() and any(torch.is_tensor(t) and t.requires_grad for t in inputs):
        return _Charged.apply(call, *inputs)
    charge(forward)
    if not all(holds_data(t) for t in inputs if torch.is_tensor(t)):
        return empty(*inputs)
    with paused():
        return plain(*inputs)
