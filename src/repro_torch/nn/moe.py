"""Mixture-of-Experts FFN — grouped top-k routing with capacity (GShard layout).

The port of the reference's ``nn/moe.py``: tokens are split into
``n_groups`` dispatch groups and routing positions and capacity are
computed within each group, so the dispatch buffers are (G, E, C_g, D).
``dispatch='scatter'`` (the default) fills small (E, C) slot tables of
token ids and gathers the token features through them; ``'einsum'`` keeps
the dense one-hot products.  ``virtual_split=s`` stores each expert as s
F-slices, weights (E·s, D, F/s), whose partial outputs add.

Routing: softmax over the top-k logits (Mixtral) or the full softmax, then
top-k, renormalised (DBRX), as ``renorm`` says.  The top k are taken as
``lax.top_k`` takes them: descending, and among equal values the lower
expert first (a stable descending sort; ``torch.topk`` promises no order
among ties, and an all-zero token gives equal logits for every expert).
Slots are given choice-major (every token's first choice before any second
choice); a (token, choice) past the group's capacity C is dropped.  The
Switch-style aux loss is returned beside the output.

``moe_ffn`` runs ``route`` (logits → choices, gate values, slot positions,
which pairs are kept, the aux loss) and then ``experts`` (dispatch, the
expert FFN, combine), so the two parts can be held apart.  Dispatch and
combine are gathers (``gather_rows``: their backward sums in a fixed order)
multiplied by ``slot_ok`` and by ``gate·keep``, as in the reference, so
gradients reach the tokens, the gate values and the router as in the
reference.  The expert products are batched ``einsum``s
(cuBLAS on the card): the reference runs them through XLA, no Pallas
kernel.  ``shard_axes`` is the reference's sharding hint; on one
controller it has nothing to do and is ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.seg_mm.ref import gather_rows
from repro_torch.nn.layers import init_linear

__all__ = ["Routing", "init_moe", "moe_ffn", "moe_capacity", "route", "experts"]


def moe_capacity(n_tokens: int, n_experts: int, top_k: int, factor: float = 1.25) -> int:
    c = int(n_tokens * top_k / n_experts * factor)
    return max(8, -(-c // 8) * 8)  # round up to 8 for lane alignment


def init_moe(generator: torch.Generator, d_model: int, d_ff: int, n_experts: int, *,
             gated: bool = True, virtual_split: int = 1,
             dtype: torch.dtype = torch.float32) -> Dict:
    """{"router": {"w": (D, E)}, "up", "down"[, "gate"]} drawn from
    ``generator`` on its device; with ``virtual_split=s`` the expert
    weights are (E·s, D, F/s) and (E·s, F/s, D): exact for (gated) MLPs,
    whose partial sums over F-slices add."""
    s = virtual_split
    if d_ff % s:
        raise ValueError(f"virtual_split {s} does not divide d_ff {d_ff}")
    ev, ffv = n_experts * s, d_ff // s
    dev = generator.device

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=dev) * scale

    p = {"router": init_linear(generator, d_model, n_experts, dtype=dtype),
         "up": normal((ev, d_model, ffv), d_model ** -0.5),
         "down": normal((ev, ffv, d_model), d_ff ** -0.5)}
    if gated:
        p["gate"] = normal((ev, d_model, ffv), d_model ** -0.5)
    return p


@dataclasses.dataclass(frozen=True)
class Routing:
    """One call's routing, per dispatch group g.

    idx:   (G, Tg, k) int64 — each token's experts, best first
    gates: (G, Tg, k) — their gate values
    pos:   (G, k·Tg) int64 — each (choice, token) pair's slot, choice-major
    keep:  (G, k·Tg) bool — the pair fits in capacity
    aux:   () f32 — the Switch aux loss
    capacity: C, the slots per expert and group
    """

    idx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    capacity: int

    @property
    def dropped(self) -> torch.Tensor:
        """(choice, token) pairs past capacity, all groups."""
        return torch.sum(~self.keep)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: Dict, xg: torch.Tensor, *, n_experts: int, top_k: int,
          capacity_factor: float = 1.25, renorm: str = "topk") -> Routing:
    """Routing of the grouped tokens ``xg`` (G, Tg, D) over ``n_experts``."""
    g, tg, _ = xg.shape
    e = n_experts
    c = moe_capacity(tg, e, top_k, capacity_factor)
    logits = xg.to(torch.float32) @ router["w"].to(torch.float32)  # (G, Tg, E)
    if renorm == "full":
        probs = torch.softmax(logits, dim=-1)
        gate_vals, idx = _top_k(probs, top_k)
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    elif renorm == "topk":
        top_logits, idx = _top_k(logits, top_k)
        gate_vals = torch.softmax(top_logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
    else:
        raise ValueError(f"renorm must be 'topk' or 'full', got {renorm!r}")

    # Switch aux loss (per group, then mean): E · Σ_e f_e · P_e
    me = torch.mean(probs, dim=1)  # (G, E)
    ce = torch.mean(torch.sum(F.one_hot(idx, e).to(torch.float32), dim=2), dim=1)
    aux = e * torch.mean(torch.sum(me * ce, dim=-1))

    # per-group buffer positions: choice-major priority (GShard)
    ohf = F.one_hot(idx.transpose(1, 2).reshape(g, top_k * tg), e)  # (G, k·Tg, E)
    pos = torch.sum((torch.cumsum(ohf, dim=1) - 1) * ohf, dim=-1)  # (G, k·Tg)
    return Routing(idx=idx, gates=gate_vals, pos=pos, keep=pos < c, aux=aux, capacity=c)


def experts(p: Dict, xg: torch.Tensor, r: Routing, *, act: Callable = F.silu,
            dispatch: str = "scatter") -> torch.Tensor:
    """Dispatch the grouped tokens ``xg`` (G, Tg, D) to their slots, run
    the expert FFN, and combine: (G, Tg, D), each token the gate-weighted
    sum of its kept choices' outputs."""
    g, tg, d = xg.shape
    e = p["router"]["w"].shape[1]
    s = p["up"].shape[0] // e
    k, c = r.idx.shape[-1], r.capacity
    dt = xg.dtype
    e_flat = r.idx.transpose(1, 2).reshape(g, k * tg)
    g_flat = r.gates.transpose(1, 2).reshape(g, k * tg)
    tok_flat = torch.arange(tg, device=xg.device).repeat(k)  # (k·Tg,) within-group token
    rows = torch.arange(g, device=xg.device)[:, None]

    if dispatch == "einsum":
        disp = (F.one_hot(e_flat, e).to(dt)[..., None]
                * F.one_hot(torch.where(r.keep, r.pos, c), c + 1).to(dt)[..., None, :c])
        xb = torch.einsum("gtec,gtd->gecd", disp, xg.index_select(1, tok_flat))
    elif dispatch == "scatter":
        # index-scatter into (E, C + 1) slot tables (a dropped pair lands in
        # column C, sliced away), then gather the token features through them
        e_safe = torch.where(r.keep, e_flat, e - 1)
        flat = e_safe * (c + 1) + torch.where(r.keep, r.pos, c)
        slot_tok = torch.zeros((g, e * (c + 1)), dtype=torch.int64, device=xg.device)
        slot_tok.scatter_(1, flat, tok_flat.expand(g, -1).contiguous())
        slot_ok = torch.zeros((g, e * (c + 1)), dtype=torch.bool, device=xg.device)
        slot_ok.scatter_(1, flat, r.keep)
        slot_tok = slot_tok.reshape(g, e, c + 1)[:, :, :c]
        slot_ok = slot_ok.reshape(g, e, c + 1)[:, :, :c]
        slot_tok = slot_tok + rows[:, :, None] * tg  # rows of the (G·Tg, D) token table
        xb = gather_rows(xg.reshape(g * tg, d), slot_tok.reshape(-1)).reshape(g, e, c, d)
        xb = xb * slot_ok[..., None].to(dt)  # (G, E, C, D)
    else:
        raise ValueError(f"dispatch must be 'scatter' or 'einsum', got {dispatch!r}")

    # virtual expansion: every real expert's buffer feeds its s F-slices
    if s > 1:
        xb = xb[:, :, None].expand(g, e, s, c, d).reshape(g, e * s, c, d)

    # expert FFN (shared virtual experts, batched over G)
    h = torch.einsum("gecd,edf->gecf", xb, p["up"].to(dt))
    if "gate" in p:
        h = act(torch.einsum("gecd,edf->gecf", xb, p["gate"].to(dt))) * h
    else:
        h = act(h)
    yb = torch.einsum("gecf,efd->gecd", h, p["down"].to(dt))
    if s > 1:  # partial outputs over F-slices sum
        yb = yb.reshape(g, e, s, c, d).sum(dim=2)

    # combine: gather per (choice, token), then sum over the k choices
    slot = (rows * e + torch.where(r.keep, e_flat, 0)) * c + torch.where(r.keep, r.pos, 0)
    got = gather_rows(yb.reshape(g * e * c, d), slot.reshape(-1)).reshape(g, k * tg, d)
    contrib = got * (g_flat * r.keep).to(dt)[..., None]
    return contrib.reshape(g, k, tg, d).sum(dim=1)


def moe_ffn(
    p: Dict,
    x: torch.Tensor,
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    renorm: str = "topk",  # 'topk' (Mixtral) | 'full' (DBRX)
    act: Callable = F.silu,
    dispatch: str = "scatter",
    n_groups: int = 1,
    virtual_split: int = 1,
    shard_axes: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) tokens → (out (T, D), aux_loss scalar)."""
    del shard_axes  # a sharding hint: nothing to do on one controller
    t, d = x.shape
    e = p["up"].shape[0] // virtual_split
    g = max(1, n_groups)
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} groups")
    xg = x.reshape(g, t // g, d)
    r = route(p["router"], xg, n_experts=e, top_k=top_k, capacity_factor=capacity_factor,
              renorm=renorm)
    return experts(p, xg, r, act=act, dispatch=dispatch).reshape(t, d), r.aux
