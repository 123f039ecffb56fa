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
kernel.

``shard_axes`` ({'dp': axes, 'expert': axis or None, 'tp': axis or None})
gives the reference's seven sharding constraints, ``spec_tok`` on the
grouped tokens and the output, ``spec_xb`` on the dispatch buffers,
``spec_xbv`` on the virtual-expert buffers and ``spec_h`` on the hidden
layer, each ``nn/partition.constrain``: a ``redistribute`` of a DTensor
and nothing on a plain tensor.  On DTensors (the partitioned program,
``launch/dryrun.py``) the parts DTensor has no rule for run rank by rank
under ``local_map``, each group on its data-parallel rank: ``route`` (the
router gathered, the choices, slots and the aux loss of the rank's groups;
the aux loss a mean over them), dispatch (the slot tables whole, the token
rows gathered only for the rank's slice of the buffer that ``spec_xb``
gives it), the expert FFN (each rank's experts, or its F-slice of every
expert under expert-TP; the weights gathered over the data-parallel axes)
and combine (each rank adds the pairs its slice holds: a partial sum over
``model``).  Between them DTensor moves the buffers: the virtual experts'
all-to-all from capacity-split to expert-split and back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.seg_mm.ref import gather_rows
from repro_torch.nn.layers import init_linear, matmul
from repro_torch.nn.partition import P, constrain, local_call, local_shard, mesh_placements, named

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
    logits = matmul(xg.to(torch.float32), router["w"].to(torch.float32))  # (G, Tg, E)
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


def _route_partitioned(router: Dict, xg, **kw) -> Routing:
    """``route`` on DTensors: each rank routes its groups (the router
    gathered whole); the aux loss is the mean of the ranks' means."""
    mesh = xg.device_mesh
    tok = mesh_placements(mesh, dp=Shard(0), like=xg)
    whole = mesh_placements(mesh)

    def local(xg_l, w):
        r = route({"w": w}, xg_l, **kw)
        return r.idx, r.gates, r.pos, r.keep, r.aux

    idx, gates, pos, keep, aux = local_map(
        local, out_placements=(tok, tok, tok, tok,
                               mesh_placements(mesh, dp=Partial("avg"), like=xg)),
        in_placements=(tok, whole),
        in_grad_placements=(tok, mesh_placements(mesh, dp=Partial(), like=xg)), device_mesh=mesh,
        redistribute_inputs=True)(xg, router["w"])
    return Routing(idx=idx, gates=gates, pos=pos, keep=keep, aux=aux,
                   capacity=moe_capacity(xg.shape[1], kw["n_experts"], kw["top_k"],
                                         kw.get("capacity_factor", 1.25)))


def _slot_tables(r: Routing, e: int, g: int, tg: int, device):
    """(slot_tok, slot_ok), each (G, E, C): the token (a row of the (G·Tg,
    D) table) each expert slot holds, and whether one does.  Pairs are
    index-scattered into (E, C + 1) tables, a dropped pair into column C,
    which is sliced away."""
    k, c = r.idx.shape[-1], r.capacity
    e_flat = r.idx.transpose(1, 2).reshape(g, k * tg)
    tok_flat = torch.arange(tg, device=device).repeat(k)  # (k·Tg,) within-group token
    rows = torch.arange(g, device=device)[:, None]
    e_safe = torch.where(r.keep, e_flat, e - 1)
    flat = e_safe * (c + 1) + torch.where(r.keep, r.pos, c)
    slot_tok = torch.zeros((g, e * (c + 1)), dtype=torch.int64, device=device)
    slot_tok.scatter_(1, flat, tok_flat.expand(g, -1).contiguous())
    slot_ok = torch.zeros((g, e * (c + 1)), dtype=torch.bool, device=device)
    slot_ok.scatter_(1, flat, r.keep)
    slot_tok = slot_tok.reshape(g, e, c + 1)[:, :, :c]
    slot_ok = slot_ok.reshape(g, e, c + 1)[:, :, :c]
    return slot_tok + rows[:, :, None] * tg, slot_ok


def _buffer_slice(mesh, placements, shape) -> Tuple[int, int, int, int]:
    """(first expert, experts, first slot, slots) of this rank's slice of
    a (G, E, C, D) buffer placed by ``placements``."""
    local, offsets = local_shard(shape, placements, mesh)
    return offsets[1], local[1], offsets[2], local[2]


def _dispatch_partitioned(xg, r: Routing, e: int, spec_xb):
    """Scatter dispatch on DTensors: each rank builds the slot tables of its
    groups and gathers the token rows of its slice of the buffer."""
    mesh = xg.device_mesh
    g, tg, d = xg.shape
    tok = mesh_placements(mesh, dp=Shard(0), like=xg)
    xb_pl = named(mesh, spec_xb)
    e0, ne, c0, nc = _buffer_slice(mesh, xb_pl, (g, e, r.capacity, d))

    def local(xg_l, idx, pos, keep):
        gl = xg_l.shape[0]
        rl = Routing(idx=idx, gates=None, pos=pos, keep=keep, aux=None, capacity=r.capacity)
        slot_tok, slot_ok = _slot_tables(rl, e, gl, tg, xg_l.device)
        slot_tok, slot_ok = (t[:, e0:e0 + ne, c0:c0 + nc] for t in (slot_tok, slot_ok))
        xb = gather_rows(xg_l.reshape(gl * tg, d), slot_tok.reshape(-1)).reshape(gl, ne, nc, d)
        return xb * slot_ok[..., None].to(xg_l.dtype)

    # the capacity dim may split unevenly (decode's C = 8 over 16 ranks): the shape is given
    return local_call(local, (xg, r.idx, r.pos, r.keep), (tok, tok, tok, tok),
                      (mesh_placements(mesh, dp=Shard(0), model=Partial(), like=xg), tok, tok,
                       tok), xb_pl, (g, e, r.capacity, d))


def _ffn_partitioned(p: Dict, xb, act: Callable):
    """The expert FFN on DTensors: each rank's experts (expert parallelism:
    the buffer split on E over ``model``) or each rank's F-slice of every
    expert (expert-TP: the output a partial sum), the weights gathered over
    the data-parallel axes."""
    mesh = xb.device_mesh
    ep = xb.placements[mesh.mesh_dim_names.index("model")] == Shard(1)
    dt = xb.dtype
    xb_pl = tuple(xb.placements)
    up_model, down_model = (Shard(0), Shard(0)) if ep else (Shard(2), Shard(1))
    up_pl, down_pl = mesh_placements(mesh, model=up_model), mesh_placements(mesh, model=down_model)
    up_grad = mesh_placements(mesh, dp=Partial(), model=up_model, like=xb)
    down_grad = mesh_placements(mesh, dp=Partial(), model=down_model, like=xb)
    xb_grad = xb_pl if ep else mesh_placements(mesh, dp=Shard(0), model=Partial(), like=xb)
    out_pl = xb_grad
    gated = "gate" in p

    def local(xb_l, up, down, *gate):
        h = torch.einsum("gecd,edf->gecf", xb_l, up)
        h = act(torch.einsum("gecd,edf->gecf", xb_l, gate[0])) * h if gated else act(h)
        return torch.einsum("gecf,efd->gecd", h, down)

    weights = (p["up"].to(dt), p["down"].to(dt)) + ((p["gate"].to(dt),) if gated else ())
    pls = (up_pl, down_pl) + ((up_pl,) if gated else ())
    grads = (up_grad, down_grad) + ((up_grad,) if gated else ())
    return local_map(local, out_placements=(out_pl,), in_placements=(xb_pl,) + pls,
                     in_grad_placements=(xb_grad,) + grads,
                     device_mesh=mesh, redistribute_inputs=True)(xb, *weights)


def _combine(yb, r: Routing, e: int, bounds=None):
    """(G, Tg, D): each token the gate-weighted sum of its kept choices'
    outputs, gathered from ``yb`` (G, E, C, D) per (choice, token).  With
    ``bounds`` (first expert, experts, first slot, slots) ``yb`` is that
    slice of the buffer and only the pairs it holds are added."""
    g, _, _, d = yb.shape
    k, c = r.idx.shape[-1], r.capacity
    tg = r.idx.shape[1]
    dt = yb.dtype
    e_flat = r.idx.transpose(1, 2).reshape(g, k * tg)
    g_flat = r.gates.transpose(1, 2).reshape(g, k * tg)
    rows = torch.arange(g, device=yb.device)[:, None]
    if bounds is None:
        slot = (rows * e + torch.where(r.keep, e_flat, 0)) * c + torch.where(r.keep, r.pos, 0)
        hit = r.keep
    else:
        e0, ne, c0, nc = bounds
        hit = (r.keep & (e_flat >= e0) & (e_flat < e0 + ne)
               & (r.pos >= c0) & (r.pos < c0 + nc))
        slot = ((rows * ne + torch.where(hit, e_flat - e0, 0)) * nc
                + torch.where(hit, r.pos - c0, 0))
    got = gather_rows(yb.reshape(-1, d), slot.reshape(-1)).reshape(g, k * tg, d)
    contrib = got * (g_flat * hit).to(dt)[..., None]
    return contrib.reshape(g, k, tg, d).sum(dim=1)


def _combine_partitioned(yb, r: Routing, e: int):
    """``_combine`` on DTensors: each rank adds the pairs its slice of the
    buffer holds, a partial sum over ``model``."""
    mesh = yb.device_mesh
    tok = mesh_placements(mesh, dp=Shard(0), like=yb)
    yb_pl = tuple(yb.placements)
    bounds = _buffer_slice(mesh, yb_pl, tuple(yb.shape))

    def local(yb_l, idx, gates, pos, keep):
        rl = Routing(idx=idx, gates=gates, pos=pos, keep=keep, aux=None, capacity=r.capacity)
        return _combine(yb_l, rl, e, bounds)

    partial = mesh_placements(mesh, dp=Shard(0), model=Partial(), like=yb)
    return local_map(local, out_placements=(partial,), in_placements=(yb_pl, tok, tok, tok, tok),
                     in_grad_placements=(yb_pl, tok, partial, tok, tok), device_mesh=mesh,
                     redistribute_inputs=True)(yb, r.idx, r.gates, r.pos, r.keep)


def experts(p: Dict, xg: torch.Tensor, r: Routing, *, act: Callable = F.silu,
            dispatch: str = "scatter", specs: Optional[Dict] = None) -> torch.Tensor:
    """Dispatch the grouped tokens ``xg`` (G, Tg, D) to their slots, run
    the expert FFN, and combine: (G, Tg, D), each token the gate-weighted
    sum of its kept choices' outputs.  ``specs``: ``moe_ffn``'s sharding
    hints (module docstring)."""
    g, tg, d = xg.shape
    e = p["router"]["w"].shape[1]
    s = p["up"].shape[0] // e
    k, c = r.idx.shape[-1], r.capacity
    dt = xg.dtype
    specs = specs or {}
    if isinstance(xg, DTensor):
        if dispatch != "scatter":
            raise ValueError(f"a partitioned MoE dispatches by 'scatter', not {dispatch!r}")
        xb = _dispatch_partitioned(xg, r, e, specs["xb"])
        return _experts_partitioned(p, xb, r, act=act, specs=specs)
    e_flat = r.idx.transpose(1, 2).reshape(g, k * tg)
    tok_flat = torch.arange(tg, device=xg.device).repeat(k)  # (k·Tg,) within-group token

    if dispatch == "einsum":
        disp = (F.one_hot(e_flat, e).to(dt)[..., None]
                * F.one_hot(torch.where(r.keep, r.pos, c), c + 1).to(dt)[..., None, :c])
        xb = torch.einsum("gtec,gtd->gecd", disp, xg.index_select(1, tok_flat))
    elif dispatch == "scatter":
        # index-scatter into slot tables, then gather the token features through them
        slot_tok, slot_ok = _slot_tables(r, e, g, tg, xg.device)
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
    return _combine(yb, r, e)


def _experts_partitioned(p: Dict, xb, r: Routing, *, act: Callable, specs: Dict):
    """``experts`` after dispatch, on DTensors, with the reference's hints."""
    g, e, c, d = xb.shape
    s = p["up"].shape[0] // e
    xb = constrain(xb, specs["xb"])
    if s > 1:  # virtual expansion; the hint moves the buffer from C- to E-split
        xb = constrain(xb[:, :, None].expand(g, e, s, c, d).reshape(g, e * s, c, d),
                       specs["xbv"])
    yb = constrain(_ffn_partitioned(p, xb, act), specs["xbv"])
    if s > 1:  # back to C-split before the F-slices sum (E·s does not split as E does)
        yb = constrain(yb, specs["xb_on_virtual"])
        yb = constrain(yb.reshape(g, e, s, c, d).sum(dim=2), specs["xb"])
    return _combine_partitioned(yb, r, e)


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
    t, d = x.shape
    e = p["up"].shape[0] // virtual_split
    g = max(1, n_groups)
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} groups")
    if isinstance(x, DTensor) and shard_axes and g % _size(x.device_mesh, shard_axes["dp"]):
        shard_axes = {**shard_axes, "dp": None}  # too few groups to split: whole on each rank
    specs = _specs(shard_axes, virtual_split)
    xg = constrain(x.reshape(g, t // g, d), specs.get("tok"))
    kw = dict(n_experts=e, top_k=top_k, capacity_factor=capacity_factor, renorm=renorm)
    r = (_route_partitioned(p["router"], xg, **kw) if isinstance(xg, DTensor)
         else route(p["router"], xg, **kw))
    out = constrain(experts(p, xg, r, act=act, dispatch=dispatch, specs=specs),
                    specs.get("tok"))
    return out.reshape(t, d), r.aux


def _size(mesh, axes) -> int:
    n = 1
    for a in (axes,) if isinstance(axes, str) else axes or ():
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def _specs(shard_axes: Optional[dict], s: int) -> Dict:
    """The reference's hints from ``shard_axes`` (none without it):
    ``tok`` (G, Tg, D), ``xb`` (G, E, C, D: the expert dim split when it
    divides, s = 1, else the capacity dim), ``xbv`` (G, E·s, C, D) and
    ``xb_on_virtual``, the capacity split of a (G, E·s, C, D) buffer.  The
    reference's ``spec_h`` (G, E·s, C, F), P(dp, expert, None, tp), is the
    placement the expert FFN's ``local_map`` gives its hidden layer."""
    if not shard_axes:
        return {}
    dp, e_ax = shard_axes.get("dp"), shard_axes.get("expert")
    return {"tok": P(dp, None, None),
            "xb": P(dp, e_ax if s == 1 else None, None if s == 1 else e_ax, None),
            "xbv": P(dp, e_ax, None, None), "xb_on_virtual": P(dp, None, e_ax, None)}
