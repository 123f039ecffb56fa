"""Step functions of the dry run's cells, per (family, kind).

The port of ``src/repro/launch/steps.py``.  ``build_cell(arch, shape,
mesh)`` returns ``(kind, step_fn, abstract_args, in_specs, out_specs,
cfg)``: the step one (arch × shape) cell runs, its arguments as abstract
tensors (``configs/common.sds``: meta tensors, nothing allocated) built
from the models' shape tables, and spec trees aligned with them
(``launch/sharding.py``).  ``None`` for a skipped cell.

The mesh (``launch/mesh.make_production_mesh``) decides the configuration
as in the reference: FSDP for training or above 8e9 bytes a chip in bf16
(it only changes the specs), ``seq_shard_axis`` and ``batch_shard_axes``
for training and prefill, and for the MoE LMs the dispatch groups (one per
data-parallel shard), ``moe_virtual_split`` (when the experts do not divide
the model axis but divide into it, as Mixtral's 8 into 16: each expert
becomes F-slices, which changes the parameter shapes, the capacity and the
expert FLOPs) and the expert or TP axis.  A step runs whole on one device
on plain tensors; on DTensors placed by the specs (``sharding.tree_named``)
every step runs as one rank's program (``run_partitioned``): the LM
configs' sharding fields their hints (``models/transformer.py``,
``nn/moe.py``), GraphCast's ``dp_axes``/``tp_axis`` its ``_constrain``
hints, the GNNs' gathers and scatters through ``graph/segment_ops.py``'s
sharded forms, DLRM's lookup on each rank's row window (``models/dlrm.py``).

Training steps take the gradient by autograd and run the full AdamW update
(``optim/adamw.apply_updates``, donated as the port's trainer donates it),
so a step holds the master weights, both moments and the gradients.
Serving steps run under ``torch.no_grad`` with every float leaf of the
params in bf16, as the reference serves.  Params and moments are f32, the
reference's; the LM casts them to its activations' dtype at each use.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from repro_torch.configs.common import sds
from repro_torch.launch import sharding as rules
from repro_torch.launch.mesh import dp_axes
from repro_torch.launch.sharding import P
from repro_torch.optim import AdamWConfig, apply_updates
from repro_torch.optim.tree import flatten, unflatten

__all__ = ["build_cell", "map_tensors", "leaf_specs", "argument_bytes_per_dev",
           "run_partitioned"]


def map_tensors(fn: Callable, tree):
    """``tree`` (dicts, lists, tuples, dataclasses) with each tensor leaf
    replaced by ``fn(leaf)``; other leaves kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: map_tensors(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)
                                            if f.init})
    return tree


def leaf_specs(args, specs) -> Iterator[Tuple[torch.Tensor, Any]]:
    """(tensor, its spec) for each tensor leaf of ``args``, with ``specs``
    the spec tree aligned with it."""
    if torch.is_tensor(args):
        yield args, specs
    elif isinstance(args, dict):
        for k, v in args.items():
            yield from leaf_specs(v, specs[k])
    elif isinstance(args, (list, tuple)):
        for a, s in zip(args, specs):
            yield from leaf_specs(a, s)
    elif dataclasses.is_dataclass(args) and not isinstance(args, type):
        for f in dataclasses.fields(args):
            yield from leaf_specs(getattr(args, f.name), getattr(specs, f.name))


def argument_bytes_per_dev(args, specs, mesh) -> int:
    """The bytes of ``args`` one device of ``mesh`` holds under ``specs``
    (``sharding.shard_shape``: a dim that does not divide is padded)."""
    return sum(math.prod(rules.shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in leaf_specs(args, specs))


def run_partitioned(step_fn, dargs):
    """``step_fn`` on DTensor arguments: one rank's program.  A plain
    tensor the step makes (positions, masks, constants) is the same on
    every rank and is taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        return step_fn(*dargs)


def _abstract(shapes, dtype: torch.dtype):
    """A tree of shapes (tuples of ints under dicts and lists) → abstract tensors."""
    if isinstance(shapes, dict):
        return {k: _abstract(v, dtype) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_abstract(v, dtype) for v in shapes]
    return sds(shapes, dtype)


def _cast_float(tree, dtype: torch.dtype):
    """Every float leaf of an abstract tree in ``dtype`` (serving's bf16 weights)."""
    return map_tensors(lambda t: sds(t.shape, dtype) if t.is_floating_point() else t, tree)


def _adamw_state(params) -> Dict:
    """AdamW's state of ``params``, abstract: f32 moments and an int32 count."""
    m = map_tensors(lambda t: sds(t.shape, torch.float32), params)
    return {"m": m, "v": map_tensors(lambda t: sds(t.shape, torch.float32), params),
            "count": sds((), torch.int32)}


def _value_and_grad(loss: Callable, params):
    """(loss(params), the gradient tree) by autograd; a leaf the loss does
    not reach gets zeros, as the reference's gradient gives it."""
    from torch.distributed.tensor import DTensor, Replicate

    flat, spec = flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    value = loss(unflatten(spec, leaves))
    if isinstance(value, DTensor):  # one value on every rank: the gradient's seed
        value = value.redistribute(value.device_mesh, [Replicate()] * value.device_mesh.ndim)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return value.detach(), unflatten(spec, [torch.zeros_like(p) if g is None else g
                                            for p, g in zip(leaves, grads)])


def _train_step(loss: Callable, opt_cfg: AdamWConfig):
    def train_step(params, opt_state, batch):
        value, grads = _value_and_grad(lambda p: loss(p, batch), params)
        params, opt_state, metrics = apply_updates(params, grads, opt_state, opt_cfg,
                                                   donate=True)
        return params, opt_state, {"loss": value, **metrics}

    return train_step


# --------------------------------------------------------------------- LM
def _lm_cell(arch_mod, cfg, kind: str, specs, mesh):
    from repro_torch.models import transformer as T

    # Training always FSDPs; serving keeps weights TP-sharded and DP-replicated
    # when they fit (> 8e9 bytes a chip at TP-16 in bf16 also shards over dp)
    serve_bytes_per_chip = cfg.n_params * 2 / mesh.shape["model"]
    fsdp = kind == "train" or serve_bytes_per_chip > 8e9
    if kind in ("train", "prefill"):
        cfg = dataclasses.replace(cfg, seq_shard_axis="model",
                                  batch_shard_axes=tuple(dp_axes(mesh)))
    if cfg.n_experts:
        # grouped dispatch, one group per dp shard; experts split into F-slice
        # virtual experts when E < |model| divides it (pure expert parallelism)
        dp = dp_axes(mesh)
        n_dp = math.prod(mesh.shape[a] for a in dp)
        m = mesh.shape["model"]
        split = 1
        if (cfg.n_experts % m != 0 and m % cfg.n_experts == 0
                and cfg.d_ff % (m // cfg.n_experts) == 0):
            split = m // cfg.n_experts
        e_div = (cfg.n_experts * split) % m == 0
        # decode routes its B tokens; the groups must divide them
        groups = math.gcd(n_dp, specs["tokens"].shape[0]) if kind == "decode" else n_dp
        cfg = dataclasses.replace(
            cfg, moe_groups=groups, moe_dp_axes=tuple(dp), moe_virtual_split=split,
            moe_expert_axis="model" if e_div else None,
            moe_tp_axis=None if e_div else "model")
    p_specs = rules.lm_param_specs(cfg, mesh, fsdp=fsdp)
    params = _abstract(T._shapes(cfg), torch.float32)

    if kind == "train":
        step = _train_step(lambda p, b: T.loss_fn(p, b["tokens"], b["labels"], cfg),
                           AdamWConfig())
        o_specs = rules.opt_state_specs(p_specs)
        return (step, (params, _adamw_state(params), specs),
                (p_specs, o_specs, rules.lm_batch_specs(mesh)), (p_specs, o_specs, None), cfg)

    params_bf16 = _cast_float(params, torch.bfloat16)
    if kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                return T.prefill(params, batch["tokens"], cfg)

        return (prefill_step, (params_bf16, specs),
                (p_specs, {"tokens": P(dp_axes(mesh), None)}), None, cfg)

    b = specs["tokens"].shape[0]
    cache = specs["cache"]
    max_len = max(c["k"].shape[2] for k, c in cache.items() if k != "cur")
    c_specs = rules.lm_cache_specs(cfg, mesh, b, max_len)

    def serve_step(params, cache, tokens):
        with torch.no_grad():
            return T.decode_step(params, cache, tokens, cfg)

    return (serve_step, (params_bf16, cache, specs["tokens"]),
            (p_specs, c_specs, P(dp_axes(mesh) if b >= 16 else None, None)), (None, c_specs), cfg)


# -------------------------------------------------------------------- GNN
def _gnn_cell(arch_mod, cfg, kind: str, specs, mesh):
    from repro_torch.models import dimenet, gcn, graphcast, mace
    from repro_torch.models.gnn_common import mlp_shapes

    model_name = arch_mod.MODEL
    if model_name == "graphcast":
        M = graphcast
        cfg = dataclasses.replace(cfg, dp_axes=tuple(dp_axes(mesh)), tp_axis="model")
        b_specs = rules.gc_batch_specs(mesh, specs)
    else:
        M = {"gcn": gcn, "mace": mace, "dimenet": dimenet}[model_name]
        b_specs = rules.gnn_batch_specs(mesh, specs)
    shapes = {"layers": mlp_shapes(gcn._dims(cfg))} if M is gcn else M._shapes(cfg)
    params = _abstract(shapes, torch.float32)
    p_specs = rules.gnn_param_specs(params, mesh)
    o_specs = {"m": p_specs, "v": p_specs, "count": P()}
    step = _train_step(lambda p, b: M.loss_fn(p, b, cfg), AdamWConfig(lr=1e-3))
    return (step, (params, _adamw_state(params), specs), (p_specs, o_specs, b_specs),
            (p_specs, o_specs, None), cfg)


# ------------------------------------------------------------------- DLRM
def _recsys_cell(arch_mod, cfg, kind: str, specs, mesh):
    from repro_torch.models import dlrm as M
    from repro_torch.models.gnn_common import mlp_shapes

    params = _abstract({"tables": (cfg.n_sparse, cfg.vocab_size, cfg.embed_dim),
                        "bot": mlp_shapes(cfg.bot_mlp), "top": mlp_shapes(M._top_dims(cfg))},
                       torch.float32)
    p_specs = rules.dlrm_param_specs(mesh)
    dp = dp_axes(mesh)

    if kind == "train":
        step = _train_step(lambda p, b: M.loss_fn(p, b["dense"], b["sparse"], b["labels"], cfg),
                           AdamWConfig(lr=1e-3))
        o_specs = rules.opt_state_specs(p_specs)
        return (step, (params, _adamw_state(params), specs),
                (p_specs, o_specs, rules.dlrm_batch_specs(mesh)), (p_specs, o_specs, None), cfg)

    params_bf16 = _cast_float(params, torch.bfloat16)
    if kind == "retrieval":
        def retrieval_step(params, batch):
            with torch.no_grad():
                return M.retrieval_scores(params, batch["dense"], batch["sparse"],
                                          batch["candidates"], cfg)

        b_specs = {"dense": P(None, None), "sparse": P(None, None, None),
                   "candidates": P(dp + ("model",), None)}
        return retrieval_step, (params_bf16, specs), (p_specs, b_specs), None, cfg

    def serve_step(params, batch):
        with torch.no_grad():
            return M.forward(params, batch["dense"], batch["sparse"], cfg)

    b_specs = {"dense": P(dp, None), "sparse": P(dp, None, None)}
    return serve_step, (params_bf16, specs), (p_specs, b_specs), P(dp), cfg


def build_cell(arch_id: str, shape_name: str, mesh, *, cfg=None, specs=None):
    """One dry-run cell: None when skipped, else (kind, step_fn,
    abstract_args, in_specs, out_specs, cfg), ``cfg`` the configuration
    the step runs (the mesh's changes made).  ``cfg`` and ``specs`` given
    replace the registry's: a reduced configuration (a cut of depth, of
    batch), on inputs of the shapes ``specs`` holds."""
    from repro_torch.configs.registry import cell_specs, get_arch

    kind, reg_specs, reg_cfg = cell_specs(arch_id, shape_name)
    if kind is None:
        return None
    mod = get_arch(arch_id)
    builder = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell}[mod.FAMILY]
    step_fn, args, in_specs, out_specs, cfg = builder(
        mod, cfg or reg_cfg, kind, reg_specs if specs is None else specs, mesh)
    return kind, step_fn, args, in_specs, out_specs, cfg
