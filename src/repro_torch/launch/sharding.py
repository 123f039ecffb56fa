"""Placement specs of the property-graph structures over an entity mesh.

A spec says, for each axis of an array, which mesh axes that axis is
block-distributed over (``None``: not split); ``REPLICATED`` (the empty
spec) puts the whole array on every device, and ``LEAD`` puts the whole
array on the mesh's lead device only (``EntityMesh.lead``).

The DIP stores shard as the reference shards them: the entity (or slot)
axis over the mesh, the attribute axis whole on every device.  The DI
arrays, ``seg``, ``node_map`` and the typed property columns stay whole on
the lead device, where the reference lets GSPMD shard them when their
length divides P and gathers them for every unsharded op that reads them
(the planner's predicates, the executor's propagation, sampling,
components, communities).  That changes where bytes live, not any answer;
the sharded traversal reads its own per-shard edge blocks
(``traverse.engine._pad_edges``).

The model families' rules (``lm_param_specs`` … ``dlrm_batch_specs``) are
the reference's, for the dry run (``launch/steps.py``) on a production
mesh (``launch/mesh.make_production_mesh``): a spec there is a tuple with
one entry per dimension, None (not split), an axis name, or a tuple of
axis names, written as the reference's ``PartitionSpec`` writes them
(``P``: a group of one axis is that axis, an empty group None), so
``tuple(PartitionSpec(...))`` of the reference equals the port's tuple.
``shard_shape`` gives a leaf's per-device shape under one.  These rules
size what one device holds (``argument_bytes_per_dev``), and on a
``torch.distributed`` ``DeviceMesh`` (``launch/mesh.fake_device_mesh``)
they place tensors: ``tree_named`` turns a tree of arguments into
DTensors.  ``P``, ``named`` (a spec's DTensor placements), ``constrain``
(the reference's ``with_sharding_constraint``) and the other placement
helpers live in ``nn/partition.py``, below the models that use them, and
are re-exported here.

* LM params — Megatron TP over ``model`` (head dim, FFN hidden, vocab),
  FSDP over the data-parallel axes on the non-TP weight dim when asked;
  the stacked group leaves' leading n_groups dim stays unsplit.
* MoE experts — the expert dim over ``model`` when the (virtual) experts
  divide it, else expert-TP on the FFN hidden dim.
* Graphs — entity and edge arrays over the data-parallel axes, wide
  feature dims over ``model``.
* DLRM — table rows over ``model``, the batch over the data-parallel axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.device import holds_data
from repro_torch.launch.mesh import dp_axes
from repro_torch.nn.partition import (P, constrain, contiguous_stride, local_call,  # noqa: F401
                                      local_shard, mesh_placements, named)

__all__ = [
    "P",
    "shard_shape",
    "lm_param_specs",
    "lm_batch_specs",
    "lm_cache_specs",
    "opt_state_specs",
    "gnn_batch_specs",
    "gnn_param_specs",
    "gc_batch_specs",
    "dlrm_param_specs",
    "dlrm_batch_specs",
    "named",
    "tree_named",
    "constrain",
    "local_call",
    "local_shard",
    "mesh_placements",
    "REPLICATED",
    "LEAD",
    "pg_entity_axes",
    "pg_entity_shards",
    "pg_di_specs",
    "pg_arr_specs",
    "pg_word_pad",
    "pg_list_specs",
    "pg_listd_specs",
    "pg_prop_spec",
    "pg_specs",
]

REPLICATED: Tuple = ()  # the whole array on every device of the mesh
LEAD = "lead"  # the whole array on the mesh's lead device only


def pg_entity_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the entity dimension of the DIP stores shards over — the
    paper's block distribution ("each locale only processes the array
    chunk it owns").  The data-parallel axis group when the mesh has a
    ``"data"`` axis, else its sole axis."""
    names = mesh.axis_names
    if "data" in names:
        return dp_axes(mesh)
    return (names[0],)


def pg_entity_shards(mesh) -> int:
    """P — the entity shard count (the paper's locale count)."""
    p = 1
    for a in pg_entity_axes(mesh):
        p *= mesh.shape[a]
    return p


def pg_di_specs(mesh) -> Dict[str, Any]:
    """DI graph placement: every array whole on the lead device (see the
    module docstring; the reference shards ``src``/``dst`` when divisible)."""
    return {"src": LEAD, "dst": LEAD, "seg": LEAD, "node_map": LEAD}


def pg_arr_specs(mesh) -> Dict[str, Any]:
    """DIP-ARR: the (K, N) bitmap split on the ENTITY axis only — the K
    attribute rows stay whole on every device, so any attribute-subset
    query touches only entities the device owns.  The packed (K, W) plane
    takes the same spec on its word axis: each device owns whole words,
    32·W/P entities, so a word-sharded mask is an entity-sharded mask
    (padding in ``pg_word_pad``)."""
    return {"bitmap": (None, pg_entity_axes(mesh))}


def pg_word_pad(mesh, n: int) -> int:
    """Padded WORD count of a packed plane over ``n`` entities: the
    smallest positive multiple of P ≥ ⌈n/32⌉.  Each shard owns
    ``32 · pg_word_pad / P`` entities; pad words, and the tail bits of the
    last real word, are zero, so no query path masks them."""
    from repro_torch.core.bitplane import n_words

    p = pg_entity_shards(mesh)
    return max(-(-n_words(n) // p), 1) * p


def pg_list_specs(mesh) -> Dict[str, Any]:
    """DIP-LIST CSR: ``val``/``slot_entity`` split over the slot axis
    (entity-sorted, so entity-aligned to within one entity's list); ``off``
    replicated (the sharded query never reads it, so it stays on the
    host)."""
    e = (pg_entity_axes(mesh),)
    return {"off": REPLICATED, "val": e, "slot_entity": e}


def pg_listd_specs(mesh) -> Dict[str, Any]:
    """DIP-LISTD: only the inverted-CSR query arrays ship to devices — the
    entity list split over slots, the attribute offsets replicated.  The
    linked-chain arrays stay on the host: the pointer chase is sequential
    and has no sharded execution."""
    return {"a_off": REPLICATED, "a_ent": (pg_entity_axes(mesh),)}


def pg_prop_spec(mesh) -> Any:
    """Typed property columns and their valid masks: whole on the lead
    device (see the module docstring)."""
    return LEAD


def pg_specs(mesh) -> Dict[str, Any]:
    """The whole property-graph spec family keyed by structure name."""
    return {
        "di": pg_di_specs(mesh),
        "arr": pg_arr_specs(mesh),
        "list": pg_list_specs(mesh),
        "listd": pg_listd_specs(mesh),
        "prop": pg_prop_spec(mesh),
    }


# ------------------------------------------------------------ model families
def tree_named(dmesh, spec_tree, args):
    """``args`` (dicts, lists, tuples and dataclasses of tensors) as DTensors on
    ``dmesh`` placed by the aligned ``spec_tree``; other leaves kept.  A
    tensor that holds data gives this rank its slice; an abstract one
    (meta, fake) an empty shard of the local shape on ``dmesh``'s device
    type (inside a ``FakeTensorMode``: a fake one)."""
    if torch.is_tensor(args):
        pl = named(dmesh, spec_tree)
        shape, offsets = local_shard(args.shape, pl, dmesh)
        if holds_data(args):
            local = args[tuple(slice(o, o + n) for o, n in zip(offsets, shape))].contiguous()
        else:
            local = torch.empty(shape, dtype=args.dtype, device=dmesh.device_type)
        return DTensor.from_local(local, dmesh, pl, run_check=False, shape=args.shape,
                                  stride=contiguous_stride(args.shape))
    if isinstance(args, dict):
        return {k: tree_named(dmesh, spec_tree[k], v) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return type(args)(tree_named(dmesh, s, a) for a, s in zip(args, spec_tree))
    if dataclasses.is_dataclass(args) and not isinstance(args, type):
        return dataclasses.replace(args, **{
            f.name: tree_named(dmesh, getattr(spec_tree, f.name), getattr(args, f.name))
            for f in dataclasses.fields(args) if torch.is_tensor(getattr(args, f.name))})
    return args


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(d is None or isinstance(d, (str, tuple)) for d in x)


def shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The per-device shape of a ``shape`` leaf under ``spec`` on
    ``mesh``: each dim divided by the product of its axes' sizes, rounded
    up (GSPMD pads a dim that does not divide)."""
    out = []
    for i, n in enumerate(shape):
        d = spec[i] if spec is not None and i < len(spec) else None
        axes = () if d is None else (d,) if isinstance(d, str) else d
        out.append(-(-int(n) // math.prod(mesh.shape[a] for a in axes)))
    return tuple(out)


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def lm_param_specs(cfg, mesh, *, fsdp: bool = False) -> Dict:
    """Spec tree of ``models/transformer.init_params``' tree."""
    fa = dp_axes(mesh) if fsdp else None  # the FSDP axis group of the non-TP dim

    def layer_specs() -> Dict:
        s = {"ln1": {"scale": P(None, None)},
             "wq": {"w": P(None, fa, "model")},
             "wk": {"w": P(None, fa, "model")},
             "wv": {"w": P(None, fa, "model")},
             "wo": {"w": P(None, "model", fa)},
             "ln2": {"scale": P(None, None)}}
        if cfg.qkv_bias:
            for k in ("wq", "wk", "wv"):
                s[k]["b"] = P(None, "model")
        if cfg.post_norms:
            s["ln1b"] = {"scale": P(None, None)}
            s["ln2b"] = {"scale": P(None, None)}
        if cfg.n_experts:
            n_virtual = cfg.n_experts * cfg.moe_virtual_split
            if n_virtual % mesh.shape["model"] == 0:  # expert parallelism over (virtual) experts
                up, down = P(None, "model", fa, None), P(None, "model", None, fa)
            else:  # expert-TP on the hidden dim
                up, down = P(None, None, fa, "model"), P(None, None, "model", fa)
            s["moe"] = {"router": {"w": P(None, fa, None)}, "up": up, "down": down}
            if cfg.gated:
                s["moe"]["gate"] = up
        else:
            s["mlp"] = {"up": {"w": P(None, fa, "model")}, "down": {"w": P(None, "model", fa)}}
            if cfg.gated:
                s["mlp"]["gate"] = {"w": P(None, fa, "model")}
        return s

    specs = {"embed": P("model", fa), "groups": [layer_specs() for _ in cfg.pattern],
             "final_norm": {"scale": P(None)}}
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": P(fa, "model")}
    return specs


def lm_batch_specs(mesh) -> Dict:
    dp = dp_axes(mesh)
    return {"tokens": P(dp, None), "labels": P(dp, None)}


def lm_cache_specs(cfg, mesh, batch: int, max_len: int) -> Dict:
    """Cache (G, B, S, Hkv, Dh): the batch over the data-parallel axes when
    it divides (else the sequence takes them), KV heads over ``model`` when
    they divide it, else the sequence takes ``model`` too.  The layer and
    the written sequence slot keep unsplit dims; ``cur`` is replicated."""
    dp = dp_axes(mesh)
    heads_div = cfg.n_kv_heads % mesh.shape["model"] == 0
    if batch % _dp_size(mesh) == 0:
        b_ax, s_axes = dp, ()
    else:
        b_ax, s_axes = None, dp  # B = 1 long context: the sequence takes dp
    if not heads_div:
        s_axes = tuple(s_axes) + ("model",)
    kv = P(None, b_ax, tuple(s_axes) or None, "model" if heads_div else None, None)
    specs: Dict[str, Any] = {f"pos{i}": {"k": kv, "v": kv} for i in range(len(cfg.pattern))}
    specs["cur"] = P()
    return specs


def opt_state_specs(param_specs) -> Dict:
    """AdamW's state mirrors the params' specs; the count is replicated."""
    return {"m": param_specs, "v": param_specs, "count": P()}


def gnn_batch_specs(mesh, batch) -> Any:
    """GraphBatch-shaped tree of specs: entity and edge arrays split over
    the data-parallel axes on their leading dim when it divides, wide (≥ 64)
    feature dims over ``model`` when it divides them."""
    dp, n_dp = dp_axes(mesh), _dp_size(mesh)
    fields = {}
    for f in dataclasses.fields(batch):
        if f.name in ("n_nodes", "n_edges", "n_graphs"):
            continue
        leaf = getattr(batch, f.name)
        if leaf is None:
            fields[f.name] = None
            continue
        fields[f.name] = _lead_and_wide(leaf.shape, dp, n_dp, mesh)
    return dataclasses.replace(batch, **fields)


def _lead_and_wide(shape, dp, n_dp: int, mesh) -> Tuple:
    lead = dp if len(shape) >= 1 and shape[0] % n_dp == 0 else None
    rest = [None] * (len(shape) - 1)
    if len(shape) == 2 and shape[1] >= 64 and shape[1] % mesh.shape["model"] == 0:
        rest[0] = "model"
    return P(lead, *rest)


def gnn_param_specs(params, mesh, *, tp_threshold: int = 256) -> Any:
    """The last dim of wide (≥ ``tp_threshold``) weights of two or more
    dims over ``model``; the rest replicated.  ``params``: a tree of
    tensors (or shapes' abstract tensors)."""
    def rule(tree):
        if isinstance(tree, dict):
            return {k: rule(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rule(v) for v in tree]
        shape = tree.shape
        if len(shape) >= 2 and shape[-1] >= tp_threshold:
            return P(*([None] * (len(shape) - 1)), "model")
        return P(*([None] * len(shape)))

    return rule(params)


def gc_batch_specs(mesh, batch) -> Any:
    """GCBatch-shaped tree of specs, by ``gnn_batch_specs``' rule."""
    dp, n_dp = dp_axes(mesh), _dp_size(mesh)
    fields = {f.name: _lead_and_wide(getattr(batch, f.name).shape, dp, n_dp, mesh)
              for f in dataclasses.fields(batch) if not f.name.startswith("n_")}
    return dataclasses.replace(batch, **fields)


def dlrm_param_specs(mesh) -> Dict:
    return {"tables": P(None, "model", None),  # each table's rows over model
            "bot": [{"w": P(None, None), "b": P(None)} for _ in range(3)],
            "top": [{"w": P(None, None), "b": P(None)} for _ in range(3)]}


def dlrm_batch_specs(mesh) -> Dict:
    dp = dp_axes(mesh)
    return {"dense": P(dp, None), "sparse": P(dp, None, None), "labels": P(dp)}
