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

The LM, GNN, GC and DLRM specs wait for the training port.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

__all__ = [
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
    from repro_torch.launch.mesh import dp_axes

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
