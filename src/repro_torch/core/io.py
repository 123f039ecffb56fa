"""Property-graph persistence — save/load a fully-attributed PropGraph.

A property graph ingested once (the expensive sort/remap path, §V) is
reloaded in seconds by later sessions — the interactive-workflow pattern
the paper targets (§VI).

On disk: a directory holding ``graph.npz`` (the DI arrays, both attribute
stores' raw pairs — backend-independent, so a load may pick a DIFFERENT
backend — and the typed property columns with their valid masks) and
``manifest.json`` (format version, sizes, backend, attribute values,
column names).  The format is the reference package's: each package loads
what the other saves.  Columns are written in the 32-bit types the
reference holds them in.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dip_shard
from repro_torch.core.attr_map import AttributeMap
from repro_torch.core.di import DIGraph
from repro_torch.core.property_graph import PropGraph, _AttrStore

__all__ = ["save_propgraph", "load_propgraph"]

_FORMAT_VERSION = 1


def _store_pairs(store: _AttrStore, what: str):
    """(entities, attribute ids, attribute values) of a store's raw pairs."""
    if store.plane_only:
        raise ValueError(
            f"the {what} store holds only a plane (from_arrays) and no raw "
            "(entity, attribute) pairs, so it cannot be saved")
    ent, att = store.pairs()
    return ent, att, store.amap.values


def save_propgraph(path: str, pg: PropGraph) -> str:
    """Atomic save (unique tmp dir + swap).  Overwrites an existing graph at
    ``path``: the new directory is renamed in only after it is complete,
    and the old one is moved aside first (``os.rename`` onto a non-empty
    directory raises).  A reader never sees a half-written graph at
    ``path``; a crash mid-swap can at worst leave the previous version
    parked in a ``<name>.old.*`` sibling, never a torn one.

    A graph with a live overlay (delta edges, delta attribute pairs,
    tombstones) is flattened first — compact-on-save on a private fork, so
    the caller's overlay is untouched — because the format stores only
    base state; ``load_propgraph`` then round-trips bitwise."""
    if pg.has_overlay():
        pg = pg.fork()
        pg.compact()
    g = pg._require_graph()
    ve, va, vvals = _store_pairs(pg._vstore, "vertex")
    ee, ea, evals = _store_pairs(pg._estore, "edge")
    path = path.rstrip(os.sep)
    parent = os.path.dirname(os.path.abspath(path)) or os.sep
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp.", dir=parent)
    try:
        arrays = {
            "src": g.src.cpu().numpy(), "dst": g.dst.cpu().numpy(),
            "seg": g.seg.cpu().numpy(), "node_map": g.node_map.cpu().numpy(),
            "v_ent": ve, "v_attr": va, "e_ent": ee, "e_attr": ea,
        }
        for kind, pre in (("node", "v"), ("edge", "e")):
            for name, (col, valid) in pg.host_columns(kind).items():
                arrays[f"{pre}p_{name}"] = col
                arrays[f"{pre}pm_{name}"] = valid
        np.savez_compressed(os.path.join(tmp, "graph.npz"), **arrays)
        manifest = {
            "version": _FORMAT_VERSION, "n": g.n, "m": g.m,
            "backend": pg.backend,
            "vertex_labels": vvals, "edge_relationships": evals,
            "vertex_props": list(pg.vertex_props),
            "edge_props": list(pg.edge_props),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.lexists(path):
            # replace-or-swap: move the old graph aside (same filesystem, so
            # both renames are atomic), expose the new one, then reclaim
            old = tempfile.mkdtemp(prefix=os.path.basename(path) + ".old.", dir=parent)
            old_g = os.path.join(old, "g")
            os.rename(path, old_g)
            try:
                os.rename(tmp, path)
            except BaseException:
                os.rename(old_g, path)  # roll the previous version back in
                shutil.rmtree(old, ignore_errors=True)
                raise
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def load_propgraph(path: str, *, backend: Optional[str] = None, mesh=None,
                   device=None) -> PropGraph:
    """Load onto ``device`` (None: the CUDA card, raising if there is
    none); ``backend`` may differ from the saved one — the stores are
    rebuilt from the raw pairs when they seal (the bulk build is the cheap
    step, §VII-B).  Index arrays and ``node_map`` of either width load as
    int32, the reference's type; 64-bit columns narrow as ingest narrows
    them.  ``mesh`` (an ``EntityMesh``) loads the graph straight onto the
    mesh: the stores seal as padded shards, the DI arrays and columns go to
    its lead device (``device`` must then be None or that device).  A save
    of either package reopens on a mesh; the format has no mesh in it."""
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    if man["version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported propgraph format v{man['version']}")
    pg = PropGraph(backend=backend or man["backend"], mesh=mesh, device=device)
    with np.load(os.path.join(path, "graph.npz")) as z:
        data = {k: z[k] for k in z.files}

    def t(name):
        return torch.from_numpy(data[name].astype(np.int32, copy=False)).to(pg.device)

    seg = data["seg"]
    g = DIGraph(src=t("src"), dst=t("dst"), seg=t("seg"), node_map=t("node_map"),
                n=int(man["n"]), m=int(man["m"]),
                max_deg=int(np.max(seg[1:] - seg[:-1], initial=0)))
    pg._set_graph(g if mesh is None else dip_shard.place_graph(g, mesh))
    g = pg.graph
    for attr, size, key, pre in (("_vstore", g.n, "vertex_labels", "v"),
                                 ("_estore", max(g.m, 1), "edge_relationships", "e")):
        store = _AttrStore(pg.backend, size, pg.device, mesh=mesh)
        store.amap = AttributeMap(man[key])
        if len(data[f"{pre}_ent"]):
            store._pairs_e.append(data[f"{pre}_ent"].astype(np.int32, copy=False))
            store._pairs_a.append(data[f"{pre}_attr"].astype(np.int32, copy=False))
        setattr(pg, attr, store)
    for kind, key, pre in (("node", "vertex_props", "v"), ("edge", "edge_props", "e")):
        for name in man[key]:
            pg._set_column(kind, name, data[f"{pre}p_{name}"], data[f"{pre}pm_{name}"])
    return pg
