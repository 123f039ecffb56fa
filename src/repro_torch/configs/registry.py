"""Architecture registry: ``--arch <id>`` resolution for the launchers.

The port of ``src/repro/configs/registry.py``: ``ARCHS`` and ``get_arch``
for all ten architectures, and the 40 (arch × shape) dry-run cells
(``arch_shapes``, ``list_cells``, ``cell_specs``) with the documented
long_500k skips (``SKIPPED_CELLS``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.configs import common
from repro_torch.configs import (
    dbrx_132b, dimenet_cfg, dlrm_rm2, gcn_cora, gemma2_9b, graphcast_cfg, mace_cfg,
    mixtral_8x22b, qwen2_72b, starcoder2_7b,
)

__all__ = ["ARCHS", "get_arch", "arch_shapes", "list_cells", "cell_specs", "SKIPPED_CELLS"]

ARCHS = {m.ARCH_ID: m for m in (mixtral_8x22b, dbrx_132b, gemma2_9b, qwen2_72b, starcoder2_7b,
                                gcn_cora, mace_cfg, dimenet_cfg, graphcast_cfg, dlrm_rm2)}

# long_500k runs only for archs with a sub-quadratic mechanism (a sliding window);
# pure full-attention archs skip it
SKIPPED_CELLS = {
    ("dbrx-132b", "long_500k"): "pure full-attention (no SWA) — long_500k skipped",
    ("qwen2-72b", "long_500k"): "pure full-attention (no SWA) — long_500k skipped",
    ("starcoder2-7b", "long_500k"): "pure full-attention (no SWA) — long_500k skipped",
}


def get_arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def arch_shapes(arch_id: str) -> List[str]:
    fam = get_arch(arch_id).FAMILY
    table = {"lm": common.LM_SHAPES, "gnn": common.GNN_SHAPES,
             "recsys": common.RECSYS_SHAPES}[fam]
    return list(table)


def list_cells() -> List[Tuple[str, str, Optional[str]]]:
    """All 40 (arch, shape, skip reason or None) cells."""
    return [(a, s, SKIPPED_CELLS.get((a, s))) for a in ARCHS for s in arch_shapes(a)]


def cell_specs(arch_id: str, shape_name: str):
    """(kind, specs, cfg) of one dry-run cell; specs are trees of abstract
    tensors (``common.sds``); kind and specs are None for a skipped cell."""
    mod = get_arch(arch_id)
    fam = mod.FAMILY
    if fam == "lm":
        cfg = mod.full_config()
        kind, specs = common.lm_input_specs(cfg, shape_name)
        return kind, specs, cfg
    if fam == "gnn":
        if mod.MODEL == "graphcast":
            cfg = mod.full_config()
            return "train", common.gc_specs(shape_name, n_vars=cfg.n_vars,
                                            d_edge=cfg.d_edge), cfg
        if mod.MODEL == "gcn":
            d_feat = common.GNN_SHAPES[shape_name].get("d_feat") or 128
            n_classes = {"full_graph_sm": 7, "ogb_products": 47}.get(shape_name, 16)
            cfg = mod.full_config(d_feat=d_feat, n_classes=n_classes)
        else:
            cfg = mod.full_config()
        return "train", common.gnn_graph_specs(shape_name, model=mod.MODEL), cfg
    if fam == "recsys":
        cfg = mod.full_config()
        kind, specs = common.recsys_input_specs(cfg, shape_name)
        return kind, specs, cfg
    raise ValueError(fam)
