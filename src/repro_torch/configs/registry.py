"""Architecture registry: ``--arch <id>`` resolution for the launchers.

The port of ``src/repro/configs/registry.py``'s ``ARCHS`` and ``get_arch``
for all ten architectures; its dry-run cells (``arch_shapes``,
``list_cells``, ``cell_specs``) wait for ROADMAP A16.
"""
from __future__ import annotations

from repro_torch.configs import (
    dbrx_132b, dimenet_cfg, dlrm_rm2, gcn_cora, gemma2_9b, graphcast_cfg, mace_cfg,
    mixtral_8x22b, qwen2_72b, starcoder2_7b,
)

__all__ = ["ARCHS", "get_arch"]

ARCHS = {m.ARCH_ID: m for m in (mixtral_8x22b, dbrx_132b, gemma2_9b, qwen2_72b, starcoder2_7b,
                                gcn_cora, mace_cfg, dimenet_cfg, graphcast_cfg, dlrm_rm2)}


def get_arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
