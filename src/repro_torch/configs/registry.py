"""Architecture registry: ``--arch <id>`` resolution for the launchers.

The port of ``src/repro/configs/registry.py``'s ``ARCHS`` and ``get_arch``
for the five ported architectures.  The reference's other five ids raise a
``KeyError`` naming the ROADMAP item that ports them; its dry-run cells
(``arch_shapes``, ``list_cells``, ``cell_specs``) wait for A16.
"""
from __future__ import annotations

from repro_torch.configs import dlrm_rm2, gcn_cora, gemma2_9b, qwen2_72b, starcoder2_7b

__all__ = ["ARCHS", "PENDING", "get_arch"]

ARCHS = {m.ARCH_ID: m for m in (gemma2_9b, qwen2_72b, starcoder2_7b, gcn_cora, dlrm_rm2)}

# the reference's other ids -> the ROADMAP item that ports them
PENDING = {"mixtral-8x22b": "A13b", "dbrx-132b": "A13b", "mace": "A14", "dimenet": "A14",
           "graphcast": "A14"}


def get_arch(arch_id: str):
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in PENDING:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ROADMAP {PENDING[arch_id]}); "
                       f"ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
