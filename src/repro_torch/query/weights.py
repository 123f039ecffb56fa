"""Weight-property extraction — the query layer's numeric-column front door
for the weighted analytics.

A pattern predicate (``{bytes > 0}``) consumes a typed edge column as a
Boolean mask; the tropical and counting semirings consume the COLUMN
ITSELF as the per-edge ⊗ operand.  ``edge_weight_values`` is that read
path: one typed edge-property column as (f32 values, validity mask).  An
edge without the property is NOT traversable under a weighted semiring —
there is no sound default weight — so callers AND the validity mask into
their edge filter.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["edge_weight_values"]


def edge_weight_values(pg, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (m,) f32, valid (m,) bool) for edge property ``name``.

    A column shorter than the edge universe pads with (0, False): the
    overlay's delta edges postdate the column, and hold no value until
    ``update_edge_properties`` sets one."""
    g = pg._require_graph()
    if name not in pg.edge_props:
        raise KeyError(f"unknown edge property {name!r}; known: {sorted(pg.edge_props)}")
    col, valid = pg.edge_props[name]
    if int(col.shape[0]) < g.m:
        pad = g.m - int(col.shape[0])
        col = torch.cat([col, col.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return col.to(torch.float32), valid
