"""repro_torch.core — the paper's contribution: DI + DIP property-graph structures."""
from repro_torch.core.attr_map import AttributeMap
from repro_torch.core.di import (
    DIGraph,
    build_di,
    build_reverse_di,
    degrees,
    edge_lookup,
    max_degree,
    neighbors_padded,
)
from repro_torch.core.dip_arr import DIPArr, build_dip_arr
from repro_torch.core.dip_list import DIPList, build_dip_list
from repro_torch.core.dip_listd import DIPListD, build_dip_listd
from repro_torch.core.property_graph import PropGraph
from repro_torch.core.queries import (
    connected_entities,
    extract_subgraph,
    filtered_bfs,
    induce_edge_mask,
)

__all__ = [
    "AttributeMap",
    "DIGraph",
    "build_di",
    "build_reverse_di",
    "degrees",
    "edge_lookup",
    "max_degree",
    "neighbors_padded",
    "DIPArr",
    "build_dip_arr",
    "DIPList",
    "build_dip_list",
    "DIPListD",
    "build_dip_listd",
    "PropGraph",
    "connected_entities",
    "extract_subgraph",
    "filtered_bfs",
    "induce_edge_mask",
]
