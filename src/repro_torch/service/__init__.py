"""repro_torch.service — concurrent graph analytics service + network front-end.

The serving layer over the property-graph stack (docs/ARCHITECTURE.md
§8–§9): a ``GraphRegistry`` of named, versioned ``PropGraph``s, a
micro-batching scheduler (adaptive window) that coalesces concurrent
pattern queries into single B1 launches and their samples into single B3
launches, a two-tier plan/result cache keyed to survive exactly as long
as correctness allows, and the ``pgd`` wire layer — ``PGServer``/``PGClient`` over a
length-prefixed JSON+binary codec (``wire.py``) — so multiple OS
processes share one registry, one device and one scheduler, the paper §III
deployment shape.  ``repro_torch.launch.pgserve`` is the CLI driver
(``--net`` for the network path).

    from repro_torch.service import Service
    with Service() as svc:
        svc.add_graph("social", pg)
        res = svc.query("social", "(a:person)-[:follows]->(b:person)")
        futs = [svc.submit("social", p) for p in patterns]  # concurrent
"""
from repro_torch.service.cache import LRUCache
from repro_torch.service.client import PGClient
from repro_torch.service.registry import GraphRegistry
from repro_torch.service.scheduler import MicroBatcher, execute_coalesced
from repro_torch.service.server import PGServer
from repro_torch.service.service import Service, ServiceConfig

__all__ = [
    "Service",
    "ServiceConfig",
    "GraphRegistry",
    "LRUCache",
    "MicroBatcher",
    "execute_coalesced",
    "PGServer",
    "PGClient",
]
