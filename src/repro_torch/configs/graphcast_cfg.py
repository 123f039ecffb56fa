"""graphcast [arXiv:2212.12794]: 16 processor layers, d_hidden=512,
mesh_refinement=6, sum aggregation, 227 variables."""
from repro_torch.models.graphcast import GraphCastConfig

FAMILY = "gnn"
ARCH_ID = "graphcast"
MODEL = "graphcast"


def full_config() -> GraphCastConfig:
    return GraphCastConfig(name=ARCH_ID, n_layers=16, d_hidden=512, n_vars=227,
                           mesh_refinement=6, aggregator="sum")


def smoke_config() -> GraphCastConfig:
    return GraphCastConfig(name=ARCH_ID + "-smoke", n_layers=2, d_hidden=32, n_vars=8)
