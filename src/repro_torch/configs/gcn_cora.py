"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden=16, mean/sym aggregation."""
from repro_torch.models.gcn import GCNConfig

FAMILY = "gnn"
ARCH_ID = "gcn-cora"
MODEL = "gcn"


def full_config(d_feat: int = 1433, n_classes: int = 7) -> GCNConfig:
    return GCNConfig(name=ARCH_ID, n_layers=2, d_in=d_feat, d_hidden=16,
                     n_classes=n_classes, norm="sym", aggregator="mean")


def smoke_config() -> GCNConfig:
    return GCNConfig(name=ARCH_ID + "-smoke", n_layers=2, d_in=32, d_hidden=8,
                     n_classes=4)
