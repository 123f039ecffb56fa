"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse fields, embed 64,
bottom MLP 13-512-256-64, top MLP 512-512-256-1, dot interaction."""
from repro_torch.models.dlrm import DLRMConfig

FAMILY = "recsys"
ARCH_ID = "dlrm-rm2"


def full_config() -> DLRMConfig:
    return DLRMConfig(name=ARCH_ID, n_dense=13, n_sparse=26, embed_dim=64,
                      vocab_size=1_000_000, bot_mlp=(13, 512, 256, 64),
                      top_mlp=(512, 512, 256, 1), interaction="dot")


def smoke_config() -> DLRMConfig:
    return DLRMConfig(name=ARCH_ID + "-smoke", vocab_size=500,
                      bot_mlp=(13, 32, 16, 8), embed_dim=8,
                      top_mlp=(32, 16, 1))
