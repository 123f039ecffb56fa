"""mace [arXiv:2206.07697]: 2 layers, 128 channels, l_max=2, correlation 3,
8 radial Bessel functions, E(3)-equivariant (Cartesian irreps)."""
from repro_torch.models.mace import MACEConfig

FAMILY = "gnn"
ARCH_ID = "mace"
MODEL = "mace"


def full_config() -> MACEConfig:
    return MACEConfig(name=ARCH_ID, n_layers=2, channels=128, l_max=2,
                      correlation=3, n_rbf=8)


def smoke_config() -> MACEConfig:
    return MACEConfig(name=ARCH_ID + "-smoke", n_layers=2, channels=16, n_rbf=4,
                      n_species=4)
