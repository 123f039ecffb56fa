"""dimenet [arXiv:2003.03123]: 6 blocks, d_hidden=128, 8 bilinear units,
7 spherical × 6 radial basis functions."""
from repro_torch.models.dimenet import DimeNetConfig

FAMILY = "gnn"
ARCH_ID = "dimenet"
MODEL = "dimenet"


def full_config() -> DimeNetConfig:
    return DimeNetConfig(name=ARCH_ID, n_blocks=6, d_hidden=128, n_bilinear=8,
                         n_spherical=7, n_radial=6)


def smoke_config() -> DimeNetConfig:
    return DimeNetConfig(name=ARCH_ID + "-smoke", n_blocks=2, d_hidden=16,
                         n_bilinear=4, n_spherical=3, n_radial=3, n_species=4)
