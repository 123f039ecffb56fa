"""DLRM's mean-pooled multi-hot embedding lookup (B4 ``embedding_bag``)."""
from repro_torch.kernels.embedding_bag import ops, ref
from repro_torch.kernels.embedding_bag.ops import embedding_bag_fields

__all__ = ["ops", "ref", "embedding_bag_fields"]
