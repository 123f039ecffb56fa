"""Blockwise online-softmax attention with GQA, causal and sliding-window
masks and Gemma-2's softcap (B6 ``flash_attention``)."""
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["ops", "ref", "flash_attention"]
