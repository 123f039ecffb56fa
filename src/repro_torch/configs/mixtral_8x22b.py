"""mixtral-8x22b [arXiv:2401.04088]: 56L d6144 48H (GQA kv=8) ff16384 v32768,
MoE 8 experts top-2, sliding-window attention."""
import torch

from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
ARCH_ID = "mixtral-8x22b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=16384, vocab=32768, window=4096, pattern=("local",),
        n_experts=8, top_k=2, moe_renorm="topk", act="silu", gated=True,
        rope_theta=1e6, dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, vocab=512, window=16, pattern=("local",),
        n_experts=4, top_k=2, act="silu", gated=True, dtype=torch.float32,
        loss_chunk=32, attn_impl="direct",
    )
