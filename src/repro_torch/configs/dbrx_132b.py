"""dbrx-132b [hf:databricks/dbrx-base]: 40L d6144 48H (GQA kv=8) ff10752
v100352, MoE 16 experts top-4 (fine-grained); full attention."""
import torch

from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
ARCH_ID = "dbrx-132b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=10752, vocab=100352, pattern=("global",),
        n_experts=16, top_k=4, moe_renorm="full", act="silu", gated=True,
        rope_theta=5e5, dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=96, vocab=512, pattern=("global",),
        n_experts=4, top_k=2, moe_renorm="full", dtype=torch.float32,
        loss_chunk=32, attn_impl="direct",
    )
