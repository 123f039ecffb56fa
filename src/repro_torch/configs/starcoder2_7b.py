"""starcoder2-7b [arXiv:2402.19173]: 32L d4608 36H (GQA kv=4) ff18432 v49152;
GQA + RoPE, non-gated GELU FFN, full attention."""
import torch

from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
ARCH_ID = "starcoder2-7b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_head=128,
        d_ff=18432, vocab=49152, pattern=("global",), act="gelu", gated=False,
        rope_theta=1e5, dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, vocab=512, pattern=("global",), act="gelu", gated=False,
        dtype=torch.float32, loss_chunk=32, attn_impl="direct",
    )
