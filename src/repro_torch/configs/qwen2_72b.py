"""qwen2-72b [arXiv:2407.10671]: 80L d8192 64H (GQA kv=8) ff29568 v152064;
QKV bias, full attention."""
import torch

from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
ARCH_ID = "qwen2-72b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=29568, vocab=152064, pattern=("global",), qkv_bias=True,
        rope_theta=1e6, act="silu", gated=True, dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, vocab=512, pattern=("global",), qkv_bias=True,
        dtype=torch.float32, loss_chunk=32, attn_impl="direct",
    )
