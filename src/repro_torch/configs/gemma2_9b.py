"""gemma2-9b [arXiv:2408.00118]: 42L d3584 16H (GQA kv=8, d_head=256) ff14336
v256000; alternating local(4096)/global layers, logit softcaps, GeGLU,
post-norms, scaled embeddings."""
import torch

from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
ARCH_ID = "gemma2-9b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_head=256,
        d_ff=14336, vocab=256000, window=4096, pattern=("local", "global"),
        attn_softcap=50.0, final_softcap=30.0, post_norms=True, scale_embed=True,
        act="gelu", gated=True, tie_embeddings=True, dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, vocab=512, window=16, pattern=("local", "global"),
        attn_softcap=50.0, final_softcap=30.0, post_norms=True, scale_embed=True,
        act="gelu", gated=True, tie_embeddings=True, dtype=torch.float32,
        loss_chunk=32, attn_impl="direct",
    )
