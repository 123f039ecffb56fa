"""repro_torch.optim — the reference's optimizers: AdamW (``adamw``),
int8 gradient compression with error feedback (``compression``) and
rowwise AdaGrad on touched table rows (``sparse_tables``)."""
from repro_torch.optim.adamw import AdamWConfig, apply_updates, cosine_schedule, init_state

__all__ = ["AdamWConfig", "apply_updates", "cosine_schedule", "init_state"]
