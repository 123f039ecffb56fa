"""Shared config tables.  Ported so far: the LM and recsys request shapes
(``LM_SHAPES``, ``RECSYS_SHAPES``) and the 512-row padding rule
(``pad512``); the reference's spec builders produce JAX shape structs and
stay behind."""
from __future__ import annotations

__all__ = ["LM_SHAPES", "RECSYS_SHAPES", "PAD_QUANTUM", "pad512"]

LM_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

RECSYS_SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}

# Entity/edge arrays are padded to multiples of 512 (= lcm of every mesh-axis
# group they shard over: dp=16, dp·pod=32, dp·pod·model=512); masks carry
# validity.
PAD_QUANTUM = 512


def pad512(n: int) -> int:
    return -(-n // PAD_QUANTUM) * PAD_QUANTUM
