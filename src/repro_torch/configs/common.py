"""Shared config tables.  Ported so far: the recsys request shapes
(``RECSYS_SHAPES``) and the 512-row padding rule (``pad512``); the
reference's spec builders produce JAX shape structs and stay behind."""
from __future__ import annotations

__all__ = ["RECSYS_SHAPES", "PAD_QUANTUM", "pad512"]

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
