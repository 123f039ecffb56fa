"""Batched property-filtered neighborhood sampling (B3 ``window_select``)."""
from repro_torch.kernels.neighbor_sample.ops import (
    SEED_BUCKET_MIN,
    WINDOW_BUCKET_MIN,
    bucketed_requests,
    bucketed_seeds,
    bucketed_window,
    neighbor_sample,
    neighbor_sample_batched,
    neighbor_sample_from_words,
    sample_compile_count,
    sample_embed,
)

__all__ = [
    "SEED_BUCKET_MIN",
    "WINDOW_BUCKET_MIN",
    "bucketed_requests",
    "bucketed_seeds",
    "bucketed_window",
    "neighbor_sample",
    "neighbor_sample_batched",
    "neighbor_sample_from_words",
    "sample_compile_count",
    "sample_embed",
]
