from repro_torch.kernels.bitmap_query import ops, ref
from repro_torch.kernels.bitmap_query.ops import (
    Q_BUCKETS,
    bitmap_query,
    bitmap_query_batched,
    bitmap_query_batched_packed,
    bitmap_query_batched_packed_sharded,
    bitmap_query_batched_sharded,
    bitmap_query_packed,
    bitmap_query_packed_sharded,
    bitmap_query_sharded,
    bucketed_q,
)

__all__ = ["ops", "ref", "bitmap_query", "bitmap_query_batched",
           "bitmap_query_packed", "bitmap_query_batched_packed",
           "bitmap_query_sharded", "bitmap_query_batched_sharded",
           "bitmap_query_packed_sharded", "bitmap_query_batched_packed_sharded",
           "bucketed_q", "Q_BUCKETS"]
