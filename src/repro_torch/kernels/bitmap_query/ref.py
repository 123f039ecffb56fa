"""Plain PyTorch versions of the bitmap_query kernels.

The CPU path of ``ops.py`` and the yardstick the CUDA kernels are held to
on the card.  They repeat the kernels' arithmetic and are no measure of
speed.
"""
import torch


def bitmap_query_ref(bitmap: torch.Tensor, attr_mask: torch.Tensor) -> torch.Tensor:
    """bitmap: (K, N) int8; attr_mask: (K,) bool → (N,) bool."""
    return bitmap_query_batched_ref(bitmap, attr_mask[None, :])[0]


def bitmap_query_batched_ref(bitmap: torch.Tensor, attr_masks: torch.Tensor) -> torch.Tensor:
    """bitmap: (K, N) int8; attr_masks: (Q, K) bool → (Q, N) bool — a fold
    over K, one (Q, N) accumulator, no (Q, K, N) intermediate."""
    q, n = attr_masks.shape[0], bitmap.shape[1]
    out = torch.zeros((q, n), dtype=torch.bool, device=bitmap.device)
    rows = bitmap != 0
    for a in range(bitmap.shape[0]):
        out |= attr_masks[:, a:a + 1] & rows[a][None, :]
    return out


def bitmap_query_packed_ref(plane: torch.Tensor, attr_mask: torch.Tensor) -> torch.Tensor:
    """plane: (K, W) int32 words; attr_mask: (K,) bool → (W,) int32."""
    return bitmap_query_batched_packed_ref(plane, attr_mask[None, :])[0]


def bitmap_query_batched_packed_ref(plane: torch.Tensor, attr_masks: torch.Tensor) -> torch.Tensor:
    """plane: (K, W) int32; attr_masks: (Q, K) bool → (Q, W) int32: the OR
    fold over the selected rows (torch has no OR reduction)."""
    q, w = attr_masks.shape[0], plane.shape[1]
    out = torch.zeros((q, w), dtype=torch.int32, device=plane.device)
    zero = torch.zeros((), dtype=torch.int32, device=plane.device)
    for a in range(plane.shape[0]):
        out |= torch.where(attr_masks[:, a:a + 1], plane[a][None, :], zero)
    return out
