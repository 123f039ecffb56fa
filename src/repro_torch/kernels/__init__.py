"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a).

Each kernel package ships ``csrc/`` (the CUDA source), ``kernel.py`` (build
at first use through the shared ``_build.py``, and the ctypes launchers),
``ops.py`` (checked wrappers: CPU tensors → the plain version, CUDA tensors
→ the kernel, launch counts) and ``ref.py`` (the plain PyTorch versions).

  bitmap_query    — DIP-ARR attribute query: packed word OR-scan (B1) and
                    byte OR-scan (B2)
  neighbor_sample — property-filtered window select for neighbor
                    sampling (B3)
  embedding_bag   — DLRM's mean-pooled multi-hot gather (B4)
  seg_mm          — DI neighbourhood aggregation, a CSR segment sum (B5)
  flash_attention — blockwise online-softmax attention with GQA, causal and
                    sliding-window masks and a logit softcap (B6)
"""
from repro_torch.kernels.embedding_bag import embedding_bag_fields

__all__ = ["embedding_bag_fields"]
