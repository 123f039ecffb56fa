"""repro_torch.configs — one module per architecture.  Ported so far:
``gcn_cora``, ``dlrm_rm2``, the dense LMs ``gemma2_9b``, ``starcoder2_7b``
and ``qwen2_72b`` (the MoE LMs wait for ROADMAP A13b), and ``common``'s LM
and recsys shape tables, and ``registry`` (``ARCHS``, ``get_arch``)."""
