"""repro_torch.configs — one module per architecture, all ten of the
reference's: the LMs ``mixtral_8x22b``, ``dbrx_132b``, ``gemma2_9b``,
``qwen2_72b`` and ``starcoder2_7b``, the GNNs ``gcn_cora``, ``mace_cfg``,
``dimenet_cfg`` and ``graphcast_cfg``, and ``dlrm_rm2``; ``common``'s
shape tables and input specs, and ``registry`` (``ARCHS``, ``get_arch`` and
the dry run's 40 cells)."""
