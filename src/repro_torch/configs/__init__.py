"""repro_torch.configs — one module per architecture.  Ported so far:
``gcn_cora``, ``dlrm_rm2`` and ``common``'s recsys shape table."""
