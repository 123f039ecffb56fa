"""repro_torch.configs — one module per architecture.  Ported so far:
``gcn_cora``."""
