"""repro_torch.models — model families: the GNN stack (``gnn_common``,
``gcn``, ``gat`` with GraphSAGE), the science models (``dimenet``,
``mace``, ``graphcast``), DLRM (``dlrm``) and the decoder-only transformer
with dense and mixture-of-experts FFNs (``transformer``)."""
