"""repro_torch.models — model families.  Ported so far: the GNN stack
(``gnn_common``, ``gcn``, ``gat`` with GraphSAGE) and DLRM (``dlrm``)."""
