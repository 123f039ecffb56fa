"""repro_torch.models — model families.  Ported so far: the GNN stack
(``gnn_common``, ``gcn``, ``gat`` with GraphSAGE), DLRM (``dlrm``) and the
dense decoder-only transformer (``transformer``; MoE waits for ROADMAP
A13b)."""
