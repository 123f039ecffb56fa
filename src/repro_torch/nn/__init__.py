"""repro_torch.nn — shared neural-net layers.  Ported so far: the linear
layer (``layers.init_linear`` / ``layers.linear``) that the GNN models use."""
