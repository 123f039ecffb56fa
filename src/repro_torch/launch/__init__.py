"""repro_torch.launch — launchers.  Ported so far: the LM serving demo
(``serve``) and the graph analytics service's driver (``pgserve``)."""
