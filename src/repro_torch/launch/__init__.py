"""repro_torch.launch — launchers and placement.  Ported so far: the LM
serving demo (``serve``), the graph analytics service's driver
(``pgserve``) and the property graph's entity mesh (``mesh``), its
collectives (``collectives``) and placement specs (``sharding``)."""
