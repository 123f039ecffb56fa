"""repro_torch.launch — launchers, meshes, placement and the dry run: the
LM serving demo (``serve``), the trainer (``train``), the graph analytics
service's driver (``pgserve``), the property graph's entity mesh and the
production meshes (``mesh``), collectives (``collectives``), placement and
spec rules (``sharding``), and the dry run's cells (``steps``), driver
(``dryrun``) and cost counter (``hlo_analysis``)."""
