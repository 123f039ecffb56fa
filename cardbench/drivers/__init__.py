"""Traffic drivers, one per kind of mix; a mix names its driver."""
