"""repro_torch.checkpoint — atomic, async, retention-managed checkpoints in
the reference's on-disk format (``manager``)."""
from repro_torch.checkpoint.manager import CheckpointManager, latest_step, restore, save

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
