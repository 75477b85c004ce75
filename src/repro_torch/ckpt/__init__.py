"""Checkpoints of the port, in the JAX package's layout."""
from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step"]
