"""repro_torch.ckpt — atomic, async checkpointing (the counterpart of
``repro.ckpt``)."""

from .checkpoint import (CheckpointManager, find_latest, load_checkpoint,
                         save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "find_latest"]
