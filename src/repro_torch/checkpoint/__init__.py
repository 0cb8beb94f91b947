"""Crash-safe checkpoints of tensor trees in the reference's on-disk format
(port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (Checkpointer, latest_step,
                                               load_aux, restore_checkpoint,
                                               save_checkpoint)

__all__ = ["Checkpointer", "latest_step", "load_aux", "restore_checkpoint",
           "save_checkpoint"]
