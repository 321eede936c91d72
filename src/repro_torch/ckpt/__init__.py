"""Checkpoint store: checksummed, double-buffered pytree files on disk,
byte-compatible with the reference's ``repro.ckpt.store``."""
from repro_torch.ckpt.store import (AsyncCheckpointer, CheckpointCorruptError,
                                    DoubleBufferedCheckpointer, load_pytree,
                                    save_pytree, save_scheduler_checkpoint)

__all__ = [
    "AsyncCheckpointer", "CheckpointCorruptError",
    "DoubleBufferedCheckpointer", "load_pytree", "save_pytree",
    "save_scheduler_checkpoint",
]
