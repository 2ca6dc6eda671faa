"""HGum-framed fault-tolerant checkpointing (counterpart of ``repro.checkpoint``)."""
from .store import (
    CheckpointManager,
    CorruptCheckpoint,
    load_checkpoint,
    restore_into,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager", "CorruptCheckpoint", "load_checkpoint", "restore_into",
    "save_checkpoint",
]
