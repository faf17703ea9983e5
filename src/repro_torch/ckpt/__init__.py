"""Checkpoint stores of the port: :class:`SweepCheckpoint`, the resumable
sweep's per-cell records (stdlib only, the same files the JAX package
writes), and the training state's checkpoints (:class:`CheckpointManager`,
``save_checkpoint`` / ``restore_checkpoint``, the JAX package's format)."""

from .checkpoint import (CheckpointManager, latest_step,  # noqa: F401
                         restore_checkpoint, save_checkpoint)
from .sweep import SCHEMA, SchemaMismatch, SweepCheckpoint  # noqa: F401

__all__ = ["SweepCheckpoint", "SchemaMismatch", "SCHEMA",
           "CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
