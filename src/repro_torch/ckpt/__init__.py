"""Checkpoint stores of the port: :class:`SweepCheckpoint`, the resumable
sweep's per-cell records (stdlib only, the same files the JAX package
writes)."""

from .sweep import SCHEMA, SchemaMismatch, SweepCheckpoint  # noqa: F401

__all__ = ["SweepCheckpoint", "SchemaMismatch", "SCHEMA"]
