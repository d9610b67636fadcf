"""Checkpointing: npz shards + json manifest."""

from .store import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint"]
