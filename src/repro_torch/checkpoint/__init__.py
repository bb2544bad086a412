"""Checkpointing: atomic npz shards, async save, restore onto any device."""
from . import ckpt

__all__ = ["ckpt"]
