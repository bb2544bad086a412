"""Optimization: plain-PyTorch AdamW, clipping, gradient compression."""
from . import adamw, clip, compression

__all__ = ["adamw", "clip", "compression"]
