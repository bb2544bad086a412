"""Model registry: config -> model instance with its weights."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .layers import seeded, target_device
from .transformer import LM
from .whisper import EncDec


def build_model(cfg: ModelConfig, *, device=None,
                dtype: torch.dtype = torch.float32, seed: int = 0):
    """The model of ``cfg``, its weights drawn on ``device`` (the card
    unless given) from a generator seeded with ``seed``."""
    dev = target_device(device)
    cls = EncDec if cfg.family == "audio" else LM
    return cls(cfg, device=dev, dtype=dtype, generator=seeded(dev, seed))
