"""Model registry: config -> model instance with its weights, and the
shapes of a cell's inputs, caches and parameters on the meta device."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from .layers import seeded, target_device
from .transformer import LM
from .whisper import EncDec


def build_model(cfg: ModelConfig, *, device=None,
                dtype: torch.dtype = torch.float32, seed: int = 0):
    """The model of ``cfg``, its weights drawn on ``device`` (the card
    unless given) from a generator seeded with ``seed``. On the meta
    device nothing is drawn: the weights are shapes and dtypes only."""
    dev = target_device(device)
    cls = EncDec if cfg.family == "audio" else LM
    return cls(cfg, device=dev, dtype=dtype, generator=seeded(dev, seed))


def _meta(*shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Meta-device stand-ins for every model input of a given cell: shapes
    and dtypes, no allocation.

    train/prefill: the full-sequence batch. decode: one new token (the KV
    cache / recurrent state is a separate input built by ``cache_specs``).
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        batch = {"tokens": _meta(B, 1)}
        if cfg.family == "audio":
            batch["frames"] = _meta(B, cfg.encoder_seq, cfg.d_model,
                                    dtype=dtype)
        return batch
    if cfg.family == "audio":
        return {"frames": _meta(B, cfg.encoder_seq, cfg.d_model, dtype=dtype),
                "tokens": _meta(B, S), "labels": _meta(B, S)}
    if cfg.family == "vlm":
        s_text = S - cfg.num_image_tokens
        return {"tokens": _meta(B, s_text),
                "image_embeds": _meta(B, cfg.num_image_tokens, cfg.d_model,
                                      dtype=dtype),
                "labels": _meta(B, s_text)}
    batch = {"tokens": _meta(B, S)}
    if shape.kind == "train":
        batch["labels"] = _meta(B, S)
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16):
    """The decode caches of a cell on the meta device (``pos`` an int)."""
    model = build_model(cfg, device="meta", dtype=dtype)
    return model.init_decode_caches(shape.global_batch, shape.seq_len, dtype)


def param_specs(cfg: ModelConfig,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """The model's parameters on the meta device, name -> tensor, one per
    layer (``convert.lm_reference_leaf`` gives each one's stacked place)."""
    model = build_model(cfg, device="meta", dtype=dtype)
    return {k: p.detach() for k, p in model.named_parameters()}
