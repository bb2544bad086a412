"""Gradient compression for the data-parallel all-reduce.

int8 error-feedback (EF-SGD style): each step quantizes (grad + carried
error) to int8 with a per-tensor scale, all-reduces the int8 payload
(8/32 = 4x less DP traffic), dequantizes, and carries the quantization
residual into the next step. Unbiased-enough in practice because the error
feedback re-injects what was rounded away.

``compress``/``decompress`` are the pure tensor-level transform and its
EF state. The collective that all-reduces the payload across devices
(the reference's ``compressed_psum``) waits for the port's mesh layer.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class EFState(NamedTuple):
    error: Any     # carried quantization residual, a dict like the grads


def init_ef(grads_like: dict[str, torch.Tensor]) -> EFState:
    return EFState(error={k: torch.zeros(g.shape, dtype=torch.float32,
                                         device=g.device)
                          for k, g in grads_like.items()})


def _quant(x32: torch.Tensor):
    """int8 payload and its 0-d float32 scale (``max|x| / 127``); round to
    nearest even, as the reference's ``jnp.round`` does."""
    floor = torch.tensor(1e-12, dtype=torch.float32, device=x32.device)
    # a 0-d tensor divisor: the card would multiply by a scalar's reciprocal
    scale = torch.maximum(x32.abs().max(), floor) / torch.tensor(
        127.0, device=x32.device)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def compress(grads: dict[str, torch.Tensor], ef: EFState):
    """-> (int8 dict, scales dict, new EF state)."""
    qs, scales, errs = {}, {}, {}
    for k, g in grads.items():
        x = g.float() + ef.error[k]
        qs[k], scales[k] = _quant(x)
        errs[k] = x - qs[k].float() * scales[k]
    return qs, scales, EFState(error=errs)


def decompress(qs: dict[str, torch.Tensor], scales: dict[str, torch.Tensor],
               dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    return {k: (q.float() * scales[k]).to(dtype) for k, q in qs.items()}
