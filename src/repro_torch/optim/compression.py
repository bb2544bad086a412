"""Gradient compression for the data-parallel all-reduce.

int8 error-feedback (EF-SGD style): each step quantizes (grad + carried
error) to int8 with a per-tensor scale, all-reduces the int8 payload
(8/32 = 4x less DP traffic), dequantizes, and carries the quantization
residual into the next step. Unbiased-enough in practice because the error
feedback re-injects what was rounded away.

Two entry points:
  * ``compress``/``decompress`` — pure tensor-level transform + EF state,
    testable anywhere;
  * ``compressed_psum`` — the collective over a process group: quantize ->
    all-reduce the int8 payload (as an int32 accumulator to avoid
    overflow) -> dequantize with the mean scale.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist


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


def psum_payload(q: torch.Tensor, scale: torch.Tensor, group=None):
    """The int8 payload summed over ``group`` as int32 (127 * n ranks fits
    easily) and the scales summed, each all-reduced once."""
    summed = q.to(torch.int32)
    dist.all_reduce(summed, group=group)
    s_sum = scale.clone()
    dist.all_reduce(s_sum, group=group)
    return summed, s_sum


def compressed_psum(grads: dict[str, torch.Tensor], ef: EFState,
                    group=None, n_devices: int | None = None):
    """EF-int8 all-reduce over ``group`` (the world if None): returns
    (mean grads, EF'). The mean scale, applied to the summed payload, is
    the standard approximation (the per-rank scales differ); the EF
    residual absorbs the mismatch.

    Leaf by leaf and in place, so that a model's gradients, residuals and
    payloads are never all held twice: each float32 gradient is
    overwritten by its mean (a gradient of another dtype gets a new
    float32 mean) and each carried residual by the new one; the returned
    dicts hold those tensors."""
    n = dist.get_world_size(group) if n_devices is None else n_devices
    mean, errs = {}, {}
    for k, g in grads.items():
        e = ef.error[k]
        x = g.float() + e
        q, scale = _quant(x)
        errs[k] = torch.sub(x, q.float() * scale, out=e)
        del x
        summed, s_sum = psum_payload(q, scale, group)
        # 0-d tensor divisors: the card would multiply by a reciprocal
        n_t = torch.tensor(float(n), device=g.device)
        m = summed.float().mul_(s_sum / n_t).div_(n_t)
        mean[k] = g.copy_(m) if g.dtype == torch.float32 else m
    return mean, EFState(error=errs)
