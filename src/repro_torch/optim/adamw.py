"""AdamW in plain PyTorch with:

  * f32 moments regardless of the parameters' dtype (bf16-safe),
  * decoupled weight decay on the leaves a decay set names,
  * linear warmup + cosine decay schedule,
  * global-norm gradient clipping (clip.py).

The update keeps the reference's formula and order, element by element,
and updates the parameters and the moments in place (under
``torch.no_grad()``), one leaf at a time: no second full-size copy of the
weights is made. The schedule and the bias corrections are host float32
scalars computed as the reference computes them, and reach each leaf's
device as 0-d tensors: a Python or host scalar divisor would be applied
on the card as a product with its reciprocal.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from ..configs.base import RunConfig
from ..spans import span

EPS = 1e-8
_F32 = np.float32


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32 on the host
    mu: Any              # first moment (f32), a dict like the params
    nu: Any              # second moment (f32)


def init(params: dict[str, torch.Tensor]) -> AdamWState:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32), mu=zeros,
                      nu={k: torch.zeros_like(z) for k, z in zeros.items()})


@functools.cache
def _libm():
    """The C library's float32 ``cosf`` and ``powf``: the reference's
    float32 ``cos`` and ``pow`` on its host give their values (numpy's and
    PyTorch's vectorised ones differ from them in the last bit)."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name, n in (("cosf", 1), ("powf", 2)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_float] * n
        fn.restype = ctypes.c_float
    return lib


def schedule(rc: RunConfig, step, total_steps: int = 10_000) -> np.float32:
    """The learning rate at ``step`` (an int or a 0-d tensor), in float32
    as the reference's ``jnp`` computes it: warmup times ``0.1 + 0.9 cos``."""
    s = _F32(int(step))
    warm = min(s / _F32(max(rc.warmup_steps, 1)), _F32(1.0))
    t = (s - _F32(rc.warmup_steps)) / _F32(
        max(total_steps - rc.warmup_steps, 1))
    t = min(max(t, _F32(0.0)), _F32(1.0))
    cos = _F32(0.5) * (_F32(1.0) + _F32(_libm().cosf(_F32(np.pi) * t)))
    return _F32(rc.learning_rate) * warm * (_F32(0.1) + _F32(0.9) * cos)


def _bias_correction(beta: float, step: int) -> np.float32:
    return _F32(1.0) - _F32(_libm().powf(_F32(beta), _F32(step)))


def apply(rc: RunConfig, params: dict[str, torch.Tensor],
          grads: dict[str, torch.Tensor], state: AdamWState,
          total_steps: int = 10_000,
          decay: dict[str, bool] | None = None):
    """One AdamW step: updates ``params`` and the moments in place and
    returns ``(params, new_state)``. ``decay`` names, per leaf, whether it
    is decayed: if None, the reference's rule on a plain dict, the leaves
    of rank 2 or more (a model's set comes from ``convert.lm_decay``,
    which follows the reference's stacked layout)."""
    with span("optim.adamw") as s:
        if s.on:
            s.count(bytes=_update_bytes(params, grads, state))
        step = state.step + 1
        lr = schedule(rc, step, total_steps)
        b1, b2 = rc.beta1, rc.beta2
        bc1 = _bias_correction(b1, int(step))
        bc2 = _bias_correction(b2, int(step))
        if decay is None:
            decay = {k: p.ndim >= 2 for k, p in params.items()}
        # a model's parameters sit on one device: the first leaf's
        dev = next(iter(params.values())).device
        lr_t, bc1_t, bc2_t = (torch.tensor(x, device=dev)
                              for x in (lr, bc1, bc2))
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k].float()
                m, v = state.mu[k], state.nu[k]
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(g * (1 - b2) * g)
                delta = (m / bc1_t).div_((v / bc2_t).sqrt_().add_(EPS))
                if decay[k]:
                    delta.add_(rc.weight_decay * p.float())
                p.copy_(p.float() - lr_t * delta)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def _update_bytes(params: dict, grads: dict, state: AdamWState) -> int:
    """The least bytes one update moves: each parameter read and written,
    its gradient read, both moments read and written (28 bytes an element
    in float32)."""
    return sum(p.numel() * (2 * p.element_size() + grads[k].element_size()
                            + 2 * state.mu[k].element_size()
                            + 2 * state.nu[k].element_size())
               for k, p in params.items())
