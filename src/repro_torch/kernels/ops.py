"""Public entry points of the kernel layer.

``alu``, ``dot``, ``qrd``, ``fft`` and ``flash`` take tensors or anything
numpy can read. Tensors run where they lie; anything else is put on the
card (``torch.device("cuda")``) unless the caller passes ``device=``, so
``device="cpu"`` runs the kernels' plain versions on the host. Asking for
the card where there is none raises. Each wrapper below launches its
hand-written CUDA kernel for tensors on the card and takes its plain
version for tensors on the host; there is no interpret-mode setting, no
environment switch and no fallback.

Words (``alu``) are int32 tensors, or uint32/int32 arrays; floats are
float32 (float64 arrays are narrowed), except that ``flash`` also takes
bfloat16 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ref
from .fft_r2 import fft_r2
from .flash_attention import flash_attention
from .mgs_qrd import mgs_qrd
from .simt_alu import simt_alu
from .wavefront_dot import wavefront_dot


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' needs a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions on the host")
    return dev


def _place(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays where it lies unless ``device`` is
    given; an array goes to ``device`` (the card by default)."""
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(_device(device))
    else:
        arr = np.ascontiguousarray(x)
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        elif arr.dtype == np.float64:           # as the reference's arrays
            arr = arr.astype(np.float32)
        t = torch.from_numpy(arr).to(_device(device))
    return t if dtype is None else t.to(dtype)


def alu(op, typ, a, b, mask, old, *, device=None):
    """One SIMT ALU instruction over ``(n, 512)`` words; lanes where
    ``mask`` is 0 keep ``old``."""
    a, b, old = (_place(x, device, torch.int32).contiguous()
                 for x in (a, b, old))
    mask = (_place(mask, device) != 0).contiguous()
    return simt_alu(int(op), int(typ), a, b, mask, old)


def dot(a, b, mask=None, mode=0, *, device=None, block_sm: int = 8):
    """Per-wavefront DOT (mode 0) or SUM reductions: ``(n_sm, 512)`` ->
    ``(n_sm, 32)``; lanes where ``mask`` is 0 contribute nothing, and no
    mask means every lane."""
    a, b = (_place(x, device, torch.float32).contiguous() for x in (a, b))
    if mask is None:
        mask = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    else:
        mask = (_place(mask, device) != 0).contiguous()
    return wavefront_dot(a, b, mask, int(mode), block_sm=block_sm)


def qrd(a, *, device=None, block_b: int = 32):
    """Batched MGS QR: ``(B, n, n)`` -> ``(Q, R)``."""
    return mgs_qrd(_place(a, device, torch.float32).contiguous(),
                   block_b=block_b)


def fft(re, im, *, device=None, block_b: int = 8, natural: bool = True):
    """Batched radix-2 FFT of ``(B, N)`` re/im planes."""
    re, im = (_place(x, device, torch.float32).contiguous() for x in (re, im))
    return fft_r2(re, im, block_b=block_b, natural=natural)


def flash(q, k, v, *, device=None, causal: bool = True, blk_q: int = 128,
          blk_k: int = 128):
    """Flash attention over ``(BH, S, D)``."""
    q, k, v = (_place(x, device).contiguous() for x in (q, k, v))
    return flash_attention(q, k, v, causal=causal, blk_q=blk_q, blk_k=blk_k)


__all__ = ["alu", "dot", "qrd", "fft", "flash", "ref"]
