"""The eGPU's wavefront dot-product / reduction unit: wrapper and plain
version.

``wavefront_dot`` reduces each 16-lane wavefront of an ``(n_sm, 512)``
thread batch to one value: the sum of ``a*b`` (mode 0, DOT) or of ``a+b``
(any other mode, SUM) over the enabled lanes (CUDA: ``csrc/dot.cu``;
plain: ``wavefront_dot_plain``). The lane-0 writeback is the caller's.

A wrapper takes the plain version only because the tensors it was given
lie on the host. For tensors on the card it launches its kernel (on the
current stream, without synchronising) or raises; it never falls back.
"""
from __future__ import annotations

import torch

from . import build, ref
from .build import check_tensor

N_THREADS = 512
N_SP = 16
N_WAVES = N_THREADS // N_SP


# the plain version, over (n_sm, 512) tiles: the summation order and
# rounding the kernel reproduces word for word
wavefront_dot_plain = ref.wavefront_dot_ref


def wavefront_dot(a, b, mask, mode: int = 0, *, block_sm: int = 8):
    """``(n_sm, 512)`` float32 ``a``, ``b`` and bool ``mask`` -> ``(n_sm,
    32)`` float32 per-wavefront sums. ``mode`` is a host integer; the
    kernel picks its own tile, ``block_sm`` is checked as the reference
    checks it. On the card, ``a``, ``b`` and ``mask`` must start at a
    16-byte boundary (a view at another offset raises ``ValueError``)."""
    if a.ndim != 2 or a.shape[1] != N_THREADS:
        raise ValueError(f"a has shape {tuple(a.shape)}, want (n_sm, "
                         f"{N_THREADS})")
    n_sm = a.shape[0]
    block_sm = min(block_sm, n_sm)
    if n_sm % block_sm:
        raise ValueError(f"n_sm={n_sm} must be a multiple of "
                         f"block_sm={block_sm}")
    mode = int(mode)
    if not a.is_cuda:
        return wavefront_dot_plain(a, b, mask, mode)
    dev = a.device
    check_tensor(a, "a", torch.float32, a.shape, dev)
    check_tensor(b, "b", torch.float32, a.shape, dev)
    check_tensor(mask, "mask", torch.bool, a.shape, dev)
    for name, t in (("a", a), ("b", b), ("mask", mask)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte boundary: the "
                             f"kernel loads it 16 bytes at a time")
    out = torch.empty((n_sm, N_WAVES), dtype=torch.float32, device=dev)
    build.launch("egpu_wavefront_dot", "dot", dev, mode, a.data_ptr(),
                 b.data_ptr(), mask.data_ptr(), out.data_ptr(), n_sm * N_WAVES)
    return out
