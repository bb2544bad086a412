"""Batched radix-2 DIF FFT: wrapper and plain version.

``fft_r2`` transforms the rows of ``(B, N)`` float32 re/im planes, N a
power of two, with all log2 N butterfly passes in one kernel and the rows
resident in shared memory between passes (CUDA: ``csrc/fft.cu``; plain:
``fft_r2_plain``). The passes leave the spectrum in bit-reversed order;
``natural=True`` returns it in natural order.

A wrapper takes the plain version only because the tensors it was given
lie on the host. For tensors on the card it launches its kernel (on the
current stream, without synchronising) or raises; it never falls back.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import build, ref
from .build import MAX_DYNAMIC_SMEM, check_tensor, current_stream


def _twiddle_table(n: int) -> np.ndarray:
    """(2, log2n, n//2): per-pass twiddles, re/im planes, repeated so pass
    p's row holds W at each butterfly position (period H = n/2 >> p).
    Computed in float64 and rounded once to float32."""
    log2n = n.bit_length() - 1
    tw = np.zeros((2, log2n, n // 2), np.float32)
    for p in range(log2n):
        h = (n // 2) >> p
        stride = n // (2 * h)
        k = (np.arange(n // 2) % h) * stride
        w = np.exp(-2j * np.pi * k / n)
        tw[0, p] = w.real
        tw[1, p] = w.imag
    return tw


@functools.lru_cache(maxsize=64)
def twiddles(n: int, device: torch.device) -> torch.Tensor:
    """The twiddle table of ``n`` on ``device``, uploaded once per (n,
    device) and shared by every row of every call."""
    return torch.from_numpy(_twiddle_table(n)).to(device)


def fft_r2_plain(re, im, natural: bool = True):
    """Pass by pass, the butterflies of the kernel: ``u = a + b``, ``d = a
    - b``, ``v = d * w`` with ``v_re = d_re w_re - d_im w_im`` and ``v_im =
    d_re w_im + d_im w_re``, each operation rounded once."""
    B, n = re.shape
    log2n = n.bit_length() - 1
    tw = twiddles(n, re.device)
    re, im = re.to(torch.float32), im.to(torch.float32)
    for p in range(log2n):
        h = (n // 2) >> p
        nb = n // (2 * h)
        wre, wim = tw[0, p, :h], tw[1, p, :h]
        re4 = re.reshape(B, nb, 2, h)
        im4 = im.reshape(B, nb, 2, h)
        a_re, b_re = re4[:, :, 0, :], re4[:, :, 1, :]
        a_im, b_im = im4[:, :, 0, :], im4[:, :, 1, :]
        u_re, u_im = a_re + b_re, a_im + b_im
        d_re, d_im = a_re - b_re, a_im - b_im
        v_re = d_re * wre - d_im * wim
        v_im = d_re * wim + d_im * wre
        re = torch.stack([u_re, v_re], dim=2).reshape(B, n)
        im = torch.stack([u_im, v_im], dim=2).reshape(B, n)
    if natural:
        inv = torch.argsort(ref.bitrev(n)).to(re.device)
        re, im = re[:, inv], im[:, inv]
    return re, im


def fft_r2(re, im, *, block_b: int = 8, natural: bool = True):
    """``(B, N)`` float32 re/im planes -> the transformed planes. The kernel
    runs one CTA per row; ``block_b`` is checked as the reference checks
    it."""
    B, n = re.shape
    if n < 1 or n & (n - 1):
        raise ValueError("N must be a power of two")
    block_b = min(block_b, B)
    if B % block_b:
        raise ValueError(f"B={B} must be a multiple of block_b={block_b}")
    if not re.is_cuda:
        return fft_r2_plain(re, im, natural)
    dev = re.device
    check_tensor(re, "re", torch.float32, (B, n), dev)
    check_tensor(im, "im", torch.float32, (B, n), dev)
    smem = 2 * 4 * n                    # a row's re and im planes
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"N={n} needs {smem} bytes of shared memory per "
                         f"row; a block may use at most {MAX_DYNAMIC_SMEM}")
    tw = twiddles(n, dev)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    fn = build.entry_point("egpu_fft_r2")
    build.check(fn(tw.data_ptr(), re.data_ptr(), im.data_ptr(),
                   ore.data_ptr(), oim.data_ptr(), B, n,
                   n.bit_length() - 1, int(bool(natural)),
                   current_stream()), "fft")
    build.launches["fft"] += 1
    return ore, oim
