"""Batched modified Gram-Schmidt QR: wrapper and plain version.

``mgs_qrd`` factors each matrix of a ``(B, n, n)`` float32 batch into Q
and R, column by column with one re-orthogonalisation pass and INVSQR
norms, the whole factorisation held in registers, a group of 8, 16 or
32 lanes per matrix (CUDA: ``csrc/qrd.cu``, n <= 32; plain:
``mgs_qrd_plain``).

A wrapper takes the plain version only because the tensors it was given
lie on the host. For tensors on the card it launches its kernel (on the
current stream of the tensors' device, without synchronising) or raises;
it never falls back.
"""
from __future__ import annotations

import torch

from . import build, ref
from .build import check_tensor

# one lane per column, at most a warp per matrix
MAX_N = 32


# the plain version: the order and rounding the kernel reproduces word
# for word
mgs_qrd_plain = ref.mgs_qrd_ref


def mgs_qrd(a, *, block_b: int = 32):
    """``(B, n, n)`` float32 -> ``(Q, R)``. The kernel runs a group of
    8, 16 or 32 lanes per matrix; ``block_b`` is checked as the reference
    checks it."""
    B, n, n2 = a.shape
    if n != n2:
        raise ValueError("square matrices only")
    block_b = min(block_b, B)
    if B % block_b:
        raise ValueError(f"B={B} must be a multiple of block_b={block_b}")
    if not a.is_cuda:
        return mgs_qrd_plain(a)
    check_tensor(a, "a", torch.float32, (B, n, n), a.device)
    if n > MAX_N:
        raise ValueError(f"n={n}: the QRD kernel takes one lane per "
                         f"column, at most a warp per matrix, n <= {MAX_N}")
    q, r = torch.empty_like(a), torch.empty_like(a)
    build.launch("egpu_mgs_qrd", "qrd", a.device, a.data_ptr(), q.data_ptr(),
                 r.data_ptr(), B, n)
    return q, r
