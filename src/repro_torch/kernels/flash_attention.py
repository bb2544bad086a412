"""Flash attention: wrapper and plain version.

``flash_attention`` runs causal or non-causal softmax attention over
``(BH, S, D)`` queries, keys and values with the online-softmax recurrence
over ``blk_k``-row key blocks; in causal mode the key blocks entirely in a
``blk_q``-row query block's future are skipped (CUDA: ``csrc/flash.cu``;
plain: ``flash_attention_plain``; oracle: ``ref.flash_attention_ref``).
It accumulates in float32, takes float32 or bfloat16 and returns q's type.

A wrapper takes the plain version only because the tensors it was given
lie on the host. For tensors on the card it launches its kernel (on the
current stream, without synchronising) or raises; it never falls back.
"""
from __future__ import annotations

import math

import torch

from . import build
from .build import MAX_DYNAMIC_SMEM, check_tensor, current_stream
from .ref import NEG_INF

# the kernel's query rows per CTA and widest head
ROWS_PER_CTA = 32
MAX_D = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_smem_bytes(d: int, blk_k: int) -> int:
    """Dynamic shared memory of one flash CTA: its query rows, the K tile
    (odd row stride), the V tile, the score tile and three row vectors."""
    return 4 * (ROWS_PER_CTA * d + blk_k * (d | 1) + blk_k * d
                + ROWS_PER_CTA * (blk_k + 1) + 3 * ROWS_PER_CTA)


def flash_attention_plain(q, k, v, causal: bool = True, blk_q: int = 128,
                          blk_k: int = 128):
    """The recurrence block by block, as the kernel runs it: per query
    block, over its live key blocks, ``m' = max(m, rowmax s)``, ``l' =
    e^(m - m') l + rowsum e^(s - m')``, ``acc' = e^(m - m') acc + e^(s -
    m') v``; out = ``acc / max(l, 1e-30)``."""
    BH, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    out = torch.empty_like(qf)
    n_kb = S // blk_k
    for j in range(S // blk_q):
        rows = torch.arange(j * blk_q, (j + 1) * blk_q, device=q.device)
        qb = qf[:, j * blk_q:(j + 1) * blk_q]
        n_live = min((j * blk_q + blk_q - 1) // blk_k + 1, n_kb) \
            if causal else n_kb
        acc = qf.new_zeros((BH, blk_q, D))
        m = qf.new_full((BH, blk_q), NEG_INF)
        l = qf.new_zeros((BH, blk_q))  # noqa: E741
        for kb in range(n_live):
            k_blk = kf[:, kb * blk_k:(kb + 1) * blk_k]
            v_blk = vf[:, kb * blk_k:(kb + 1) * blk_k]
            s = (qb @ k_blk.transpose(1, 2)) * scale
            if causal:
                cols = torch.arange(kb * blk_k, (kb + 1) * blk_k,
                                    device=q.device)
                s = torch.where(cols[None, :] <= rows[:, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = alpha * l + p.sum(dim=-1)  # noqa: E741
            acc = acc * alpha[..., None] + p @ v_blk
            m = m_new
        out[:, j * blk_q:(j + 1) * blk_q] = \
            acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, blk_q: int = 128,
                    blk_k: int = 128):
    """``(BH, S, D)`` q, k, v -> ``(BH, S, D)`` in q's dtype. Heads are
    folded into the leading dim (GQA repetition is the caller's job)."""
    BH, S, D = q.shape
    if S % blk_q or S % blk_k:
        raise ValueError(f"S={S} must be a multiple of blk_q/blk_k")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal, blk_q, blk_k)
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_tensor(t, name, q.dtype, (BH, S, D), dev)
    if D > MAX_D:
        raise ValueError(f"D={D}: the flash kernel takes heads of at most "
                         f"{MAX_D}")
    smem = flash_smem_bytes(D, blk_k)
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"blk_k={blk_k} at D={D} needs {smem} bytes of "
                         f"shared memory; a block may use at most "
                         f"{MAX_DYNAMIC_SMEM}")
    if BH > 65535 or S // blk_q > 65535:
        raise ValueError(f"a grid of {BH} x {S // blk_q} query blocks "
                         f"exceeds 65535 in a dimension")
    out = torch.empty_like(q)
    fn = build.entry_point("egpu_flash_attention")
    build.check(fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), BH, S, D, blk_q, blk_k,
                   int(bool(causal)), current_stream()), "flash")
    build.launches["flash"] += 1
    return out

