"""Attention: GQA/MQA/MHA, causal + local-window masks, KV-cache decode.

GQA grouped einsum (no materialized KV-head replication): q heads are
reshaped (G kv groups x R reps). Scores and softmax in float32. The decode
path writes each slot's new key and value at its own position in a
fixed-capacity cache (a ring of ``window`` rows for local attention, so
RG-LRU hybrids keep O(window) state at any context).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..spans import span
from .layers import apply_rope, dense_init, param

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


class Attention(nn.Module):
    def __init__(self, d_model, n_heads, n_kv_heads, head_dim, *, dtype,
                 device, generator, qkv_bias=False, d_kv_model=None):
        super().__init__()
        d_kv_model = d_kv_model or d_model
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.wq = param(dense_init(d_model, n_heads * head_dim, **kw))
        self.wk = param(dense_init(d_kv_model, n_kv_heads * head_dim, **kw))
        self.wv = param(dense_init(d_kv_model, n_kv_heads * head_dim, **kw))
        self.wo = param(dense_init(n_heads * head_dim, d_model, **kw))
        if qkv_bias:
            z = lambda n: param(torch.zeros(n, dtype=dtype, device=device))  # noqa: E731
            self.bq = z(n_heads * head_dim)
            self.bk = z(n_kv_heads * head_dim)
            self.bv = z(n_kv_heads * head_dim)


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_cap, KVH, D)
    v: torch.Tensor     # (B, S_cap, KVH, D)
    # for windowed attention the cache is a ring buffer of size window


def _project_qkv(p, x, x_kv, n_heads, n_kv_heads, head_dim):
    B, S, _ = x.shape
    Skv = x_kv.shape[1]
    q = x @ p.wq
    k = x_kv @ p.wk
    v = x_kv @ p.wv
    if hasattr(p, "bq"):
        q = q + p.bq.to(q.dtype)
        k = k + p.bk.to(k.dtype)
        v = v + p.bv.to(v.dtype)
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, Skv, n_kv_heads, head_dim),
            v.reshape(B, Skv, n_kv_heads, head_dim))


def _gqa_scores(q, k):
    """q: (B,S,H,D), k: (B,T,G,D) -> scores (B,G,R,S,T)."""
    B, S, H, D = q.shape
    G = k.shape[2]
    R = H // G
    qg = q.reshape(B, S, G, R, D)
    return torch.einsum("bsgrd,btgd->bgrst", qg.float(),
                        k.float()) / np.sqrt(D)


def _gqa_out(weights, v, out_dtype):
    """weights: (B,G,R,S,T), v: (B,T,G,D) -> (B,S,H*D)."""
    B, G, R, S, T = weights.shape
    D = v.shape[-1]
    o = torch.einsum("bgrst,btgd->bsgrd", weights, v.float())
    return o.reshape(B, S, G * R * D).to(out_dtype)


def _band(rows, cols, window: int, device, q_lo: int = 0, k_lo: int = 0):
    """The causal (and, with ``window``, banded) mask of query rows
    ``q_lo...`` against key columns ``k_lo...``."""
    i = torch.arange(rows, device=device)[:, None] + q_lo
    j = torch.arange(cols, device=device)[None, :] + k_lo
    mask = j <= i
    if window:
        mask &= j > i - window
    return mask


def attention(p, x, positions, cfg, *, x_kv=None, causal=True,
              window: int = 0, rope: bool = True):
    """Full (prefill/train) attention. x: (B,S,D).

    When ``cfg.attn_q_chunk`` is set (and applicable) the scores are
    computed q-chunk by q-chunk over static causal/banded key ranges, so
    the S^2 score tensor is never materialized whole.
    """
    self_attn = x_kv is None
    x_kv = x if x_kv is None else x_kv
    q, k, v = _project_qkv(p, x, x_kv, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    S = q.shape[1]
    qc = getattr(cfg, "attn_q_chunk", 0)
    with span("attn.scores") as s:
        qs, ks, vs = s.inputs(q, k, v)
        if causal and qc and S > qc and S % qc == 0 and self_attn:
            out = _blocked_causal(qs, ks, vs, qc, window, x.dtype,
                                  getattr(cfg, "attn_w_bf16", False))
        else:
            scores = _gqa_scores(qs, ks)                 # (B,G,R,S,T)
            S, T = scores.shape[-2], scores.shape[-1]
            if causal:
                scores = torch.where(_band(S, T, window, x.device), scores,
                                     NEG_INF)
            w = torch.softmax(scores, dim=-1)
            out = _gqa_out(w, vs, x.dtype)
        out = s.output(out)
    return out @ p.wo, (k, v)


def _blocked_causal(q, k, v, chunk: int, window: int, out_dtype,
                    w_bf16: bool = False):
    """Causal (optionally banded) attention, q-chunked with static key
    slices. Peak score tile: (B,G,R,chunk,kmax) instead of (...,S,S);
    windowed attention touches only ceil((window+chunk)/chunk) key blocks
    per q block."""
    B, S, H, D = q.shape
    outs = []
    for ci in range(S // chunk):
        q_lo, q_hi = ci * chunk, (ci + 1) * chunk
        k_lo = 0
        if window:
            k_lo = max(0, q_hi - window - chunk)
            k_lo = (k_lo // chunk) * chunk           # static, block-aligned
        k_hi = q_hi
        scores = _gqa_scores(q[:, q_lo:q_hi], k[:, k_lo:k_hi])
        mask = _band(chunk, k_hi - k_lo, window, q.device, q_lo, k_lo)
        scores = torch.where(mask, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        if w_bf16:
            w = w.to(torch.bfloat16).float()
        outs.append(_gqa_out(w, v[:, k_lo:k_hi], out_dtype))
    return torch.cat(outs, dim=1)


def init_cache(batch, capacity, n_kv_heads, head_dim, dtype,
               device) -> KVCache:
    z = torch.zeros((batch, capacity, n_kv_heads, head_dim), dtype=dtype,
                    device=device)
    return KVCache(k=z, v=z.clone())


def positions_of(pos, batch: int, device) -> torch.Tensor:
    """``pos`` (an int, a 0-d or a ``(B,)`` tensor) as a ``(B,)`` int64
    tensor on ``device``."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).expand(batch)
    return torch.full((batch,), int(pos), dtype=torch.int64, device=device)


def decode_attention(p, x, pos, cache: KVCache, cfg, *, window: int = 0,
                     rope: bool = True):
    """One-token decode. x: (B,1,D); pos: an int or a (B,) tensor (the
    serving engine's slots sit at different positions).

    The cache has fixed capacity C (= seq_len, or window for local
    attention, where it is addressed as a ring buffer). Returns the output
    and a new cache; the given one is not written.
    """
    B = x.shape[0]
    C = cache.k.shape[1]
    pos_v = positions_of(pos, B, x.device)
    q, k, v = _project_qkv(p, x, x, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    if rope:
        q = apply_rope(q, pos_v[:, None], cfg.rope_theta)
        k = apply_rope(k, pos_v[:, None], cfg.rope_theta)
    slot = pos_v % max(C, 1) if window > 0 else pos_v
    rows = torch.arange(B, device=x.device)
    # a write past the last row is dropped, as an out-of-range scatter is
    # in the reference: the row keeps what it holds
    inside = (slot < C)[:, None, None]
    at = slot.clamp(max=C - 1)
    newk = cache.k.index_put(
        (rows, at), torch.where(inside, k[:, 0].to(cache.k.dtype),
                                cache.k[rows, at]))
    newv = cache.v.index_put(
        (rows, at), torch.where(inside, v[:, 0].to(cache.v.dtype),
                                cache.v[rows, at]))
    scores = _gqa_scores(q, newk)                    # (B,G,R,1,C)
    idx = torch.arange(C, device=x.device)[None, :]
    if window > 0:
        valid = (idx <= slot[:, None]) | (pos_v[:, None] >= C)  # ring full
    else:
        valid = idx <= pos_v[:, None]
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = _gqa_out(w, newv, x.dtype)
    return out @ p.wo, KVCache(k=newk, v=newv)
