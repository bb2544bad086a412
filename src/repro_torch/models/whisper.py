"""Whisper-style encoder-decoder backbone [arXiv:2212.04356].

The conv/mel frontend is a stub: the model consumes precomputed frame
embeddings (B, encoder_seq, d_model). The transformer backbone is complete:
encoder (bidirectional self-attention, LayerNorm+GELU), decoder (causal
self-attention with KV cache + cross-attention over encoder output).
Decoder positions use sinusoidal tables so any decode length works without
a learned-table resize (real whisper-tiny caps at 448 learned positions).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import attention as attn
from .layers import (
    MLP,
    Embed,
    LayerNorm,
    cross_entropy,
    embed,
    layernorm,
    mlp,
    seeded,
    sinusoidal_positions,
    target_device,
    unembed,
)


class EncBlock(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        dd = dict(dtype=kw["dtype"], device=kw["device"])
        self.ln1 = LayerNorm(cfg.d_model, **dd)
        self.attn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, **kw)
        self.ln2 = LayerNorm(cfg.d_model, **dd)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, "gelu", **kw)


class DecBlock(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        dd = dict(dtype=kw["dtype"], device=kw["device"])
        heads = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        self.ln1 = LayerNorm(cfg.d_model, **dd)
        self.self = attn.Attention(*heads, **kw)
        self.ln_x = LayerNorm(cfg.d_model, **dd)
        self.cross = attn.Attention(*heads, **kw)
        self.ln2 = LayerNorm(cfg.d_model, **dd)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, "gelu", **kw)


def _arange_rows(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)[None].expand(like.shape[0], n)


class EncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dev = target_device(device)
        kw = dict(dtype=dtype, device=dev,
                  generator=generator if generator is not None
                  else seeded(dev))
        dd = dict(dtype=dtype, device=dev)
        self.embed = Embed(cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings,
                           **kw)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, **kw)
                                        for _ in range(cfg.encoder_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, **kw)
                                        for _ in range(cfg.n_layers))
        self.ln_enc = LayerNorm(cfg.d_model, **dd)
        self.ln_dec = LayerNorm(cfg.d_model, **dd)

    @property
    def device(self) -> torch.device:
        return self.ln_dec.scale.device

    # ---- encoder -----------------------------------------------------------
    def encode(self, frames):
        cfg = self.cfg
        S = frames.shape[1]
        pos_tab = torch.from_numpy(sinusoidal_positions(S, cfg.d_model)).to(
            device=frames.device, dtype=frames.dtype)
        x = frames + pos_tab[None]
        positions = _arange_rows(S, frames)
        for p in self.enc_blocks:
            a, _ = attn.attention(p.attn, layernorm(p.ln1, x), positions, cfg,
                                  causal=False, rope=False)
            x = x + a
            x = x + mlp(p.mlp, layernorm(p.ln2, x), "gelu")
        return layernorm(self.ln_enc, x)

    # ---- decoder (full sequence: train/prefill) ------------------------------
    def decode_full(self, tokens, enc_out, want_cache=False):
        cfg = self.cfg
        B, S = tokens.shape
        x = embed(self.embed.embedding, tokens)
        x = x + torch.from_numpy(sinusoidal_positions(S, cfg.d_model)).to(
            device=x.device, dtype=x.dtype)[None]
        positions = _arange_rows(S, x)
        enc_pos = _arange_rows(enc_out.shape[1], enc_out)
        selfs, crosses = [], []
        for p in self.dec_blocks:
            a, (k, v) = attn.attention(p.self, layernorm(p.ln1, x), positions,
                                       cfg, causal=True, rope=False)
            x = x + a
            c, (ck, cv) = attn.attention(p.cross, layernorm(p.ln_x, x),
                                         enc_pos, cfg, x_kv=enc_out,
                                         causal=False, rope=False)
            x = x + c
            x = x + mlp(p.mlp, layernorm(p.ln2, x), "gelu")
            selfs.append((k, v))
            crosses.append((ck, cv))
        x = layernorm(self.ln_dec, x)
        caches = None
        if want_cache:
            stack = lambda kvs: attn.KVCache(  # noqa: E731
                *(torch.stack(t) for t in zip(*kvs)))
            caches = (stack(selfs), stack(crosses))
        return unembed(self.embed, x), caches

    # ---- losses / serving ----------------------------------------------------
    def loss(self, batch):
        enc_out = self.encode(batch["frames"])
        logits, _ = self.decode_full(batch["tokens"], enc_out)
        ce = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
        return ce, {"ce": ce, "aux": 0.0}

    # generic LM-compatible API
    def forward(self, batch, last_only: bool = False):
        enc_out = self.encode(batch["frames"])
        logits, _ = self.decode_full(batch["tokens"], enc_out)
        return logits[:, -1:] if last_only else logits

    def prefill(self, batch):
        enc_out = self.encode(batch["frames"])
        logits, caches = self.decode_full(batch["tokens"], enc_out,
                                          want_cache=True)
        return logits, {"dec": caches, "enc_out": enc_out,
                        "pos": batch["tokens"].shape[1]}

    def init_decode_caches(self, batch_size, capacity,
                           dtype: torch.dtype = torch.float32):
        cfg = self.cfg
        L = cfg.n_layers
        z = lambda *shape: torch.zeros(shape, dtype=dtype,  # noqa: E731
                                       device=self.device)
        kv = (L, batch_size, capacity, cfg.n_kv_heads, cfg.head_dim)
        ckv = (L, batch_size, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"dec": (attn.KVCache(z(*kv), z(*kv)),
                        attn.KVCache(z(*ckv), z(*ckv))),
                "enc_out": z(batch_size, cfg.encoder_seq, cfg.d_model),
                "pos": 0}

    def decode_step(self, caches, token, pos=None):
        """One decoder token against cached self-attn + encoder cross-attn."""
        cfg = self.cfg
        pos = caches["pos"] if pos is None else pos
        B = token.shape[0]
        x = embed(self.embed.embedding, token)
        pos_v = attn.positions_of(pos, B, x.device)
        # sinusoidal position at a dynamic (per-row) index, computed directly
        d = cfg.d_model
        i = torch.arange(d // 2, dtype=torch.float32, device=x.device)[None, :]
        ang = pos_v.float()[:, None] / torch.pow(10_000.0, 2 * i / d)
        posemb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, None]
        x = x + posemb.to(x.dtype)
        enc_out = caches["enc_out"]
        enc_pos = _arange_rows(enc_out.shape[1], enc_out)
        self_kv, cross_kv = caches["dec"]
        ks, vs = [], []
        for layer, p in enumerate(self.dec_blocks):
            a, skv = attn.decode_attention(
                p.self, layernorm(p.ln1, x), pos_v,
                attn.KVCache(self_kv.k[layer], self_kv.v[layer]), cfg,
                rope=False)
            x = x + a
            # cross-attention reads the encoder output again (as the
            # reference does; its cached cross K/V is carried unread)
            c, _ = attn.attention(p.cross, layernorm(p.ln_x, x), enc_pos, cfg,
                                  x_kv=enc_out, causal=False, rope=False)
            x = x + c
            x = x + mlp(p.mlp, layernorm(p.ln2, x), "gelu")
            ks.append(skv.k)
            vs.append(skv.v)
        x = layernorm(self.ln_dec, x)
        return unembed(self.embed, x), {
            "dec": (attn.KVCache(torch.stack(ks), torch.stack(vs)), cross_kv),
            "enc_out": enc_out, "pos": pos + 1}
