"""Decoder-only LM covering the dense / moe / ssm / hybrid / vlm families.

The layers are a ``ModuleList`` run by a Python loop, in execution order:
deepseek's dense first layer is ``block0`` beside the others;
recurrentgemma's (rec, rec, attn) pattern is laid out group by group, then
the tail. The decode caches keep the reference's stacked layout and keys
(``kv``: ``KVCache`` of ``(L, B, C, KVH, D)``; ``ssm``: ``(conv, state)``
of ``(L, B, ...)``; hybrid ``groups`` keyed ``"<i>_<kind>"`` with a leading
group axis, and ``tail``), so the two can be compared leaf by leaf.

API (used by serve/launch):
    LM(cfg, device=, dtype=, generator=)  -> module with its weights
    forward(batch)                        -> logits (f32)
    loss(batch)                           -> (scalar, metrics)
    prefill(batch)                        -> (logits, caches)
    init_decode_caches(B, capacity)       -> zero caches
    decode_step(caches, tok, pos)         -> (logits, caches)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..spans import span
from . import attention as attn
from . import moe as moe_mod
from . import rglru as rg
from . import ssm as ssm_mod
from .layers import (
    MLP,
    Embed,
    RMSNorm,
    cross_entropy,
    dense_init,
    embed,
    mlp,
    param,
    rmsnorm,
    scalar_in,
    seeded,
    target_device,
    unembed,
)

# the weight of a MoE's auxiliary (load-balancing) loss in the training
# objective; the sharded train step weighs it the same way
AUX_LOSS_WEIGHT = 0.01


# ---------------------------------------------------------------------------
# per-layer parameter modules
# ---------------------------------------------------------------------------

class AttnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        dd = dict(dtype=kw["dtype"], device=kw["device"])
        self.ln_attn = RMSNorm(cfg.d_model, **dd)
        self.attn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, qkv_bias=cfg.qkv_bias, **kw)
        self.ln_mlp = RMSNorm(cfg.d_model, **dd)
        if cfg.family == "moe":
            self.moe = moe_mod.MoE(cfg, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, **kw)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, dtype=kw["dtype"], device=kw["device"])
        self.ssm = ssm_mod.SSD(cfg, **kw)


class RecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        dd = dict(dtype=kw["dtype"], device=kw["device"])
        self.ln_mix = RMSNorm(cfg.d_model, **dd)
        self.rec = rg.RGLRU(cfg, **kw)
        self.ln_mlp = RMSNorm(cfg.d_model, **dd)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, **kw)


class HybAttnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        dd = dict(dtype=kw["dtype"], device=kw["device"])
        self.ln_mix = RMSNorm(cfg.d_model, **dd)
        self.attn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, **kw)
        self.ln_mlp = RMSNorm(cfg.d_model, **dd)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, **kw)


# ---------------------------------------------------------------------------
# per-layer forward (full sequence)
# ---------------------------------------------------------------------------

def _ffn(p, cfg, y):
    if cfg.family == "moe" and hasattr(p, "moe"):
        return moe_mod.moe_layer(p.moe, cfg, y)
    return mlp(p.mlp, y, cfg.activation), 0.0


def _attn_block_fwd(p, cfg, x, positions, window=0):
    # the residual adds lie inside the sublayers' spans: the residual
    # reads its input through ``inputs`` too, which keeps the sum of its
    # gradient with the sublayer's where it is without the spans
    with span("attn") as s:
        x = s.inputs(x)
        h, kv = attn.attention(p.attn, rmsnorm(p.ln_attn, x, cfg.norm_eps),
                               positions, cfg, window=window)
        x = x + s.output(h)
    with span("ffn") as s:
        x = s.inputs(x)
        m, aux = _ffn(p, cfg, rmsnorm(p.ln_mlp, x, cfg.norm_eps))
        x = x + s.output(m)
    return x, aux, kv


def _ssm_block_fwd(p, cfg, x, conv_st=None, ssm_st=None, decode=False):
    y, st = ssm_mod.ssd_block(p.ssm, cfg, rmsnorm(p.ln, x, cfg.norm_eps),
                              conv_state=conv_st, ssm_state=ssm_st,
                              decode=decode)
    return x + y, st


def _rec_block_fwd(p, cfg, x, conv_st=None, h_st=None, decode=False):
    y, st = rg.recurrent_block(p.rec, rmsnorm(p.ln_mix, x, cfg.norm_eps),
                               conv_state=conv_st, h_state=h_st,
                               decode=decode)
    x = x + y
    return x + mlp(p.mlp, rmsnorm(p.ln_mlp, x, cfg.norm_eps),
                   cfg.activation), st


def _hyb_attn_fwd(p, cfg, x, positions):
    h, kv = attn.attention(p.attn, rmsnorm(p.ln_mix, x, cfg.norm_eps),
                           positions, cfg, window=cfg.window)
    x = x + h
    return x + mlp(p.mlp, rmsnorm(p.ln_mlp, x, cfg.norm_eps),
                   cfg.activation), kv


def _tuple_like(c, xs):
    """A tuple of ``xs`` of the type of ``c`` (a plain or a named tuple)."""
    xs = tuple(xs)
    return type(c)(*xs) if hasattr(c, "_fields") else xs


def _stack(caches):
    """Per-layer caches (tuples of tensors) -> one tuple of stacked ones."""
    return _tuple_like(caches[0], (torch.stack(xs) for xs in zip(*caches)))


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dev = target_device(device)
        kw = dict(dtype=dtype, device=dev,
                  generator=generator if generator is not None
                  else seeded(dev))
        self.embed = Embed(cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings,
                           **kw)
        self.ln_f = RMSNorm(cfg.d_model, dtype=dtype, device=dev)
        if cfg.family == "ssm":
            self.blocks = nn.ModuleList(SSMBlock(cfg, **kw)
                                        for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            block = {"rec": RecBlock, "attn": HybAttnBlock}
            self.blocks = nn.ModuleList(block[k](cfg, **kw)
                                        for k in self.kinds)
        else:  # dense / moe / vlm
            if cfg.first_layer_dense:
                self.block0 = AttnBlock(dataclasses.replace(
                    cfg, family="dense", d_ff=cfg.dense_d_ff), **kw)
            self.blocks = nn.ModuleList(
                AttnBlock(cfg, **kw)
                for _ in range(cfg.n_layers - int(cfg.first_layer_dense)))
            if cfg.family == "vlm":
                self.img_proj = param(dense_init(cfg.d_model, cfg.d_model,
                                                 **kw))

    @property
    def device(self) -> torch.device:
        return self.ln_f.scale.device

    # ---- the hybrid's layer layout ------------------------------------------
    @property
    def kinds(self) -> list[str]:
        """The hybrid's block kinds in execution order."""
        pat = self.cfg.block_pattern
        return [pat[i % len(pat)] for i in range(self.cfg.n_layers)]

    def _hybrid_where(self, layer: int):
        """Where a hybrid layer's cache sits: ``("groups", "<i>_<kind>",
        g)`` inside the pattern's repeats, ``("tail", j, None)`` after."""
        pat = self.cfg.block_pattern
        n_groups = self.cfg.n_layers // len(pat)
        g, i = divmod(layer, len(pat))
        if g < n_groups:
            return "groups", f"{i}_{pat[i]}", g
        return "tail", layer - n_groups * len(pat), None

    # ---- embedding frontends ------------------------------------------------
    def _embed_inputs(self, batch):
        cfg = self.cfg
        with span("embed") as s:
            # the table read through ``inputs``: the backward span ends
            # with the gather's scatter into it
            x = s.output(embed(s.inputs(self.embed.embedding),
                               batch["tokens"]))
        if cfg.family == "vlm":
            img = batch["image_embeds"].to(x.dtype) @ self.img_proj
            x = torch.cat([img, x], dim=1)
        if cfg.family == "hybrid":
            x = x * scalar_in(np.sqrt(cfg.d_model), x.dtype)  # gemma scaling
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        return x, positions

    # ---- full-sequence forward ----------------------------------------------
    def forward(self, batch, last_only: bool = False):
        return self._forward_full(batch, last_only=last_only)[0]

    def _forward_full(self, batch, last_only: bool = False):
        cfg = self.cfg
        x, positions = self._embed_inputs(batch)
        aux_total = 0.0
        if cfg.family == "ssm":
            for blk in self.blocks:
                x, _ = _ssm_block_fwd(blk, cfg, x)
        elif cfg.family == "hybrid":
            for kind, blk in zip(self.kinds, self.blocks):
                if kind == "rec":
                    x, _ = _rec_block_fwd(blk, cfg, x)
                else:
                    x, _ = _hyb_attn_fwd(blk, cfg, x, positions)
        else:  # dense / moe / vlm
            if cfg.first_layer_dense:
                dense_cfg = dataclasses.replace(cfg, family="dense")
                x, _, _ = _attn_block_fwd(self.block0, dense_cfg, x,
                                          positions)
            auxs = []
            for blk in self.blocks:
                x, aux, _ = _attn_block_fwd(blk, cfg, x, positions)
                auxs.append(aux)
            if cfg.family == "moe":
                aux_total = torch.stack(auxs).sum()
        with span("head") as s:
            x = rmsnorm(self.ln_f, s.inputs(x), cfg.norm_eps)
            if last_only:
                # serving prefill: only the last position's logits are needed
                x = x[:, -1:]
            logits = s.output(unembed(self.embed, x, cfg.logits_soft_cap))
        return logits, aux_total

    # ---- loss ----------------------------------------------------------------
    def loss(self, batch):
        cfg = self.cfg
        logits, aux = self._forward_full(batch)
        if cfg.family == "vlm":
            logits = logits[:, cfg.num_image_tokens:, :]
        with span("head") as s:
            ce = s.output(cross_entropy(s.inputs(logits)[:, :-1],
                                        batch["labels"][:, 1:]))
        loss = ce + AUX_LOSS_WEIGHT * aux
        return loss, {"ce": ce, "aux": aux}

    # ---- serving: prefill + single-token decode -------------------------------
    def prefill(self, batch):
        """Full-context forward that also materializes decode caches."""
        cfg = self.cfg
        x, positions = self._embed_inputs(batch)
        S = x.shape[1]
        if cfg.family == "ssm":
            sts = []
            for blk in self.blocks:
                x, st = _ssm_block_fwd(blk, cfg, x)
                sts.append(st)
            caches = {"ssm": _stack(sts), "pos": S}
        elif cfg.family == "hybrid":
            x, caches = self._hybrid_prefill(x, positions)
        else:
            caches = {}
            if cfg.first_layer_dense:
                dense_cfg = dataclasses.replace(cfg, family="dense")
                x, _, (k0, v0) = _attn_block_fwd(self.block0, dense_cfg, x,
                                                 positions)
            kvs = []
            for blk in self.blocks:
                x, _, kv = _attn_block_fwd(blk, cfg, x, positions)
                kvs.append(attn.KVCache(*kv))
            caches = {"kv": _stack(kvs), "pos": S}
            if cfg.first_layer_dense:
                caches["kv0"] = attn.KVCache(k=k0, v=v0)
        x = rmsnorm(self.ln_f, x, cfg.norm_eps)
        return unembed(self.embed, x, cfg.logits_soft_cap), caches

    def _hybrid_prefill(self, x, positions):
        cfg = self.cfg
        groups: dict[str, list] = {}
        tail = []
        for layer, (kind, blk) in enumerate(zip(self.kinds, self.blocks)):
            where, key, _ = self._hybrid_where(layer)
            if kind == "rec":
                x, st = _rec_block_fwd(blk, cfg, x)
            else:
                x, (k, v) = _hyb_attn_fwd(blk, cfg, x, positions)
                # keep only the last `window` positions; a tail attention
                # layer keeps no cache (0), as in the reference
                st = (attn.KVCache(k=k[:, -cfg.window:], v=v[:, -cfg.window:])
                      if where == "groups" else 0)
            if where == "groups":
                groups.setdefault(key, []).append(st)
            else:
                tail.append(st)
        return x, {"groups": {k: _stack(v) for k, v in groups.items()},
                   "tail": tail, "pos": x.shape[1]}

    def init_decode_caches(self, batch_size: int, capacity: int,
                           dtype: torch.dtype = torch.float32):
        """Zero caches for decode from scratch."""
        cfg = self.cfg
        L = cfg.n_layers
        z = lambda *shape, dt=dtype: torch.zeros(  # noqa: E731
            shape, dtype=dt, device=self.device)
        if cfg.family == "ssm":
            K = cfg.conv_kernel
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            return {"ssm": (
                z(L, batch_size, K - 1, conv_dim),
                z(L, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                  cfg.ssm_state, dt=torch.float32)), "pos": 0}
        if cfg.family == "hybrid":
            pat = cfg.block_pattern
            n_groups, rem = divmod(cfg.n_layers, len(pat))
            cap = min(cfg.window, capacity) if cfg.window else capacity

            def one(kind, *lead):
                if kind == "rec":
                    return (z(*lead, batch_size, 3, cfg.lru_width),
                            z(*lead, batch_size, cfg.lru_width,
                              dt=torch.float32))
                shape = (*lead, batch_size, cap, cfg.n_kv_heads,
                         cfg.head_dim)
                return attn.KVCache(k=z(*shape), v=z(*shape))
            return {"groups": {f"{i}_{kind}": one(kind, n_groups)
                               for i, kind in enumerate(pat)},
                    "tail": [one(pat[i % len(pat)]) for i in range(rem)],
                    "pos": 0}
        # dense / moe / vlm
        n_scan = L - int(cfg.first_layer_dense)
        shape = (batch_size, capacity, cfg.n_kv_heads, cfg.head_dim)
        caches = {"kv": attn.KVCache(k=z(n_scan, *shape), v=z(n_scan, *shape)),
                  "pos": 0}
        if cfg.first_layer_dense:
            caches["kv0"] = attn.KVCache(k=z(*shape), v=z(*shape))
        return caches

    def decode_step(self, caches, token, pos=None):
        """token: (B, 1) ints; pos: an int or a (B,) tensor of each row's
        position (the caches' ``pos`` if None). Returns (logits (B,1,V),
        new caches); the given caches are not written."""
        cfg = self.cfg
        pos = caches["pos"] if pos is None else pos
        x = embed(self.embed.embedding, token)
        pos_v = attn.positions_of(pos, x.shape[0], x.device)
        if cfg.family == "hybrid":
            x = x * scalar_in(np.sqrt(cfg.d_model), x.dtype)

        if cfg.family == "ssm":
            sts = []
            conv, state = caches["ssm"]
            for layer, blk in enumerate(self.blocks):
                x, st = _ssm_block_fwd(blk, cfg, x, conv[layer], state[layer],
                                       decode=True)
                sts.append(st)
            new = {"ssm": _stack(sts), "pos": pos + 1}

        elif cfg.family == "hybrid":
            groups: dict[str, list] = {}
            tail = []
            for layer, (kind, blk) in enumerate(zip(self.kinds, self.blocks)):
                where, key, g = self._hybrid_where(layer)
                c = (_tuple_like(caches["groups"][key],
                                 (t[g] for t in caches["groups"][key]))
                     if where == "groups" else caches["tail"][key])
                if kind == "rec":
                    x, st = _rec_block_fwd(blk, cfg, x, *c, decode=True)
                else:
                    hn = rmsnorm(blk.ln_mix, x, cfg.norm_eps)
                    a, st = attn.decode_attention(blk.attn, hn, pos_v, c, cfg,
                                                  window=cfg.window)
                    x = x + a
                    x = x + mlp(blk.mlp, rmsnorm(blk.ln_mlp, x, cfg.norm_eps),
                                cfg.activation)
                if where == "groups":
                    groups.setdefault(key, []).append(st)
                else:
                    tail.append(st)
            new = {"groups": {k: _stack(v) for k, v in groups.items()},
                   "tail": tail, "pos": pos + 1}

        else:
            new = {"pos": pos + 1}

            def layer_step(blk, block_cfg, x, kv):
                hn = rmsnorm(blk.ln_attn, x, cfg.norm_eps)
                a, kv2 = attn.decode_attention(blk.attn, hn, pos_v, kv, cfg)
                x = x + a
                m, _ = _ffn(blk, block_cfg, rmsnorm(blk.ln_mlp, x,
                                                    cfg.norm_eps))
                return x + m, kv2

            if cfg.first_layer_dense:
                x, new["kv0"] = layer_step(
                    self.block0, dataclasses.replace(cfg, family="dense"), x,
                    caches["kv0"])
            kv = caches["kv"]
            kvs = []
            for layer, blk in enumerate(self.blocks):
                x, kv2 = layer_step(blk, cfg, x,
                                    attn.KVCache(kv.k[layer], kv.v[layer]))
                kvs.append(kv2)
            new["kv"] = _stack(kvs)

        x = rmsnorm(self.ln_f, x, cfg.norm_eps)
        return unembed(self.embed, x, cfg.logits_soft_cap), new
