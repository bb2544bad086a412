"""Mixture-of-Experts layer: top-k routing, capacity-slot dispatch.

Dispatch is index-based (gather/scatter), not the one-hot einsum form: the
(tokens x experts x capacity) dispatch tensor is O(T^2); index dispatch is
O(E*C*d) = O(T*k*cf*d).

  1. top-k routing probabilities per token (renormalized over the k picks);
  2. in-expert slot positions via a priority-ordered cumulative count
     (all first choices, then second choices, ... — GShard order);
  3. slot table (E, C) <- token index, through an (E, C+1) table whose
     last column takes the dropped picks;
  4. expert FFNs run on gathered (E, C, d) tiles, one batched product per
     weight over the stacked experts;
  5. outputs gathered back per (token, choice) and combined with gates.

Tokens overflowing capacity are dropped (combine weight zero). Shared
experts (DeepSeekMoE) are dense FFNs added unconditionally. Returns the
Switch-style load-balance aux loss.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, dense_init, mlp, param


class MoE(nn.Module):
    def __init__(self, cfg, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        E = cfg.n_experts
        self.router = param(dense_init(cfg.d_model, E, scale=0.02, **kw))
        self.experts = MLP(cfg.d_model, cfg.d_ff, cfg.activation, n=E, **kw)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg.d_model, cfg.d_ff * cfg.n_shared_experts,
                              cfg.activation, **kw)


def route_topk(logits, k: int, capacity: int):
    """logits: (T, E) -> routing plan.

    Returns dict with:
      expert (T, k) int64, slot (T, k) int32, keep (T, k) bool,
      gate (T, k) f32 (renormalized), slot_token (E, C) int32 (-1 = empty),
      aux scalar.
    """
    T, E = logits.shape
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    gate, expert = torch.topk(probs, k, dim=-1)               # (T, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(expert, E).float()                     # (T, k, E)
    # priority order: all 1st choices first, then 2nd, ... (GShard)
    flat = onehot.transpose(0, 1).reshape(k * T, E)
    pos = torch.cumsum(flat, dim=0) - flat                    # (kT, E)
    pos = pos.reshape(k, T, E).transpose(0, 1)
    slot = torch.sum(pos * onehot, dim=-1).to(torch.int32)    # (T, k)
    keep = slot < capacity
    # slot table: (E, C) <- token index (unique slots: collision-free; the
    # drop lane, column C, only ever takes -1)
    tok_ids = torch.arange(T, dtype=torch.int32, device=dev)[:, None] \
        .expand(T, k)
    e_safe = torch.where(keep, expert, 0)
    s_safe = torch.where(keep, slot, capacity).long()
    slot_token = torch.full((E, capacity + 1), -1, dtype=torch.int32,
                            device=dev)
    slot_token[e_safe.reshape(-1), s_safe.reshape(-1)] = \
        torch.where(keep, tok_ids, -1).reshape(-1)
    slot_token = slot_token[:, :capacity]
    # Switch aux loss: E * sum_e fraction_routed_e * mean_prob_e
    f = onehot.sum(dim=1).mean(dim=0)
    aux = E * torch.sum(f * probs.mean(dim=0))
    return {"expert": expert, "slot": slot, "keep": keep, "gate": gate,
            "slot_token": slot_token, "aux": aux}


def moe_layer(p, cfg, x):
    """x: (B, S, d). Returns (y, aux_loss)."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    capacity = int(np.ceil(T / E * cfg.capacity_factor * k))
    xt = x.reshape(T, d)
    plan = route_topk(xt @ p.router, k, capacity)
    # gather tokens into expert tiles: (E, C, d); empty slots read row 0
    # and are masked after
    st = plan["slot_token"]                                   # (E, C)
    xe = xt[st.clamp_min(0).long()]                           # (E, C, d)
    xe = torch.where((st >= 0)[..., None], xe, 0).to(x.dtype)
    ye = mlp(p.experts, xe, cfg.activation)                   # (E, C, d)
    # gather back per (token, choice) and combine with gates
    e_safe = torch.where(plan["keep"], plan["expert"], 0)
    s_safe = torch.where(plan["keep"], plan["slot"], 0).long()
    yt = ye[e_safe, s_safe]                                   # (T, k, d)
    w = (plan["gate"] * plan["keep"]).float()
    y = torch.einsum("tkd,tk->td", yt.float(), w)
    y = y.to(x.dtype).reshape(B, S, d)
    if hasattr(p, "shared"):
        y = y + mlp(p.shared, x, cfg.activation)
    return y, plan["aux"]
