"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060].

Chunked SSD algorithm: within chunks of Q tokens the recurrence is
evaluated as (masked) matmuls, and a loop over chunks carries the (H, P, N)
recurrent state across them, so prefill is linear in sequence length and
decode carries O(H*P*N) state.

Block = in_proj -> short conv (x,B,C) -> SSD -> gated RMSNorm -> out_proj.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import RMSNorm, dense_init, param, rmsnorm, truncated_normal


class SSD(nn.Module):
    def __init__(self, cfg, *, dtype, device, generator):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
        kw = dict(dtype=dtype, device=device, generator=generator)
        d_in_proj = 2 * di + 2 * G * N + H
        conv_dim = di + 2 * G * N
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = param(dense_init(d, d_in_proj, **kw))
        self.conv_w = param(truncated_normal(
            (cfg.conv_kernel, conv_dim), 1.0 / np.sqrt(cfg.conv_kernel), **kw))
        self.conv_b = param(torch.zeros(conv_dim, dtype=dtype, device=device))
        self.a_log = param(torch.log(torch.linspace(1.0, 16.0, H, **f32)))
        self.d_skip = param(torch.ones(H, **f32))
        u = torch.empty(H, **f32).uniform_(np.log(1e-3), np.log(1e-1),
                                           generator=generator)
        self.dt_bias = param(torch.log(torch.expm1(torch.exp(u))))
        self.norm = RMSNorm(di, dtype=dtype, device=device)
        self.out_proj = param(dense_init(di, d, **kw))


def _split_proj(cfg, zxbcdt):
    di, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return torch.split(zxbcdt, [di, di, G * N, G * N,
                                zxbcdt.shape[-1] - 2 * di - 2 * G * N], -1)


def _conv(p, u, state=None):
    """Causal depthwise short conv. u: (B, L, C). Returns (y, new_state)."""
    K = p.conv_w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], K - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                      # (B, L+K-1, C)
    L = u.shape[1]
    w = p.conv_w.to(u.dtype)
    y = sum(full[:, j:j + L] * w[j] for j in range(K))
    y = y + p.conv_b.to(u.dtype)
    return F.silu(y), full[:, -(K - 1):, :] if K > 1 else None


def _segsum(x):
    """(..., Q) -> (..., Q, Q) lower-triangular segment sums."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    lower = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    return torch.where(lower, seg, -torch.inf)


def ssd_scan(cfg, x, dt, B, C, a_log, init_state=None):
    """Chunked SSD. x: (b,L,H,P); dt: (b,L,H) (post-softplus);
    B, C: (b,L,G,N). Returns (y (b,L,H,P), final_state (b,H,P,N))."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(cfg.ssm_chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q
    rep = H // G
    A = -torch.exp(a_log)                                  # (H,)

    f32 = torch.float32
    xc = x.to(f32).reshape(b, nc, Q, H, P)
    dtc = dt.to(f32).reshape(b, nc, Q, H)
    Bc = B.to(f32).reshape(b, nc, Q, G, N)
    Cc = C.to(f32).reshape(b, nc, Q, G, N)
    dA = dtc * A[None, None, None, :]                      # (b,nc,Q,H)

    # intra-chunk (diagonal block): decay matrix per head
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))      # (b,nc,H,Q,Q)
    CB = torch.einsum("bcqgn,bcsgn->bcgqs", Cc, Bc)        # (b,nc,G,Q,S)
    CB = torch.repeat_interleave(CB, rep, dim=2)           # (b,nc,H,Q,S)
    dtx = dtc[..., None] * xc                              # dt-weighted input
    if getattr(cfg, "ssd_bf16", False):
        # bf16 operands, f32 accumulation
        bf = torch.bfloat16
        y_diag = torch.einsum("bchqs,bcshp->bcqhp",
                              (CB * Lmat).to(bf).to(f32),
                              dtx.to(bf).to(f32))
    else:
        y_diag = torch.einsum("bchqs,bcshp->bcqhp", CB * Lmat, dtx)

    # per-chunk input -> state contribution:
    #   sum_q exp(sum_{s>q} dA_s) * dt_q B_q x_q
    total = torch.sum(dA, dim=2, keepdim=True)             # (b,nc,1,H)
    decay_states = torch.exp(total - torch.cumsum(dA, dim=2))  # (b,nc,Q,H)
    Brep = torch.repeat_interleave(Bc, rep, dim=3) if rep > 1 else Bc
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Brep, decay_states, dtx)

    # inter-chunk recurrence over chunk states, one chunk at a time
    chunk_decay = torch.exp(torch.sum(dA, dim=2))          # (b,nc,H)
    h = (torch.zeros((b, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    prev = []                                              # state entering c
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                        # (b,nc,H,P,N)

    # contribution of carried state to outputs inside each chunk:
    #   y_q += C_q . (exp(sum_{s<=q} dA_s) * h_prev)
    state_decay = torch.exp(torch.cumsum(dA, dim=2))       # (b,nc,Q,H)
    Crep = torch.repeat_interleave(Cc, rep, dim=3) if rep > 1 else Cc
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Crep, prev, state_decay)

    y = (y_diag + y_off).reshape(b, L, H, P)
    return y.to(x.dtype), h


def ssd_block(p, cfg, x, *, conv_state=None, ssm_state=None, decode=False):
    """Full Mamba2 block. x: (B, L, d_model). Returns (y, (conv_st, ssm_st)).

    The reference's ``ssd_shard_heads`` option only places the SSD
    intermediates on a mesh axis; on one card it has no meaning and is
    ignored.
    """
    H, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    zxbcdt = x @ p.in_proj
    z, xin, B, C, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, B, C], dim=-1)
    conv_out, new_conv = _conv(p, conv_in, conv_state if decode else None)
    xin, B, C = torch.split(conv_out, [cfg.d_inner, G * N, G * N], -1)
    b, L = x.shape[0], x.shape[1]
    xh = xin.reshape(b, L, H, P)
    Bh = B.reshape(b, L, G, N)
    Ch = C.reshape(b, L, G, N)
    dth = F.softplus(dt.float() + p.dt_bias[None, None, :])  # (b,L,H)
    if decode:
        # single-token recurrence: h = h*exp(dt*A) + dt*B*x
        A = -torch.exp(p.a_log)
        dA = torch.exp(dth[:, 0] * A[None, :])             # (b,H)
        rep = H // G
        if G != H:
            Bx = torch.repeat_interleave(Bh[:, 0], rep, dim=1).reshape(b, H, N)
            Cx = torch.repeat_interleave(Ch[:, 0], rep, dim=1).reshape(b, H, N)
        else:
            Bx, Cx = Bh[:, 0], Ch[:, 0]
        dtx = dth[:, 0, :, None] * xh[:, 0].float()
        h = ssm_state.float() * dA[..., None, None] \
            + dtx[..., None] * Bx[:, :, None, :]
        y = torch.einsum("bhpn,bhn->bhp", h, Cx.float())
        y = y + p.d_skip[None, :, None] * xh[:, 0].float()
        y = y.reshape(b, 1, H * P).to(x.dtype)
        new_ssm = h
    else:
        y, new_ssm = ssd_scan(cfg, xh, dth, Bh, Ch, p.a_log,
                              init_state=ssm_state)
        y = y + p.d_skip.to(x.dtype)[None, None, :, None] * xh
        y = y.reshape(b, L, H * P)
    y = rmsnorm(p.norm, y * F.silu(z))
    return y @ p.out_proj, (new_conv, new_ssm)
