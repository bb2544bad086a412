"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427].

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill evaluates the diagonal linear recurrence with a log-depth scan
(Hillis-Steele: ceil(log2 L) rounds of elementwise products); decode is a
single step carrying (conv_state, h). The scan combines terms in another
order than the reference's associative scan, so the two agree within a
float32 tolerance, not bit for bit. The surrounding block is Griffin's
recurrent block: two input branches, a width-4 causal conv on the
recurrent branch, GeLU gating on the other, and an output projection.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init, gelu, param, truncated_normal

_C = 8.0


class RGLRU(nn.Module):
    def __init__(self, cfg, *, dtype, device, generator):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width
        kw = dict(dtype=dtype, device=device, generator=generator)
        f32 = dict(dtype=torch.float32, device=device)
        # Lambda init so a^c in [0.9, 0.999] (Griffin appendix)
        u = torch.empty(w, **f32).uniform_(0.9, 0.999, generator=generator)
        self.w_x = param(dense_init(d, w, **kw))      # recurrent branch
        self.w_y = param(dense_init(d, w, **kw))      # gate branch
        self.conv_w = param(truncated_normal((4, w), 0.5, **kw))
        self.conv_b = param(torch.zeros(w, dtype=dtype, device=device))
        self.w_a = param(dense_init(w, w, **kw))
        self.b_a = param(torch.zeros(w, **f32))
        self.w_i = param(dense_init(w, w, **kw))
        self.b_i = param(torch.zeros(w, **f32))
        # softplus^-1(-log u / c)
        self.lam = param(torch.log(torch.expm1(-torch.log(u) / _C)))
        self.w_out = param(dense_init(w, d, **kw))


def _conv(p, u, state=None):
    K = p.conv_w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], K - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    L = u.shape[1]
    w = p.conv_w.to(u.dtype)
    y = sum(full[:, j:j + L] * w[j] for j in range(K))
    return y + p.conv_b.to(u.dtype), full[:, -(K - 1):, :]


def _gates(p, x):
    """x: (..., w) -> (a, gated_input) in f32."""
    x32 = x.float()
    r = torch.sigmoid(x32 @ p.w_a.float() + p.b_a)
    i = torch.sigmoid(x32 @ p.w_i.float() + p.b_i)
    log_a = -_C * F.softplus(p.lam) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * (i * x32)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1 from h_0 = 0: an inclusive scan of
    the pairs (a, b) under (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), in
    ceil(log2 L) rounds."""
    L = a.shape[1]
    off = 1
    while off < L:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return b


def rglru(p, x, h0=None):
    """x: (B, L, w). Returns (y, h_last)."""
    a, bx = _gates(p, x)                       # (B,L,w) f32
    if h0 is not None:
        # fold carried state into the first step: h_1 = a_1 h0 + b_1
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0.float()[:, None],
                        bx[:, 1:]], dim=1)
    h = linear_scan(a, bx)
    return h.to(x.dtype), h[:, -1]


def rglru_step(p, x, h):
    """Single decode step. x: (B, 1, w); h: (B, w) f32."""
    a, bx = _gates(p, x)
    hn = a[:, 0] * h.float() + bx[:, 0]
    return hn[:, None, :].to(x.dtype), hn


def recurrent_block(p, x, *, conv_state=None, h_state=None, decode=False):
    """Griffin recurrent block. x: (B, L, d). Returns (y, (conv, h))."""
    branch = x @ p.w_x
    gate = gelu(x @ p.w_y)
    conv_out, new_conv = _conv(p, branch, conv_state if decode else None)
    if decode:
        h, new_h = rglru_step(p, conv_out, h_state)
    else:
        h, new_h = rglru(p, conv_out, h0=h_state)
    return (h * gate) @ p.w_out, (new_conv, new_h)
