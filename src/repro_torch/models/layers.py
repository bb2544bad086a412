"""Shared neural-net layers: parameter modules and plain functions on
tensors (float32 math for norms, RoPE and logits, whatever the dtype of the
weights).

A layer's parameters live in a small ``nn.Module`` whose parameter names
are the reference's parameter keys, so that ``convert.lm_params_from_numpy``
is a copy; the forward math is a plain function taking that module, as
``rmsnorm(p, x)``. Weights keep the reference's ``(d_in, d_out)`` layout and
are applied as ``x @ W``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def target_device(device) -> torch.device:
    """The device a model is built on: the card unless ``device`` says
    otherwise; a card that is asked for and absent raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' needs a CUDA device and none is available; "
            "pass device='cpu' to run on the host")
    return dev


def seeded(device: torch.device, seed: int = 0) -> torch.Generator | None:
    """A generator on ``device`` seeded with ``seed``; None on the meta
    device, which has no generator and where nothing is drawn."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def truncated_normal(shape, scale, *, dtype, device, generator):
    """``scale`` times a normal cut at +-2, drawn in float32 (on the meta
    device only the shape and dtype)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * scale).to(dtype)


def dense_init(d_in, d_out, *, dtype, device, generator, scale=None,
               n: int = 0):
    """A ``(d_in, d_out)`` weight (``(n, d_in, d_out)`` for ``n`` stacked
    experts) at scale ``1/sqrt(d_in)`` unless given."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    shape = (n, d_in, d_out) if n else (d_in, d_out)
    return truncated_normal(shape, scale, dtype=dtype, device=device,
                            generator=generator)


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=t.is_floating_point())


def scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a constant cast to the dtype of
    the tensor it multiplies."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


class RMSNorm(nn.Module):
    def __init__(self, d, *, dtype, device):
        super().__init__()
        self.scale = param(torch.zeros(d, dtype=dtype, device=device))


def rmsnorm(p, x, eps=1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p.scale.float())).to(dt)


class LayerNorm(nn.Module):
    def __init__(self, d, *, dtype, device):
        super().__init__()
        self.scale = param(torch.ones(d, dtype=dtype, device=device))
        self.bias = param(torch.zeros(d, dtype=dtype, device=device))


def layernorm(p, x, eps=1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(dt)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Gated (swiglu/geglu) or plain (gelu) MLP; ``n > 0`` stacks ``n``
    experts on a leading axis (their ``x`` is ``(n, C, d)``)."""

    def __init__(self, d_model, d_ff, activation, *, dtype, device,
                 generator, n: int = 0):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator, n=n)
        if activation in ("swiglu", "geglu"):
            self.w_gate = param(dense_init(d_model, d_ff, **kw))
        self.w_up = param(dense_init(d_model, d_ff, **kw))
        self.w_down = param(dense_init(d_ff, d_model, **kw))


def gelu(x):
    # the tanh form, the reference's default (torch's default is erf)
    return F.gelu(x, approximate="tanh")


def mlp(p, x, activation):
    if activation == "swiglu":
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    elif activation == "geglu":
        h = gelu(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = gelu(x @ p.w_up)
    return h @ p.w_down


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, vocab, d_model, tie: bool, *, dtype, device,
                 generator):
        super().__init__()
        self.embedding = param(truncated_normal(
            (vocab, d_model), 0.02, dtype=dtype, device=device,
            generator=generator))
        if not tie:
            self.unembed = param(dense_init(d_model, vocab, dtype=dtype,
                                            device=device,
                                            generator=generator))


def embed(table, tokens):
    return F.embedding(tokens.long(), table)


def unembed(p, x, soft_cap: float = 0.0):
    if hasattr(p, "unembed"):
        logits = x @ p.unembed
    else:
        logits = x @ p.embedding.T.to(x.dtype)
    logits = logits.float()
    if soft_cap > 0.0:
        logits = soft_cap * torch.tanh(logits / soft_cap)
    return logits


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=64)
def _freqs(head_dim: int, theta: float, device: torch.device):
    # made once per device: a copy from the host inside a decode step would
    # wait for the card
    return torch.from_numpy(rope_freqs(head_dim, theta).astype(
        np.float32)).to(device)


def apply_rope(x, positions, theta):
    """x: (B, S, H, D); positions: (B, S) or (S,). Split halves (not
    interleaved), angles in float32."""
    d = x.shape[-1]
    freqs = _freqs(d, float(theta), x.device)                 # (d/2,)
    ang = positions[..., None].float() * freqs                # (B,S,d/2)
    cos = torch.cos(ang)[..., None, :]                        # (B,S,1,d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoidal_positions(n, d):
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, ignore: int = -100):
    """Mean CE over non-ignored positions; logits f32 (B,S,V), labels (B,S)."""
    mask = labels != ignore
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1)
