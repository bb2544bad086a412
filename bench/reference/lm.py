"""Plain float32 reference of the decoder LM the benchmark trains (family
``dense``), written from its equations in plain PyTorch: no
kernel, cache manager or batching of the program, and nothing imported
from it. The weights are a dict, name -> tensor, as ``harness.weights``
makes them; the sizes are the ``model`` group of a configuration file.

The equations, as the configuration runs them:

* ``x = embedding[tokens]``; per layer ``h = x + attn(norm(x))``, then
  ``h + ffn(norm(h))``; ``logits = norm(x) @ unembed`` (``embedding.T``
  where tied).
* ``norm(x) = x * rsqrt(mean(x^2) + eps) * (1 + offset)``.
* Attention: grouped-query heads, rotary angles ``pos / theta^(2i/D)``
  on the split halves of each head, scores ``q.k / sqrt(D)``, causal,
  softmax in float32.
* FFN: ``(silu(x Wg) * (x Wu)) Wd``.
* Training: mean cross-entropy of each next token; global-norm clipping;
  AdamW with linear warmup and cosine decay, float32 host scalars.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -0.7 * float(np.finfo(np.float32).max)
ADAM_EPS = 1e-8


def rmsnorm(x, offset, eps):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + offset)


def rope(x, pos, theta):
    """x: (B, S, H, D); pos: (B, S) or (S,) integer positions."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (np.arange(0, d, 2) / d))
    inv = torch.tensor(inv.astype(np.float32), device=x.device)
    ang = pos[..., None].float() * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    a, b = x.chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def _heads(m):
    return m["n_heads"], m["n_kv_heads"], m["head_dim"]


def _qkv(w, p, x, m):
    B, S, _ = x.shape
    H, G, D = _heads(m)
    q = (x @ w[f"{p}.attn.wq"]).reshape(B, S, H, D)
    k = (x @ w[f"{p}.attn.wk"]).reshape(B, S, G, D)
    v = (x @ w[f"{p}.attn.wv"]).reshape(B, S, G, D)
    return q, k, v


def _attend(w, p, q, k, v, valid, m):
    """q: (B, S, H, D); k, v: (B, T, G, D); valid: broadcastable to
    (B, G, R, S, T)."""
    B, S, H, D = q.shape
    G = k.shape[2]
    qg = q.reshape(B, S, G, H // G, D)
    s = torch.einsum("bsgrd,btgd->bgrst", qg, k) / math.sqrt(D)
    a = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    o = torch.einsum("bgrst,btgd->bsgrd", a, v).reshape(B, S, H * D)
    return o @ w[f"{p}.attn.wo"]


def attention(w, p, x, m):
    """Full causal attention over ``x`` (B, S, d) from position 0."""
    S = x.shape[1]
    q, k, v = _qkv(w, p, x, m)
    pos = torch.arange(S, device=x.device)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    causal = pos[None, :] <= pos[:, None]
    return _attend(w, p, q, k, v, causal, m)


def ffn(w, p, x):
    return (F.silu(x @ w[f"{p}.w_gate"]) * (x @ w[f"{p}.w_up"])) \
        @ w[f"{p}.w_down"]


def layer(w, p, x, m):
    """One block over the full sequence."""
    eps = m.get("norm_eps", 1e-6)
    h = x + attention(w, p, rmsnorm(x, w[f"{p}.ln_attn.scale"], eps), m)
    return h + ffn(w, f"{p}.mlp", rmsnorm(h, w[f"{p}.ln_mlp.scale"], eps))


def head(w, x, m):
    x = rmsnorm(x, w["ln_f.scale"], m.get("norm_eps", 1e-6))
    if "embed.unembed" in w:
        return x @ w["embed.unembed"]
    return x @ w["embed.embedding"].t()


def forward(w, tokens, m):
    """Logits (B, S, V) of ``tokens``."""
    x = w["embed.embedding"][tokens]
    for i in range(m["n_layers"]):
        x = layer(w, f"blocks.{i}", x, m)
    return head(w, x, m)


def nll_sum(logits, tokens):
    """The summed cross-entropy of each next token, and their count."""
    lg, lab = logits[:, :-1], tokens[:, 1:]
    gold = torch.gather(lg, -1, lab[..., None])[..., 0]
    return (torch.logsumexp(lg, dim=-1) - gold).sum(), lab.numel()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def lr_at(hp: dict, step: int) -> np.float32:
    f = np.float32
    s = f(step)
    warm = min(s / f(max(hp["warmup_steps"], 1)), f(1.0))
    t = (s - f(hp["warmup_steps"])) / f(max(hp["total_steps"]
                                            - hp["warmup_steps"], 1))
    t = min(max(t, f(0.0)), f(1.0))
    cos = f(0.5) * (f(1.0) + f(math.cos(f(math.pi) * t)))
    return f(hp["learning_rate"]) * warm * (f(0.1) + f(0.9) * cos)


def decayed(name: str, t) -> bool:
    """AdamW decays the matrices and every layer's norm offsets; not the
    final norm's."""
    return t.ndim >= 2 or name.startswith("blocks.")


def train_steps(w, batches, m, hp, rows: int = 0):
    """Runs ``len(batches)`` steps from the weights ``w`` (name ->
    tensor, updated in place) and returns per step the loss, and after
    the first step the norm of each leaf's clipped gradient, the
    gradient as AdamW gets it. ``rows`` > 0 takes the gradient of each
    batch in blocks of that many rows (the same sums, less memory)."""
    params = {k: t.detach().requires_grad_() for k, t in w.items()}
    mu = {k: torch.zeros_like(t) for k, t in params.items()}
    nu = {k: torch.zeros_like(t) for k, t in params.items()}
    losses, grad_norms = [], None
    b1, b2, wd = hp["beta1"], hp["beta2"], hp["weight_decay"]
    for step, tokens in enumerate(batches, 1):
        B = tokens.shape[0]
        n = rows or B
        count = tokens[:, 1:].numel()
        total = 0.0
        for r in range(0, B, n):
            logits = forward(params, tokens[r:r + n], m)
            s, _ = nll_sum(logits, tokens[r:r + n])
            loss = s / count
            loss.backward()
            total += float(loss.detach())
            del logits, loss
        losses.append(total)
        with torch.no_grad():
            grads = {k: p.grad for k, p in params.items()}
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(hp["grad_clip"] / (norm + 1e-6), max=1.0)
            for g in grads.values():
                g.mul_(scale)
            if step == 1:
                grad_norms = {k: float(torch.linalg.vector_norm(g))
                              for k, g in grads.items()}
            lr = torch.tensor(lr_at(hp, step), device=norm.device)
            bc1 = torch.tensor(np.float32(1) - np.float32(b1) ** np.float32(
                step), device=norm.device)
            bc2 = torch.tensor(np.float32(1) - np.float32(b2) ** np.float32(
                step), device=norm.device)
            for k, p in params.items():
                g, mk, vk = grads[k], mu[k], nu[k]
                mk.mul_(b1).add_(g * (1 - b1))
                vk.mul_(b2).add_(g * (1 - b2) * g)
                delta = (mk / bc1) / ((vk / bc2).sqrt() + ADAM_EPS)
                if decayed(k, p):
                    delta = delta + wd * p
                p.copy_(p - lr * delta)
                p.grad = None
            del grads
    return losses, grad_norms
