"""The yardstick's arithmetic: the H100's float32 peak and a training
step's model FLOPs.

``param_count`` and ``train_flops`` are frozen copies of the program's
``roofline.analysis.param_count`` and ``model_flops`` (6 N D, N counting
the embedding) for the dense family."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_FLOPS_FP32 = 67e12      # float32 outside the tensor cores


def param_count(m: dict) -> tuple[int, int]:
    """(total, active) parameters, the embedding counted (once if tied)."""
    from .weights import padded_vocab
    d = m["d_model"]
    attn = 2 * d * m["n_heads"] * m["head_dim"] + \
        2 * d * m["n_kv_heads"] * m["head_dim"]
    emb = padded_vocab(m) * d * (1 if m.get("tie_embeddings") else 2)
    total = m["n_layers"] * (attn + 3 * d * m["d_ff"]) + emb
    return total, total


def train_flops(m: dict, tokens: int) -> float:
    return 6.0 * param_count(m)[1] * tokens
