"""recurrentgemma-2b: Griffin-style hybrid — RG-LRU recurrent blocks with
1:2 local attention [arXiv:2402.19427]. 26L d=2560, pattern (rec, rec, attn),
10H MQA kv=1 head_dim 256, window 2048, lru_width 2560, GeGLU d_ff 7680."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    window=2048,
    activation="geglu",
    logits_soft_cap=30.0,
    tie_embeddings=True,
)
