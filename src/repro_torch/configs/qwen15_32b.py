"""qwen1.5-32b: dense LM with QKV bias [hf:Qwen/Qwen1.5 family].
64L d=5120 40H (kv=40: MHA) d_ff=27392 vocab 152064."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27_392,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
