"""phi3.5-moe-42b-a6.6b: 16-expert top-2 MoE
[hf:microsoft/Phi-3.5-MoE-instruct]. 32L d=4096 32H GQA kv=8 d_ff=6400/expert
vocab 32064."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    n_experts=16,
    top_k=2,
)
