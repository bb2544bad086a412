"""deepseek-moe-16b: fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066]. 28L d=2048 16H (kv=16: MHA) d_ff=1408/expert
vocab 102400; layer 0 is a dense FFN (d_ff 10944) per the paper."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    first_layer_dense=True,
    dense_d_ff=10_944,
)
