"""mamba2-780m: SSD (state-space duality) LM [arXiv:2405.21060].
48L d_model=1536, attention-free, ssm_state=128, vocab 50280 (padded 50432
for TP divisibility), d_inner = 2*d = 3072, headdim 64 => 48 SSD heads."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,          # SSD heads (d_inner / ssm_head_dim)
    n_kv_heads=48,
    d_ff=0,              # attention/MLP-free: the Mamba2 block is the layer
    vocab_size=50_280,
    ssm_state=128,
    d_inner=3072,
    ssm_head_dim=64,
    ssm_groups=8,        # B/C groups (TP-friendly grouping)
    conv_kernel=4,
    activation="gelu",
    tie_embeddings=True,
)
