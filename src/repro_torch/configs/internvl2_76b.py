"""internvl2-76b: InternViT frontend (STUB) + 76B-class LM backbone
[arXiv:2404.16821]. LM: 80L d=8192 64H GQA kv=8 d_ff=28672 vocab 128256.
The vision tower is stubbed: input_specs() provides precomputed patch
embeddings (256 image tokens) that a projector maps into the LM stream."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    num_image_tokens=256,
    rope_theta=500_000.0,
)
