"""whisper-tiny: encoder-decoder audio transformer [arXiv:2212.04356].
4+4L d=384 6H d_ff=1536 vocab 51865 (padded 52096). The conv/mel frontend is
a STUB per the brief: input_specs() provides precomputed 1500-frame
embeddings; the transformer backbone (enc self-attn, dec self+cross attn)
is fully implemented."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,              # decoder layers
    encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    activation="gelu",
    tie_embeddings=True,
)
