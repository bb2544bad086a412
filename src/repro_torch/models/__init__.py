"""Model zoo: dense/GQA, MoE, Mamba2-SSD, RG-LRU hybrid, enc-dec, VLM.

The reference's ``input_specs``, ``cache_specs`` and ``param_specs`` (shape
stand-ins for its dry run) are not ported yet."""
from .registry import build_model
from .transformer import LM
from .whisper import EncDec

__all__ = ["build_model", "LM", "EncDec"]
