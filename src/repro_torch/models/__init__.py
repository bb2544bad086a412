"""Model zoo: dense/GQA, MoE, Mamba2-SSD, RG-LRU hybrid, enc-dec, VLM."""
from .registry import build_model, cache_specs, input_specs, param_specs
from .transformer import LM
from .whisper import EncDec

__all__ = ["build_model", "cache_specs", "input_specs", "param_specs",
           "LM", "EncDec"]
