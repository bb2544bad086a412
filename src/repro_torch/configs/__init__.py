"""Architecture registry: ``--arch <id>`` resolution."""
from . import (
    deepseek_moe_16b,
    granite_3_2b,
    internvl2_76b,
    mamba2_780m,
    phi35_moe,
    qwen15_32b,
    qwen25_32b,
    recurrentgemma_2b,
    whisper_tiny,
    yi_6b,
)
from .base import SHAPES, ModelConfig, RunConfig, ShapeConfig, shape_applicable

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        mamba2_780m, internvl2_76b, yi_6b, qwen15_32b, granite_3_2b,
        qwen25_32b, phi35_moe, deepseek_moe_16b, recurrentgemma_2b,
        whisper_tiny,
    )
}


def get_arch(name: str, smoke: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    cfg = ARCHS[name]
    return cfg.smoke() if smoke else cfg


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "RunConfig", "ShapeConfig",
           "get_arch", "shape_applicable"]
