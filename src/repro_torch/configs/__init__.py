"""Architecture registry of the port: --arch <id> -> ArchConfig (the same
ten configurations as the reference's, as plain data)."""

from .base import SHAPES, ArchConfig, ShapeConfig
from .codeqwen15_7b import CONFIG as codeqwen15_7b
from .deepseek_v3_671b import CONFIG as deepseek_v3_671b
from .granite_20b import CONFIG as granite_20b
from .granite_moe_3b import CONFIG as granite_moe_3b
from .h2o_danube3_4b import CONFIG as h2o_danube3_4b
from .llama32_vision_90b import CONFIG as llama32_vision_90b
from .mamba2_130m import CONFIG as mamba2_130m
from .recurrentgemma_9b import CONFIG as recurrentgemma_9b
from .seamless_m4t_v2 import CONFIG as seamless_m4t_v2
from .smollm_135m import CONFIG as smollm_135m

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        mamba2_130m,
        deepseek_v3_671b,
        granite_moe_3b,
        codeqwen15_7b,
        granite_20b,
        h2o_danube3_4b,
        smollm_135m,
        recurrentgemma_9b,
        llama32_vision_90b,
        seamless_m4t_v2,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "get_arch"]
