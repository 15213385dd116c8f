"""Config registry: ``get_arch(id)`` / ``ARCHS`` plus shape registry."""

from .base import (
    ArchConfig,
    MLACfg,
    MoECfg,
    SSMCfg,
    ShapeConfig,
    SHAPES,
    act_dtype,
    input_specs,
    reduced,
    step_kind,
)
from .recurrentgemma_9b import CONFIG as recurrentgemma_9b
from .glm4_9b import CONFIG as glm4_9b
from .gemma3_4b import CONFIG as gemma3_4b
from .qwen15_110b import CONFIG as qwen15_110b
from .nemotron4_15b import CONFIG as nemotron4_15b
from .deepseek_v2_lite_16b import CONFIG as deepseek_v2_lite_16b
from .granite_moe_1b import CONFIG as granite_moe_1b
from .whisper_medium import CONFIG as whisper_medium
from .mamba2_370m import CONFIG as mamba2_370m
from .internvl2_26b import CONFIG as internvl2_26b

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        recurrentgemma_9b,
        glm4_9b,
        gemma3_4b,
        qwen15_110b,
        nemotron4_15b,
        deepseek_v2_lite_16b,
        granite_moe_1b,
        whisper_medium,
        mamba2_370m,
        internvl2_26b,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def cells(include_skipped: bool = False):
    """All assigned (arch × shape) cells; long_500k only where applicable."""
    out = []
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and not arch.supports_long_context
            if skipped and not include_skipped:
                continue
            out.append((arch, shape, skipped))
    return out


__all__ = [
    "ArchConfig",
    "MLACfg",
    "MoECfg",
    "SSMCfg",
    "ShapeConfig",
    "SHAPES",
    "act_dtype",
    "input_specs",
    "reduced",
    "step_kind",
    "ARCHS",
    "get_arch",
    "cells",
]
