"""Architecture registry: --arch <id> resolves here.

The ten model configurations of ``repro.configs``, field for field, and
the assigned (architecture x input shape) cells of the compile-only
accounting (``SHAPES``, ``shapes_for``, ``all_cells``).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, RunConfig,
                                      ShapeConfig)

_MODULES = {
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "mixtral-8x22b": "mixtral_8x22b",
    "musicgen-medium": "musicgen_medium",
    "minicpm-2b": "minicpm_2b",
    "gemma2-9b": "gemma2_9b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen1.5-110b": "qwen1_5_110b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
}

ARCH_IDS = tuple(_MODULES)

#: long_500k applicability: sub-quadratic attention only
LONG_CONTEXT_ARCHS = ("jamba-v0.1-52b", "falcon-mamba-7b", "mixtral-8x22b")


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def shapes_for(arch: str) -> tuple[ShapeConfig, ...]:
    """The assigned shape cells of one architecture: train, prefill and
    decode, and ``long_500k`` for the sub-quadratic ones."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if arch in LONG_CONTEXT_ARCHS:
        out.append(SHAPES["long_500k"])
    return tuple(out)


def all_cells() -> list[tuple[str, ShapeConfig]]:
    return [(a, s) for a in ARCH_IDS for s in shapes_for(a)]


__all__ = ["ARCH_IDS", "LONG_CONTEXT_ARCHS", "SHAPES", "ModelConfig",
           "RunConfig", "ShapeConfig", "get_config", "get_smoke_config",
           "shapes_for", "all_cells"]
