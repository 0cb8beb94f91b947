"""Architecture registry: --arch <id> resolves here.

The ten model configurations of ``repro.configs``, field for field.  The
port's model code runs the dense attention families; the MoE, SSM, hybrid,
audio and vision configurations are priced as whole-model decode traffic
(``repro_torch.models.trace``), and ``models.transformer`` refuses to build
them before any weight is made.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, RunConfig

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


__all__ = ["ARCH_IDS", "LONG_CONTEXT_ARCHS", "ModelConfig", "RunConfig", "get_config",
           "get_smoke_config"]
