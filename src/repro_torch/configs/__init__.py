"""Architecture registry: --arch <id> resolves here.

The port carries the configurations its slices serve; the others of
``repro.configs`` come with the slices that run their model families.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, RunConfig

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


__all__ = ["ARCH_IDS", "ModelConfig", "RunConfig", "get_config",
           "get_smoke_config"]
