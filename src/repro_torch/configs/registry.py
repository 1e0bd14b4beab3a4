"""Architecture registry of the port: every arch of the JAX registry."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
