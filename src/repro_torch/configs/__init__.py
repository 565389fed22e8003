"""Config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

Lists every arch of the JAX package's registry, in its order; the port
serves and trains each of them.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

_MODULES: Dict[str, str] = {
    "dbrx-132b": "dbrx_132b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen3-8b": "qwen3_8b",
    "minitron-4b": "minitron_4b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-780m": "mamba2_780m",
    "qwen3-4b": "qwen3_4b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen1.5-110b": "qwen1_5_110b",
}

ARCH_IDS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
