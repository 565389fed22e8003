"""Config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

Lists the archs the port serves and trains so far.  The JAX package's
other archs need the MoE or prefix-frontend slices of the port.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig  # noqa: F401

_MODULES: Dict[str, str] = {
    "qwen3-4b": "qwen3_4b",
    "mamba2-780m": "mamba2_780m",
}

ARCH_IDS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()
