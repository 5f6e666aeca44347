"""Config registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``.

Arch ids use the dashed names; module files use underscores.  Only the
dense architectures the port serves are registered so far.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

ARCH_IDS: List[str] = [
    "olmo-1b",
]


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown or unported arch {arch_id!r}; the port "
                         f"has {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()
