"""Config registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``.

Arch ids use the dashed names; module files use underscores.  Every
architecture of the reference is registered, in its order: the dense
(olmo-1b, gemma3-1b, smollm-360m, glm4-9b), MoE (moonshot-v1-16b-a3b,
mixtral-8x22b), SSM (mamba2-780m), hybrid (zamba2-7b) and VLM
(internvl2-2b) families, and the enc-dec seamless-m4t-large-v2 (family
"audio").
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

ARCH_IDS: List[str] = [
    "mixtral-8x22b",
    "moonshot-v1-16b-a3b",
    "mamba2-780m",
    "zamba2-7b",
    "glm4-9b",
    "gemma3-1b",
    "olmo-1b",
    "smollm-360m",
    "seamless-m4t-large-v2",
    "internvl2-2b",
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
