"""Modality frontend stubs (counterpart of ``repro/models/frontends.py``).

The ``[vlm]`` and ``[audio]`` configs specify the transformer backbone
only; the frontend's output arrives as precomputed patch or frame
embeddings.  These helpers fabricate plausible frontend outputs for tests
and ``chip_smoke.py`` and write the shape contract down in one place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig


def frontend_embed_shape(cfg: ModelConfig, batch: int,
                         seq_len: int) -> Optional[Tuple[int, int, int]]:
    """Shape of the precomputed embeddings the backbone consumes."""
    if cfg.frontend == "vision":
        return (batch, cfg.frontend_tokens, cfg.d_model)
    if cfg.frontend == "audio":
        return (batch, seq_len, cfg.d_model)   # encoder frames
    return None


def fake_frontend(generator: torch.Generator, cfg: ModelConfig, batch: int,
                  seq_len: int, dtype=torch.bfloat16,
                  device="cuda") -> torch.Tensor:
    """Normal f32 values from ``generator`` (on ``device``), cast to
    ``dtype`` and then scaled by 0.02, in the reference's order."""
    shape = frontend_embed_shape(cfg, batch, seq_len)
    if shape is None:
        raise ValueError(f"{cfg.name} has no frontend")
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return x.to(dtype) * 0.02


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens accompanying the frontend prefix (VLM)."""
    if cfg.frontend == "vision":
        return seq_len - cfg.frontend_tokens
    return seq_len
