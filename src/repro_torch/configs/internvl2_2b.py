"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT + InternLM2.  [arXiv:2404.16821; hf]

Backbone = the InternLM2-1.8B decoder; the InternViT frontend is a stub
(1024 precomputed patch embeddings prepended per the assignment).
"""
import dataclasses

from repro_torch.configs.base import AttentionPattern, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    attn=AttentionPattern(kind="full"),
    frontend="vision",
    frontend_tokens=1024,
    rope_theta=1e6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="internvl2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, frontend_tokens=8)
