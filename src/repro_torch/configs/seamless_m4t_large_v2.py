"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206 — enc-dec, multimodal.  [arXiv:2308.11596; hf]

Backbone only, as in the reference: 24 encoder + 24 decoder layers; the
audio frontend is a stub (precomputed frame embeddings,
``models/frontends.py``).
"""
import dataclasses

from repro_torch.configs.base import AttentionPattern, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                  # decoder stack
    n_encoder_layers=24,          # encoder stack
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    attn=AttentionPattern(kind="full"),
    frontend="audio",
    rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="seamless-smoke", n_layers=2, n_encoder_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab=512)
