"""olmo-1b [dense] — 16L d_model=2048 16H (GQA kv=16) d_ff=8192
vocab=50304 — non-parametric LN.  [arXiv:2402.00838; hf]"""
import dataclasses

from repro_torch.configs.base import AttentionPattern, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab=50304,
    attn=AttentionPattern(kind="full"),
    parametric_norm=False,          # OLMo's non-parametric LayerNorm
    tie_embeddings=True,
    rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="olmo-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=256)
