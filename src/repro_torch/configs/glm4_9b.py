"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE, GQA.  [hf:THUDM/glm-4-9b; hf]"""
import dataclasses

from repro_torch.configs.base import AttentionPattern, ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=151552,
    attn=AttentionPattern(kind="full"),
    rope_theta=5e6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="glm4-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab=512)
