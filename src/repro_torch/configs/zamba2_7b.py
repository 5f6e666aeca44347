"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
(applied every 6 layers, weights shared).  [arXiv:2411.15242]"""
import dataclasses

from repro_torch.configs.base import AttentionPattern, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    attn=AttentionPattern(kind="full"),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4, chunk=128),
    shared_attn_every=6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-smoke", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
        ssm=SSMConfig(d_state=16, head_dim=8, expand=2, d_conv=4, chunk=16),
        shared_attn_every=2)
