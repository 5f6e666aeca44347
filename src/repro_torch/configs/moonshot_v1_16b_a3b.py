"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
import dataclasses

from repro_torch.configs.base import AttentionPattern, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    attn=AttentionPattern(kind="full"),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408),
    rope_theta=5e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=64, vocab=512,
        moe=MoEConfig(num_experts=8, top_k=3, d_expert=64,
                      capacity_factor=4.0))
