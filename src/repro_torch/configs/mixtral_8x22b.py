"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2.

Source: the model card and ``config.json`` of mistralai/Mixtral-8x22B-v0.1
(Mistral AI, April 2024), whose ``sliding_window`` is null: the 8x22B
release attends over its full 65,536 positions.  The ``swa`` window of
4096 here is this repository's own, kept as the reference package has
it.  arXiv:2401.04088 gives the block's equations, for the 8x7B sibling
only."""
import dataclasses

from repro_torch.configs.base import AttentionPattern, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    attn=AttentionPattern(kind="swa", window=4096),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=16384),
    rope_theta=1e6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        attn=AttentionPattern(kind="swa", window=32),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128,
                      capacity_factor=4.0))
