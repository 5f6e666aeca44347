"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global, 128k context.
[hf:google/gemma-3-1b-pt]"""
import dataclasses

from repro_torch.configs.base import AttentionPattern, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    attn=AttentionPattern(kind="local_global", window=512, local_ratio=5),
    rope_theta=1e6,
    tie_embeddings=True,
    # §Perf: zero-padded dead heads (H 4->16, kv 1->4) shard attention
    # 16-ways at a 4x padded-compute cost — net ~4x (see smollm note)
    head_pad_multiple=16,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma3-smoke", n_layers=4, d_model=64, n_heads=2,
        n_kv_heads=1, head_dim=32, d_ff=128, vocab=512,
        attn=AttentionPattern(kind="local_global", window=16, local_ratio=1))
