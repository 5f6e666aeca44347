"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 — llama-arch small.  [hf:HuggingFaceTB/SmolLM; hf]

15 heads / kv=5: indivisible by a 16-way model axis — the sharding rules
(the reference's parallel/rules.py) replicate attention and shard
MLP/vocab, which is exactly the kind of odd-size case IAAT's
boundary-free kernels target.
"""
import dataclasses

from repro_torch.configs.base import AttentionPattern, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab=49152,
    attn=AttentionPattern(kind="full"),
    tie_embeddings=True,
    rope_theta=1e4,
    # §Perf: 15 heads never divide a 2^k model axis; zero-padded dead
    # heads (H 15->48, kv 5->16, GQA pairing preserved) let attention
    # shard 16-ways at a 3.2x padded-compute cost — net ~5x
    head_pad_multiple=16,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="smollm-smoke", n_layers=2, d_model=60, n_heads=3,
        n_kv_heads=1, head_dim=20, d_ff=96, vocab=256)
