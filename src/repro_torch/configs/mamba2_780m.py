"""mamba2-780m [ssm] — 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128 (SSD, state-space duality).  [arXiv:2405.21060]"""
import dataclasses

from repro_torch.configs.base import AttentionPattern, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    attn=AttentionPattern(kind="none"),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=128),
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", n_layers=2, d_model=64, vocab=256,
        ssm=SSMConfig(d_state=16, head_dim=8, expand=2, d_conv=4, chunk=16))
