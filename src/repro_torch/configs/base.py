"""Model configuration schema (counterpart of ``repro/configs/base.py``).

One ``ModelConfig`` per architecture lives in
``src/repro_torch/configs/<arch>.py`` (the same numbers as the reference)
plus a ``smoke()`` reduction of the same family for CPU tests.  The dtype
fields stay strings; :attr:`ModelConfig.compute_dtype` and
:attr:`ModelConfig.param_torch_dtype` map them to torch dtypes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Vocab padded for TP divisibility (logical vocab kept for the loss)."""
    return -(v // -multiple) * multiple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2
    # routing drops no (token, expert) pair: serving steps compute each
    # expert's rows in sorted row tiles (``layers.moe``), every other
    # call at capacity E / k, and ``capacity_factor`` is not read
    dropless: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int                  # N
    head_dim: int = 64            # P
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class AttentionPattern:
    """Per-layer attention kind schedule.

    kind: "full" | "swa" (all layers windowed) | "local_global"
    (local_ratio local layers per 1 global) | "none" (attention-free).
    """
    kind: str = "full"
    window: Optional[int] = None
    local_ratio: int = 0          # e.g. 5 for gemma3's 5:1

    def is_subquadratic(self) -> bool:
        return self.kind in ("swa", "none")

    def layer_is_global(self, i: int) -> bool:
        if self.kind == "local_global":
            return (i % (self.local_ratio + 1)) == self.local_ratio
        return self.kind == "full"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    attn: AttentionPattern = AttentionPattern()
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2-style): one shared attention block reused every
    # ``shared_attn_every`` layers
    shared_attn_every: int = 0
    # enc-dec
    n_encoder_layers: int = 0
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: Optional[str] = None          # None | "audio" | "vision"
    frontend_tokens: int = 0                # prefix length contributed
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    parametric_norm: bool = True            # olmo: False
    tie_embeddings: bool = False
    # compute policy
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"                     # full | dots | none
    # paper integration: route small GEMMs through IAAT dispatch
    iaat_dispatch: bool = True
    # §Perf: pad attention heads (with ZERO-initialised dead heads) up to
    # a multiple compatible with the model axis, preserving the GQA
    # pairing (H_pad = lcm(rep, mult)-multiple).  Dead heads contribute
    # exactly 0 forward AND receive exactly 0 gradient (their q/k/v and
    # wo rows stay 0), so the math is unchanged while attention shards.
    head_pad_multiple: int = 0

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def n_heads_padded(self) -> int:
        if not self.n_heads or not self.head_pad_multiple:
            return self.n_heads
        rep = self.n_heads // self.n_kv_heads
        step = rep * self.head_pad_multiple // math.gcd(
            rep, self.head_pad_multiple)
        return -(self.n_heads // -step) * step

    @property
    def n_kv_heads_padded(self) -> int:
        if not self.n_kv_heads or not self.head_pad_multiple:
            return self.n_kv_heads
        rep = self.n_heads // self.n_kv_heads
        return self.n_heads_padded // rep

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, L = self.d_model, self.n_layers
        hd = self.head_dim_
        n = 0
        emb = self.vocab_padded * d
        n += emb * (1 if self.tie_embeddings else 2)
        is_hybrid = self.shared_attn_every > 0

        def attn_params():
            return d * hd * (self.n_heads + 2 * self.n_kv_heads) + \
                self.n_heads * hd * d

        def mlp_params(dff):
            return 3 * d * dff  # gated (SwiGLU)

        if self.family in ("dense", "vlm", "audio", "encdec"):
            per = attn_params() + mlp_params(self.d_ff) + 2 * d
            n += per * L
            if self.family == "encdec":
                per_dec = attn_params() * 2 + mlp_params(self.d_ff) + 3 * d
                n += per_dec * self.n_encoder_layers  # decoder stack
        elif self.family == "moe":
            m = self.moe
            per = attn_params() + 2 * d + d * m.num_experts  # router
            per += m.num_experts * 3 * d * m.d_expert
            n += per * L
        elif self.family in ("ssm", "hybrid"):
            di, s = self.d_inner, self.ssm
            nh = self.ssm_heads
            per = d * (2 * di + 2 * s.d_state + nh)   # in_proj(z,x,B,C,dt)
            per += s.d_conv * (di + 2 * s.d_state)    # conv
            per += nh * 2                             # A_log, D
            per += di * d + 2 * d                     # out_proj + norms
            n += per * L
            if is_hybrid:
                n += attn_params() + mlp_params(self.d_ff) + 2 * d
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        full = self.param_count()
        expert_all = m.num_experts * 3 * self.d_model * m.d_expert * self.n_layers
        expert_act = m.top_k * 3 * self.d_model * m.d_expert * self.n_layers
        return full - expert_all + expert_act


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        sub = cfg.attn.is_subquadratic() or cfg.family in ("ssm", "hybrid") \
            or cfg.attn.kind == "local_global"
        if not sub:
            return False, "pure full-attention arch: long_500k skipped per assignment"
    if shape.kind == "decode" and cfg.family == "encdec" \
            and shape.name == "long_500k":
        return False, "enc-dec 500k decode not meaningful"
    return True, ""
