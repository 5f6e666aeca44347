"""Decoder-only LM, dense family, for paged serving (counterpart of
``repro/models/lm.py``).

Parameters live in :class:`DenseLM`, an ``nn.Module`` built either from a
``torch.Generator`` (:func:`init_lm`) or from the JAX package's parameter
tree (:func:`params_from_numpy`).  Matmul weights are stored in the
compute dtype, cast once at load (see ``common.mm``); norm weights keep
the parameter dtype, as the reference's ``rmsnorm`` widens them to f32.

The layer stack is a Python loop over layers in place of ``lax.scan``;
the KV pools are one stacked tensor per K and V, updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.api import Policy
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.common import mm, rmsnorm


def _frozen(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_frozen, (wq, wk, wv, wo))


class MLP(nn.Module):
    def __init__(self, wg, wu, wd):
        super().__init__()
        self.wg, self.wu, self.wd = map(_frozen, (wg, wu, wd))


class Block(nn.Module):
    """[attn + mlp] with optional parametric pre-norms."""

    def __init__(self, attn: Attention, mlp: MLP, ln1=None, ln2=None):
        super().__init__()
        self.attn, self.mlp = attn, mlp
        self.ln1, self.ln2 = _frozen(ln1), _frozen(ln2)


class DenseLM(nn.Module):
    def __init__(self, embed, blocks, final_norm=None, unembed=None):
        super().__init__()
        self.embed = _frozen(embed)                # (Vp, d)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _frozen(final_norm)
        self.unembed = _frozen(unembed)            # (d, Vp) when untied


# --------------------------------------------------------------------------
# Construction.
# --------------------------------------------------------------------------

def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.shared_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            "(dense only)")
    if cfg.head_pad_multiple:
        raise NotImplementedError(f"{cfg.name}: head padding (a sharding "
                                  "aid) is not ported")


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device="cuda") -> DenseLM:
    """Random weights from ``generator`` (on ``device``), with the
    reference's shapes and scales (``ninit``: f32 normal times a scale,
    then the cast)."""
    _check_family(cfg)
    cdt, pdt = cfg.compute_dtype, cfg.param_torch_dtype

    def ninit(shape, scale, dtype=cdt):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    d, H, Hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim_, cfg.d_ff)
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(H * hd) / math.sqrt(2.0 * cfg.n_layers)
    sd = 1.0 / math.sqrt(ff) / math.sqrt(2.0 * cfg.n_layers)
    norm = (lambda: torch.ones(d, dtype=pdt, device=device)) \
        if cfg.parametric_norm else (lambda: None)
    blocks = []
    for _ in range(cfg.n_layers):
        attn = Attention(ninit((d, H * hd), s), ninit((d, Hkv * hd), s),
                         ninit((d, Hkv * hd), s), ninit((H * hd, d), so))
        mlp = MLP(ninit((d, ff), s), ninit((d, ff), s), ninit((ff, d), sd))
        blocks.append(Block(attn, mlp, norm(), norm()))
    unembed = None if cfg.tie_embeddings else \
        ninit((d, cfg.vocab_padded), 1.0 / math.sqrt(d))
    return DenseLM(ninit((cfg.vocab_padded, d), d ** -0.5), blocks, norm(),
                   unembed)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cuda", dtype: Optional[torch.dtype] = None
                      ) -> DenseLM:
    """The JAX package's parameters (nested dict of numpy arrays, layers
    stacked on axis 0, ``None`` for absent norms) as the port's module.
    Matmul weights and the embedding are cast to ``dtype`` (default: the
    compute dtype) once, here; norm weights keep their dtype."""
    _check_family(cfg)
    dtype = dtype or cfg.compute_dtype

    def t(a, dt=dtype):
        if a is None:
            return None
        a = torch.from_numpy(np.array(a, dtype=np.float32))   # a copy
        return a.to(device=device, dtype=dt)

    def norm(a):
        return None if a is None else t(a, cfg.param_torch_dtype)

    b = tree["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        at, ml = b["attn"], b["mlp"]
        attn = Attention(*(t(at[k][i]) for k in ("wq", "wk", "wv", "wo")))
        mlp = MLP(*(t(ml[k][i]) for k in ("wg", "wu", "wd")))
        ln1 = b["ln1"][i] if b.get("ln1") is not None else None
        ln2 = b["ln2"][i] if b.get("ln2") is not None else None
        blocks.append(Block(attn, mlp, norm(ln1), norm(ln2)))
    return DenseLM(t(tree["embed"]), blocks, norm(tree.get("final_norm")),
                   t(tree.get("unembed")))


# --------------------------------------------------------------------------
# Paged serving.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PagedState:
    """Device-side serving state: attention K/V block pools, indexed
    through block tables (see ``repro_torch.serve.paged``)."""
    attn_k: torch.Tensor                 # (L, P, Hkv, BS, hd)
    attn_v: torch.Tensor


def init_paged_state(cfg: ModelConfig, num_blocks: int, block_size: int,
                     slots: int, dtype=torch.bfloat16,
                     device="cuda") -> PagedState:
    """Zero serving state; block 0 of every pool is the null sink, and
    zero-init keeps it finite for the masked reads inactive slots discard.
    (``slots`` sizes the per-slot recurrent rows of the ssm/hybrid
    families, which are not ported; dense models keep none.)"""
    _check_family(cfg)
    shape = (cfg.n_layers, num_blocks, cfg.n_kv_heads_padded, block_size,
             cfg.head_dim_)
    return PagedState(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device))


def _embed_tokens(params: DenseLM, cfg: ModelConfig, tokens):
    return params.embed[tokens].to(cfg.compute_dtype)


def _unembed(params: DenseLM, cfg: ModelConfig, x, be: Policy):
    # the tied embed.T is a strided view (strides (1, d)): it reaches the
    # GEMM kernel uncopied, which reads it along its unit-stride K dim
    w = params.embed.T if cfg.tie_embeddings else params.unembed
    return mm(x, w, be)


def _paged_core(params: DenseLM, cfg: ModelConfig, be: Policy, x,
                ps: PagedState, block_tables, qpos, decode_from=None):
    """Layer stack shared by paged prefill chunks and slot decode; K/V go
    through ``block_tables`` into the pools (in place).  Returns logits."""
    for i, blk in enumerate(params.blocks):
        h = rmsnorm(x, blk.ln1, cfg.norm_eps)
        x = x + L.attention(blk.attn, h, be, cfg,
                            paged_kv=(ps.attn_k[i], ps.attn_v[i],
                                      block_tables, qpos, decode_from))
        h2 = rmsnorm(x, blk.ln2, cfg.norm_eps)
        x = x + L.mlp(blk.mlp, h2, be)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return _unembed(params, cfg, x, be)


def paged_prefill(params: DenseLM, cfg: ModelConfig, be: Policy, tokens,
                  ps: PagedState, block_tables, pos_start, n_prompt):
    """One prefill chunk for ONE request: tokens (1, C) at absolute
    positions ``pos_start[0] + [0..C)``; block_tables (1, nmax).  Rows at
    positions >= ``n_prompt`` exist only on recompute-resume and take the
    decode numerics.  Returns logits (1, C, Vp); the pools in ``ps`` are
    updated in place."""
    x = _embed_tokens(params, cfg, tokens)
    B, C, _ = x.shape
    qpos = pos_start[:, None] + torch.arange(C, device=x.device)[None, :]
    dfrom = torch.full((B,), int(n_prompt), dtype=qpos.dtype,
                       device=x.device)
    return _paged_core(params, cfg, be, x, ps, block_tables, qpos, dfrom)


def paged_decode(params: DenseLM, cfg: ModelConfig, be: Policy, tokens,
                 ps: PagedState, block_tables, pos):
    """One slot-level decode step over ALL slots: tokens (slots, 1), pos
    (slots,).  Inactive rows read/write the null block through their
    all-zero table row.  Returns logits (slots, 1, Vp)."""
    x = _embed_tokens(params, cfg, tokens)
    qpos = pos[:, None] + torch.arange(x.shape[1], device=x.device)[None, :]
    return _paged_core(params, cfg, be, x, ps, block_tables, qpos)
