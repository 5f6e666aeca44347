"""Transformer layers for paged serving: GQA attention over a paged KV
pool and the gated MLP (counterpart of ``repro/models/layers.py``).

Every projection goes through ``common.mm`` (the IAAT dispatch hook).
Weights keep the reference's ``(d_in, d_out)`` layout, so every GEMM shape
the Router sees is the reference's.  Reductions are taken in the same
order and precision as the reference (f32 accumulation via operands
widened to f32, in place of ``preferred_element_type``), because token
identity in paged serving depends on them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.api import Policy
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import mm, rope


def _split_heads(x, n, hd):
    B, S, _ = x.shape
    return x.reshape(B, S, n, hd).transpose(1, 2)


def _merge_heads(x):
    B, H, S, hd = x.shape
    return x.transpose(1, 2).reshape(B, S, H * hd)


def _f32_einsum(eq: str, a, b):
    """einsum with f32 accumulation and an f32 result (the reference's
    ``preferred_element_type=jnp.float32``): operands are widened first,
    so every product is exact."""
    return torch.einsum(eq, a.float(), b.float())


def paged_attend(q, k_pool, v_pool, block_table, q_pos, *,
                 scale: float, window: Optional[int] = None,
                 decode_from=None):
    """Attention over a paged KV pool, read through a block table.

    q: (B, H, C, hd); k_pool/v_pool: (P, Hkv, BS, hd) — one layer's pool;
    block_table: (B, nmax) pool ids in logical order (padded with the null
    block 0); q_pos: (B, C) absolute query positions.  Flattened key j of
    the gathered buffer holds sequence position j, so the mask is
    ``j <= q_pos``.

    Decode rows (C == 1) take the grouped-GQA normalised-softmax order;
    prefill rows take the repeated-KV unnormalised-exp (flash) order, and
    rows at ``q_pos >= decode_from`` (recompute-resume replays of decoded
    tokens) take the decode order inside a C > 1 chunk — the reference's
    exact reduction orders (``layers.py:151-187``)."""
    B, H, C, hd = q.shape
    Hkv, BS = k_pool.shape[1], k_pool.shape[2]
    nmax = block_table.shape[1]
    rep = H // Hkv
    kg = k_pool[block_table].permute(0, 2, 1, 3, 4) \
        .reshape(B, Hkv, nmax * BS, hd)
    vg = v_pool[block_table].permute(0, 2, 1, 3, 4) \
        .reshape(B, Hkv, nmax * BS, hd)
    key_pos = torch.arange(nmax * BS, device=q.device)
    ok = key_pos[None, None, :] <= q_pos[:, :, None]            # (B, C, S)
    if window is not None:
        ok &= key_pos[None, None, :] > q_pos[:, :, None] - window
    neg = torch.tensor(float("-inf"), device=q.device)
    if C == 1:
        qf = q.reshape(B, Hkv, rep, hd)
        logits = _f32_einsum("bkrd,bksd->bkrs", qf, kg) * scale
        logits = torch.where(ok[:, None, None, 0, :], logits, neg)
        p = torch.softmax(logits, dim=-1)
        out = _f32_einsum("bkrs,bksd->bkrd", p.to(vg.dtype), vg)
        return out.reshape(B, H, 1, hd).to(q.dtype)
    kb = torch.repeat_interleave(kg, rep, dim=1)
    vb = torch.repeat_interleave(vg, rep, dim=1)
    s = _f32_einsum("bhqd,bhkd->bhqk", q, kb) * scale
    s = torch.where(ok[:, None], s, neg)
    m = s.amax(-1)                     # rows always see >= 1 valid key
    p = torch.exp(s - m[..., None])
    p = torch.where(ok[:, None], p, torch.zeros((), device=q.device))
    l = p.sum(-1)
    acc = _f32_einsum("bhqk,bhkd->bhqd", p.to(vb.dtype), vb)
    flash = (acc / torch.clamp(l, min=1e-37)[..., None]).to(q.dtype)
    if decode_from is None:
        return flash
    qf = q.reshape(B, Hkv, rep, C, hd)
    logits = _f32_einsum("bkrqd,bksd->bkrqs", qf, kg) * scale
    logits = torch.where(ok[:, None, None], logits, neg)
    pd = torch.softmax(logits, dim=-1)
    outd = _f32_einsum("bkrqs,bksd->bkrqd", pd.to(vg.dtype), vg)
    outd = outd.reshape(B, H, C, hd).to(q.dtype)
    replay = q_pos >= decode_from[:, None]                      # (B, C)
    return torch.where(replay[:, None, :, None], outd, flash)


def attention(p, x, be: Policy, cfg: ModelConfig, *, paged_kv,
              window: Optional[int] = None):
    """Attention in paged mode: ``paged_kv = (k_pool, v_pool, block_table,
    q_pos (B, C), decode_from (B,) or None)``.  Ropes q/k at the absolute
    positions, writes the chunk's K/V into the pools through the block
    table, and attends over the gathered pool.  Returns y (B, C, d)."""
    H, Hkv, hd = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.head_dim_
    scale = hd ** -0.5
    k_pool, v_pool, bt, qpos, decode_from = paged_kv
    q = _split_heads(mm(x, p.wq, be), H, hd)
    k = _split_heads(mm(x, p.wk, be), Hkv, hd)
    v = _split_heads(mm(x, p.wv, be), Hkv, hd)
    BS = k_pool.shape[2]
    q = rope(q, qpos, cfg.rope_theta)
    k = rope(k, qpos, cfg.rope_theta)
    blk = torch.gather(bt, 1, torch.div(qpos, BS, rounding_mode="floor"))
    off = torch.remainder(qpos, BS)                             # (B, C)
    heads = torch.arange(Hkv, device=x.device)[None, None, :]
    # The reference's functional `.at[blk, :, off, :].set` becomes an
    # in-place index_put_ on this layer's slice of the stacked pool: the
    # pools are updated where they live, never copied.  Indices broadcast
    # to (B, C, Hkv); values are (B, C, Hkv, hd).
    k_pool.index_put_((blk[..., None], heads, off[..., None]),
                      k.transpose(1, 2).to(k_pool.dtype))
    v_pool.index_put_((blk[..., None], heads, off[..., None]),
                      v.transpose(1, 2).to(v_pool.dtype))
    y = paged_attend(q, k_pool, v_pool, bt, qpos, window=window,
                     scale=scale, decode_from=decode_from)
    return mm(_merge_heads(y), p.wo, be)


def mlp(p, x, be: Policy):
    """Gated MLP (SwiGLU)."""
    h = F.silu(mm(x, p.wg, be)) * mm(x, p.wu, be)
    return mm(h, p.wd, be)
