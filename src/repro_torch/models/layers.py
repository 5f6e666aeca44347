"""Transformer layers: GQA attention (causal or not, full or
sliding-window; over a whole prompt, a ring KV buffer, a paged KV pool or
an encoder's precomputed K/V), the gated MLP and the MoE layer
(counterpart of ``repro/models/layers.py``).

Every projection goes through ``common.mm`` (the IAAT dispatch hook);
attention over a whole prompt switches between the CUDA flash kernel and
the chunked library oracle by the ``Policy``, as the reference switches
between its Pallas kernel and ``ref.chunked_mha``.  Weights keep the
reference's ``(d_in, d_out)`` layout, so every GEMM shape the Router sees
is the reference's.  Reductions are taken in the same order and precision
as the reference (f32 accumulation via operands widened to f32, in place
of ``preferred_element_type``), because token identity in serving depends
on them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import api
from repro_torch.api import Policy
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention, ref
from repro_torch.models.common import mm, rope
from repro_torch.parallel.ctx import constrain, moe_shard_count


def attention_specs(cfg: ModelConfig):
    """Logical axes of one attention layer's weights (the reference's)."""
    return {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}


def mlp_specs(cfg: ModelConfig):
    return {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"),
            "wd": ("mlp", "embed")}


def moe_specs(cfg: ModelConfig):
    return {"router": ("embed", None),
            "w_gate": ("experts", "embed", "expert_mlp"),
            "w_up": ("experts", "embed", "expert_mlp"),
            "w_down": ("experts", "expert_mlp", "embed")}


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


def _full_attn(q, k, v, be: Policy, *, causal, window, q_offset, scale):
    """Attention over a whole prompt: the CUDA flash kernel when the
    policy's non-GEMM family is the kernel (``be.use_kernels``, the
    reference's ``pallas``: every backend but the forced library, unless
    ``Policy.kernels`` pins it), else the chunked oracle in plain torch
    ops."""
    if be.use_kernels:
        return flash_attention.flash_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            scale=scale)
    return ref.chunked_mha(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, scale=scale,
                           kv_chunk=min(1024, k.shape[2]))


def decode_attend(q, k_buf, v_buf, pos: int, *, window: Optional[int],
                  scale: float):
    """One-token attention over a (ring) KV buffer.

    q: (B, H, 1, hd); k_buf/v_buf: (B, Hkv, W, hd); ``pos`` is the position
    of the query token (the buffer already holds it at slot pos % W).
    Slot s holds position  p_s = pos - ((pos - s) mod W)  — for a
    full-length buffer this is p_s = s, so one formula covers the ring
    (sliding-window) and the linear (full) cache.  Grouped-GQA,
    normalised-softmax order, as the reference's."""
    B, H, _, hd = q.shape
    Hkv, W = k_buf.shape[1], k_buf.shape[2]
    rep = H // Hkv
    s_idx = torch.arange(W, device=q.device)
    p_s = pos - torch.remainder(pos - s_idx, W)
    ok = p_s >= 0
    if window is not None:
        ok &= p_s > pos - window
    qf = q.reshape(B, Hkv, rep, hd)
    logits = _f32_einsum("bkrd,bksd->bkrs", qf, k_buf) * scale
    logits = torch.where(ok, logits,
                         torch.tensor(float("-inf"), device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = _f32_einsum("bkrs,bksd->bkrd", p.to(v_buf.dtype), v_buf)
    return out.reshape(B, H, 1, hd).to(q.dtype)


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


def attention(p, x, be: Policy, cfg: ModelConfig, *, causal: bool = True,
              window: Optional[int] = None, kv_cache=None,
              pos: Optional[int] = None, paged_kv=None, cross_kv=None):
    """Attention layer.  Modes:

      prefill: no cache given; x holds positions 0..S-1 (q and k roped
               there), attended through :func:`_full_attn`, causally
               unless ``causal`` is False (the encoder); returns (y,
               (k, v)), the roped k and v (B, Hkv, S, hd) for the
               caller's cache.
      decode:  ``kv_cache = (k_buf, v_buf)`` (B, Hkv, W, hd), ``pos`` the
               token's position; writes its K/V into ring slot pos % W
               (in place), attends through :func:`decode_attend`; returns y.
      paged:   ``paged_kv = (k_pool, v_pool, block_table, q_pos (B, C),
               decode_from (B,) or None)``; writes the chunk's K/V into
               the pools through the block table (in place), attends over
               the gathered pool; returns y.
      cross:   ``cross_kv = (k, v)`` (B, Hkv, S_src, hd), projected from
               the encoder's states; only q is projected, and neither q
               nor k is roped; every query attends every key through
               :func:`_full_attn`; returns y.
    The reference returns the updated buffers functionally; here they are
    updated where they live, never copied."""
    H, Hkv, hd = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.head_dim_
    scale = hd ** -0.5
    B, S, _ = x.shape
    q = _split_heads(mm(x, p.wq, be), H, hd)
    if cross_kv is not None:
        k, v = cross_kv
        y = _full_attn(q, k, v, be, causal=False, window=None, q_offset=0,
                       scale=scale)
        return mm(_merge_heads(y), p.wo, be)
    q = constrain(q, "batch", "heads", None, None)
    k = constrain(_split_heads(mm(x, p.wk, be), Hkv, hd),
                  "batch", "kv", None, None)
    v = constrain(_split_heads(mm(x, p.wv, be), Hkv, hd),
                  "batch", "kv", None, None)
    if paged_kv is not None:
        k_pool, v_pool, bt, qpos, decode_from = paged_kv
        BS = k_pool.shape[2]
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, qpos, cfg.rope_theta)
        blk = torch.gather(bt, 1, torch.div(qpos, BS, rounding_mode="floor"))
        off = torch.remainder(qpos, BS)                         # (B, C)
        heads = torch.arange(Hkv, device=x.device)[None, None, :]
        # The reference's `.at[blk, :, off, :].set` becomes an in-place
        # index_put_ on this layer's slice of the stacked pool.  Indices
        # broadcast to (B, C, Hkv); values are (B, C, Hkv, hd).
        k_pool.index_put_((blk[..., None], heads, off[..., None]),
                          k.transpose(1, 2).to(k_pool.dtype))
        v_pool.index_put_((blk[..., None], heads, off[..., None]),
                          v.transpose(1, 2).to(v_pool.dtype))
        y = paged_attend(q, k_pool, v_pool, bt, qpos, window=window,
                         scale=scale, decode_from=decode_from)
        return mm(_merge_heads(y), p.wo, be)
    if kv_cache is not None:
        k_buf, v_buf = kv_cache
        pos_arr = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        q = rope(q, pos_arr, cfg.rope_theta)
        k = rope(k, pos_arr, cfg.rope_theta)
        slot = pos % k_buf.shape[2]
        k_buf[:, :, slot] = k[:, :, 0].to(k_buf.dtype)
        v_buf[:, :, slot] = v[:, :, 0].to(v_buf.dtype)
        y = decode_attend(q, k_buf, v_buf, pos, window=window, scale=scale)
        return mm(_merge_heads(y), p.wo, be)
    positions = torch.arange(S, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    y = _full_attn(q, k, v, be, causal=causal, window=window, q_offset=0,
                   scale=scale)
    return mm(_merge_heads(y), p.wo, be), (k, v)


def mlp(p, x, be: Policy):
    """Gated MLP (SwiGLU)."""
    h = F.silu(mm(x, p.wg, be)) * mm(x, p.wu, be)
    h = constrain(h, "batch", None, "mlp")
    return mm(h, p.wd, be)


# --------------------------------------------------------------------------
# MoE: top-k routing, sort-based capacity dispatch, grouped small GEMM;
# one dispatch group, or one per data shard (``moe_shard_count``).
# --------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, ninit):
    """(router, w_gate, w_up, w_down) with the reference's shapes and
    scales (``layers.py::init_moe``); ``ninit(shape, scale, dtype)`` draws
    them.  The router is f32; the experts take ``ninit``'s dtype (the
    compute dtype, or a master copy's)."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_expert
    s = 1.0 / math.sqrt(d)
    sd = 1.0 / math.sqrt(f) / math.sqrt(2.0 * cfg.n_layers)
    return (ninit((d, E), s, torch.float32), ninit((E, d, f), s),
            ninit((E, d, f), s), ninit((E, f, d), sd))


def _capacity(T: int, m) -> int:
    c = int(math.ceil(T * m.top_k / m.num_experts * m.capacity_factor))
    # the reference's grain: 128-multiples from 128 on, else 8-multiples
    grain = 128 if c >= 128 else 8
    return max(grain, -(c // -grain) * grain)


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest along the last dim, ties to the lower
    index (a stable descending sort; ``torch.topk`` leaves tie order
    unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_dispatch_groups(router, xg, cfg: ModelConfig, C: int):
    """Route + sort + capacity for G token shards at once.  xg: (G, T, d).

    Returns (buf (G, E, C, d), (slots (G, T*k), top_p (G, T, k)), aux
    (G,)): each group's dispatch is the reference's ``_moe_dispatch`` on
    its own tokens (the reference vmaps it; here every op takes the group
    dim).  Each kept (token, expert) pair gets slot ``e * C + rank``; a
    pair past its expert's capacity goes to the sink index ``E * C``.
    The reference's scatters with ``mode="drop"`` write duplicates only
    to the sink, which both packages discard, so a plain scatter into an
    ``E*C + 1`` row is the same map.  Counts are a scatter-add, so the
    dispatch also runs on the meta device (the dry run)."""
    m = cfg.moe
    G, T, d = xg.shape
    E, k = m.num_experts, m.top_k
    dev = xg.device

    # the router stays f32 (an f32 matmul, TF32 off): not a routed GEMM
    logits = torch.matmul(xg.reshape(G * T, d).float(), router)   # (GT, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)                               # (GT, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    logits, probs = logits.reshape(G, T, E), probs.reshape(G, T, E)

    flat_e = top_e.reshape(G, T * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = torch.div(torch.arange(T * k, device=dev), k,
                     rounding_mode="floor")[order]
    counts = torch.zeros((G, E), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))                       # (G, E)
    starts = torch.cumsum(counts, 1) - counts
    rank = torch.arange(T * k, device=dev) - torch.gather(starts, 1, se)
    keep = rank < C
    dest = torch.where(keep, se * C + rank, E * C)                # sink

    inv = torch.zeros((G, E * C + 1), dtype=torch.long, device=dev) \
        .scatter_(1, dest, stok)                                  # slot->token
    filled = torch.zeros((G, E * C + 1), dtype=torch.bool, device=dev) \
        .scatter_(1, dest, keep)
    gi = torch.arange(G, device=dev)[:, None]
    buf = torch.where(filled[:, :E * C, None], xg[gi, inv[:, :E * C]], 0)
    slot_flat = torch.empty((G, T * k), dtype=torch.long, device=dev) \
        .scatter_(1, order, dest)                                 # (G, T*k)

    me = probs.mean(1)                                            # (G, E)
    ce = (counts / torch.clamp(counts.sum(-1, keepdim=True), min=1)).float()
    aux = m.aux_loss * E * torch.sum(me * ce, -1) \
        + m.router_z_loss * torch.mean(torch.logsumexp(logits, -1) ** 2, -1)
    return (buf.reshape(G, E, C, d), (slot_flat, top_p.reshape(G, T, k)),
            aux)


def _moe_dispatch(router, xf, cfg: ModelConfig, C: int):
    """One token shard's dispatch, xf: (T, d) -> (buf (E, C, d), (slots
    (T*k,), top_p (T, k)), aux): :func:`_moe_dispatch_groups` at G = 1."""
    buf, (slot, top_p), aux = _moe_dispatch_groups(router, xf[None], cfg, C)
    return buf[0], (slot[0], top_p[0]), aux[0]


def _moe_combine_groups(out_buf, meta, T: int, k: int):
    """Per-token gather of its k expert rows, G groups at once (out_buf
    (G, E, C, d) -> (G, T, d)); a dropped pair (slot ``E*C``) reads the one
    zero row padded after each group's buffer (the reference's
    ``mode="fill"``).  The weighted sum takes bf16 products in f32 and
    rounds once to the buffer's dtype."""
    slot_flat, top_p = meta
    G, E, C, d = out_buf.shape
    flat = torch.cat([out_buf.reshape(G, E * C, d),
                      out_buf.new_zeros(G, 1, d)], 1)
    gi = torch.arange(G, device=out_buf.device)[:, None]
    rows = flat[gi, slot_flat].reshape(G, T, k, d)
    return _f32_einsum("gtkd,gtk->gtd", rows,
                       top_p.to(rows.dtype)).to(rows.dtype)


def _moe_combine(out_buf, meta, T: int, k: int):
    """One shard's combine, out_buf (E, C, d) -> (T, d)."""
    slot_flat, top_p = meta
    return _moe_combine_groups(out_buf[None], (slot_flat[None],
                                               top_p[None]), T, k)[0]


def _expert_ffn(p, buf, be: Policy, x_dtype):
    """(…, E, C, d) @ experts: grouped small GEMMs (the paper's habitat).

    The 3-D (one shard) case: when the policy's non-GEMM family is the
    kernel (``be.use_kernels``) each grouped product routes through
    ``api.batched_gemm``, so the per-group (C, K, N) problem gets the same
    input-aware treatment as the 2-D path (the reference's plain einsum
    when the router declines the kernel); the library family runs the
    einsums directly.  The 4-D (G, E, C, d) case of the per-shard branch
    is the library einsum under every policy, with the reference's
    layout constraints, as the reference's 4-D case.  The weights are
    stored in the compute dtype already, so the reference's cast is a
    no-op here.

    The gate ``silu(g) * u`` is taken in f32 and rounded once: under
    ``jit`` XLA fuses the reference's elementwise chain and keeps its
    bf16 intermediates in f32 (excess precision), so one rounding is what
    the reference's serving step computes."""
    wg, wu, wd = (w.to(x_dtype) for w in (p.w_gate, p.w_up, p.w_down))
    if buf.ndim == 4:
        g = torch.einsum("gecd,edf->gecf", buf, wg)
        u = torch.einsum("gecd,edf->gecf", buf, wu)
        h = constrain((F.silu(g.float()) * u.float()).to(g.dtype),
                      "moe_group", "experts", None, "expert_mlp")
        return constrain(torch.einsum("gecf,efd->gecd", h, wd),
                         "moe_group", "experts", None, None)
    if be.use_kernels:
        def gmm(a, w):
            return api.batched_gemm(a, w, policy=be)
    else:
        def gmm(a, w):
            return torch.einsum("eck,ekn->ecn", a, w)
    g, u = gmm(buf, wg), gmm(buf, wu)
    h = (F.silu(g.float()) * u.float()).to(g.dtype)
    return gmm(h, wd)


def moe(p, x, be: Policy, cfg: ModelConfig):
    """x: (B, S, d) -> (y, aux).

    One dispatch over all B*S tokens (padding rows included: they route
    and take capacity, as in the reference), the expert FFN, the combine;
    or, where the activation context asks for G = ``moe_shard_count()`` >
    1 dispatch groups and T = B*S splits into G shards of a multiple of 8
    tokens (the reference's guard), the per-data-shard branch: each
    shard routes its T/G tokens at its own capacity, the expert FFN runs
    on the (G, E, C, d) buffer, each shard combines its own tokens, and
    aux is the shards' mean."""
    m = cfg.moe
    B, S, d = x.shape
    T, k = B * S, m.top_k
    G = moe_shard_count()
    if G <= 1 or T % G or (T // G) % 8:
        buf, meta, aux = _moe_dispatch(p.router, x.reshape(T, d), cfg,
                                       _capacity(T, m))
        out_buf = _expert_ffn(p, buf, be, x.dtype)
        y = _moe_combine(out_buf, meta, T, k)
        return y.to(x.dtype).reshape(B, S, d), aux
    T_loc = T // G
    xg = constrain(x.reshape(G, T_loc, d), "moe_group", None, None)
    buf, (slot, top_p), aux = _moe_dispatch_groups(p.router, xg, cfg,
                                                   _capacity(T_loc, m))
    buf = constrain(buf, "moe_group", "experts", None, None)
    slot = constrain(slot, "moe_group", None)
    top_p = constrain(top_p, "moe_group", None, None)
    out_buf = _expert_ffn(p, buf, be, x.dtype)
    yg = constrain(_moe_combine_groups(out_buf, (slot, top_p), T_loc, k),
                   "moe_group", None, None)
    return yg.to(x.dtype).reshape(B, S, d), aux.mean()
