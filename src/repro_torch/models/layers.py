"""Transformer layers: GQA attention (causal or not, full or
sliding-window; over a whole prompt, a ring KV buffer, a paged KV pool or
an encoder's precomputed K/V), the gated MLP and the MoE layer
(counterpart of ``repro/models/layers.py``).

Every projection goes through ``common.mm`` (the IAAT dispatch hook);
attention over a whole prompt switches between the CUDA flash kernel and
the chunked library oracle by the ``Policy``, as the reference switches
between its Pallas kernel and ``ref.chunked_mha``; attention over a paged
pool between the CUDA paged-attention kernel and its plain ops.  Weights
keep the reference's ``(d_in, d_out)`` layout, so every GEMM shape the
Router sees is the reference's.  Reductions are taken in the same order
and precision as the reference (f32 accumulation via operands widened to
f32, in place of ``preferred_element_type``), because token identity in
serving depends on them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import api, obs
from repro_torch.api import Policy
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention, paged_attention, ref
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.models.common import mm, rope
from repro_torch.parallel import spmd
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


def _full_attn(q, k, v, be: Policy, *, causal, window, q_offset, scale):
    """Attention over a whole prompt: the CUDA flash kernel when the
    policy's non-GEMM family is the kernel (``be.use_kernels``, the
    reference's ``pallas``: every backend but the forced library, unless
    ``Policy.kernels`` pins it), else the chunked oracle in plain torch
    ops.  On DTensors (batch and heads sharded) it runs on each rank's
    local heads; where q and k/v are laid out differently (a GQA whose
    kv heads the rules replicate) both are replicated over that mesh
    dim first."""
    if spmd.any_dtensor(q, k, v):
        return _sharded_attn(q, k, v, be, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    if be.use_kernels:
        return flash_attention.flash_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            scale=scale)
    return ref.chunked_mha(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, scale=scale,
                           kv_chunk=min(1024, k.shape[2]))


def _sharded_attn(q, k, v, be: Policy, **kw):
    from torch.distributed.tensor import Replicate
    q, k, v = (spmd.settle(t) for t in (q, k, v))
    pl = tuple(a if a == b == c else Replicate()
               for a, b, c in zip(q.placements, k.placements, v.placements))
    q, k, v = (t if tuple(t.placements) == pl
               else t.redistribute(t.device_mesh, pl) for t in (q, k, v))
    return spmd.local(lambda a, b, c: _full_attn(a, b, c, be, **kw), pl,
                      q, k, v)


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
    logits = ref.f32_einsum("bkrd,bksd->bkrs", qf, k_buf) * scale
    logits = torch.where(ok, logits,
                         torch.tensor(float("-inf"), device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = ref.f32_einsum("bkrs,bksd->bkrd", p.to(v_buf.dtype), v_buf)
    return out.reshape(B, H, 1, hd).to(q.dtype)


def split_decode_attend(q, k_buf, v_buf, pos: int, *, window: Optional[int],
                        scale: float, ring: int, first: int, groups):
    """:func:`decode_attend` over one rank's share of a ring buffer split
    along its slots: ``k_buf``/``v_buf`` (B, Hkv, W_local, hd) hold the
    global slots ``first .. first + W_local`` of a ``ring``-slot buffer,
    and ``groups`` are the process groups (``(DeviceMesh, mesh dim)``)
    over which the slots are split.  The split softmax: each rank masks
    its slots by their positions p_s, takes its max of the logits, then
    the all-reduced max; its sum of exp(logit - max), then the all-reduced
    sum; its probabilities (normalised by the global sum and rounded to
    the cache's dtype, as the whole-buffer softmax rounds them) times its
    V, then the all-reduced sum.  Equal to the whole-buffer op to f32
    rounding (the sums over slots are taken in another order)."""
    from torch.distributed import _functional_collectives as funcol

    def reduce(t, op):
        for g in groups:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
        return t

    B, H, _, hd = q.shape
    Hkv, Wl = k_buf.shape[1], k_buf.shape[2]
    rep = H // Hkv
    s_idx = first + torch.arange(Wl, device=q.device)
    p_s = pos - torch.remainder(pos - s_idx, ring)
    ok = p_s >= 0
    if window is not None:
        ok &= p_s > pos - window
    qf = q.reshape(B, Hkv, rep, hd)
    logits = ref.f32_einsum("bkrd,bksd->bkrs", qf, k_buf) * scale
    logits = torch.where(ok, logits,
                         torch.tensor(float("-inf"), device=q.device))
    # the token's own slot is valid on some rank, so the global max is
    # finite; a rank whose slots are all masked adds exp(-inf) = 0
    m = reduce(logits.amax(-1, keepdim=True), "max")
    e = torch.exp(logits - m)
    p = e / reduce(e.sum(-1, keepdim=True), "sum")
    out = reduce(ref.f32_einsum("bkrs,bksd->bkrd", p.to(v_buf.dtype),
                                v_buf), "sum")
    return out.reshape(B, H, 1, hd).to(q.dtype)


def _sharded_decode(q, k, v, k_buf, v_buf, pos: int, *,
                    window: Optional[int], scale: float):
    """One-token attention on DTensors: the token's K/V written into ring
    slot pos % W of the cache's local shards (on the rank that owns the
    slot, where the slots are split; the cache is never redistributed),
    q laid out as the cache on its batch and kv-head dims and replicated
    elsewhere, then :func:`decode_attend` on the local tensors, or, where
    the cache's slots are split over mesh dims, :func:`split_decode_attend`
    with its all-reduces over those dims.  The output is laid out as q."""
    from torch.distributed.tensor import Replicate
    mesh, W = k_buf.device_mesh, k_buf.shape[2]
    slot = slice(pos % W, pos % W + 1)
    spmd.write(k_buf, (slice(None), slice(None), slot), k)
    spmd.write(v_buf, (slice(None), slice(None), slot), v)
    cpl = tuple(k_buf.placements)
    qpl = tuple(p if p.is_shard(0) or p.is_shard(1) else Replicate()
                for p in cpl)
    q = spmd.settle(q)
    if tuple(q.placements) != qpl:
        q = q.redistribute(mesh, qpl)
    ql, kl, vl = q.to_local(), k_buf.to_local(), v_buf.to_local()
    seq = [(mesh, j) for j, p in enumerate(cpl) if p.is_shard(2)]
    if seq:
        first = spmd.local_offset(k_buf.shape, mesh, cpl)[2]
        y = split_decode_attend(ql, kl, vl, pos, window=window, scale=scale,
                                ring=W, first=first, groups=seq)
    else:
        y = decode_attend(ql, kl, vl, pos, window=window, scale=scale)
    return spmd.from_local(y, mesh, qpl, q.shape)


def paged_attend(q, k_pool, v_pool, block_table, q_pos, be: Policy, *,
                 scale: float, window: Optional[int] = None,
                 decode_from=None):
    """Attention over a paged KV pool, read through a block table.

    q: (B, H, C, hd); k_pool/v_pool: (P, Hkv, BS, hd) — one layer's pool;
    block_table: (B, nmax) pool ids in logical order (padded with the null
    block 0); q_pos: (B, C) absolute query positions.  Flattened key j of
    a slot's table holds sequence position j, so the mask is
    ``j <= q_pos``.

    Decode rows (C == 1) take the grouped-GQA normalised-softmax order;
    prefill rows take the repeated-KV unnormalised-exp (flash) order, and
    rows at ``q_pos >= decode_from`` (recompute-resume replays of decoded
    tokens) take the decode order inside a C > 1 chunk — the reference's
    exact reduction orders (``layers.py:151-187``).  The CUDA paged
    attention kernel computes them when the policy's non-GEMM family is
    the kernel (``be.use_kernels``) and the pools are ones it takes
    (``paged_attention.applies``: bf16 on the card at head dim 64, 128 or
    256); else the plain ops do.  The call is the unranged span
    ``model.paged_attend``, its ``path`` "kernel" or "plain"."""
    kernel = (q.dtype == k_pool.dtype and not spmd.any_dtensor(q, k_pool)
              and paged_attention.applies(be.use_kernels, k_pool.device,
                                          k_pool.dtype, k_pool.shape[3]))
    fn = paged_attention.paged_attention if kernel else \
        paged_attention.paged_attention_plain
    with obs.span("model.paged_attend", ranged=False,
                  path="kernel" if kernel else "plain"):
        return fn(q, k_pool, v_pool, block_table, q_pos, scale=scale,
                  window=window, decode_from=decode_from)


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
               (in place), attends through :func:`decode_attend` (on
               DTensors :func:`_sharded_decode`); returns y.
      paged:   ``paged_kv = (k_pool, v_pool, block_table, q_pos (B, C),
               decode_from (B,) or None)``; writes the chunk's K/V into
               the pools through the block table (in place), attends over
               the pool through the table (:func:`paged_attend`); returns
               y.
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
        y = paged_attend(q, k_pool, v_pool, bt, qpos, be, window=window,
                         scale=scale, decode_from=decode_from)
        return mm(_merge_heads(y), p.wo, be)
    if kv_cache is not None:
        k_buf, v_buf = kv_cache
        pos_arr = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        q = rope(q, pos_arr, cfg.rope_theta)
        k = rope(k, pos_arr, cfg.rope_theta)
        if spmd.is_dtensor(k_buf):
            y = _sharded_decode(q, k, v, k_buf, v_buf, pos, window=window,
                                scale=scale)
            return mm(_merge_heads(y), p.wo, be)
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
    """Rows an expert takes of T tokens: T k / E times the capacity
    factor, E / k where routing is dropless (C = T: no pair can drop)."""
    cf = m.num_experts / m.top_k if m.dropless else m.capacity_factor
    c = int(math.ceil(T * m.top_k / m.num_experts * cf))
    # the reference's grain: 128-multiples from 128 on, else 8-multiples
    grain = 128 if c >= 128 else 8
    return max(grain, -(c // -grain) * grain)


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest along the last dim, ties to the lower
    index (a stable descending sort; ``torch.topk`` leaves tie order
    unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router, x2, k: int):
    """x2 (T, d) -> (logits, probs (T, E), top_p, top_e (T, k)): the f32
    router (an f32 matmul, TF32 off: not a routed GEMM), the softmax over
    the experts, the stable top-k, renormalised."""
    logits = torch.matmul(x2.float(), router)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_p, top_e


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

    logits, probs, top_p, top_e = _route(router, xg.reshape(G * T, d), k)
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
    return ref.f32_einsum("gtkd,gtk->gtd", rows,
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
    if spmd.is_dtensor(buf):
        return _sharded_expert_ffn(buf, wg, wu, wd)
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


def _sharded_expert_ffn(buf, wg, wu, wd):
    """The 4-D expert FFN on DTensors: the expert weights gathered over
    the batch axes (FSDP), the buffer laid out to match them on ``model``
    (EP: ``Shard(1)``, the experts; TP on ``expert_mlp``: replicated, the
    output then ``Partial``), the library einsums on the local shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    wg, wu, wd = (spmd.gather_fsdp(w) for w in (wg, wu, wd))
    buf = spmd.settle(buf)
    pl, out = [], []
    for b, g, dn in zip(buf.placements, wg.placements, wd.placements):
        pl.append(Shard(1) if g.is_shard(0) else
                  Replicate() if g.is_shard(2) else b)
        out.append(Partial() if dn.is_shard(1) else pl[-1])
    if tuple(pl) != tuple(buf.placements):
        buf = buf.redistribute(buf.device_mesh, tuple(pl))

    def ffn(b, g_w, u_w, d_w):
        g = torch.einsum("gecd,edf->gecf", b, g_w)
        u = torch.einsum("gecd,edf->gecf", b, u_w)
        h = (F.silu(g.float()) * u.float()).to(g.dtype)
        return torch.einsum("gecf,efd->gecd", h, d_w)
    y = spmd.local(ffn, tuple(out), buf, wg, wu, wd)
    return constrain(y, "moe_group", "experts", None, None)


def _sharded_moe(p, x, be: Policy, cfg: ModelConfig, G: int):
    """:func:`moe` on DTensors: G dispatch groups along the batch
    sharding (one group, x gathered whole, where the per-shard guard
    fails), the dispatch and the combine on each rank's local groups
    (top-k, sort and scatter have no sharding strategy: they run through
    ``local_map`` on the group dim, every model rank alike), the expert
    FFN by :func:`_sharded_expert_ffn`."""
    m = cfg.moe
    B, S, d = x.shape
    T, k = B * S, m.top_k
    x = spmd.settle(x)
    if G <= 1 or T % G or (T // G) % 8:
        G = 1
        xg = x.redistribute(x.device_mesh, spmd.replicate(x.device_mesh)) \
            .reshape(1, T, d)
    else:
        xg = constrain(x.reshape(G, T // G, d), "moe_group", None, None)
    T_loc, C = T // G, _capacity(T // G, m)
    xg = spmd.settle(xg)
    pl = tuple(xg.placements)
    buf, (slot, top_p), aux = spmd.local(
        lambda xl, r: _moe_dispatch_groups(r, xl, cfg, C), (pl, pl, pl, pl),
        xg, spmd.whole(p.router))
    buf = constrain(buf, "moe_group", "experts", None, None)
    out_buf = _expert_ffn(p, buf, be, x.dtype)
    out_buf = out_buf.redistribute(out_buf.device_mesh, pl)
    yg = spmd.local(lambda o, sl, tp: _moe_combine_groups(
        o, (sl, tp), T_loc, k), pl, out_buf, slot, top_p)
    if G > 1:
        yg = constrain(yg, "moe_group", None, None)
        # groups split within a sequence (B smaller than the group shards:
        # a microbatch cut from a gathered batch): the rows are whole on
        # every rank, as x's were
        ypl = yg.placements
        if B % math.prod(yg.device_mesh.size(j)
                         for j, q in enumerate(ypl) if q.is_shard(0)):
            from torch.distributed.tensor import Replicate
            yg = yg.redistribute(yg.device_mesh, tuple(
                Replicate() if q.is_shard(0) else q for q in ypl))
    return yg.to(x.dtype).reshape(B, S, d), aux.mean()


# -- dropless serving: each expert's rows in sorted row tiles ---------------

#: the fields of the dropless layer's device tally (``obs.tally("moe")``,
#: summed over the captured calls): (token, expert) pairs routed, live
#: row tiles, tile rows computed (live tiles x bm), experts that needed a
#: second tile, experts that got a row
MOE_TALLY = ("pairs", "live_tiles", "tile_rows", "second_tiles",
             "experts_touched")


def dropless_tile(T: int, m) -> int:
    """The row tile ``bm`` of a dropless call over T tokens: twice the
    mean rows an expert gets (T k / E), up to a multiple of 8, so that
    one tile nearly always holds an expert's rows: 16 at T 32 with top-2
    of 8 (an expert's count is about Binomial(T, k / E), 8 +- 2.4 there,
    past 16 for 6 experts in 10,000)."""
    return 8 * max(1, -(-2 * T * m.top_k // (8 * m.num_experts)))


def tile_table(top_e, E: int, bm: int):
    """The sorted-tile layout of one call's (token, expert) pairs, built
    on the device with no read back.  top_e (T, k) ->

      ids   (n,)       int32: the expert of each row tile; -1 past the
                       live ones (idle tiles);
      rows  (T k,)     the tile row of each pair, token-major;
      inv   (n bm,)    the token each tile row reads (T: a zero row);
      counts, tiles (E,): each expert's pairs and row tiles.

    Pairs sort by expert (stable, so tokens keep their order inside an
    expert); expert e takes ceil(c_e / bm) consecutive tiles.  The table
    holds n = E + ceil(T k / bm) tiles, at least sum_e ceil(c_e / bm)
    for any counts (each ceiling adds less than one tile), so its size
    is known on the host before any count is."""
    T, k = top_e.shape
    dev = top_e.device
    flat = top_e.reshape(-1)
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat))
    tiles = torch.div(counts + (bm - 1), bm, rounding_mode="floor")
    end = torch.cumsum(tiles, 0)
    n = E + -(-T * k // bm)
    # the expert whose tiles cover tile t: the experts ending at or
    # before it; E (idle) past the last live tile
    ids = torch.searchsorted(end, torch.arange(n, device=dev), right=True)
    ids = torch.where(ids < E, ids, -1).to(torch.int32)
    first = torch.cumsum(counts, 0) - counts
    at = (end - tiles)[se] * bm + torch.arange(T * k, device=dev) - first[se]
    rows = torch.empty_like(at).scatter_(0, order, at)
    inv = torch.full((n * bm,), T, dtype=torch.long, device=dev).scatter_(
        0, at, torch.div(order, k, rounding_mode="floor"))
    return ids, rows, inv, counts, tiles


def _tile_routes(be: Policy, cfg: ModelConfig, bm: int, dtype):
    """The router's decisions for the three expert GEMMs of a dropless
    call in row tiles of ``bm`` (gate, up: (bm, d, f); down: (bm, f,
    d)), or None where the policy's non-GEMM family is the library or
    the router sends a tile to the library, whose ragged path copies one
    expert's weights a tile."""
    if not be.use_kernels:
        return None
    m = cfg.moe
    E, d, f = m.num_experts, cfg.d_model, m.d_expert
    routes = [api.route("ragged_gemm", (E, bm, K, N), dtype, policy=be)
              for K, N in ((d, f), (d, f), (f, d))]
    return routes if all(r.use_kernel for r in routes) else None


def _dropless_moe(p, xf, cfg: ModelConfig, bm: int, routes):
    """xf (T, d) -> y (T, d) through sorted row tiles: route (as the
    capacity layout does), the tile table (:func:`tile_table`), every
    pair's row gathered into its tile (padding rows zero), gate, up and
    down on the ragged kernel (``grouped_gemm.ragged_gemm`` with the
    router's blocks; idle tiles load nothing) with the SwiGLU between
    them, then each token's k rows combined with its weights as
    :func:`_moe_combine` does.  Spans ``model.moe.dispatch``,
    ``model.moe.experts`` and ``model.moe.combine`` (unranged); inside a
    capture the call also adds its counts to the device tally ``moe``
    (:data:`MOE_TALLY`).  No value is read back to the host."""
    m = cfg.moe
    T, d = xf.shape
    E, k = m.num_experts, m.top_k
    with obs.span("model.moe.dispatch", ranged=False):
        _, _, top_p, top_e = _route(p.router, xf, k)
        ids, rows, inv, counts, tiles = tile_table(top_e, E, bm)
        buf = torch.cat([xf, xf.new_zeros(1, d)])[inv]
        if obs.capturing():
            live = tiles.sum()
            obs.tally("moe", MOE_TALLY, torch.stack([
                counts.sum(), live, live * bm, (tiles > 1).sum(),
                (counts > 0).sum()]))
    with obs.span("model.moe.experts", ranged=False):
        wg, wu, wd = (w.to(xf.dtype) for w in (p.w_gate, p.w_up, p.w_down))
        dg, du, dd = routes
        g = _gg.ragged_gemm(buf, wg, ids, bm=bm, blocks=dg.blocks,
                            idle_tiles=True)
        u = _gg.ragged_gemm(buf, wu, ids, bm=bm, blocks=du.blocks,
                            idle_tiles=True)
        h = (F.silu(g.float()) * u.float()).to(g.dtype)
        out = _gg.ragged_gemm(h, wd, ids, bm=bm, blocks=dd.blocks,
                              idle_tiles=True)
    with obs.span("model.moe.combine", ranged=False):
        pair_rows = out[rows].reshape(T, k, d)
        return ref.f32_einsum("tkd,tk->td", pair_rows,
                              top_p.to(pair_rows.dtype)).to(pair_rows.dtype)


def moe(p, x, be: Policy, cfg: ModelConfig, serving: bool = False):
    """x: (B, S, d) -> (y, aux).

    One dispatch over all B*S tokens (padding rows included: they route
    and take capacity, as in the reference), the expert FFN, the combine;
    or, where the activation context asks for G = ``moe_shard_count()`` >
    1 dispatch groups and T = B*S splits into G shards of a multiple of 8
    tokens (the reference's guard), the per-data-shard branch: each
    shard routes its T/G tokens at its own capacity, the expert FFN runs
    on the (G, E, C, d) buffer, each shard combines its own tokens, and
    aux is the shards' mean.

    A dropless configuration's ``serving`` calls (a decode step or a
    prefill chunk; one dispatch group, plain tensors) take sorted row
    tiles instead (:func:`_dropless_moe`, row tile :func:`dropless_tile`)
    where the router keeps every tile on the ragged kernel; their aux is
    0.0, a training term the serving paths drop.  Every other call of a
    dropless configuration runs the capacity layout at C = T
    (:func:`_capacity`), which computes the same result."""
    m = cfg.moe
    B, S, d = x.shape
    T, k = B * S, m.top_k
    G = moe_shard_count()
    if spmd.is_dtensor(x):
        return _sharded_moe(p, x, be, cfg, G)
    if m.dropless and serving and G <= 1:
        bm = dropless_tile(T, m)
        routes = _tile_routes(be, cfg, bm, x.dtype)
        if routes is not None:
            y = _dropless_moe(p, x.reshape(T, d), cfg, bm, routes)
            return y.to(x.dtype).reshape(B, S, d), 0.0
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
