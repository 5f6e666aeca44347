"""Attention over a paged KV pool, read through a block table, on Hopper.

q (B, H, C, D) attends over one layer's pools k, v (P, Hkv, BS, D)
through ``block_table`` (B, nmax), with absolute query positions
``q_pos`` (B, C): flattened key j of a slot's table holds sequence
position j, and row (b, h, c) sees the keys ``j <= q_pos[b, c]`` (and,
with a window, ``j > q_pos[b, c] - window``), GQA by kv head
``h // (H // Hkv)``.  Decode rows (C == 1, or ``q_pos >= decode_from``
in a chunk: recompute-resume replays of decoded tokens) take the
normalised-softmax order, the others the unnormalised-exp (flash) order:
the reference's two reduction orders (``repro/models/layers.py``
``paged_attend``).

* :func:`paged_attention_plain` is the plain PyTorch version: the whole
  table gathered, f32 products of the widened operands, masks, softmax.
  It is the model's path wherever the kernel is not
  (``models/layers.py::paged_attend``), and the kernel's yardstick.
* On a CUDA tensor :func:`paged_attention` launches the hand-written
  kernel (``csrc/paged_attention.cu``, built by ``kernels/build.py``) or
  raises; on a CPU tensor it runs the plain version.  The kernel reads
  each slot's live blocks where they lie, once per group of query rows,
  and reads ``q_pos``, the table and ``decode_from`` on the device: a
  launch makes no host read and no sync.  Each launch is counted
  (:func:`launch_count`).
* :func:`applies` says which calls take the kernel: under a policy whose
  non-GEMM family is the kernel, bf16 pools on the card at a head dim of
  :data:`HEAD_DIMS`, at any table length (past about 50k keys the kernel
  scores the table in tiles, :func:`tile_blocks`).  The model chooses by
  it, never on failure.

The kernel has no backward: a CUDA call that autograd would record raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.kernels.iaat_gemm import records_grad
from repro_torch.kernels.ref import f32_einsum

#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128, 256)
#: query rows a CUDA block can hold (its instances)
ROWS = (1, 2, 4, 8)
#: the kernel's ring of K/V blocks in shared memory (``STAGES`` in the source)
STAGES = 4
#: dynamic shared memory a block may take: 227 KB less room for the
#: kernel's static arrays
SMEM_MAX = 232448 - 1024
#: blocks a launch should have to fill the card: one on each of an H100's
#: 132 SMs
FILL_BLOCKS = 132

_launches = 0


def launch_count() -> int:
    """CUDA launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def smem_bytes(rows: int, head_dim: int, block_size: int,
               table_len: int) -> int:
    """Dynamic shared memory of a block holding ``rows`` query rows: the
    ring of K/V blocks, the rows' q in f32 and their scores over
    ``table_len`` keys (the whole table, nmax x BS, or a tile of it) in
    f32."""
    return (STAGES * block_size * head_dim * 2 + rows * head_dim * 4
            + rows * table_len * 4)


def rows_per_block(rows: int, head_dim: int, block_size: int,
                   table_len: int, groups: int = 1) -> int:
    """The query rows a CUDA block holds for a call with ``rows`` = rep x C
    rows in each of ``groups`` = B x Hkv (slot, kv head) pairs: the
    smallest instance of :data:`ROWS` that holds a pair's rows, so that
    they share each K/V block read, halved while the launch would have
    fewer than :data:`FILL_BLOCKS` blocks (a prefill chunk: the rows'
    scores are the work there, and the K/V blocks read again come from
    L2) or its scores over the whole table do not fit shared memory; at
    one row a table of any length fits, in tiles (:func:`tile_blocks`)."""
    r = next((n for n in ROWS if n >= rows), ROWS[-1])
    while r > 1 and (groups * -(-rows // r) < FILL_BLOCKS or smem_bytes(
            r, head_dim, block_size, table_len) > SMEM_MAX):
        r //= 2
    return r


def tile_blocks(rows: int, head_dim: int, block_size: int,
                nmax: int) -> int:
    """The most table blocks whose scores a block of ``rows`` rows holds:
    the whole table (``nmax`` blocks) where it fits, else the kernel
    scores the slot's range in tiles of this many blocks, three times
    over K (about 50k keys a tile at one row)."""
    free = SMEM_MAX - smem_bytes(rows, head_dim, block_size, 0)
    return max(1, min(nmax, free // (rows * block_size * 4)))


def applies(use_kernels: bool, device: torch.device, dtype: torch.dtype,
            head_dim: int) -> bool:
    """Whether a call on pools of this device, dtype and head dim takes
    the kernel: the policy's non-GEMM family is the kernel
    (``Policy.use_kernels``) and the pools are bf16 on the card at a head
    dim of :data:`HEAD_DIMS`."""
    return (use_kernels and device.type == "cuda"
            and dtype == torch.bfloat16 and head_dim in HEAD_DIMS)


def paged_attention_plain(q, k_pool, v_pool, block_table, q_pos, *,
                          scale: float, window: Optional[int] = None,
                          decode_from=None):
    """Plain PyTorch version: the whole table gathered, the mask
    ``j <= q_pos`` (and the window's), then decode rows (C == 1) in the
    grouped-GQA normalised-softmax order, prefill rows in the repeated-KV
    unnormalised-exp (flash) order, and rows at ``q_pos >= decode_from``
    inside a C > 1 chunk in the decode order: the reference's exact
    reduction orders (``layers.py:151-187``)."""
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
    with obs.span("serve.sync", ranged=False):  # a blocking copy
        neg = torch.tensor(float("-inf"), device=q.device)
    if C == 1:
        qf = q.reshape(B, Hkv, rep, hd)
        logits = f32_einsum("bkrd,bksd->bkrs", qf, kg) * scale
        logits = torch.where(ok[:, None, None, 0, :], logits, neg)
        p = torch.softmax(logits, dim=-1)
        out = f32_einsum("bkrs,bksd->bkrd", p.to(vg.dtype), vg)
        return out.reshape(B, H, 1, hd).to(q.dtype)
    kb = torch.repeat_interleave(kg, rep, dim=1)
    vb = torch.repeat_interleave(vg, rep, dim=1)
    s = f32_einsum("bhqd,bhkd->bhqk", q, kb) * scale
    s = torch.where(ok[:, None], s, neg)
    m = s.amax(-1)                     # rows always see >= 1 valid key
    p = torch.exp(s - m[..., None])
    p = torch.where(ok[:, None], p, torch.zeros((), device=q.device))
    l = p.sum(-1)
    acc = f32_einsum("bhqk,bhkd->bhqd", p.to(vb.dtype), vb)
    flash = (acc / torch.clamp(l, min=1e-37)[..., None]).to(q.dtype)
    if decode_from is None:
        return flash
    qf = q.reshape(B, Hkv, rep, C, hd)
    logits = f32_einsum("bkrqd,bksd->bkrqs", qf, kg) * scale
    logits = torch.where(ok[:, None, None], logits, neg)
    pd = torch.softmax(logits, dim=-1)
    outd = f32_einsum("bkrqs,bksd->bkrqd", pd.to(vg.dtype), vg)
    outd = outd.reshape(B, H, C, hd).to(q.dtype)
    replay = q_pos >= decode_from[:, None]                      # (B, C)
    return torch.where(replay[:, None, :, None], outd, flash)


def _strides(t):
    return (ctypes.c_longlong * 4)(*t.stride())


def _launch(q, k_pool, v_pool, block_table, q_pos, scale, window,
            decode_from):
    global _launches
    from repro_torch.kernels import build
    B, H, C, D = q.shape
    P, Hkv, BS, _ = k_pool.shape
    nmax = block_table.shape[1]
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != torch.bfloat16 or q.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"paged_attention: no CUDA kernel for q {q.dtype}, {name} "
                f"{t.dtype} (bf16 only)")
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.stride(3) != 1 or t.stride(2) != D or t.stride() != \
                k_pool.stride() or t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} needs each block's "
                             "BS x D contiguous and 16-byte aligned, and "
                             "the two pools' strides equal")
    for name, t in (("block_table", block_table), ("q_pos", q_pos),
                    ("decode_from", decode_from)):
        if t is not None and (t.dtype != torch.int64 or
                              t.device != q.device):
            raise TypeError(f"paged_attention: {name} must be int64 on "
                            f"{q.device}")
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"paged_attention: no CUDA kernel for "
                                  f"head dim {D} (built: {HEAD_DIMS})")
    if records_grad(q, k_pool, v_pool):
        raise NotImplementedError("paged_attention: the CUDA kernel has no "
                                  "backward")
    rows = rows_per_block(H // Hkv * C, D, BS, nmax * BS, B * Hkv)
    tile = tile_blocks(rows, D, BS, nmax)
    out = torch.empty((B, C, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    lib = build.load()
    df = 0 if decode_from is None else decode_from.data_ptr()
    df_s = 0 if decode_from is None else decode_from.stride(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention(
            D, q.data_ptr(), _strides(q), k_pool.data_ptr(),
            v_pool.data_ptr(), k_pool.stride(0), k_pool.stride(1),
            block_table.data_ptr(), *block_table.stride(), q_pos.data_ptr(),
            *q_pos.stride(), df, df_s, out.data_ptr(), _strides(out), B, H,
            Hkv, C, BS, nmax, rows, tile, 0 if window is None else window,
            scale, smem_bytes(rows, D, BS, tile * BS), stream)
    if rc == -1:
        raise RuntimeError(f"paged_attention: (D={D}, rows={rows}) is not "
                           "an instance of the built kernel")
    if rc:
        msg = lib.iaat_error_string(rc).decode()
        raise RuntimeError(f"paged_attention: launch failed: {msg}")
    _launches += 1
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    q_pos: torch.Tensor, *, scale: float,
                    window: Optional[int] = None,
                    decode_from: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q (B, H, C, D); k_pool, v_pool (P, Hkv, BS, D); block_table (B, nmax)
    and q_pos (B, C) int64; decode_from (B,) int64 or None.  Returns
    (B, H, C, D) in q's dtype; on the card a view of a (B, C, H, D) buffer,
    so merging the heads back needs no copy.  Every row must see at least
    one key (``0 <= q_pos < nmax x BS``); ``window`` is at least 1 when
    given."""
    B, H, C, D = q.shape
    if k_pool.ndim != 4 or tuple(k_pool.shape) != tuple(v_pool.shape) or \
            k_pool.shape[3] != D or H % k_pool.shape[1] or \
            tuple(block_table.shape[:1]) != (B,) or \
            tuple(q_pos.shape) != (B, C):
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}, "
                         f"table {tuple(block_table.shape)}, q_pos "
                         f"{tuple(q_pos.shape)} are not (B, H, C, D), "
                         "(P, Hkv, BS, D) twice, (B, nmax), (B, C)")
    if window is not None and window < 1:
        raise ValueError(f"paged_attention: window {window} < 1")
    if q.device.type == "cuda":
        return _launch(q, k_pool, v_pool, block_table, q_pos, scale, window,
                       decode_from)
    if q.device.type != "cpu":
        raise ValueError(f"no paged attention kernel for device {q.device}")
    return paged_attention_plain(q, k_pool, v_pool, block_table, q_pos,
                                 scale=scale, window=window,
                                 decode_from=decode_from)
