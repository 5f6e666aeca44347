"""Tiled online-softmax attention on Hopper: GQA, causal with a query
offset, sliding window.

Counterpart of ``repro/kernels/flash_attention.py``: q (B, Hq, Sq, D),
k and v (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q's dtype, GQA by kv head
``h // (Hq // Hkv)`` with K and V never repeated in memory.

* On a CUDA tensor :func:`flash_attention` launches a hand-written CUDA
  kernel (``csrc/flash_attention.cu``, built by ``kernels/build.py``) or
  raises; there is no fallback.  bf16 at head dims :data:`TC_HEAD_DIMS`
  runs the tensor-core kernel (``wgmma``, ``flash_attention_tc``), every
  other (dtype, head dim) the CUDA-core kernel (``flash_attention``): the
  choice is by type (:func:`kernel_for`), never on failure.  Each launch
  is checked with ``cudaGetLastError`` and counted per kernel
  (:func:`launch_count`).  The kernels' tile sizes are their own, so the
  reference's ``bq``/``bkv`` have no counterpart here.
* The reference takes any head dim.  A D between the built instances
  (smollm's 20, zamba2's 112) is zero-padded along D to the next one
  (:func:`padded_head_dim`: 20 -> 32, 112 -> 128) and the output sliced
  back: zero columns leave q k^T unchanged and add zero columns to P V.
  The scale stays the caller's (1/sqrt of the unpadded D by default),
  never 1/sqrt(D_padded).  A D above 256 raises on the card.
* On a CPU tensor it runs :func:`flash_attention_plain`, the plain PyTorch
  version: the same online softmax over KV chunks, in f32, with the same
  masks and the same finite ``NEG_INF``/``1e-37`` handling, on the same
  padded operands.

The kernel has no backward: a CUDA call that autograd would record raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.iaat_gemm import records_grad

#: the reference kernel's finite stand-in for -inf (``flash_attention.py:23``)
NEG_INF = -1e30
#: head dims the CUDA kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: head dims of the tensor-core kernel (bf16 only)
TC_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the most blocks a CUDA grid takes along y and z
_GRID_YZ_MAX = 65535
#: KV chunk of the plain version (the reference kernel's default bkv)
_PLAIN_CHUNK = 128

_launches = {"flash_attention": 0, "flash_attention_tc": 0}


def launch_count(kernel: Optional[str] = None) -> int:
    """CUDA launches since the last :func:`reset_launch_count`: of
    ``kernel`` ("flash_attention_tc", the tensor-core kernel, or
    "flash_attention", the CUDA-core one), or of both when None."""
    if kernel is None:
        return sum(_launches.values())
    return _launches[kernel]


def reset_launch_count() -> None:
    for k in _launches:
        _launches[k] = 0


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call of this (dtype, head dim) launches, as the C
    entry chooses it."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "flash_attention_tc"
    return "flash_attention"


def padded_head_dim(D: int) -> int:
    """The built head dim a call of head dim ``D`` runs at: the smallest
    instance of :data:`HEAD_DIMS` at least ``D``."""
    for h in HEAD_DIMS:
        if h >= D:
            return h
    raise NotImplementedError(
        f"flash_attention: head dim {D} is above the largest built "
        f"instance, {HEAD_DIMS[-1]} (zero-padding only widens D, and the "
        "tensor-core kernel's tiles stop at 256); no config of the repo "
        "has one")


def _pad_d(t: torch.Tensor, D: int) -> torch.Tensor:
    """``t`` (B, H, S, d) zero-padded along its last dim to ``D``."""
    return torch.nn.functional.pad(t, (0, D - t.shape[3]))


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` when it has a unit stride along D and 16-byte-aligned rows
    (what the tensor-core kernel's 16-byte copies need), else a contiguous
    copy of it."""
    es = t.element_size()
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
            (st * es) % 16 == 0 for st in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          scale: Optional[float] = None):
    """Plain PyTorch version: online softmax over KV chunks in f32, masks
    ``ki < Sk``, causal ``ki <= qi``, window ``ki > qi - window`` (``qi``
    offset by ``q_offset``), masked scores at ``NEG_INF`` and their
    probabilities zeroed, output ``acc / max(l, 1e-37)`` cast once."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    qf = q.float().reshape(B, Hkv, rep, Sq, D)
    qi = torch.arange(Sq, device=dev)[:, None] + q_offset
    zero = torch.zeros((), device=dev)
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, rep, Sq), device=dev)
    acc = torch.zeros((B, Hkv, rep, Sq, D), device=dev)
    for k0 in range(0, Sk, _PLAIN_CHUNK):
        kb = k[:, :, k0:k0 + _PLAIN_CHUNK].float()
        vb = v[:, :, k0:k0 + _PLAIN_CHUNK].float()
        s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kb) * scale
        ki = k0 + torch.arange(kb.shape[2], device=dev)[None, :]
        ok = ki < Sk
        if causal:
            ok = ok & (ki <= qi)
        if window is not None:
            ok = ok & (ki > qi - window)
        s = torch.where(ok, s, torch.full((), NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), zero)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bgrqk,bgkd->bgrqd", p,
                                                   vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def _strides(t):
    return (ctypes.c_longlong * 4)(*t.stride())


def _launch(q, k, v, causal, window, q_offset, scale):
    from repro_torch.kernels import build
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}; the kernel takes one dtype")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"flash_attention: no CUDA kernel for "
                                  f"{q.dtype} (f32 and bf16 only)")
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"flash_attention: no CUDA kernel for "
                                  f"head dim {D} (built: {HEAD_DIMS}; "
                                  "flash_attention pads to them)")
    if records_grad(q, k, v):
        raise NotImplementedError("flash_attention: the CUDA kernel has no "
                                  "backward yet")
    if Hq > _GRID_YZ_MAX or B > _GRID_YZ_MAX:
        raise ValueError(f"flash_attention: B={B}, Hq={Hq} exceed the CUDA "
                         "grid")
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Sk == 0:
        return out.zero_()
    kernel = kernel_for(q.dtype, D)
    if kernel == "flash_attention_tc":
        q, k, v = _rows_aligned(q), _rows_aligned(k), _rows_aligned(v)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention(
            _DTYPE_CODE[q.dtype], D, q.data_ptr(), _strides(q),
            k.data_ptr(), _strides(k), v.data_ptr(), _strides(v),
            out.data_ptr(), _strides(out), B, Hq, Hkv, Sq, Sk, q_offset,
            int(causal), 0 if window is None else window, scale, stream)
    if rc == -1:
        raise RuntimeError(f"flash_attention: ({q.dtype}, D={D}) is not an "
                           "instance of the built kernel")
    if rc == -2:
        raise RuntimeError("flash_attention: the tensor-core kernel refused "
                           "operands without 16-byte-aligned rows")
    if rc:
        msg = lib.iaat_error_string(rc).decode()
        raise RuntimeError(f"flash_attention: launch failed: {msg}")
    _launches[kernel] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); returns (B, Hq, Sq, D).

    Operands may be any strided views (the CUDA kernel reads them through
    their strides).  ``window`` must be at least 1 when given.  A head dim
    between the built instances runs zero-padded to the next one (module
    docstring), on either device."""
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape) or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, Hq, Sq, D), (B, Hkv, Sk, D) twice")
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq}/{Hkv}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    D = q.shape[3]
    scale = scale if scale is not None else D ** -0.5
    card = _on_card(q)
    if not card and q.device.type != "cpu":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    # on the CPU a D past the instances has none to pad to: the plain
    # version takes any D
    Dp = D if not card and D > HEAD_DIMS[-1] else padded_head_dim(D)
    if Dp != D:
        q, k, v = _pad_d(q, Dp), _pad_d(k, Dp), _pad_d(v, Dp)
    if card:
        out = _launch(q, k, v, causal, window, q_offset, scale)
    else:
        out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)
    return out[..., :D] if Dp != D else out


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the card (the kernel's side)."""
    return t.device.type == "cuda"
