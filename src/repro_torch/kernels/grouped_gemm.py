"""Grouped small-GEMM kernels on Hopper — IAAT's ML habitat.

Counterpart of ``repro/kernels/grouped_gemm.py``: G independent
(rows_g x K) @ (K x N) products whose row counts the input sets (the MoE
expert FFN).  Two kernels, both in ``csrc/grouped_gemm.cu``:

* :func:`batched_gemm` — equal-capacity groups, x (G, C, K) @ w (G, K, N);
* :func:`ragged_gemm`  — group-contiguous rows in row tiles of ``bm``
  rows, one group id per tile, x (T, K) @ w[gid] (G, K, N).

Each wrapper launches its CUDA kernel on a CUDA tensor (or raises; there
is no fallback), counts the launch (:func:`launch_count`), and on a CPU
tensor runs its plain version (:func:`batched_gemm_plain`,
:func:`ragged_gemm_plain`: f32 accumulation, f64 for D, one cast).  The
kernels have no backward yet: a CUDA call that autograd would record
raises.

Blocks are an instance ``(bm, bn, bk)`` of the install-time table
(:func:`pick_blocks`, or ``Decision.blocks`` from ``repro_torch.api``).
For ragged, the caller's row tile ``bm`` is a separate argument: the
instance's ``bm`` may be larger (the tile's rows are masked) or smaller
(the tile spans several blocks).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import kernelgen, vmem
from repro_torch.kernels.iaat_gemm import records_grad

#: the most blocks a CUDA grid takes along y and z
_GRID_YZ_MAX = 65535

_launches = {"batched_gemm": 0, "ragged_gemm": 0}


def launch_count(kernel: str) -> int:
    """CUDA launches of ``kernel`` ("batched_gemm" or "ragged_gemm")
    since the last :func:`reset_launch_count`."""
    return _launches[kernel]


def reset_launch_count() -> None:
    for k in _launches:
        _launches[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(a // -b)


def pick_blocks(C: int, K: int, N: int, dtype) -> Tuple[int, int, int]:
    """IAAT install-time table lookup for the per-group (C, K, N) problem.

    Returns an instance ``(bm, bn, bk)`` of the Hopper table: the largest
    bm not past C's aligned extent, then among those instances the largest
    bn not past N's, then the largest bk not past K's (the smallest the
    table has where none is that small).  The reference took each
    dimension's maximum on its own and halved until VMEM fit; on Hopper a
    pair of per-dimension maxima may not exist (S/H have no (128, 256); D
    lacks (64, 256), (128, 128) and (128, 256)), and every instance fits
    shared memory already, so the choice is made among whole instances."""
    letter = kernelgen.blas_letter(dtype)
    cands = [(s.bm, s.bn, s.bk) for s in kernelgen.kernel_table(letter, "NN")]
    limits = (vmem.align_m(C, dtype), vmem.align_n(N, dtype),
              vmem.align_k(K, dtype))
    for axis, limit in enumerate(limits):
        vals = [c[axis] for c in cands]
        pick = max([v for v in vals if v <= limit] or [min(vals)])
        cands = [c for c in cands if c[axis] == pick]
    return cands[0]


# --------------------------------------------------------------------------
# The plain versions.
# --------------------------------------------------------------------------

def _acc_out(x, w):
    out = torch.promote_types(x.dtype, w.dtype)
    return torch.promote_types(out, torch.float32), out


def batched_gemm_plain(x, w):
    """x (G, C, K) @ w (G, K, N) in the accumulator dtype (f32, f64 for
    D), one cast to promote_types(x, w)."""
    acc, out = _acc_out(x, w)
    return torch.matmul(x.to(acc), w.to(acc)).to(out)


def ragged_gemm_plain(x, w, tile_group_ids, bm: int):
    """Row tile t of x (rows [t*bm, (t+1)*bm)) @ w[tile_group_ids[t]], in
    the accumulator dtype, one cast."""
    acc, out = _acc_out(x, w)
    T, K = x.shape
    wt = w[tile_group_ids.long()]                     # (T // bm, K, N)
    prod = torch.matmul(x.reshape(-1, bm, K).to(acc), wt.to(acc))
    return prod.reshape(T, w.shape[-1]).to(out)


# --------------------------------------------------------------------------
# The launches.
# --------------------------------------------------------------------------

def _kernel_letter(name: str, *ts) -> str:
    dt = ts[0].dtype
    for t in ts:
        if t.dtype != dt:
            raise TypeError(f"{name}: operands are {[t.dtype for t in ts]}; "
                            "the kernel takes one dtype")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{ts[0].device}")
    letter = kernelgen.blas_letter(dt)
    if letter not in kernelgen.KERNEL_LETTERS:
        raise NotImplementedError(f"{name}: no CUDA kernel for {dt}")
    if records_grad(*ts):
        raise NotImplementedError(f"{name}: the CUDA kernel has no backward "
                                  "yet")
    return letter


def _call(name: str, letter: str, dev, *args) -> None:
    from repro_torch.kernels import build
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"{name}_{letter}")(*args, stream)
    if rc == -1:
        raise RuntimeError(f"{name}_{letter}: blocks {args[:3]} are not an "
                           "instance of the built kernel table")
    if rc:
        msg = lib.iaat_error_string(rc).decode()
        raise RuntimeError(f"{name}_{letter}: launch failed: {msg}")
    _launches[name] += 1


def _launch_batched(x, w, blocks):
    letter = _kernel_letter("batched_gemm", x, w)
    G, C, K = x.shape
    N = w.shape[2]
    bm, bn, bk = blocks
    out = torch.empty((G, C, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    if G > _GRID_YZ_MAX or _cdiv(C, bm) > _GRID_YZ_MAX:
        raise ValueError(f"batched_gemm: G={G}, C={C} at bm={bm} exceed the "
                         "CUDA grid")
    _call("batched_gemm", letter, x.device, bm, bn, bk,
          x.data_ptr(), *x.stride(), w.data_ptr(), *w.stride(),
          out.data_ptr(), *out.stride(), G, C, N, K)
    return out


def _launch_ragged(x, w, ids, bm: int, blocks):
    letter = _kernel_letter("ragged_gemm", x, w)
    T, K = x.shape
    N = w.shape[2]
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    ids = ids.to(device=x.device, dtype=torch.int32).contiguous()
    ntiles = T // bm
    if ntiles * _cdiv(bm, blocks[0]) > _GRID_YZ_MAX:
        raise ValueError(f"ragged_gemm: {ntiles} row tiles of {bm} exceed "
                         "the CUDA grid")
    _call("ragged_gemm", letter, x.device, *blocks,
          x.data_ptr(), *x.stride(), w.data_ptr(), *w.stride(),
          ids.data_ptr(), bm, ntiles, out.data_ptr(), *out.stride(), N, K)
    return out


# --------------------------------------------------------------------------
# Public entries.
# --------------------------------------------------------------------------

def batched_gemm(x: torch.Tensor, w: torch.Tensor, *,
                 blocks: Optional[Tuple[int, int, int]] = None
                 ) -> torch.Tensor:
    """x (G, C, K) @ w (G, K, N) -> (G, C, N).  Operands may be any
    strided views; ``blocks`` defaults to :func:`pick_blocks`."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise ValueError(f"batched_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (G, C, K), (G, K, N)")
    if x.device.type == "cuda":
        G, C, K = x.shape
        return _launch_batched(
            x, w, blocks or pick_blocks(C, K, w.shape[2], x.dtype))
    if x.device.type != "cpu":
        raise ValueError(f"no grouped kernel for device {x.device}")
    return batched_gemm_plain(x, w)


def ragged_gemm(x: torch.Tensor, w: torch.Tensor,
                tile_group_ids: torch.Tensor, *, bm: int = 128,
                blocks: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
    """x (T, K) group-contiguous (each group padded to ``bm`` rows, the
    padding zeroed); w (G, K, N); tile_group_ids (T // bm,) mapping each
    row tile to its group.  Returns (T, N).  Every id must be in [0, G):
    it is checked here, before any launch (one device-to-host read)."""
    T, K = x.shape
    G, Kw, N = w.shape
    if K != Kw:
        raise ValueError(f"ragged_gemm: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    if bm < 1 or T % bm:
        raise ValueError(f"T={T} must be padded to bm={bm}")
    if tuple(tile_group_ids.shape) != (T // bm,):
        raise ValueError(f"tile_group_ids {tuple(tile_group_ids.shape)} != "
                         f"({T // bm},)")
    if tile_group_ids.numel():
        lo, hi = (int(v) for v in torch.aminmax(tile_group_ids))
        if lo < 0 or hi >= G:
            raise ValueError(f"tile_group_ids in [{lo}, {hi}], not in "
                             f"[0, {G})")
    if x.device.type == "cuda":
        return _launch_ragged(x, w, tile_group_ids, bm,
                              blocks or pick_blocks(bm, K, N, x.dtype))
    if x.device.type != "cpu":
        raise ValueError(f"no grouped kernel for device {x.device}")
    return ragged_gemm_plain(x, w, tile_group_ids, bm)
