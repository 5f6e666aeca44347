"""Grouped small-GEMM kernels on Hopper — IAAT's ML habitat.

Counterpart of ``repro/kernels/grouped_gemm.py``: G independent
(rows_g x K) @ (K x N) products whose row counts the input sets (the MoE
expert FFN).  Two kernels, both in ``csrc/grouped_gemm.cu``:

* :func:`batched_gemm` — equal-capacity groups, x (G, C, K) @ w (G, K, N);
* :func:`ragged_gemm`  — group-contiguous rows in row tiles of ``bm``
  rows, one group id per tile, x (T, K) @ w[gid] (G, K, N).

Each wrapper launches its CUDA kernel on a CUDA tensor (or raises; there
is no fallback), counts the launch (:func:`launch_count`) and its path
(:func:`path_count`), and on a CPU tensor runs its plain version
(:func:`batched_gemm_plain`, :func:`ragged_gemm_plain`: f32
accumulation, f64 for D, one cast).  The kernels have no backward yet: a
CUDA call that autograd would record raises.

The path follows the operands (:func:`launch_plan`, no knob): the
``cp.async`` ring when x's k and w's n have unit stride and 16-byte-aligned
rows (:func:`load_path`; the MoE layer's buffers and weights), else the
scalar loads; on the ring a bf16 product runs on the tensor cores
(``mma.sync``, counted as "mma").  A launch whose grid holds under half
as many blocks as the card has SMs is cut along K
(``plan.grouped_slices``) and reduced in the same launch, through a ``torch.empty`` workspace and one
zeroed ticket per output tile (the IAAT kernel's ticket array).

Blocks are an instance ``(bm, bn, bk)`` of the install-time table
(:func:`pick_blocks`, or ``Decision.blocks`` from ``repro_torch.api``).
For ragged, the caller's row tile ``bm`` is a separate argument: the
instance's ``bm`` may be larger (the tile's rows are masked) or smaller
(the tile spans several blocks).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import kernelgen, plan, vmem
from repro_torch.kernels import iaat_gemm
from repro_torch.kernels.iaat_gemm import records_grad

#: the most blocks a CUDA grid takes along y and z
_GRID_YZ_MAX = 65535

_launches = {"batched_gemm": 0, "ragged_gemm": 0}
#: launches of either kernel by path: "ring" (16-byte cp.async copies),
#: "scalar" (synchronous element loads), "split" (K slices > 1, either
#: path) and "mma" (the ring's bf16 product on the tensor cores)
_paths = {"ring": 0, "scalar": 0, "split": 0, "mma": 0}


def launch_count(kernel: str) -> int:
    """CUDA launches of ``kernel`` ("batched_gemm" or "ragged_gemm")
    since the last :func:`reset_launch_count`."""
    return _launches[kernel]


def path_count(path: str) -> int:
    """Launches of either kernel since the last :func:`reset_launch_count`
    on ``path``: "ring", "scalar", "split" or "mma"."""
    return _paths[path]


def reset_launch_count() -> None:
    for d in (_launches, _paths):
        for k in d:
            d[k] = 0


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
    the accumulator dtype, one cast; a tile whose id is negative (idle)
    gives zero rows."""
    acc, out = _acc_out(x, w)
    T, K = x.shape
    ids = tile_group_ids.long()
    wt = w[ids.clamp(min=0)]                          # (T // bm, K, N)
    prod = torch.matmul(x.reshape(-1, bm, K).to(acc), wt.to(acc))
    prod = torch.where((ids >= 0)[:, None, None], prod, 0)
    return prod.reshape(T, w.shape[-1]).to(out)


# --------------------------------------------------------------------------
# The launches.
# --------------------------------------------------------------------------

def _ring_rows(t: torch.Tensor) -> bool:
    """Whether ``t`` has unit stride along its last dim, a 16-byte-aligned
    start and 16-byte multiples for the stride of every other dim that
    has more than one element: 16-byte copies along its rows are then
    aligned."""
    item = t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        (s * item) % 16 == 0 for d, s in zip(t.shape[:-1], t.stride()[:-1])
        if d > 1)


def load_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The grouped kernels' path for x (G, C, K) or (T, K) and w (G, K,
    N), by their strides: "ring" when x has k and w has n of unit stride
    and both have 16-byte-aligned rows (the ring's copies; the MoE layer's
    row-major buffers and weights); else "scalar"."""
    return "ring" if _ring_rows(x) and _ring_rows(w) else "scalar"


def launch_plan(x: torch.Tensor, w: torch.Tensor,
                blocks: Tuple[int, int, int], tile: Optional[int] = None
                ) -> Tuple[str, int]:
    """(path, K slices) of one grouped launch: batched x (G, C, K), or,
    with ``tile``, ragged x (T, K) in row tiles of ``tile`` rows; w (G, K,
    N).  The grid holds ceil(N / bn) x ceil(rows / bm) blocks per group
    or row tile, and it is split along K by ``plan.grouped_slices``."""
    bm, bn, bk = blocks
    K, N = w.shape[1], w.shape[2]
    tiles, rows = (x.shape[0], x.shape[1]) if tile is None else \
        (x.shape[0] // tile, tile)
    grid = _cdiv(N, bn) * _cdiv(rows, bm) * tiles
    return load_path(x, w), plan.grouped_slices(grid, K, bk)


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


def _split(dev, letter: str, slices: int, tiles: int, rows: int, N: int,
           steps: int):
    """(workspace, its pointer, the tickets' pointer) of a launch of
    ``slices`` K slices over ``tiles`` output tiles and ``rows`` x N
    outputs; (None, None, None) for one slice.  It raises past the ticket
    array's length, and for more slices than K has ``steps`` of bk."""
    if not 1 <= slices <= max(steps, 1):
        raise ValueError(f"{slices} K slices of {steps} bk steps")
    if slices == 1:
        return None, None, None
    if tiles > iaat_gemm._TICKETS_LEN:
        raise ValueError(f"a split grouped grid of {tiles} tiles exceeds "
                         f"the {iaat_gemm._TICKETS_LEN} tickets")
    acc = torch.float64 if letter == "D" else torch.float32
    # held until the launch is queued; the stream orders any reuse
    ws = torch.empty((slices, rows, N), dtype=acc, device=dev)
    # the tickets of the stream the launch goes to (_call's)
    tickets = iaat_gemm._tickets_on(
        dev, torch._C._cuda_getCurrentRawStream(dev.index))
    return ws, ws.data_ptr(), tickets.data_ptr()


def _call(name: str, letter: str, path: str, slices: int, x,
          *args) -> None:
    from repro_torch.kernels import build
    fn = getattr(build.load(), f"{name}_{path}_{letter}")
    # the launch goes to x's device and its current stream (the raw
    # handle, as iaat_gemm does: a Stream object costs host time a call)
    idx = x.get_device()
    if idx == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(x.device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if rc == -1:
        raise RuntimeError(f"{name}_{path}_{letter}: blocks {args[:3]} are "
                           "not an instance of the built kernel table")
    if rc:
        msg = build.load().iaat_error_string(rc).decode()
        raise RuntimeError(f"{name}_{path}_{letter}: launch failed: {msg}")
    _launches[name] += 1
    _paths[path] += 1
    _paths["split"] += slices > 1
    _paths["mma"] += path == "ring" and letter == "H"


def _launch_batched(x, w, blocks, slices: Optional[int] = None):
    """The batched kernel on x (G, C, K) and w (G, K, N); ``slices``
    overrides the split rule (a measurement's knob, not the callers')."""
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
    path, rule = launch_plan(x, w, blocks)
    slices = slices or rule
    ws, ws_p, tk_p = _split(x.device, letter, slices,
                            _cdiv(N, bn) * _cdiv(C, bm) * G, G * C, N,
                            _cdiv(K, bk))
    _call("batched_gemm", letter, path, slices, x, bm, bn, bk,
          x.data_ptr(), *x.stride(), w.data_ptr(), *w.stride(),
          out.data_ptr(), *out.stride(), G, C, N, K, slices, ws_p, tk_p)
    return out


def _launch_ragged(x, w, ids, bm: int, blocks,
                   slices: Optional[int] = None):
    """The ragged kernel on x (T, K) in row tiles of ``bm`` and w (G, K,
    N); ``slices`` as for :func:`_launch_batched`."""
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
    if ntiles > _GRID_YZ_MAX or _cdiv(bm, blocks[0]) > _GRID_YZ_MAX:
        raise ValueError(f"ragged_gemm: {ntiles} row tiles of {bm} exceed "
                         "the CUDA grid")
    path, rule = launch_plan(x, w, blocks, tile=bm)
    slices = slices or rule
    ws, ws_p, tk_p = _split(
        x.device, letter, slices,
        _cdiv(N, blocks[1]) * _cdiv(bm, blocks[0]) * ntiles, T, N,
        _cdiv(K, blocks[2]))
    _call("ragged_gemm", letter, path, slices, x, *blocks,
          x.data_ptr(), *x.stride(), w.data_ptr(), *w.stride(),
          ids.data_ptr(), bm, ntiles, out.data_ptr(), *out.stride(), N, K,
          slices, ws_p, tk_p)
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
                blocks: Optional[Tuple[int, int, int]] = None,
                idle_tiles: bool = False) -> torch.Tensor:
    """x (T, K) group-contiguous (each group padded to ``bm`` rows, the
    padding zeroed); w (G, K, N); tile_group_ids (T // bm,) mapping each
    row tile to its group.  Returns (T, N).  Every id must be in [0, G):
    it is checked here, before any launch (one device-to-host read).

    ``idle_tiles``: an id may also be -1, an idle tile, whose CUDA blocks
    exit before they load anything and whose output rows are left as
    ``torch.empty`` made them (zero in the plain version), so the caller
    reads none of them; the ids are the caller's to keep in [-1, G) and
    are not read on the host (a table built on the device, sized for the
    worst case, costs no sync)."""
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
    if tile_group_ids.numel() and not idle_tiles:
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
