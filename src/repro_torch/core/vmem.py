"""Register Allocator (paper §IV-C), adapted: the Hopper block budget.

The paper allocates 32x128-bit NEON registers across three groups (A
columns, B rows, the C block).  The module keeps the JAX package's name so
its counterpart is easy to find, but on an H100 the two scarce resources
of one CUDA block are these (DESIGN_PORT.md §1):

1. *Shared memory.*  The kernel stages one (bk x bm) tile of A and one
   (bk x bn) tile of B per K step (the complex kernel of (re, im) pairs).  A block may use 227 KB of the SM's
   256 KB, above 48 KB only as dynamic shared memory after an opt-in;
   :func:`footprint` checks a candidate against that budget.  The real
   kernel's asynchronous path keeps a ring of such tiles, as many stages
   (up to :data:`RING_STAGES_MAX`) as leave room for two blocks on an SM
   (:data:`RING_BUDGET`, :func:`ring_stage_bytes`, ``Footprint.stages``).
2. *Registers.*  Each of the kernel's 256 threads keeps bm*bn/256
   accumulators (two 32-bit registers each for f64; three planes of them,
   Karatsuba's P1, P2 and P3, in the complex kernel).  :func:`reg_pressure`
   replaces ``vreg_pressure``: the table keeps the accumulators at or
   under :data:`ACC_REG_CAP` registers so a thread stays well inside the
   255-register limit and two blocks fit on one SM's 65,536 registers.

The alignment grain (``align_*``, :data:`GRAIN_M`, :data:`GRAIN_N`)
replaces the TPU's (sublane, lane) tiling.
"""
from __future__ import annotations

import dataclasses

import torch

SMEM_OPTIN_BYTES = 232448       # 227 KB: the most one block can opt into
SMEM_SM_BYTES = 233472          # 228 KB of shared memory on one SM
SMEM_BLOCK_RESERVED = 1024      # shared memory the runtime keeps per block
NUM_SMS = 132                   # streaming multiprocessors of an H100 SXM
#: resident blocks per SM the table is designed for (ACC_REG_CAP keeps two
#: blocks' registers within one SM's 65,536)
BLOCKS_PER_SM = 2
RING_STAGES_MAX = 3             # stages of the real kernel's cp.async ring
#: shared memory a ring may take so that BLOCKS_PER_SM blocks share an SM
RING_BUDGET = SMEM_SM_BYTES // BLOCKS_PER_SM - SMEM_BLOCK_RESERVED
NTHREADS = 256                  # threads per block of the IAAT kernel
#: the complex kernel (csrc/cx_gemm.cu): complex elements padding a staged
#: row, and k rows of one stage of its ring (a bk step is bk / CX_RING_K
#: stages)
CX_PAD = 2
CX_RING_K = 16
ACC_REG_CAP = 64                # accumulator registers per thread
LINE_BYTES = 128                # one coalesced warp transaction (32 x 4 B)
# Rows: multiples of 16, the m16 of mma.sync.  A CUDA-core kernel has no
# hard row grain; m16 keeps the table valid for the tensor-core kernels
# later PRs put behind it.  Columns: multiples of 64, one whole 128-byte
# line of bf16 (two of f32, four of f64) per warp row, and the narrowest
# width the thread layout tiles at bm=16 (16 x 64 = 4 outputs a thread).
GRAIN_M = 16
GRAIN_N = 64


def itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def line_elems(dtype: torch.dtype) -> int:
    """Elements of one 128-byte line (bf16 64, f32 32, f64 16): a warp's
    coalesced transaction along a unit-stride dim."""
    return LINE_BYTES // itemsize(dtype)


def pad(dtype: torch.dtype) -> int:
    """Elements of padding per shared-memory row (4 bytes, at least one
    element), so that a column of a tile spreads across the 32 banks."""
    return max(1, 4 // itemsize(dtype))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def align_m(m: int, dtype) -> int:
    return round_up(max(m, 1), GRAIN_M)


def align_n(n: int, dtype) -> int:
    return round_up(max(n, 1), GRAIN_N)


def align_k(k: int, dtype) -> int:
    # K is the contiguous dim of A(N)/B(T): align it to whole lines
    return round_up(max(k, 1), line_elems(dtype))


@dataclasses.dataclass(frozen=True)
class Footprint:
    """``total`` is one bk step of the synchronous loop (the real
    kernel's scalar path); ``stages`` x ``stage_bytes`` is the ring (the
    complex kernel's holds one bk step, cut into stages)."""
    a_bytes: int
    b_bytes: int
    acc_regs: int
    total: int
    stages: int = 1
    stage_bytes: int = 0

    @property
    def ring_bytes(self) -> int:
        return self.stages * self.stage_bytes

    @property
    def blocks_per_sm(self) -> int:
        """Blocks of the ring path resident on one SM: BLOCKS_PER_SM when
        the ring fits RING_BUDGET, else one."""
        return BLOCKS_PER_SM if self.ring_bytes <= RING_BUDGET else 1

    @property
    def fits(self) -> bool:
        return self.total <= SMEM_OPTIN_BYTES and \
            self.ring_bytes <= SMEM_OPTIN_BYTES and \
            self.acc_regs <= ACC_REG_CAP


def reg_pressure(bm: int, bn: int, acc_dtype=torch.float32, *,
                 complex_: bool = False) -> int:
    """Accumulator registers per thread for a (bm x bn) C block; the
    complex (Karatsuba) kernel keeps three planes, P1, P2 and P3."""
    words = max(1, itemsize(acc_dtype) // 4)
    planes = 3 if complex_ else 1
    return -(-bm * bn // NTHREADS) * words * planes


def ring_stage_bytes(bm: int, bn: int, bk: int, dtype) -> int:
    """One stage of the real kernel's ring (``csrc/tile.cuh`` ``Ring``):
    the A tile as bm rows of bk (k contiguous) and the B tile as bk rows
    of bn or bn rows of bk (whichever way B's unit stride runs: room for
    the larger), every row padded by 16 bytes so that rows stay aligned
    for 16-byte copies and a column spreads over the banks."""
    item = itemsize(dtype)
    p = 16 // item
    return (bm * (bk + p) + max(bk * (bn + p), bn * (bk + p))) * item


def footprint(bm: int, bn: int, bk: int, dtype, *, complex_: bool = False,
              acc_dtype=torch.float32) -> Footprint:
    """Shared bytes and accumulator registers of one (bm, bn, bk) block:
    the A tile bk x (bm + pad) and the B tile bk x (bn + pad), staged once
    per K step in the synchronous loop.  ``dtype`` is the plane type; a
    complex block stages its tiles as (re, im) pairs, rows of bm (bn)
    complex elements padded by :data:`CX_PAD` (the Karatsuba sums Ar+Ai,
    Br+Bi are formed in registers, not staged), and streams one bk step
    through a ring of bk / :data:`CX_RING_K` stages of CX_RING_K rows.  A
    real block's ring takes as many stages of :func:`ring_stage_bytes` as
    fit :data:`RING_BUDGET` (two blocks an SM), at most
    :data:`RING_STAGES_MAX` and at least one (then one block an SM, within
    the 227 KB opt-in)."""
    item, p = itemsize(dtype), pad(dtype)
    regs = reg_pressure(bm, bn, acc_dtype, complex_=complex_)
    if complex_:
        a = bk * (bm + CX_PAD) * 2 * item
        b = bk * (bn + CX_PAD) * 2 * item
        stages = bk // CX_RING_K
        return Footprint(a, b, regs, a + b, stages, (a + b) // stages)
    a = bk * (bm + p) * item
    b = bk * (bn + p) * item
    stage = ring_stage_bytes(bm, bn, bk, dtype)
    stages = max(1, min(RING_STAGES_MAX, RING_BUDGET // stage))
    return Footprint(a, b, regs, a + b, stages, stage)


def thread_layout_ok(bm: int, bn: int) -> bool:
    """The kernel's thread layout (csrc/iaat_gemm.cu): each of 256 threads
    owns TM rows x TN=4 columns, with bn/4 threads across a row."""
    per = bm * bn // NTHREADS
    return (bm * bn % NTHREADS == 0 and per >= 4 and per % 4 == 0
            and NTHREADS % (bn // 4) == 0 and bn % 4 == 0)
