"""Register Allocator (paper §IV-C), adapted: the Hopper block budget.

The paper allocates 32x128-bit NEON registers across three groups (A
columns, B rows, the C block).  The module keeps the JAX package's name so
its counterpart is easy to find, but on an H100 the two scarce resources
of one CUDA block are these (DESIGN_PORT.md §1):

1. *Shared memory.*  The kernel stages one (bk x bm) tile of A and one
   (bk x bn) tile of B per K step (the complex kernel two of each: the
   real and the imaginary plane).  A block may use 227 KB of the SM's
   256 KB, above 48 KB only as dynamic shared memory after an opt-in;
   :func:`footprint` checks a candidate against that budget.
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
NTHREADS = 256                  # threads per block of the IAAT kernel
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
    a_bytes: int
    b_bytes: int
    acc_regs: int
    total: int

    @property
    def fits(self) -> bool:
        return self.total <= SMEM_OPTIN_BYTES and self.acc_regs <= ACC_REG_CAP


def reg_pressure(bm: int, bn: int, acc_dtype=torch.float32, *,
                 complex_: bool = False) -> int:
    """Accumulator registers per thread for a (bm x bn) C block; the
    complex (Karatsuba) kernel keeps three planes, P1, P2 and P3."""
    words = max(1, itemsize(acc_dtype) // 4)
    planes = 3 if complex_ else 1
    return -(-bm * bn // NTHREADS) * words * planes


def footprint(bm: int, bn: int, bk: int, dtype, *, complex_: bool = False,
              acc_dtype=torch.float32) -> Footprint:
    """Shared bytes and accumulator registers of one (bm, bn, bk) block:
    the A tile bk x (bm + pad) and the B tile bk x (bn + pad), staged once
    per K step (no double buffering in this kernel).  ``dtype`` is the
    plane type; a complex block stages a real and an imaginary plane of
    each tile (the Karatsuba sums Ar+Ai, Br+Bi are formed in registers,
    not staged)."""
    item, p = itemsize(dtype), pad(dtype)
    planes = 2 if complex_ else 1
    a = bk * (bm + p) * item * planes
    b = bk * (bn + p) * item * planes
    return Footprint(a, b, reg_pressure(bm, bn, acc_dtype,
                                        complex_=complex_), a + b)


def thread_layout_ok(bm: int, bn: int) -> bool:
    """The kernel's thread layout (csrc/iaat_gemm.cu): each of 256 threads
    owns TM rows x TN=4 columns, with bn/4 threads across a row."""
    per = bm * bn // NTHREADS
    return (bm * bn % NTHREADS == 0 and per >= 4 and per % 4 == 0
            and NTHREADS % (bn // 4) == 0 and bn % 4 == 0)
