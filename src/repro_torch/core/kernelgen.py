"""Kernel Generator (paper §IV-B): the install-time stage, for Hopper.

The paper generates hundreds of assembly microkernels, one per (size x
dtype x transposition), at install time.  Here a kernel is one template
instance of the CUDA GEMM in ``kernels/csrc/iaat_gemm.cu``, specialised on
a :class:`KernelSig`'s (dtype, bm, bn, bk).  :func:`kernel_table`
enumerates the legal signatures from the Hopper block budget
(:mod:`repro_torch.core.vmem`); :func:`install` compiles every instance
of the table into one shared library (``kernels/build.py``).

The kernel takes each operand's strides, so one instance serves all four
transpositions: the table lists the same blocks under NN/NT/TN/TT, and an
instance is keyed by (dtype, bm, bn, bk) alone.

dtype naming follows BLAS/the paper: S = float32, D = float64,
C = complex64, Z = complex128, plus H = bfloat16 for the framework layer.
S/D/H run the real kernel (``csrc/iaat_gemm.cu``); C/Z run the complex
Karatsuba kernel (``csrc/cx_gemm.cu``), whose three accumulator planes
give them a smaller table (DESIGN_PORT.md §9).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.core import vmem
from repro_torch.core.templates import TRANSPOSITIONS

BLAS_DTYPES = {
    "S": torch.float32,
    "D": torch.float64,
    "C": torch.complex64,
    "Z": torch.complex128,
}
REAL_OF = {"S": torch.float32, "D": torch.float64,
           "C": torch.float32, "Z": torch.float64}
IS_COMPLEX = {"S": False, "D": False, "C": True, "Z": True}
# extra dtypes the framework layer uses (not in the paper's BLAS set)
FRAMEWORK_DTYPES = {"H": torch.bfloat16}
#: letters of the real kernels (iaat_gemm.cu and the grouped kernels)
KERNEL_LETTERS = ("S", "D", "H")
#: letters of the complex Karatsuba kernel (cx_gemm.cu); no grouped kernel
COMPLEX_LETTERS = ("C", "Z")
#: every letter of the install-time table, in the order of its code in
#: the C ABI (-DIAAT_LETTER)
TABLE_LETTERS = KERNEL_LETTERS + COMPLEX_LETTERS


def blas_letter(dtype: torch.dtype) -> str:
    for k, v in {**BLAS_DTYPES, **FRAMEWORK_DTYPES}.items():
        if v == dtype:
            return k
    raise ValueError(f"unsupported dtype {dtype}")


@dataclasses.dataclass(frozen=True, order=True)
class KernelSig:
    """Identity of one generated kernel (the paper's TABLE I row entry)."""
    letter: str          # S/D/C/Z/H
    trans: str           # NN/NT/TN/TT
    bm: int
    bn: int
    bk: int

    @property
    def dtype(self) -> torch.dtype:
        return {**BLAS_DTYPES, **FRAMEWORK_DTYPES}[self.letter]

    @property
    def real_dtype(self) -> torch.dtype:
        return REAL_OF.get(self.letter, self.dtype)

    @property
    def complex_(self) -> bool:
        return IS_COMPLEX.get(self.letter, False)

    @property
    def acc_dtype(self) -> torch.dtype:
        return torch.float64 if self.letter in ("D", "Z") else torch.float32

    @property
    def name(self) -> str:
        kind = {"S": "sgemm", "D": "dgemm", "C": "cgemm", "Z": "zgemm",
                "H": "hgemm"}[self.letter]
        return f"{kind}_{self.trans.lower()}_{self.bm}x{self.bn}x{self.bk}"

    @property
    def instance(self) -> Tuple[str, int, int, int]:
        """The CUDA template instance that runs this signature."""
        return (self.letter, self.bm, self.bn, self.bk)

    def footprint(self) -> vmem.Footprint:
        return vmem.footprint(self.bm, self.bn, self.bk, self.real_dtype,
                              complex_=self.complex_,
                              acc_dtype=self.acc_dtype)


# --------------------------------------------------------------------------
# Install-time enumeration (DESIGN_PORT.md §2).
#
# Heights are multiples of the 16-row grain, widths of the 64-column
# grain (vmem.GRAIN_N); bk is one or two 128-byte lines of f32.  A
# candidate survives when the kernel's thread layout tiles it, its shared
# tiles fit the 227 KB opt-in budget and its accumulators stay within the
# register cap.  That leaves 22 S, 22 H and 18 D instances; the complex
# kernel stages two planes of each operand and keeps three accumulator
# planes (Karatsuba P1, P2, P3), which leaves 12 C and 6 Z.
# --------------------------------------------------------------------------

_BM_CANDIDATES = (16, 32, 64, 128)
_BN_CANDIDATES = (64, 128, 256)
_BK_CANDIDATES = (32, 64)


@functools.lru_cache(maxsize=None)
def kernel_table(letter: str, trans: str) -> Tuple[KernelSig, ...]:
    """All legal generated kernels for one (dtype, transposition)."""
    if trans not in TRANSPOSITIONS:
        raise ValueError(trans)
    if letter not in TABLE_LETTERS:
        raise ValueError(letter)
    out: List[KernelSig] = []
    for bm in _BM_CANDIDATES:
        for bn in _BN_CANDIDATES:
            if bm % vmem.GRAIN_M or bn % vmem.GRAIN_N or \
                    not vmem.thread_layout_ok(bm, bn):
                continue
            for bk in _BK_CANDIDATES:
                sig = KernelSig(letter, trans, bm, bn, bk)
                if sig.footprint().fits:
                    out.append(sig)
    return tuple(sorted(out))


@functools.lru_cache(maxsize=None)
def full_table() -> Tuple[KernelSig, ...]:
    """The complete install-time kernel census (paper TABLE I analogue)."""
    sigs: List[KernelSig] = []
    for letter in TABLE_LETTERS:
        for trans in TRANSPOSITIONS:
            sigs.extend(kernel_table(letter, trans))
    return tuple(sigs)


def instances() -> Tuple[Tuple[str, int, int, int], ...]:
    """Distinct CUDA template instances the table needs (trans is a
    run-time stride choice, so it is not part of an instance)."""
    return tuple(sorted({s.instance for s in full_table()}))


# --------------------------------------------------------------------------
# Build: signature -> callable; install = compile the whole table.
# --------------------------------------------------------------------------

_BUILD_CACHE: Dict[KernelSig, Callable] = {}


def build_kernel(sig: KernelSig) -> Callable:
    """The callable of one signature: ``call(a, b, c=None, alpha, beta)``
    runs ``alpha * op(A) @ op(B) + beta * C`` for operands of any size (the
    grid follows the shapes; edges are bounds-checked in the kernel)."""
    fn = _BUILD_CACHE.get(sig)
    if fn is None:
        from repro_torch.kernels import iaat_gemm  # deferred: kernels import core

        def fn(a, b, c=None, alpha=1.0, beta=0.0):
            return iaat_gemm.gemm_region(sig, a, b, c, alpha=alpha, beta=beta)
        fn.__name__ = sig.name
        fn.sig = sig
        _BUILD_CACHE[sig] = fn
    return fn


def install() -> int:
    """The install-time stage proper: compile every instance of the table
    (needs ``nvcc``; raises without it).  Returns the instance count."""
    from repro_torch.kernels import build
    build.load()
    return len(instances())


def census() -> Dict[str, int]:
    """Kernel counts per (dtype, trans) — the TABLE I shape of our table."""
    out: Dict[str, int] = {}
    for letter in TABLE_LETTERS:
        for tr in TRANSPOSITIONS:
            out[f"{letter}GEMM_{tr}"] = len(kernel_table(letter, tr))
    return out
