"""Kernel Executing Plan (paper §V-B).

After the input-aware tile algorithm produces a :class:`Tiling`, the plan
builder fuses maximal runs of identical blocks into *regions* (one kernel
launch each) and binds every region to a generated kernel signature from
the install-time table.  Executing the plan runs the region kernels, each
writing straight into its strided view of ONE output tensor — no pack
step, no boundary scalar code, and no stitching copy.

Plans are cached by the full problem signature, the paper's "repeated
same-size GEMM" sweet spot: the first call plans, every later call with
the same shapes reuses the plan.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.core import kernelgen, vmem
from repro_torch.core.kernelgen import KernelSig
from repro_torch.core.tiler import Block, Tiling, tile_hopper


@dataclasses.dataclass(frozen=True)
class Region:
    """A (gm x gn) grid of identical (bm x bn) kernel blocks."""
    sig: KernelSig
    m0: int
    n0: int
    gm: int
    gn: int

    @property
    def m_extent(self) -> int:
        return self.gm * self.sig.bm

    @property
    def n_extent(self) -> int:
        return self.gn * self.sig.bn


@dataclasses.dataclass(frozen=True)
class Plan:
    M: int
    N: int
    K: int
    letter: str
    trans: str
    regions: Tuple[Region, ...]
    tiling: Tiling

    @property
    def num_kernel_calls(self) -> int:
        return len(self.regions)

    def memops(self) -> int:
        return self.tiling.memops(self.K)


def _choose_bk(letter: str, trans: str, bm: int, bn: int, K: int) -> int:
    """Largest table bk that fits with (bm, bn); capped near K."""
    sig0 = kernelgen.kernel_table(letter, trans)
    cands = sorted({s.bk for s in sig0 if s.bm == bm and s.bn == bn})
    if not cands:
        raise ValueError(f"no kernel {letter}/{trans} {bm}x{bn}")
    ka = vmem.align_k(K, kernelgen.REAL_OF.get(letter, torch.bfloat16))
    # smallest bk covering K in one step, else the largest available
    # (fewer K steps per C block)
    for bk in cands:
        if bk >= ka:
            return bk
    return cands[-1]


def _override_plan(M: int, N: int, K: int, letter: str, trans: str,
                   sig: KernelSig) -> Plan:
    """Single-region plan pinned to a tuned kernel signature: one
    ceil-div grid of ``sig`` blocks covering C; M/N overhang is resolved
    by the kernel's bounds checks exactly as in tiled plans."""
    if sig.letter != letter or sig.trans != trans:
        raise ValueError(f"override {sig.name} does not match "
                         f"{letter}/{trans}")
    gm = -(M // -sig.bm)
    gn = -(N // -sig.bn)
    blocks = []
    for i in range(gm):
        m0 = i * sig.bm
        for j in range(gn):
            n0 = j * sig.bn
            blocks.append(Block(m0, n0, min(sig.bm, M - m0),
                                min(sig.bn, N - n0)))
    tiling = Tiling(M, N, tuple(blocks), "tuned")
    return Plan(M, N, K, letter, trans,
                (Region(sig, 0, 0, gm, gn),), tiling)


@functools.lru_cache(maxsize=4096)
def build_plan(M: int, N: int, K: int, letter: str, trans: str,
               override: Optional[KernelSig] = None) -> Plan:
    if override is not None:
        return _override_plan(M, N, K, letter, trans, override)
    tiling = tile_hopper(M, N, letter, trans)
    # fuse: per stripe, merge equal-width runs; then merge vertically
    # adjacent stripes with identical runs.
    rows: List[Tuple[int, int, List[Tuple[int, int, int]]]] = []
    by_row: dict = {}
    for b in tiling.blocks:
        by_row.setdefault((b.m0, b.m), []).append(b)
    for (m0, m), blocks in sorted(by_row.items()):
        blocks.sort(key=lambda b: b.n0)
        runs: List[Tuple[int, int, int]] = []  # (n0, n, count)
        for b in blocks:
            if runs and runs[-1][1] == b.n and \
                    runs[-1][0] + runs[-1][1] * runs[-1][2] == b.n0:
                n0, n, c = runs[-1]
                runs[-1] = (n0, n, c + 1)
            else:
                runs.append((b.n0, b.n, 1))
        rows.append((m0, m, runs))
    merged: List[Tuple[int, int, int, List[Tuple[int, int, int]]]] = []
    for m0, m, runs in rows:
        if merged and merged[-1][1] == m and merged[-1][3] == runs \
                and merged[-1][0] + merged[-1][1] * merged[-1][2] == m0:
            p0, pm, pc, pruns = merged[-1]
            merged[-1] = (p0, pm, pc + 1, pruns)
        else:
            merged.append((m0, m, 1, runs))
    regions: List[Region] = []
    for m0, m, gm, runs in merged:
        for n0, n, gn in runs:
            bk = _choose_bk(letter, trans, m, n, K)
            regions.append(Region(KernelSig(letter, trans, m, n, bk),
                                  m0, n0, gm, gn))
    return Plan(M, N, K, letter, trans, tuple(regions), tiling)


# --------------------------------------------------------------------------
# Execution.
# --------------------------------------------------------------------------

def _rows(x: torch.Tensor, lo: int, hi: int, axis: int) -> torch.Tensor:
    """A view of ``x`` cut to [lo, hi) along ``axis`` (no copy)."""
    return x.narrow(axis, lo, hi - lo)


def execute(plan: Plan, a: torch.Tensor, b: torch.Tensor,
            c: Optional[torch.Tensor] = None, alpha=1.0, beta=0.0
            ) -> torch.Tensor:
    """Run the kernel executing plan; returns C (M x N).

    The regions partition the (M, N) rectangle exactly (the tiling covers
    the aligned extent, clipped here to M x N), so every element of the
    ``torch.empty`` output is written by exactly one region kernel, each
    straight into its strided view.  When autograd records the call, each
    region's result is instead copied into its view, so the copy carries
    the gradient (training only; serving never takes that path).

    Operands of mixed dtype are first brought to their promoted type, as
    the reference's ``_cx_call`` casts each plane: a real x complex GEMM
    runs the complex kernel on a zero imaginary plane.  ``c`` of any dtype
    is cast by the region (``iaat_gemm.c_dtype``)."""
    from repro_torch.kernels import iaat_gemm
    M, N, trans = plan.M, plan.N, plan.trans
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    out = torch.empty((M, N), dtype=dtype, device=a.device)
    a_m_axis = 0 if trans[0] == "N" else 1
    b_n_axis = 1 if trans[1] == "N" else 0
    for r in plan.regions:
        m_lo, m_hi = r.m0, min(M, r.m0 + r.m_extent)
        n_lo, n_hi = r.n0, min(N, r.n0 + r.n_extent)
        if m_lo >= M or n_lo >= N:
            continue  # fully-overhang region (alignment padding)
        a_sl = _rows(a, m_lo, m_hi, a_m_axis)
        b_sl = _rows(b, n_lo, n_hi, b_n_axis)
        c_sl = None if c is None else c[m_lo:m_hi, n_lo:n_hi]
        view = out[m_lo:m_hi, n_lo:n_hi]
        if iaat_gemm.records_grad(a, b, c):
            view.copy_(iaat_gemm.gemm_region(r.sig, a_sl, b_sl, c_sl,
                                             alpha=alpha, beta=beta))
        else:
            iaat_gemm.gemm_region(r.sig, a_sl, b_sl, c_sl, alpha=alpha,
                                  beta=beta, out=view)
    return out
