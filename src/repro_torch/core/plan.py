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

The run-time stage also splits K (:func:`k_slices`) for regions whose
grid underfills the card, a quantity derived from the region's grid, K,
its kernel's bk and the card's SM count; it stays one launch a region.
The grouped kernels split by a rule of their own (:func:`grouped_slices`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.core import kernelgen, vmem
from repro_torch.core.kernelgen import KernelSig
from repro_torch.core.tiler import Block, Tiling, tile_hopper


#: the fewest bk steps a K slice takes, so that the kernel's load ring
#: has a next tile to fetch while it multiplies the current one
MIN_SLICE_STEPS = 2
#: regions one launch of the complex kernel takes (``csrc/cx_gemm.cu``
#: MAX_REGIONS), and the Router's plan cut (``api.MAX_PLAN_REGIONS``)
LAUNCH_REGIONS = 64


def k_slices(gm: int, gn: int, K: int, bk: int, resident: int) -> int:
    """K slices of one region (DESIGN_PORT.md §11): 1 when its gm x gn
    grid fills the card's :data:`vmem.NUM_SMS` SMs or K has fewer than
    2 x :data:`MIN_SLICE_STEPS` steps of bk; else as many slices as keep
    the split grid within one wave of NUM_SMS x ``resident`` blocks (the
    kernel's blocks an SM, ``Footprint.blocks_per_sm``; at least two
    slices), and no more than leave each slice :data:`MIN_SLICE_STEPS`
    steps.  One wave, not the fewest slices past NUM_SMS: a grid just
    past a wave runs as two waves.  The kernel deals the K steps out to
    the slices evenly (:func:`slice_steps`)."""
    grid = gm * gn
    steps = -(-K // bk)
    if grid >= vmem.NUM_SMS or steps < 2 * MIN_SLICE_STEPS:
        return 1
    return min(max(2, vmem.NUM_SMS * resident // grid),
               steps // MIN_SLICE_STEPS)


def grouped_slices(blocks: int, K: int, bk: int) -> int:
    """K slices of one grouped launch (``kernels/grouped_gemm.py``;
    DESIGN_PORT.md §7): the most slices that keep its ``blocks``-block
    grid within one block an SM (:data:`vmem.NUM_SMS`), and no more than
    leave each slice :data:`MIN_SLICE_STEPS` steps of bk; 1 when fewer
    than two slices fit.  One block an SM, not the resident blocks of
    :func:`k_slices`'s wave: on the H100 a grouped block streams its
    weights at a rate its ring's copies in flight set (about 23 GB/s at
    (16, 256, 64) bf16, whatever the grid), so about 130 blocks fill the
    memory, and past that a split only adds its fix-up (PERF.md §6, PR
    18: at 96 and 120 blocks two slices were slower than one).  The
    kernel deals the K steps out as :func:`slice_steps` does."""
    s = min(vmem.NUM_SMS // max(blocks, 1), -(-K // bk) // MIN_SLICE_STEPS)
    return s if s >= 2 else 1


def slice_steps(K: int, bk: int, slices: int) -> List[Tuple[int, int]]:
    """The [first, end) bk steps of each slice, as the kernel deals them
    out: the first ``steps % slices`` slices take one step more."""
    steps = -(-K // bk)
    lo, rem = divmod(steps, slices)
    out, s = [], 0
    for z in range(slices):
        n = lo + (z < rem)
        out.append((s, s + n))
        s += n
    return out


@dataclasses.dataclass(frozen=True)
class Region:
    """A (gm x gn) grid of identical (bm x bn) kernel blocks, K cut into
    ``slices`` (:func:`k_slices`)."""
    sig: KernelSig
    m0: int
    n0: int
    gm: int
    gn: int
    slices: int

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

    @functools.cached_property
    def launch_tables(self) -> Tuple[Tuple[Tuple[int, ...], ...], ...]:
        """The region tables of the one-launch complex path (DESIGN_PORT.md
        §9), one a launch of at most :data:`LAUNCH_REGIONS` regions.  A row
        per region that holds part of (M, N), in plan order: (start, m0,
        m_hi, n0, n_hi, gn, bm, bn, bk), its first block in the launch's
        grid, its rows and columns clipped to the output, its blocks across
        and its instance.  A block runs the last row whose first block is
        at or before it."""
        return launch_tables(self.M, self.N, self.regions)

    @functools.cached_property
    def c_launch_tables(self):
        """:attr:`launch_tables` as the C entry takes them."""
        return c_tables(self.launch_tables)


def launch_tables(M: int, N: int, regions) -> Tuple[Tuple[Tuple[int, ...],
                                                          ...], ...]:
    """:attr:`Plan.launch_tables` of ``regions`` over an (M, N) output."""
    tables, rows, start = [], [], 0
    for r in regions:
        if r.m0 >= M or r.n0 >= N:
            continue  # fully-overhang region (alignment padding)
        if len(rows) == LAUNCH_REGIONS:
            tables.append(tuple(rows))
            rows, start = [], 0
        m_hi = min(M, r.m0 + r.m_extent)
        n_hi = min(N, r.n0 + r.n_extent)
        gm = -(-(m_hi - r.m0) // r.sig.bm)
        gn = -(-(n_hi - r.n0) // r.sig.bn)
        rows.append((start, r.m0, m_hi, r.n0, n_hi, gn, r.sig.bm, r.sig.bn,
                     r.sig.bk))
        start += gm * gn
    tables.append(tuple(rows))
    return tuple(tables)


def c_tables(tables):
    """Region tables as the complex kernel's C entry takes them: an
    (int array of the rows, row count) a launch."""
    return tuple(((ctypes.c_int * (9 * len(t)))(*(v for row in t
                                                   for v in row)), len(t))
                 for t in tables)


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
                (Region(sig, 0, 0, gm, gn, _slices(sig, gm, gn, K)),),
                tiling)


def _slices(sig: KernelSig, gm: int, gn: int, K: int) -> int:
    """:func:`k_slices` for a real kernel; the complex kernel keeps its
    whole-K loop (one slice)."""
    if sig.complex_:
        return 1
    return k_slices(gm, gn, K, sig.bk, sig.footprint().blocks_per_sm)


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
            sig = KernelSig(letter, trans, m, n, _choose_bk(letter, trans,
                                                            m, n, K))
            regions.append(Region(sig, m0, n0, gm, gn,
                                  _slices(sig, gm, gn, K)))
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
    is cast by the region (``iaat_gemm.c_dtype``).

    A complex plan runs as one launch of the complex kernel over the
    plan's region table (:attr:`Plan.launch_tables`;
    ``iaat_gemm.cx_plan``): the checks and the output allocation happen
    once a call, and the regions' offsets replace their views."""
    from repro_torch.kernels import iaat_gemm
    M, N, trans = plan.M, plan.N, plan.trans
    dtype = torch.promote_types(a.dtype, b.dtype)
    if a.dtype != dtype:
        a = a.to(dtype)
    if b.dtype != dtype:
        b = b.to(dtype)
    if dtype.is_complex:
        return iaat_gemm.cx_plan(plan, a, b, c, alpha, beta)
    out = torch.empty((M, N), dtype=dtype, device=a.device)
    a_m_axis = 0 if trans[0] == "N" else 1
    b_n_axis = 1 if trans[1] == "N" else 0
    grad = iaat_gemm.records_grad(a, b, c)
    for r in plan.regions:
        m_lo, m_hi = r.m0, min(M, r.m0 + r.m_extent)
        n_lo, n_hi = r.n0, min(N, r.n0 + r.n_extent)
        if m_lo >= M or n_lo >= N:
            continue  # fully-overhang region (alignment padding)
        if (m_lo, m_hi, n_lo, n_hi) == (0, M, 0, N):
            # the region is all of C (the decode step's case): no views,
            # which saves host time a call
            a_sl, b_sl, c_sl, view = a, b, c, out
        else:
            a_sl = _rows(a, m_lo, m_hi, a_m_axis)
            b_sl = _rows(b, n_lo, n_hi, b_n_axis)
            c_sl = None if c is None else c[m_lo:m_hi, n_lo:n_hi]
            view = out[m_lo:m_hi, n_lo:n_hi]
        if grad:
            view.copy_(iaat_gemm.gemm_region(r.sig, a_sl, b_sl, c_sl,
                                             alpha=alpha, beta=beta,
                                             slices=r.slices))
        else:
            iaat_gemm.gemm_region(r.sig, a_sl, b_sl, c_sl, alpha=alpha,
                                  beta=beta, out=view, slices=r.slices)
    return out
