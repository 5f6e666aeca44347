"""The Input-Aware Adaptive Tile Algorithm (paper §V-A) — the run-time stage.

Given (M, N, K, dtype, transposition) and the install-time kernel table,
tile matrix C into blocks such that every block is EXACTLY a generated
kernel size (zero boundary processing) while minimizing the paper's memops
objective  Σᵢ(mᵢ+nᵢ)·K + 2MN  (principle b), preferring big SIMD-aligned
blocks (principles a, c).

Two planners are provided:

* ``greedy`` — faithful to the paper's Algorithm 2 (TileSingleDim greedy
  with the remainder-averaging rule, the M≤8/==9/<12/==12/>12 case split
  for SGEMM_NN, and the ExtendTo8/ExtendTo16 comparison).
* ``dp`` — our beyond-paper planner: exact dynamic programming over row
  stripes.  For a stripe of height m covering N with J blocks the cost is
  m·J + N, so  total = Σ_s m_s·J(m_s) + N·S  is minimised exactly.
  On the paper's own Fig. 2 example (15×15 SGEMM_NN) ``dp`` finds the
  coefficient 72 the paper reports for IAAT (12×{6,6,3} + 3×{13,2}).

The same machinery runs against two kernel tables: the verbatim ARMv8
TABLE I (cost-model benchmarks) and the Hopper table from ``kernelgen``
(real execution), in which case dims are pre-aligned to the Hopper grain
(16 rows, one 128-byte line of columns) and edge overhang is handled by
the kernel's bounds-checked loads and stores, not by 1-wide cleanup
kernels.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import cost, kernelgen, paper_table, vmem


@dataclasses.dataclass(frozen=True)
class Block:
    m0: int
    n0: int
    m: int
    n: int


@dataclasses.dataclass(frozen=True)
class Tiling:
    M: int
    N: int
    blocks: Tuple[Block, ...]
    method: str

    @property
    def coeff(self) -> int:
        return cost.memops_coeff((b.m, b.n) for b in self.blocks)

    def memops(self, K: int) -> int:
        return cost.memops_blocks(((b.m, b.n) for b in self.blocks),
                                  K, self.M, self.N)

    def validate_cover(self) -> None:
        """Invariant: blocks exactly partition the (M, N) rectangle."""
        covered = sum(b.m * b.n for b in self.blocks)
        assert covered == self.M * self.N, (covered, self.M * self.N)
        rects = sorted((b.m0, b.n0, b.m, b.n) for b in self.blocks)
        for i, (r0, c0, rm, rn) in enumerate(rects):
            assert 0 <= r0 and r0 + rm <= self.M
            assert 0 <= c0 and c0 + rn <= self.N
            for (s0, d0, sm, sn) in rects[i + 1:]:
                if r0 < s0 + sm and s0 < r0 + rm \
                        and c0 < d0 + sn and d0 < c0 + rn:
                    raise AssertionError(f"overlap {rects[i]} vs {(s0,d0,sm,sn)}")


# --------------------------------------------------------------------------
# Kernel-table views.
# --------------------------------------------------------------------------

class TableView:
    """m -> allowed widths, for either the ARMv8 or the Hopper table."""

    def __init__(self, widths: Dict[int, Sequence[int]]):
        self._w = {m: tuple(sorted(ws)) for m, ws in widths.items() if ws}

    def heights(self) -> Tuple[int, ...]:
        return tuple(sorted(self._w))

    def widths_for(self, m: int) -> Tuple[int, ...]:
        return self._w.get(m, ())

    @classmethod
    def armv8(cls, letter: str, trans: str) -> "TableView":
        return cls({m: range(1, nmax + 1)
                    for m, nmax in paper_table.widths_for(letter, trans).items()})

    @classmethod
    def hopper(cls, letter: str, trans: str) -> "TableView":
        widths: Dict[int, set] = {}
        for sig in kernelgen.kernel_table(letter, trans):
            widths.setdefault(sig.bm, set()).add(sig.bn)
        return cls({m: sorted(ws) for m, ws in widths.items()})


# --------------------------------------------------------------------------
# TileSingleDim (paper, line 10 of Algorithm 2) + remainder averaging.
# --------------------------------------------------------------------------

def tile_single_dim(L: int, sizes: Sequence[int]) -> List[Tuple[int, int]]:
    """Greedy cover of L with ``sizes``; returns [(dim, count)].

    Biggest-first; if the final remainder is 'too small' (< half the
    previous size) the last two pieces are averaged (paper §V-A)."""
    sizes = sorted(set(sizes), reverse=True)
    out: List[Tuple[int, int]] = []
    rest = L
    big = sizes[0]
    if rest >= big:
        cnt = rest // big
        rem = rest - cnt * big
        if 0 < rem < max(1, big // 2) and cnt >= 1:
            # averaging rule: split (big + rem) across two near-equal pieces
            cnt -= 1
            pair = big + rem
            a, b = -(-pair // 2), pair // 2
            a = _snap_down(a, sizes)
            b = pair - a
            if cnt:
                out.append((big, cnt))
            for piece in _split_piece(a, sizes) + _split_piece(b, sizes):
                out.append(piece)
            return _merge_runs(out)
        if cnt:
            out.append((big, cnt))
        rest = rem
    while rest > 0:
        fit = next((s for s in sizes if s <= rest), None)
        if fit is None:
            raise ValueError(f"cannot tile {L} with {sizes}")
        cnt = rest // fit
        out.append((fit, cnt))
        rest -= fit * cnt
    return _merge_runs(out)


def _snap_down(x: int, sizes: Sequence[int]) -> int:
    for s in sorted(sizes, reverse=True):
        if s <= x:
            return s
    return min(sizes)


def _split_piece(p: int, sizes: Sequence[int]) -> List[Tuple[int, int]]:
    out = []
    rest = p
    for s in sorted(sizes, reverse=True):
        if rest <= 0:
            break
        c = rest // s
        if c:
            out.append((s, c))
            rest -= s * c
    if rest:
        raise ValueError(f"cannot split {p} with {sizes}")
    return out


def _merge_runs(runs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for d, c in runs:
        if merged and merged[-1][0] == d:
            merged[-1] = (d, merged[-1][1] + c)
        else:
            merged.append((d, c))
    return merged


# --------------------------------------------------------------------------
# Exact cover DP (our planner).
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _min_cover(N: int, widths: Tuple[int, ...]) -> Optional[Tuple[int, ...]]:
    """Minimal-count exact cover of N by ``widths`` (DP, scaled by gcd)."""
    g = math.gcd(N, functools.reduce(math.gcd, widths))
    n, ws = N // g, tuple(w // g for w in widths)
    INF = 1 << 30
    best = [0] + [INF] * n
    pick = [0] * (n + 1)
    for i in range(1, n + 1):
        for w in ws:
            if w <= i and best[i - w] + 1 < best[i]:
                best[i] = best[i - w] + 1
                pick[i] = w
    if best[n] >= INF:
        return None
    out = []
    i = n
    while i:
        out.append(pick[i] * g)
        i -= pick[i]
    return tuple(sorted(out, reverse=True))


def _stripe_dp(M: int, N: int, table: TableView) -> List[Tuple[int, Tuple[int, ...]]]:
    """Exact DP over stripe heights. Returns [(height, col widths)]."""
    heights = table.heights()
    g = functools.reduce(math.gcd, heights + (M,))
    INF = float("inf")
    # per-height column cover cost: m*J(m) + N
    stripe_cost: Dict[int, Tuple[float, Tuple[int, ...]]] = {}
    for m in heights:
        covN = _min_cover(N, table.widths_for(m))
        if covN is None:
            continue
        stripe_cost[m] = (m * len(covN) + N, covN)
    if not stripe_cost:
        raise ValueError(f"no feasible stripe for N={N}")
    mm = M // g
    best = [0.0] + [INF] * mm
    pick = [0] * (mm + 1)
    hs = sorted(stripe_cost, reverse=True)
    for i in range(1, mm + 1):
        for m in hs:
            ms = m // g
            if m % g == 0 and ms <= i:
                c = best[i - ms] + stripe_cost[m][0]
                if c < best[i]:
                    best[i] = c
                    pick[i] = m
    if best[mm] is INF:
        raise ValueError(f"cannot tile M={M} with heights {heights}")
    stripes = []
    i = mm
    while i:
        m = pick[i]
        stripes.append((m, stripe_cost[m][1]))
        i -= m // g
    stripes.sort(key=lambda s: -s[0])
    return stripes


def _blocks_from_stripes(stripes: List[Tuple[int, Sequence[int]]],
                         M: int, N: int, method: str) -> Tiling:
    blocks: List[Block] = []
    r = 0
    for m, widths in stripes:
        c = 0
        for w in widths:
            blocks.append(Block(r, c, m, w))
            c += w
        assert c == N, (c, N)
        r += m
    assert r == M, (r, M)
    return Tiling(M, N, tuple(blocks), method)


# --------------------------------------------------------------------------
# Paper Algorithm 2 (greedy), generalised from the SGEMM_NN pseudocode.
# --------------------------------------------------------------------------

def _greedy_stripes(M: int, N: int, table: TableView) \
        -> List[Tuple[int, Tuple[int, ...]]]:
    heights = sorted(table.heights(), reverse=True)
    max_n_of = {m: max(table.widths_for(m)) for m in table.heights()}
    # Paper line 1: if N fits the widest kernel of some height, pin n_c = N
    # and take the tallest such height (bigger-block principle).
    pin = [m for m in heights if N <= max_n_of[m]]
    stripes: List[Tuple[int, Tuple[int, ...]]] = []
    if pin:
        m1 = pin[0]
        cnt = M // m1
        rem = M - cnt * m1
        if cnt:
            stripes += [(m1, (N,))] * cnt
        if rem:
            for m, c in tile_single_dim(rem, [h for h in heights if h <= rem] or heights[-1:]):
                cov = _min_cover(N, table.widths_for(m))
                stripes += [(m, cov)] * c
        return stripes
    # Otherwise tile M greedily, then cover N per stripe height greedily.
    for m, c in tile_single_dim(M, heights):
        ws = table.widths_for(m)
        runs = tile_single_dim(N, ws)
        cov = tuple(w for w, cc in runs for _ in range(cc))
        stripes += [(m, cov)] * c
    return stripes


def _greedy_nn_paper(M: int, N: int, table: TableView) \
        -> List[Tuple[int, Tuple[int, ...]]]:
    """Algorithm 2 verbatim for the ARMv8 SGEMM_NN table."""
    W = {m: max(table.widths_for(m)) for m in table.heights()}
    if N <= 13:
        return _greedy_stripes(M, N, table)
    stripes: List[Tuple[int, Tuple[int, ...]]] = []

    def ncov(m, lim):
        runs = tile_single_dim(N, list(range(1, lim + 1)))
        return tuple(w for w, c in runs for _ in range(c))

    if M <= 8:
        for m, c in tile_single_dim(M, [1, 2, 3, 4]):
            stripes += [(m, ncov(m, 13))] * c
    elif M == 9:
        for m in (4, 3, 2):
            stripes.append((m, ncov(m, 13)))
    elif M < 12:
        stripes.append((8, ncov(8, 8)))
        stripes.append((M - 8, ncov(M - 8, 13)))
    elif M == 12:
        stripes.append((12, ncov(12, 6)))
    else:
        q, r = divmod(M, 4)
        if r == 1:
            m1 = [(4, q - 1)]
            m2 = [(3, ncov(3, 8)), (2, ncov(2, 13))]
        else:
            m1 = [(4, q)]
            m2 = [(r, ncov(r, 13))] if r else []
        # ExtendTo8 / ExtendTo16: fuse pairs/quads of 4-stripes into 8/16
        # stripes and keep whichever needs fewer loads.
        cands = []
        for unit in (8, 16):
            n4 = m1[0][1] * 4
            big, rest = divmod(n4, unit)
            st = [(unit, ncov(unit, W.get(unit, 4)))] * big
            if rest:
                for mm, cc in tile_single_dim(rest, [4, 3, 2, 1]):
                    st += [(mm, ncov(mm, 13 if mm <= 4 else 8))] * cc
            cands.append(st)
        best = min(cands, key=lambda st: sum(m * len(ws) for m, ws in st))
        stripes += best
        stripes += [(m, ws) for m, ws in m2]
    return stripes


def tile(M: int, N: int, table: TableView, method: str = "dp",
         paper_nn: bool = False) -> Tiling:
    if method == "dp":
        stripes = _stripe_dp(M, N, table)
    elif method == "greedy":
        stripes = (_greedy_nn_paper if paper_nn else _greedy_stripes)(M, N, table)
        stripes = [(m, tuple(ws)) for m, ws in stripes]
    else:
        raise ValueError(method)
    t = _blocks_from_stripes(stripes, M, N, method)
    t.validate_cover()
    return t


# --------------------------------------------------------------------------
# Public entry points.
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def tile_armv8(M: int, N: int, letter: str = "S", trans: str = "NN",
               method: str = "dp") -> Tiling:
    """Cost-model tiling against the verbatim paper table."""
    if trans in paper_table.MIRRORED:
        t = tile(N, M, TableView.armv8(letter, trans), method,
                 paper_nn=(letter, trans) == ("S", "NN") and method == "greedy")
        blocks = tuple(Block(b.n0, b.m0, b.n, b.m) for b in t.blocks)
        return Tiling(M, N, blocks, method)
    return tile(M, N, TableView.armv8(letter, trans), method,
                paper_nn=(letter, trans) == ("S", "NN") and method == "greedy")


@functools.lru_cache(maxsize=4096)
def tile_hopper(M: int, N: int, letter: str, trans: str) -> Tiling:
    """Execution tiling against the Hopper kernel table (the counterpart
    of the reference's ``tile_tpu``: the same DP, another grain).  The
    paper's greedy tiler is kept only for :func:`tile_armv8`.

    Dims are aligned up to the Hopper grain first; the overhang inside the
    final blocks is resolved by the kernel's bounds checks (never by
    scalar cleanup).
    """
    sig0 = kernelgen.kernel_table(letter, trans)
    if not sig0:
        raise ValueError(f"empty kernel table for {letter} {trans}")
    dt = sig0[0].real_dtype
    Ma = vmem.align_m(M, dt)
    Na = vmem.align_n(N, dt)
    return tile(Ma, Na, TableView.hopper(letter, trans), "dp")
