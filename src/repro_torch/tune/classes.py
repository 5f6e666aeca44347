"""Geometric size-class bucketing over (M, N, K, dtype, trans).

Counterpart of ``repro/tune/classes.py``, kept identical: the buckets are
pure integer functions, so a class key means the same shapes in both
packages.

A profile cannot store one entry per exact problem shape — the input
space is continuous.  Instead each dimension is bucketed geometrically
(ratio ``GROWTH``), so a bounded number of classes covers every size up
to the small-GEMM crossover and beyond, and shapes within ~GROWTH of
each other — whose kernel choice is the same in practice — share one
measured entry.  Tillet's input-aware tuner makes the same move with a
learned classifier; fixed geometric buckets keep lookup a pure integer
computation with zero model state.

Bucket i covers [GROWTH**i, GROWTH**(i+1)) and its *representative* (the
shape actually benchmarked for the class) is the geometric midpoint
round(GROWTH**(i+0.5)), which minimises worst-case ratio error across
the bucket.  Bucketing is deterministic and endpoint-stable: bucket
boundaries are precomputed integers, so float noise in ``log`` cannot
flip a boundary size between classes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

GROWTH = 2.0
_MAX_BUCKET = 64          # covers dims up to 2**64 — effectively unbounded


def _bucket_edges(max_bucket: int = _MAX_BUCKET) -> Tuple[int, ...]:
    # edges[i] = smallest integer size that falls in bucket i
    return tuple(int(math.ceil(GROWTH ** i)) for i in range(max_bucket + 1))


_EDGES = _bucket_edges()


def bucket_index(x: int) -> int:
    """Index i of the geometric bucket containing integer size ``x >= 1``."""
    if x < 1:
        raise ValueError(f"size must be >= 1, got {x}")
    # binary search over the precomputed integer edges — deterministic at
    # boundaries, unlike floor(log(x)/log(GROWTH)) which can ride float
    # error for exact powers.
    lo, hi = 0, len(_EDGES) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _EDGES[mid] <= x:
            lo = mid
        else:
            hi = mid - 1
    return lo


def bucket_bounds(i: int) -> Tuple[int, int]:
    """[lo, hi) integer size range of bucket ``i``."""
    return _EDGES[i], _EDGES[i + 1]


def bucket_representative(i: int) -> int:
    """Benchmarked size for bucket ``i``: the geometric midpoint."""
    return max(1, int(round(GROWTH ** (i + 0.5))))


@dataclasses.dataclass(frozen=True, order=True)
class SizeClass:
    """One profile key: dtype letter, transposition, per-dim bucket ids."""
    letter: str
    trans: str
    mb: int
    nb: int
    kb: int

    @property
    def key(self) -> str:
        """Stable string key used in the JSON profile."""
        return f"{self.letter}/{self.trans}/{self.mb}-{self.nb}-{self.kb}"

    @classmethod
    def from_key(cls, key: str) -> "SizeClass":
        letter, trans, buckets = key.split("/")
        mb, nb, kb = (int(b) for b in buckets.split("-"))
        return cls(letter, trans, mb, nb, kb)


def size_class(M: int, N: int, K: int, letter: str, trans: str) -> SizeClass:
    return SizeClass(letter, trans, bucket_index(M), bucket_index(N),
                     bucket_index(K))


def representative(sc: SizeClass) -> Tuple[int, int, int]:
    """The (M, N, K) the tuner benchmarks on behalf of the whole class."""
    return (bucket_representative(sc.mb), bucket_representative(sc.nb),
            bucket_representative(sc.kb))


def classes_up_to(letters: Sequence[str], trans: Sequence[str],
                  max_dim: int, min_dim: int = 8,
                  cube_only: bool = False) -> List[SizeClass]:
    """Enumerate the sweep's class grid: every (mb, nb, kb) combination
    whose representatives land in [min_dim, max_dim] (``cube_only``
    restricts to mb == nb == kb, the quick-sweep diagonal).

    Filtering is on the *representative* — the shape actually timed — so
    ``max_dim`` bounds real sweep cost (a bucket whose midpoint
    overshoots max_dim would silently benchmark up to sqrt(GROWTH)
    bigger problems)."""
    ids = [i for i in range(bucket_index(max_dim) + 2)
           if min_dim <= bucket_representative(i) <= max_dim]
    out: List[SizeClass] = []
    for letter in letters:
        for tr in trans:
            for mb in ids:
                for nb in ids:
                    if cube_only and nb != mb:
                        continue
                    for kb in ids:
                        if cube_only and kb != mb:
                            continue
                        out.append(SizeClass(letter, tr, mb, nb, kb))
    return out
