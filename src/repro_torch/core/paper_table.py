"""Paper TABLE I, verbatim: the ARMv8 generated-kernel size table.

Used by the cost-model benchmarks (tiling memops reproduction, kernel
census) so the run-time tile algorithm can be validated against the paper's
own numbers (Fig. 2: 15x15 SGEMM_NN -> 72K+450 loads vs 105K+450
traditional) independently of the TPU block table.

Encoding: for each (letter, trans), a list of (m, n_max) meaning kernels
m x {1..n_max} exist.  TT families are stored transposed in the paper
({1..n}xM); we normalise to (m, n_max) with ``tt_swapped=True`` semantics
handled by the tiler via orientation flip.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# (m, n_max) rows; kernels are m x {1..n_max}
ARMV8_TABLE: Dict[Tuple[str, str], Tuple[Tuple[int, int], ...]] = {
    ("S", "NN"): ((16, 4), (12, 6), (8, 8), (4, 13), (3, 13), (2, 13), (1, 13)),
    ("S", "NT"): ((16, 4), (12, 8), (8, 8), (4, 20), (3, 24), (2, 28), (1, 32)),
    ("S", "TN"): ((4, 4), (3, 5), (2, 7), (1, 10)),
    # TT is the NN table mirrored: {1..4}x16 etc.
    ("S", "TT"): ((16, 4), (12, 6), (8, 8), (4, 13), (3, 13), (2, 13), (1, 13)),
    ("D", "NN"): ((8, 4), (4, 8), (3, 8), (2, 15), (1, 15)),
    ("D", "NT"): ((8, 4), (4, 8), (3, 8), (2, 20), (1, 20)),
    ("D", "TN"): ((4, 4), (3, 5), (2, 7), (1, 10)),
    ("D", "TT"): ((8, 4), (4, 8), (3, 8), (2, 15), (1, 15)),
    ("C", "NN"): ((8, 4), (4, 9), (3, 9), (2, 12), (1, 20)),
    ("C", "NT"): ((8, 4), (4, 8), (3, 8), (2, 12), (1, 20)),
    ("C", "TN"): ((4, 9), (3, 9), (2, 12), (1, 20)),
    ("C", "TT"): ((8, 4), (4, 9), (3, 9), (2, 12), (1, 20)),
    ("Z", "NN"): ((4, 4), (3, 4), (2, 7), (1, 10)),
    ("Z", "NT"): ((4, 4), (3, 4), (2, 7), (1, 10)),
    ("Z", "TN"): ((4, 4), (3, 4), (2, 7), (1, 10)),
    ("Z", "TT"): ((4, 4), (3, 4), (2, 7), (1, 10)),
}

# Transpositions whose paper table is column-major (n x m kernels): the
# tiler solves the flipped problem and swaps back.
MIRRORED = {"TT"}


def kernel_sizes(letter: str, trans: str) -> List[Tuple[int, int]]:
    """Explicit (m, n) kernel list for one family."""
    rows = ARMV8_TABLE[(letter, trans)]
    return [(m, n) for m, n_max in rows for n in range(1, n_max + 1)]


def widths_for(letter: str, trans: str) -> Dict[int, int]:
    """m -> n_max mapping (the tiler's feasibility oracle)."""
    return {m: n_max for m, n_max in ARMV8_TABLE[(letter, trans)]}


def census() -> Dict[str, int]:
    """Kernel count per family — the paper's 'hundreds of kernels'."""
    out = {}
    for (letter, trans), rows in ARMV8_TABLE.items():
        out[f"{letter}GEMM_{trans}"] = sum(n for _, n in rows)
    return out


def total_kernels() -> int:
    return sum(census().values())


# Paper-quoted reference points used as benchmark assertions:
PAPER_FIG2_TRADITIONAL_COEFF = 105   # 15x15 SGEMM_NN, traditional tiling
PAPER_FIG2_IAAT_COEFF = 72           # 15x15 SGEMM_NN, IAAT tiling
PAPER_SMALL_THRESHOLD = 80           # cbrt(MNK) bound, non-TN
PAPER_SMALL_THRESHOLD_TN = 32        # cbrt(MNK) bound, TN
