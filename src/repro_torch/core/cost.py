"""Cost models: the paper's memops objective (§V-A) + H100 roofline terms.

The run-time tiler minimizes data movement into the compute units:

    memops(blocks, K) = sum_i (m_i + n_i) * K  +  2 * M * N      (paper eq.)

(the K term = A-panel + B-panel loads per C block; 2MN = read+write of C).
On Hopper the same objective counts the global->shared traffic of an
unpacked GEMM (each C block streams its A and B panels once), so it
transfers unchanged; only the feasible block set differs.

The hardware constants are those of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense rates, at the full 700 W power limit).  A card capped below
700 W runs slower under load; measured numbers carry the card's limit.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

from repro_torch.core import kernelgen, templates

# --- hardware constants (NVIDIA H100 SXM data sheet) ----------------------
PEAK_FLOPS_BF16 = 989e12        # tensor cores, dense
PEAK_FLOPS_F32 = 67e12          # CUDA cores (no tensor cores)
PEAK_FLOPS_F64 = 67e12          # f64 tensor cores (34e12 on CUDA cores)
HBM_BW = 3.35e12                # bytes/s

#: operations per byte at which a bf16 GEMM stops being bound by HBM
RIDGE_BF16 = PEAK_FLOPS_BF16 / HBM_BW

#: the peak each BLAS letter can reach on the card, for the bound a
#: kernel's time is compared against; a complex letter is its plane type's
#: (C: f32, Z: f64), since the Karatsuba product is real arithmetic
PEAK_BY_LETTER = {"H": PEAK_FLOPS_BF16, "S": PEAK_FLOPS_F32,
                  "D": PEAK_FLOPS_F64, "C": PEAK_FLOPS_F32,
                  "Z": PEAK_FLOPS_F64}
ITEMSIZE = {"H": 2, "S": 4, "D": 8, "C": 8, "Z": 16}


def memops_blocks(blocks: Iterable[Tuple[int, int]], K: int, M: int,
                  N: int) -> int:
    """The paper's exact objective: Σ(m_i+n_i)·K + 2·M·N."""
    s = sum(m + n for m, n in blocks)
    return s * K + 2 * M * N


def memops_coeff(blocks: Iterable[Tuple[int, int]]) -> int:
    """Just the K coefficient Σ(m_i+n_i) (what the tiler minimizes)."""
    return sum(m + n for m, n in blocks)


@dataclasses.dataclass(frozen=True)
class RooflineEstimate:
    flops: float
    hbm_bytes: float
    compute_s: float
    memory_s: float

    @property
    def bound(self) -> str:
        return "operations" if self.compute_s >= self.memory_s else "bytes"

    @property
    def seconds(self) -> float:
        return max(self.compute_s, self.memory_s)


def gemm_roofline(M: int, N: int, K: int, letter: str, *,
                  has_c: bool = False) -> RooflineEstimate:
    """Least time one H100 could take for C = αAB (+βC): each input read
    once, the output written once, the operations at the letter's peak.
    A complex letter counts the Karatsuba's own work, 6MNK + 5MN real
    operations (``templates.contract_flops``), not the paper's 8MNK: the
    bound is the least work that computes the function."""
    item = ITEMSIZE[letter]
    traffic = (M * K + K * N + M * N * (2 if has_c else 1)) * item
    flops = templates.contract_flops(
        M, N, K, complex_=kernelgen.IS_COMPLEX.get(letter, False))
    return RooflineEstimate(flops, traffic, flops / PEAK_BY_LETTER[letter],
                            traffic / HBM_BW)
