"""The paper's own 'architecture': the small-GEMM benchmark suite.

IAAT's evaluation object is not a neural network but the S/D/C/Z x
NN/NT/TN/TT small-GEMM grid (paper §VI).  This config pins that grid so
benchmarks and examples share one definition of the paper's workload.
"""
import dataclasses
from typing import Tuple

from repro_torch.core.paper_table import (PAPER_SMALL_THRESHOLD,
                                    PAPER_SMALL_THRESHOLD_TN)


@dataclasses.dataclass(frozen=True)
class PaperGemmConfig:
    letters: Tuple[str, ...] = ("S", "D", "C", "Z")
    transpositions: Tuple[str, ...] = ("NN", "NT", "TN", "TT")
    # M = N = K sweep bounds per the paper's smallness definition
    max_n: int = PAPER_SMALL_THRESHOLD          # 80 (non-TN)
    max_n_tn: int = PAPER_SMALL_THRESHOLD_TN    # 32 (TN)
    step: int = 2

    def sizes(self, trans: str):
        lim = self.max_n_tn if trans == "TN" else self.max_n
        return range(self.step, lim + 1, self.step)


CONFIG = PaperGemmConfig()


def smoke() -> PaperGemmConfig:
    return dataclasses.replace(CONFIG, letters=("S",), max_n=16, max_n_tn=8)
