"""Roofline terms of a step (counterpart of ``repro/launch/hlo_stats.py``).

The hardware constants are ``core/cost.py``'s: ``PEAK_FLOPS_BF16``
(989e12 FLOP/s, dense tensor cores) and ``HBM_BW`` (3.35e12 B/s), NVIDIA's
data-sheet figures for the H100 SXM5 80GB at 700 W, the card every chip
run of the port uses.  They are data-sheet figures, not measurements.

``coll_bytes`` are one rank's collective bytes by kind (the outputs of
the ``_c10d_functional`` ops DTensor issues, counted by
``step_analyzer.StepCounter``: the reference's ``collective_bytes``),
and ``collective_s`` is their total over ``NVLINK_BW``, 450 GB/s each
way a card on the H100 SXM5's fourth-generation NVLink inside a node
(900 GB/s both ways: NVIDIA's data sheet, not a measurement; the
reference divides by its ICI link rate).  A step that runs on one rank
(a serving cell: the port serves on one rank, as the reference's serve
launcher has no mesh) has no collectives and leaves both None, with the
reason.  The memory terms are the arguments' per-device bytes, from the
sharding rules' local shapes (``parallel/rules.py``); temporaries are
not estimated (None, with the reason), because nothing is compiled.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.cost import HBM_BW, PEAK_FLOPS_BF16

PEAK_FLOPS = PEAK_FLOPS_BF16

TEMP_UNKNOWN = ("not estimated: eager torch allocates temporaries op by "
                "op, and nothing is compiled that could report them")
#: per-card NVLink bandwidth each way, H100 SXM5 (data sheet)
NVLINK_BW = 450e9
NVLINK_NOTE = ("collective_s = coll_bytes total / 450e9 B/s: NVLink 4 "
               "each way a card, H100 SXM5 data sheet")
COLL_ONE_RANK = ("none: the step runs on one rank (the port serves on one "
                 "rank); per-device counts are the global count / devices")


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device matmul FLOPs
    hbm_bytes: float             # per-device operand + output bytes
    model_flops: float           # analytic 6·N·D (active) per device
    coll_bytes: Optional[Dict[str, float]] = None   # by kind, + "total"
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: Optional[float] = None

    def __post_init__(self):
        self.compute_s = self.flops / PEAK_FLOPS
        self.memory_s = self.hbm_bytes / HBM_BW
        if self.coll_bytes is not None:
            self.coll_bytes = dict(self.coll_bytes)
            self.coll_bytes["total"] = sum(
                v for k, v in self.coll_bytes.items() if k != "total")
            self.collective_s = self.coll_bytes["total"] / NVLINK_BW

    def _terms(self) -> Dict[str, float]:
        t = {"compute": self.compute_s, "memory": self.memory_s}
        if self.collective_s is not None:
            t["collective"] = self.collective_s
        return t

    @property
    def dominant(self) -> str:
        t = self._terms()
        return max(t, key=t.get)

    @property
    def step_s(self) -> float:
        return max(self._terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based MFU bound implied by the dominant term."""
        if self.step_s == 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.step_s

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "step_s": self.step_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_note": NVLINK_NOTE if self.coll_bytes is not None
            else COLL_ONE_RANK,
        }


def memory_analysis_terms(arguments: Dict[str, int]) -> Dict:
    """The reference's ``memory_analysis`` keys that have a counterpart:
    ``argument_size_in_bytes`` per device (the sum of ``arguments``, bytes
    by argument group), ``temp_size_in_bytes`` None with the reason."""
    return {"argument_size_in_bytes": int(sum(arguments.values())),
            "arguments": {k: int(v) for k, v in arguments.items()},
            "temp_size_in_bytes": None, "temp_note": TEMP_UNKNOWN}
