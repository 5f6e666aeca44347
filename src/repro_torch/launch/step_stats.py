"""Roofline terms of a step (counterpart of ``repro/launch/hlo_stats.py``).

The hardware constants are ``core/cost.py``'s: ``PEAK_FLOPS_BF16``
(989e12 FLOP/s, dense tensor cores) and ``HBM_BW`` (3.35e12 B/s), NVIDIA's
data-sheet figures for the H100 SXM5 80GB at 700 W, the card every chip
run of the port uses.  They are data-sheet figures, not measurements.

``coll_bytes`` are one rank's collective bytes by kind (the outputs of
the ``_c10d_functional`` ops DTensor and the split softmax emit, counted
by ``step_analyzer.StepCounter``: the reference's ``collective_bytes``),
and ``collective_s`` is their total over ``NVLINK_BW``, 450 GB/s each
way a card on the H100 SXM5's fourth-generation NVLink inside a node
(900 GB/s both ways: NVIDIA's data sheet, not a measurement; the
reference divides by its ICI link rate).  A step on a mesh of one rank
has no collectives and leaves both None, with the reason.

The memory terms are the reference's ``memory_analysis`` keys, one
rank's (:func:`memory_analysis_terms`): the arguments from the sharding
rules' local shapes (``parallel/rules.py``), the output and alias bytes
of what the step returned, and the temporaries from the live bytes the
counter followed through the step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.cost import HBM_BW, PEAK_FLOPS_BF16

PEAK_FLOPS = PEAK_FLOPS_BF16

TEMP_NOTE = ("total_nonalias = the port's argument bytes (port_arguments) "
             "+ the step's peak of live allocations (step_analyzer); "
             "temp = total_nonalias - arguments - output + alias")
#: per-card NVLink bandwidth each way, H100 SXM5 (data sheet)
NVLINK_BW = 450e9
NVLINK_NOTE = ("collective_s = coll_bytes total / 450e9 B/s: NVLink 4 "
               "each way a card, H100 SXM5 data sheet")
COLL_ONE_RANK = "none: a mesh of one rank"


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


def memory_analysis_terms(arguments: Dict[str, int], port: Dict[str, int],
                          *, peak_live: int, output: int,
                          alias: int) -> Dict:
    """The reference's ``memory_analysis`` keys, one device's:
    ``argument_size_in_bytes`` (the sum of ``arguments``, bytes by
    argument group as the reference counts them; ``port`` as the port
    stores them), ``output_size_in_bytes`` and ``alias_size_in_bytes`` (the
    step's returned leaves, and those of them that share an argument's
    storage), ``total_nonalias``, measured: the port's argument bytes plus
    the step's peak of live allocations (``peak_live``), and
    ``temp_size_in_bytes`` = total_nonalias - arguments - output + alias,
    the reference's identity (``hlo_stats.memory_analysis_terms``) read
    backwards, the arguments as the port holds them.  The reference's
    ``generated_code_size_in_bytes`` has no counterpart and is left out."""
    held = int(sum(port.values()))
    total = held + int(peak_live)
    return {"argument_size_in_bytes": int(sum(arguments.values())),
            "arguments": {k: int(v) for k, v in arguments.items()},
            "port_arguments": {k: int(v) for k, v in port.items()},
            "output_size_in_bytes": int(output),
            "alias_size_in_bytes": int(alias),
            "temp_size_in_bytes": total - held - int(output) + int(alias),
            "total_nonalias": total, "temp_note": TEMP_NOTE}
