"""Fault tolerance: step monitoring, straggler detection, restart policy
(counterpart of ``repro/train/fault.py``, a copy).

At 1000+ nodes the assumptions are (a) *something* is always failing,
(b) checkpoint/restore is the only durable state, (c) stragglers cost more
than failures.  This module provides the local building blocks:

* ``StepMonitor``  — per-step wall-time EMA + z-score straggler flagging
  (on real pods, each host reports; the launcher aggregates and evicts).
* ``run_with_restarts`` — supervises a train function; on failure restores
  from the latest complete checkpoint and replays (data pipeline is
  counter-based, so replay is exact).
* ``SimulatedFault`` — deterministic fault injection for tests.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger("repro_torch.fault")


@dataclasses.dataclass
class StepStats:
    step: int
    seconds: float
    straggler: bool


class StepMonitor:
    def __init__(self, z_thresh: float = 3.0, warmup: int = 5):
        self.z = z_thresh
        self.warmup = warmup
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.history: List[StepStats] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> StepStats:
        dt = time.monotonic() - self._t0
        straggler = False
        if self.n >= self.warmup:
            sd = max(self.var ** 0.5, 1e-6)
            straggler = (dt - self.mean) / sd > self.z
        # EMA update (skip straggler samples so they don't mask themselves)
        if not straggler:
            self.n += 1
            a = 2.0 / (self.n + 1) if self.n < 50 else 0.04
            d = dt - self.mean
            self.mean += a * d
            self.var = (1 - a) * (self.var + a * d * d)
        st = StepStats(step, dt, straggler)
        self.history.append(st)
        if straggler:
            log.warning("straggler: step %d took %.3fs (mean %.3fs)",
                        step, dt, self.mean)
        return st

    def summary(self) -> Dict:
        if not self.history:
            return {}
        ts = [s.seconds for s in self.history]
        return {"steps": len(ts), "mean_s": sum(ts) / len(ts),
                "max_s": max(ts),
                "stragglers": sum(s.straggler for s in self.history)}


class SimulatedFault(Exception):
    pass


def run_with_restarts(train_once: Callable[[int], int], *,
                      max_restarts: int = 3) -> int:
    """``train_once(attempt) -> final_step``; restores internally from the
    checkpointer it owns.  Returns the final step reached."""
    attempt = 0
    while True:
        try:
            return train_once(attempt)
        except SimulatedFault as e:          # injected faults: always retry
            attempt += 1
            log.warning("fault (%s); restart %d/%d", e, attempt, max_restarts)
            if attempt > max_restarts:
                raise
        except (RuntimeError, OSError) as e:  # real runtime faults
            attempt += 1
            log.warning("fault (%s); restart %d/%d", e, attempt, max_restarts)
            if attempt > max_restarts:
                raise
