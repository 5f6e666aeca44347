"""Micro-benchmark harness for the empirical tuner (port).

Counterpart of ``repro/tune/timer.py``.  ``warmup`` calls are discarded
(they also build the CUDA kernels and set up cuBLAS); the statistic is
the *median* of ``reps`` repeats, immune to one preemption.

* On the card each repeat is bracketed by two CUDA events on the
  caller's current stream and closed by waiting on the second event:
  the time is the device's, not the enqueue's.  Nothing waits for the
  whole device, so the online tuner, timing on its own stream, leaves
  the serving stream alone (its kernels may share the SMs meanwhile).
* On the CPU (the plain versions) each repeat is timed with
  ``time.perf_counter``.  Such a time orders the candidates of a CPU
  sweep and says nothing about the card; its profile is marked
  ``mode="cpu"`` and never applied there (``tune/profile.py``).

:func:`try_measure` prunes a candidate that fails inside a sweep: it
returns None, logs the error and records it in :data:`FAILURES`, which a
caller that must not lose candidates (``chip_smoke.py``) checks.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch import obs

_LOG = logging.getLogger("repro_torch.tune")

#: (what, error) of every candidate :func:`try_measure` pruned
FAILURES: List[Tuple[str, str]] = []


@dataclasses.dataclass(frozen=True)
class Measurement:
    median_us: float
    best_us: float
    worst_us: float
    reps: int

    @property
    def reliable(self) -> bool:
        """Repeats agree to within 4x — enough to trust a ranking."""
        return self.worst_us <= 4 * self.best_us

    def to_json(self) -> dict:
        return {"median_us": self.median_us, "best_us": self.best_us,
                "worst_us": self.worst_us, "reps": self.reps}

    @classmethod
    def from_json(cls, d: dict) -> "Measurement":
        return cls(float(d["median_us"]), float(d["best_us"]),
                   float(d["worst_us"]), int(d["reps"]))


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def measure(fn: Callable[[], Any], *, device="cpu", warmup: int = 1,
            reps: int = 5) -> Measurement:
    """Time ``fn()`` on ``device``: median-of-``reps`` microseconds after
    ``warmup`` discarded calls (CUDA events on the caller's current
    stream on the card, the host clock on the CPU)."""
    if reps < 1:
        raise ValueError("reps must be >= 1")
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    times = []
    if cuda:
        # e0 is reached once the warm-up queued before it has run
        stream = torch.cuda.current_stream(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        for _ in range(reps):
            e0.record(stream)
            fn()
            e1.record(stream)
            e1.synchronize()
            times.append(e0.elapsed_time(e1) * 1e3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
    m = Measurement(_median(times), min(times), max(times), reps)
    obs.counter("tune.measurements").inc()
    obs.histogram("tune.measure_us").record(m.median_us)
    if not m.reliable:
        obs.counter("tune.unreliable").inc()
    return m


def try_measure(fn: Callable[[], Any], *, what: str = "", device="cpu",
                warmup: int = 1, reps: int = 5) -> Optional[Measurement]:
    """:func:`measure`, but a candidate that fails to build or launch
    yields None (and is logged and recorded in :data:`FAILURES`) instead
    of ending the sweep."""
    try:
        return measure(fn, device=device, warmup=warmup, reps=reps)
    except Exception as e:  # noqa: BLE001 — any failure prunes the candidate
        obs.counter("tune.failures").inc()
        FAILURES.append((what, f"{type(e).__name__}: {e}"))
        _LOG.warning("tune: candidate %s failed: %s: %s", what,
                     type(e).__name__, e)
        return None
