"""repro_torch.tune.online — background traffic-aware re-tuning (port).

Counterpart of ``repro/tune/online.py``: the paper's run-time stage
applied to live traffic.  :class:`OnlineTuner` periodically folds
``obs.ROUTES.windowed(decay=...)`` — the decayed shape distribution the
route memo keeps at no cost to the memo-hit path — into a
traffic-weighted priority over size classes, re-times the hottest
through :func:`repro_torch.tune.search.budgeted_sweep` (at most
``budget`` stopwatch timings a cycle), and merges the delta into the
live :class:`DeviceProfile` through ``merge`` + ``set_active_profile``.

What differs from the reference, where routing happens at jit trace time:

* The port routes eagerly on every call, so a swap could reach an engine
  step in flight.  ``PagedEngine`` runs each step under
  ``profile.pinned()``: a swap published meanwhile is installed when the
  step ends, so no step sees two profiles.  Every entry the tuner
  installs is a measured kernel/library pair, so a decision flip trades
  one correct path for another.
* On the card the tuner owns a ``torch.cuda.Stream`` and times every
  candidate inside ``torch.cuda.stream(...)``: its launches, its CUDA
  events and the wait on them stay on that stream (``timer.measure``),
  and its split-K launches have their own tickets
  (``iaat_gemm._tickets_on``).  The engine's stream is never synchronised.
* The reference's ``interpret=`` has no counterpart: ``device`` (the
  card where there is one) decides what is timed, and the profile's mode
  is its type.
* On the card a verdict is installed only from timings worth the name:
  at least :data:`CARD_WARMUP` warm-up call and :data:`CARD_REPS`
  repeats (the reference's defaults, no warm-up and one repeat, are
  harmless in its interpret mode but here time start-up), operands drawn
  on the card (``search._maker``), and each sweep's first library call of
  a letter made before any timing (``search.budgeted_sweep``): a new
  thread's first cuBLAS call on its stream sets up a handle and a
  workspace (a first batched einsum took 104 ms on an NVIDIA H100 80GB
  HBM3 at 700 W, ``chip_smoke.py`` "online grouped").  And the card is
  idle while a sweep times: an engine serving with the tuner runs the
  cycle itself, on its own thread between two steps (:meth:`poll`), and
  the sweep waits for the device first.  Timed beside the engine's
  kernels, from a thread of its own, olmo-1b's M = 45 classes read
  1.35-2.21x in the kernel's favour where the idle card gives cuBLAS
  1.18-1.94x (NVIDIA H100 80GB HBM3, 700 W, ``chip_smoke.py`` "online
  serve" with the tuner on its own thread).
* The port's route log counts every executed call (the reference
  counts trace-time calls, which stop once a step is compiled), so a
  class's decayed count keeps growing with steady serving and would pass
  the ``retune_ratio`` hysteresis again and again.  The tuner therefore
  weighs each class by its share of the window's calls, in percent
  (``min_weight`` 1.0: classes under 1 % are cold): steady traffic reads
  the same weight however long it has run and is tuned once, and only a
  shift in the mix re-tunes.  :func:`weighted_targets` is the
  reference's.
* ``max_dim`` defaults to 16384, not 1024: the decode projections of a
  served 1–2B model (d_model 2048, d_ff 8192: representatives 2896 and
  11585) time in microseconds on the card and are the traffic to tune,
  while the vocabulary head's class (olmo-1b's representative 46341,
  about 1 GB of operands drawn on the host) stays out.

``REPRO_ONLINE_TUNE=0`` makes :meth:`OnlineTuner.start` and
:meth:`OnlineTuner.poll` no-ops (manual :meth:`cycle` calls still work).  Each cycle bumps ``tune.online.cycles``
/ ``classes_retuned`` / ``swaps``, records ``tune.online.cycle_us`` and
lands a ``TUNE_CYCLE`` event with its wall time in the flight recorder;
an error inside the background loop counts ``tune.online.errors`` and
leaves the profile as it was.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.tune import classes as classes_mod
from repro_torch.tune import profile as profile_mod
from repro_torch.tune.classes import SizeClass
from repro_torch.tune.profile import DeviceProfile
from repro_torch.tune.search import TuneTarget

__all__ = ["OnlineTuner", "CycleReport", "weighted_targets", "enabled",
           "KILL_SWITCH_ENV"]

KILL_SWITCH_ENV = "REPRO_ONLINE_TUNE"
_LOG = logging.getLogger("repro_torch.tune")

#: route-log ops that run per-group problems on the grouped kernels
#: (measured by ``tune_grouped_class``, recorded under the profile's
#: ``grouped:`` namespace); everything else re-times as 2-D.
_GROUPED_OPS = ("batched_gemm", "ragged_gemm")
#: the least warm-up and repeats of a timing on the card
CARD_WARMUP, CARD_REPS = 1, 3


def enabled() -> bool:
    """The ``REPRO_ONLINE_TUNE`` kill switch (default on; only explicit
    off values disable, as for ``REPRO_OBS``)."""
    v = os.environ.get(KILL_SWITCH_ENV)
    return (v or "1").strip().lower() not in ("0", "false", "off", "no")


def weighted_targets(folded: Dict[Tuple[str, str, str], float], *,
                     min_weight: float = 1.0,
                     done: Optional[Dict[Tuple[str, str], float]] = None,
                     retune_ratio: float = 1.5,
                     top_k: Optional[int] = None,
                     max_dim: Optional[int] = None) -> List[TuneTarget]:
    """Fold a ``ROUTES.windowed(decay=...)`` dict into a re-tune priority
    list, hottest first.

    ``folded`` maps ``(op, letter, cls)`` to a decayed count.  Ops
    collapse to the measuring kind ("gemm" for 2-D and ND, "grouped" for
    the batched and ragged paths, whose class strings already describe
    the per-group (C, N, K) problem), weights summing within a kind.
    Classes below ``min_weight`` are cold.  ``done`` maps ``(kind,
    class-key)`` to the weight at which a class was last tuned: it is
    skipped until its weight exceeds ``retune_ratio`` times that, so
    steady traffic is tuned once.  ``max_dim`` drops classes whose
    representative exceeds it.
    """
    acc: Dict[Tuple[str, str], Tuple[float, SizeClass]] = {}
    for (op, letter, cls), w in folded.items():
        kind = "grouped" if op in _GROUPED_OPS else "gemm"
        try:
            sc = SizeClass.from_key(f"{letter}/NN/{cls}")
        except (ValueError, TypeError):
            continue
        if max_dim is not None and \
                max(classes_mod.representative(sc)) > max_dim:
            continue
        key = (kind, sc.key)
        prev = acc.get(key)
        acc[key] = (w + (prev[0] if prev else 0.0), sc)
    out: List[TuneTarget] = []
    for (kind, sckey), (w, sc) in acc.items():
        if w < min_weight:
            continue
        if done is not None and w <= retune_ratio * done.get((kind, sckey),
                                                             0.0):
            continue
        out.append(TuneTarget(kind, sc, w))
    out.sort(key=lambda t: (-t.weight, t.kind, t.sc.key))
    return out[:top_k] if top_k is not None else out


@dataclasses.dataclass(frozen=True)
class CycleReport:
    """What one :meth:`OnlineTuner.cycle` did (the same numbers land in
    the ``tune.online.*`` metrics)."""
    cycle: int
    considered: int            # hot classes that passed the weighter
    retuned: int               # classes re-timed this cycle
    timings: int               # stopwatch budget spent
    swapped: bool              # a merged profile was published
    wall_us: float


class OnlineTuner:
    """Background re-tuner: windowed traffic in, profile swaps out.

    * ``poll()`` — a cycle on the caller's thread once ``interval_s``
      seconds have passed since the first poll or the last cycle.
      ``PagedEngine(tuner=)`` polls after each step, so that a sweep
      times the card between two steps.
    * ``start()`` / ``stop()`` — a daemon thread runs :meth:`cycle` every
      ``interval_s`` seconds, waiting first, for a caller with no loop
      of its own to poll from; ``stop`` is idempotent, safe with requests
      in flight, and joins the thread with a timeout.
    * ``cycle()`` — one synchronous pass.

    ``sweeper`` injects the measuring stage (``f(targets, budget=) ->
    (delta_profile, tuned, timings)``, the contract of
    ``search.budgeted_sweep``), so tests drive the weighting, merge and
    swap without a stopwatch.
    """

    def __init__(self, *, interval_s: float = 5.0, top_k: int = 4,
                 budget: int = 8, decay: float = 0.5, n_buckets: int = 8,
                 min_weight: float = 1.0, retune_ratio: float = 1.5,
                 top: int = 1, warmup: int = 0, reps: int = 1,
                 grouped_G: int = 4, max_dim: Optional[int] = 16384,
                 device=None, device_kind: Optional[str] = None,
                 sweeper: Optional[Callable[..., tuple]] = None,
                 persist: bool = False):
        self.interval_s = interval_s
        self.top_k, self.budget = top_k, budget
        self.decay, self.n_buckets = decay, n_buckets
        self.min_weight, self.retune_ratio = min_weight, retune_ratio
        self.top, self.warmup, self.reps = top, warmup, reps
        self.grouped_G, self.max_dim = grouped_G, max_dim
        self.device = torch.device(device or profile_mod.current_mode())
        self.mode = self.device.type
        self._device_kind = device_kind
        self._sweeper = sweeper
        self.persist = persist
        self.cycles = 0
        self.swaps = 0
        # (kind, class-key) -> traffic weight when last tuned
        self._done: Dict[Tuple[str, str], float] = {}
        self._cycle_lock = threading.Lock()     # one cycle at a time
        self._due: Optional[float] = None       # poll()'s next cycle
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream = None                     # the card's timing stream

    # -- one pass ----------------------------------------------------------

    def targets(self) -> List[TuneTarget]:
        """Current windowed traffic, as each class's percent of the
        window's decayed calls -> re-tune priorities."""
        folded = obs.ROUTES.windowed(self.n_buckets, decay=self.decay)
        total = sum(folded.values())
        shares = {k: 100.0 * w / total for k, w in folded.items()} \
            if total else {}
        return weighted_targets(shares, min_weight=self.min_weight,
                                done=self._done,
                                retune_ratio=self.retune_ratio,
                                top_k=self.top_k, max_dim=self.max_dim)

    def timing(self) -> Tuple[int, int]:
        """(warm-up, repeats) of each timing: as given on the CPU, at least
        (:data:`CARD_WARMUP`, :data:`CARD_REPS`) on the card."""
        if self.device.type == "cuda":
            return max(self.warmup, CARD_WARMUP), max(self.reps, CARD_REPS)
        return self.warmup, self.reps

    def _sweep(self, targets: Sequence[TuneTarget]):
        if self._sweeper is not None:
            return self._sweeper(targets, budget=self.budget)
        from repro_torch.tune import search
        warmup, reps = self.timing()

        def run():
            return search.budgeted_sweep(
                targets, budget=self.budget, top=self.top,
                warmup=warmup, reps=reps, device=self.device,
                grouped_G=self.grouped_G, device_kind=self._device_kind)
        if self.device.type != "cuda":
            return run()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            return run()

    def _merge_and_swap(self, delta: DeviceProfile) -> bool:
        """Fold the cycle's delta into the latest published profile and
        publish the result (one ``set_active_profile``).  ``merge`` keeps
        the faster-measured entry, so an online entry displaces an
        offline one only when it beat it; a profile of another device
        kind or mode is left alone (``tune.online.merge_skips``)."""
        base = profile_mod.latest_profile()
        if base is not None and len(base):
            if base.device_kind != delta.device_kind \
                    or base.mode != delta.mode:
                obs.counter("tune.online.merge_skips").inc()
                return False
            merged = base.merge(delta)
        else:
            merged = delta
        profile_mod.set_active_profile(merged)
        self.swaps += 1
        obs.counter("tune.online.swaps").inc()
        if self.persist:
            try:
                merged.save()
            except OSError:
                obs.counter("tune.online.persist_failures").inc()
        return True

    def cycle(self) -> CycleReport:
        """One synchronous pass: weigh traffic, re-tune within budget,
        merge and publish.  A manual call during a background run waits
        for the cycle in flight."""
        with self._cycle_lock:
            t0 = time.perf_counter()
            targets = self.targets()
            delta: Optional[DeviceProfile] = None
            tuned: List[TuneTarget] = []
            timings = 0
            if targets:
                delta, tuned, timings = self._sweep(targets)
            swapped = False
            if delta is not None and len(delta):
                swapped = self._merge_and_swap(delta)
            for t in tuned:
                key = (t.kind, t.sc.key)
                self._done[key] = max(t.weight, self._done.get(key, 0.0))
            self.cycles += 1
            wall_us = (time.perf_counter() - t0) * 1e6
            obs.counter("tune.online.cycles").inc()
            if tuned:
                obs.counter("tune.online.classes_retuned").inc(len(tuned))
            obs.histogram("tune.online.cycle_us").record(wall_us)
            obs.TRACE.emit(
                "TUNE_CYCLE",
                arg=(self.cycles, len(tuned), timings, bool(swapped)),
                dur_us=wall_us)
            return CycleReport(self.cycles, len(targets), len(tuned),
                               timings, swapped, wall_us)

    def _safe_cycle(self) -> Optional[CycleReport]:
        try:
            return self.cycle()
        except Exception:   # noqa: BLE001 — tuning never ends serving
            obs.counter("tune.online.errors").inc()
            _LOG.exception("online tune cycle failed; the profile "
                           "stays as it was")
            return None

    def poll(self) -> Optional[CycleReport]:
        """One cycle on the caller's thread when ``interval_s`` has passed
        since the first poll or the last cycle, else nothing.  A no-op
        under ``REPRO_ONLINE_TUNE=0`` and while the background loop runs;
        an error is counted and never raised."""
        if not enabled() or self.running:
            return None
        now = time.perf_counter()
        if self._due is None:
            self._due = now + self.interval_s
        if now < self._due:
            return None
        try:
            return self._safe_cycle()
        finally:
            self._due = time.perf_counter() + self.interval_s

    # -- background lifecycle ----------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> bool:
        """Start the background loop; False under ``REPRO_ONLINE_TUNE=0``
        (the tuner stays inert).  A second start while running is a no-op
        that returns True."""
        if not enabled():
            return False
        if self.running:
            return True
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="repro-torch-online-tuner",
                                        daemon=True)
        self._thread.start()
        return True

    def _loop(self) -> None:
        # wait first: traffic needs a beat to accumulate, and a stop()
        # right after start() exits without a cycle
        while not self._stop.wait(self.interval_s):
            self._safe_cycle()

    def stop(self, timeout: float = 30.0) -> bool:
        """Signal and join the background loop; True when the thread is
        down.  Idempotent; the tuner can be started again."""
        t, self._thread = self._thread, None
        if t is None:
            return True
        self._stop.set()
        t.join(timeout)
        return not t.is_alive()

    def __enter__(self) -> "OnlineTuner":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
