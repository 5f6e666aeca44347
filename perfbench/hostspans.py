"""The program's own spans set on the traced slice's clock, and joined to
its device trace.

``repro_torch.obs`` records a span while a capture is open, and the
traced slice's profiler opens one: its name, its start and end on
``time.perf_counter_ns``, the index of its parent, its request id and
attributes, and for some its device time.  The harness's
``perfbench.step`` spans lie on the profiler's clock, one around each
engine step or train step it calls, and the program's own step span
(``serve.step``, ``train.step``) lies inside each.

* ``align``: a program step starts after its harness step, by at least
  the overhead of one call, and ends before it; so the offset between
  the two clocks is the largest, over the slice's steps, of the start of
  a harness step less the start of its program step (the step whose
  program span began soonest after its harness span's, the closest to
  the truth), and every program step so moved must end inside its
  harness step, within ``TOLERANCE_US``.  Not the midpoints, nor the
  median of the starts: the harness's own work after a step (the
  clients' poll, a train step's loss read back) and before it (a train
  step's batch) moves each by tens of us to ms.
* ``Captured``: the records inside the slice's program steps, summed by
  name, parent and attribute.
* ``Captured.idle_under``: the device's idle time while a span was the
  innermost one open on the host.

Where the program records no spans (a checkout that predates them), the
buffer dropped records, or the steps do not line up, ``capture`` gives
None, and so does every reader built on it.
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional, Sequence, Tuple

from perfbench import trace as tr

HARNESS_STEP = "perfbench.step"
#: how far a program step, aligned, may reach out of its harness step (us)
TOLERANCE_US = 200.0


def records() -> Optional[List[Any]]:
    """The program's span records (``obs.spans()``), or None where it has
    no span recorder or its buffer dropped records."""
    from repro_torch import obs
    spans = getattr(obs, "spans", None)
    drops = getattr(obs, "span_drops", None)
    if spans is None or drops is None or drops():
        return None
    return spans()


def align(data: Dict[str, Any], recs: Sequence[Any],
          step: str) -> Optional[float]:
    """The offset (us) that puts a program stamp (ns / 1e3) on the
    slice's clock, or None where the steps do not pair one to one or an
    aligned program step ends outside its harness step."""
    harness = sorted((a, b) for n, a, b in data["spans"]
                     if n == HARNESS_STEP)
    prog = sorted((r for r in recs if r.name == step
                   and r.t1_ns is not None), key=lambda r: r.t0_ns)
    if not harness or len(harness) != len(prog):
        return None
    off = max(a - r.t0_ns / 1e3 for (a, _), r in zip(harness, prog))
    if any(r.t1_ns / 1e3 + off > b + TOLERANCE_US
           for (_, b), r in zip(harness, prog)):
        return None
    return off


def _idle(data: Dict[str, Any]) -> Tuple[List[float], List[float],
                                         List[float]]:
    """The slice's idle gaps as (starts, ends, idle time before each)."""
    starts, ends, before = [], [], []
    t, acc = data["t0"], 0.0
    for a, b in tr.busy(data) + [(data["t1"], data["t1"])]:
        if a > t:
            starts.append(t)
            ends.append(a)
            before.append(acc)
            acc += a - t
        t = max(t, b)
    return starts, ends, before


class Captured:
    """The records of a traced slice's program steps (see ``capture``)."""

    def __init__(self, data: Dict[str, Any], recs: Sequence[Any],
                 offset: float, step: str) -> None:
        self.data, self.recs, self.offset = data, recs, offset
        # each record's step (-1: outside every step) and the names of
        # the spans around it; a parent is recorded before its children
        self.step_of: List[int] = []
        self.around: List[frozenset] = []
        for i, r in enumerate(recs):
            p = r.parent
            if r.name == step:
                self.step_of.append(i)
            else:
                self.step_of.append(self.step_of[p] if p >= 0 else -1)
            self.around.append(self.around[p] | {recs[p].name} if p >= 0
                               else frozenset())
        self.steps = [i for i, r in enumerate(recs) if r.name == step]

    def of(self, name: str, inside: Optional[str] = None,
           outside: Optional[str] = None) -> List[Any]:
        """Records named ``name`` in the steps; with ``inside`` only those
        under a span of that name, with ``outside`` only those under
        none."""
        return [r for i, r in enumerate(self.recs)
                if r.name == name and self.step_of[i] >= 0
                and (inside is None or inside in self.around[i])
                and (outside is None or outside not in self.around[i])]

    @staticmethod
    def ms(recs: Sequence[Any]) -> float:
        """Summed host time of ``recs`` (ms)."""
        return sum(r.t1_ns - r.t0_ns for r in recs) * 1e-6

    def idle_under(self, name: str) -> float:
        """Device idle time (s) while a span named ``name`` in the steps
        was the innermost one open on the host."""
        starts, ends, before = _idle(self.data)

        def upto(x: float) -> float:
            k = bisect.bisect_right(starts, x) - 1
            if k < 0:
                return 0.0
            return before[k] + min(x, ends[k]) - starts[k]

        def within(r) -> float:
            return upto(r.t1_ns / 1e3 + self.offset) - \
                upto(r.t0_ns / 1e3 + self.offset)
        kids: Dict[int, List[Any]] = {}
        for r in self.recs:
            if r.parent >= 0:
                kids.setdefault(r.parent, []).append(r)
        total = 0.0
        for i, r in enumerate(self.recs):
            if r.name == name and self.step_of[i] >= 0:
                total += within(r) - sum(within(c) for c in kids.get(i, ()))
        return total * 1e-6


def capture(ctx: Dict[str, Any], kind: str, step: str) -> Optional[Captured]:
    """The program's spans of the traced slice of a ``kind`` cell, whose
    steps are ``step`` spans; None where there is nothing sound to read."""
    data = ctx.get("slice")
    if ctx.get("kind") != kind or data is None or not ctx.get("slice_steps"):
        return None
    recs = records()
    if not recs:
        return None
    off = align(data, recs, step)
    if off is None:
        return None
    cap = Captured(data, recs, off, step)
    if len(cap.steps) != ctx["slice_steps"]:
        return None
    return cap
