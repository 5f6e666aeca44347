"""Slot-level continuous-batching scheduler.

State machine per request (DESIGN.md §Paged KV & slot scheduler)::

    QUEUED -> PREFILL -> DECODE -> DONE
       ^         |          |
       +---------+----------+   (preempt on block exhaustion: blocks
                                 released, generated tokens kept, the
                                 request re-queues at the FRONT and
                                 re-prefills prompt+generated on resume)

Unlike the wave engine (which admits a whole wave, then blocks until the
slowest member finishes), slots here are independent: a request is
admitted the moment a slot frees up — mid-decode of everyone else — and
evicted the moment it hits EOS or its token budget, returning its slot
AND its cache blocks to the pool immediately.

The scheduler is pure host-side state (queue, slots, per-seq counters)
so it unit-tests without a model; the engine owns the device work and
drives it via ``admit`` / ``next_prefill`` / ``decoding`` / ``finish``
/ ``preempt``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

from repro_torch import obs
from repro_torch.serve.paged import CacheMap, SlotStateStore

__all__ = ["QUEUED", "PREFILL", "DECODE", "DONE", "Seq", "SlotScheduler"]

QUEUED = "queued"
PREFILL = "prefilling"
DECODE = "decoding"
DONE = "done"


@dataclasses.dataclass
class Seq:
    """Scheduler-side view of one request.

    ``pos`` counts context tokens whose K/V sit in the pool; ``out`` is
    the drained generated tokens; ``inflight`` counts decode steps
    issued to the device but not yet drained back.  On preemption the
    generated prefix is kept: the resume target is ``prompt + out`` and
    prefill recomputes that whole context (recompute-style preemption —
    at temperature 0 the continuation is exactly what it would have
    been)."""
    req: object                         # engine.Request (duck-typed)
    state: str = QUEUED
    slot: int = -1
    pos: int = 0
    out: List[int] = dataclasses.field(default_factory=list)
    inflight: int = 0
    admit_seq: int = -1                 # admission stamp; victim = max
    preemptions: int = 0
    admitted_once: bool = False

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def target(self) -> List[int]:
        """Tokens prefill must put in the pool before decode resumes."""
        return list(self.req.prompt) + self.out

    @property
    def budget_left(self) -> int:
        """Decode steps still worth issuing (max_new minus drained and
        in-flight tokens)."""
        return self.req.max_new - len(self.out) - self.inflight


class SlotScheduler:
    """FIFO admission into free slots; per-slot eviction/preemption."""

    def __init__(self, cache: CacheMap, slots: int,
                 state: Optional[SlotStateStore] = None) -> None:
        self.cache = cache
        self.state = state          # slot-row ownership, lockstep below
        self.n_slots = slots
        self.queue: Deque[Seq] = collections.deque()
        self.slots: List[Optional[Seq]] = [None] * slots
        self.live: Dict[int, Seq] = {}          # rid -> Seq (active only)
        self._stamp = 0

    # -- admission ---------------------------------------------------------

    def submit(self, seq: Seq, fit_tokens: Optional[int] = None) -> None:
        """``fit_tokens`` is the engine's worst-case pool footprint for
        the request (chunk-rounded prefill tail included); a request
        that could not complete even with the whole pool to itself is
        rejected here, which is what makes preemption livelock-free."""
        total = fit_tokens or (len(seq.req.prompt) + seq.req.max_new)
        if not self.cache.fits_ever(total):
            raise ValueError(
                f"request {seq.rid}: {total} tokens can never fit the "
                f"pool ({self.cache.allocator.capacity} blocks x "
                f"{self.cache.block_size})")
        self.queue.append(seq)

    def admit(self) -> List[Seq]:
        """Fill free slots from the queue (FIFO); called every engine
        iteration, so admission happens mid-flight, not between waves."""
        admitted = []
        for s in range(self.n_slots):
            if self.slots[s] is not None or not self.queue:
                continue
            seq = self.queue.popleft()
            seq.slot, seq.state = s, PREFILL
            seq.pos = 0
            seq.admit_seq = self._stamp
            self._stamp += 1
            self.slots[s] = seq
            self.live[seq.rid] = seq
            if self.state is not None:
                self.state.bind(s, seq.rid)
            obs.TRACE.emit("RESUME" if seq.preemptions else "ADMIT",
                           rid=seq.rid, slot=s)
            admitted.append(seq)
        return admitted

    # -- queries -----------------------------------------------------------

    def next_prefill(self) -> Optional[Seq]:
        """Earliest-admitted sequence still prefilling (round-robin is
        unnecessary: chunks are short and admission order is fairness)."""
        cands = [q for q in self.live.values() if q.state == PREFILL]
        return min(cands, key=lambda q: q.admit_seq) if cands else None

    def decoding(self) -> List[Seq]:
        return [q for q in self.live.values() if q.state == DECODE]

    def active(self) -> int:
        return len(self.live)

    def has_work(self) -> bool:
        return bool(self.queue or self.live)

    # -- transitions -------------------------------------------------------

    def finish(self, seq: Seq) -> None:
        """EOS or token budget reached: slot, blocks AND the slot's
        recurrent-state row free NOW."""
        self.cache.release(seq.rid)
        if self.state is not None:
            self.state.release(seq.rid)
        if seq.slot >= 0:
            self.slots[seq.slot] = None
        self.live.pop(seq.rid, None)
        seq.state, seq.slot = DONE, -1

    def preempt_victim(self, needer: Seq) -> Optional[Seq]:
        """Youngest-admitted active sequence (possibly ``needer``
        itself) — oldest requests keep their blocks, preserving FIFO
        fairness."""
        if not self.live:
            return None
        return max(self.live.values(), key=lambda q: q.admit_seq)

    def preempt(self, seq: Seq) -> None:
        """Release everything and put the sequence back at the FRONT of
        the queue; generated tokens survive in ``seq.out``."""
        assert seq.inflight == 0, "drain before preempting"
        obs.TRACE.emit("PREEMPT", rid=seq.rid, slot=seq.slot)
        self.cache.release(seq.rid)
        if self.state is not None:
            self.state.release(seq.rid)
        if seq.slot >= 0:
            self.slots[seq.slot] = None
        self.live.pop(seq.rid, None)
        seq.state, seq.slot, seq.pos = QUEUED, -1, 0
        seq.preemptions += 1
        obs.counter("serve.preemptions").inc()
        self.queue.appendleft(seq)
