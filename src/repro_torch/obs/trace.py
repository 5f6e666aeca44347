"""repro_torch.obs.trace — the per-request flight recorder's event ring.

Counterpart of ``repro/obs/trace.py``: a bounded ring of typed,
timestamped events from the paged serving engine, the scheduler, the
block pool and the Router's memo-miss path.  The per-request reducer and
the Perfetto export are not ported yet; the events are recorded with the
same taxonomy so they can be.

Events are emitted from host-side code only; an append is one
``deque.append`` (drop-oldest via ``maxlen``); timestamps are
``time.perf_counter()``; ``REPRO_OBS=0`` or ``REPRO_TRACE=0`` turn the
recorder off.
"""
from __future__ import annotations

import collections
import os
import time
from typing import Any, List, Optional, Tuple

__all__ = ["EVENT_TYPES", "Event", "EventLog", "TRACE", "emit"]

#: The closed event taxonomy: ``emit`` rejects anything else.
EVENT_TYPES = frozenset((
    "REQ_ARRIVE",     # engine.submit: rid, (prompt_len, max_new)
    "ADMIT",          # sched.admit, first admission: rid, slot
    "RESUME",         # sched.admit, re-admission after preempt: rid, slot
    "PREFILL_CHUNK",  # engine: rid, slot, (pos0, n_tokens), dur_us
    "FIRST_TOKEN",    # engine: rid, slot
    "DECODE_TICK",    # engine, sampled: (step_idx, n_decoding)
    "PREEMPT",        # sched.preempt: rid, slot
    "FINISH",         # engine._finish: rid, slot, n_out
    "EVICT",          # paged.CacheMap.release: rid, blocks freed
    "ROUTE_MISS",     # api.Router.route memo-miss: (op, letter, trans, dims)
    "PROFILE_SWAP",   # tune.profile active-profile transition: tag
))

#: One record: (t, type, rid, slot, arg, dur_us).
Event = Tuple[float, str, int, int, Any, Optional[float]]

_DEFAULT_CAP = 65536


class EventLog:
    """Fixed-capacity ring of :data:`Event` records (drops the oldest)."""

    def __init__(self, capacity: Optional[int] = None,
                 enabled: bool = True) -> None:
        if capacity is None:
            capacity = int(os.environ.get("REPRO_TRACE_CAP", _DEFAULT_CAP))
        if capacity < 1:
            raise ValueError("EventLog capacity must be >= 1")
        self.capacity = capacity
        self.on = enabled
        self.n_total = 0
        self._ring: collections.deque = collections.deque(maxlen=capacity)

    def emit(self, etype: str, rid: int = -1, slot: int = -1,
             arg: Any = None, dur_us: Optional[float] = None) -> None:
        if not self.on:
            return
        if etype not in EVENT_TYPES:
            raise ValueError(f"unknown trace event {etype!r}; "
                             f"expected one of {sorted(EVENT_TYPES)}")
        self.n_total += 1
        self._ring.append((time.perf_counter(), etype, rid, slot, arg,
                           dur_us))

    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self) -> List[Event]:
        """Events oldest-first (a list copy)."""
        return list(self._ring)

    def reset(self) -> None:
        self._ring.clear()
        self.n_total = 0


def _trace_env_on() -> bool:
    v = os.environ.get("REPRO_TRACE")
    return (v or "1").strip().lower() not in ("0", "false", "off", "no")


#: The process-global flight recorder every emitter writes to.
TRACE = EventLog(enabled=_trace_env_on())


def emit(etype: str, rid: int = -1, slot: int = -1, arg: Any = None,
         dur_us: Optional[float] = None) -> None:
    """Module-level convenience over :data:`TRACE`."""
    TRACE.emit(etype, rid, slot, arg, dur_us)
