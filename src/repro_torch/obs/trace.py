"""repro_torch.obs.trace — the per-request flight recorder.

Counterpart of ``repro/obs/trace.py``: a bounded ring of typed,
timestamped events from the paged serving engine, the scheduler, the
block pool, the Router's memo-miss path, the profile swaps and the online
tuner's cycles, and three consumers on top:

* :func:`per_request` — per-request queue wait, TTFT split into wait and
  prefill, decode stall (preempt→resume gaps after the first token) and
  preemptions; :func:`observe` folds them into ``REGISTRY`` histograms
  and :func:`summary` into a small dict;
* :func:`perfetto` / :func:`write_trace` — a Chrome-trace-event JSON
  (Perfetto, ``chrome://tracing``): slots as tracks, each request as
  flow-linked queued→prefill→decode slices, the tuner's cycles on their
  own track;
* the raw events, embedded in the export under ``reproTrace`` so that
  ``python -m repro_torch.obs trace IN OUT`` re-derives both views.

The event tuples and the Chrome-trace output are the reference's, so one
event list gives identical JSON in both packages.  Events are emitted
from host-side code only; an append is one ``deque.append`` (drop-oldest
via ``maxlen``); timestamps are ``time.perf_counter()``; ``REPRO_OBS=0``
or ``REPRO_TRACE=0`` turn the recorder off.
"""
from __future__ import annotations

import collections
import json
import os
import pathlib
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "EVENT_TYPES", "Event", "EventLog", "TRACE", "emit", "per_request",
    "observe", "summary", "perfetto", "write_trace", "load_events",
    "TRACE_SCHEMA_VERSION",
]

TRACE_SCHEMA_VERSION = 1

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
    "TUNE_CYCLE",     # tune.online cycle end: (cycle, retuned, timings,
                      #   swapped), dur_us = cycle wall time
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

    @property
    def dropped(self) -> int:
        """Events lost to drop-oldest since the last reset."""
        return max(0, self.n_total - len(self._ring))

    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self) -> List[Event]:
        """Events oldest-first (a list copy)."""
        return list(self._ring)

    def set_enabled(self, on: bool) -> None:
        self.on = bool(on)

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


# --------------------------------------------------------------------------
# Per-request reducer.
# --------------------------------------------------------------------------

def per_request(events: Iterable[Event]) -> Dict[int, dict]:
    """Derive per-request timing from the event stream.

    Returns ``rid -> record`` with (all times in microseconds):

    * ``queue_wait_us`` — submit → FIRST admission (the admission queue);
    * ``ttft_us`` / ``ttft_wait_us`` / ``ttft_prefill_us`` — time to
      first token split into time spent QUEUED (initial wait plus any
      pre-first-token preemption gaps) and time spent in a slot
      prefilling; ``ttft = wait + prefill`` by construction;
    * ``decode_stall_us`` — preempt→resume gaps AFTER the first token
      (decode progress frozen while re-queued);
    * ``preemptions``, ``prefill_chunks``, ``e2e_us``, ``n_out``,
      ``finished``.

    Requests whose REQ_ARRIVE fell off the ring still appear (anchored
    at their first surviving event) so a partial trace degrades to
    partial answers, never KeyErrors.
    """
    recs: Dict[int, dict] = {}
    waiting: Dict[int, float] = {}      # rid -> t it (re-)entered the queue

    def rec(rid: int, t: float) -> dict:
        r = recs.get(rid)
        if r is None:
            r = recs[rid] = {
                "rid": rid, "t_arrive": t, "t_first_admit": None,
                "t_first_token": None, "t_finish": None,
                "wait_us": 0.0, "decode_stall_us": 0.0,
                "preemptions": 0, "prefill_chunks": 0, "n_out": 0,
            }
        return r

    for t, etype, rid, slot, arg, dur in sorted(events, key=lambda e: e[0]):
        if rid < 0:
            continue                    # batch-wide / router events
        r = rec(rid, t)
        if etype == "REQ_ARRIVE":
            r["t_arrive"] = t
            waiting[rid] = t
        elif etype in ("ADMIT", "RESUME"):
            since = waiting.pop(rid, None)
            if since is not None:
                gap = (t - since) * 1e6
                if r["t_first_token"] is None:
                    r["wait_us"] += gap
                else:
                    r["decode_stall_us"] += gap
            if r["t_first_admit"] is None:
                r["t_first_admit"] = t
        elif etype == "PREEMPT":
            r["preemptions"] += 1
            waiting[rid] = t
        elif etype == "PREFILL_CHUNK":
            r["prefill_chunks"] += 1
        elif etype == "FIRST_TOKEN":
            if r["t_first_token"] is None:
                r["t_first_token"] = t
        elif etype == "FINISH":
            r["t_finish"] = t
            r["n_out"] = arg if isinstance(arg, int) else r["n_out"]

    out: Dict[int, dict] = {}
    for rid, r in recs.items():
        t_arr = r["t_arrive"]
        row = {
            "rid": rid,
            "preemptions": r["preemptions"],
            "prefill_chunks": r["prefill_chunks"],
            "decode_stall_us": round(r["decode_stall_us"], 1),
            "finished": r["t_finish"] is not None,
            "n_out": r["n_out"],
        }
        if r["t_first_admit"] is not None:
            row["queue_wait_us"] = round((r["t_first_admit"] - t_arr) * 1e6, 1)
        if r["t_first_token"] is not None:
            ttft = (r["t_first_token"] - t_arr) * 1e6
            wait = min(r["wait_us"], ttft)
            row["ttft_us"] = round(ttft, 1)
            row["ttft_wait_us"] = round(wait, 1)
            row["ttft_prefill_us"] = round(ttft - wait, 1)
        if r["t_finish"] is not None:
            row["e2e_us"] = round((r["t_finish"] - t_arr) * 1e6, 1)
        out[rid] = row
    return out


def observe(per_req: Dict[int, dict]) -> None:
    """Fold reducer output into the live metric registry (the BENCH
    export then carries the derived distributions next to the engine's
    own aggregates)."""
    from repro_torch import obs
    for r in per_req.values():
        for field, metric in (("queue_wait_us", "serve.trace.queue_wait_us"),
                              ("ttft_wait_us", "serve.trace.ttft_wait_us"),
                              ("ttft_prefill_us",
                               "serve.trace.ttft_prefill_us"),
                              ("decode_stall_us",
                               "serve.trace.decode_stall_us")):
            if field in r:
                obs.histogram(metric).record(r[field])
        obs.histogram("serve.trace.preemptions").record(r["preemptions"])


def summary(per_req: Dict[int, dict]) -> dict:
    """Small comparable dict for BENCH ``meta`` blocks."""
    n = len(per_req)
    fin = [r for r in per_req.values() if r["finished"]]
    out = {"requests": n, "finished": len(fin),
           "preemptions": sum(r["preemptions"] for r in per_req.values())}

    def med(field):
        vs = sorted(r[field] for r in per_req.values() if field in r)
        return round(vs[len(vs) // 2], 1) if vs else None

    for field in ("queue_wait_us", "ttft_wait_us", "ttft_prefill_us",
                  "decode_stall_us"):
        v = med(field)
        if v is not None:
            out[f"{field[:-3]}_p50_us"] = v
    return out


# --------------------------------------------------------------------------
# Chrome-trace-event / Perfetto export.
# --------------------------------------------------------------------------

_PID_SERVE = 1
_PID_ROUTER = 2
_TID_QUEUE = 0                      # request queue track; slots are 1 + slot


def _meta(pid: int, tid: Optional[int], name: str, value: str,
          sort: Optional[int] = None) -> List[dict]:
    ev = {"ph": "M", "pid": pid, "name": name, "args": {"name": value}}
    if tid is not None:
        ev["tid"] = tid
    out = [ev]
    if sort is not None and tid is not None:
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_sort_index", "args": {"sort_index": sort}})
    return out


def perfetto(events: Iterable[Event], *,
             slots: Optional[int] = None) -> dict:
    """Render the event stream as a Chrome-trace-event document.

    Track layout: pid 1 ("repro.serve") has tid 0 = the admission queue
    and tid ``1+s`` = slot ``s``; pid 2 ("repro.router") carries
    ROUTE_MISS / PROFILE_SWAP instants on tid 0 and the online tuner's
    TUNE_CYCLE slices on its own tid 1 track (each cycle renders as a
    complete slice spanning its measured duration, so a miss burst on
    the route track lines up under the swap that caused it and the
    cycle that produced the swap).  Each request becomes a chain of
    complete ("X") slices — ``queued`` on the queue track, ``prefill`` /
    ``decode`` on the slot that ran it — linked by flow events
    (``s``/``t``/``f`` with ``id = rid``), so Perfetto draws the arrow
    from a preempted slice back through the queue to the resumed one:
    the preemption gap is the visible hole between them.
    """
    evs = sorted(events, key=lambda e: e[0])
    doc: dict = {"traceEvents": [], "displayTimeUnit": "ms"}
    te = doc["traceEvents"]
    if not evs:
        return doc
    t0 = evs[0][0]

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    max_slot = max((e[3] for e in evs), default=-1)
    if slots is not None:
        max_slot = max(max_slot, slots - 1)
    te.extend(_meta(_PID_SERVE, None, "process_name", "repro.serve"))
    te.extend(_meta(_PID_SERVE, _TID_QUEUE, "thread_name", "queue", sort=0))
    for s in range(max_slot + 1):
        te.extend(_meta(_PID_SERVE, 1 + s, "thread_name", f"slot {s}",
                        sort=1 + s))
    te.extend(_meta(_PID_ROUTER, None, "process_name", "repro.router"))
    te.extend(_meta(_PID_ROUTER, 0, "thread_name", "route/profile", sort=0))
    te.extend(_meta(_PID_ROUTER, 1, "thread_name", "online tuner", sort=1))

    # per-request open slice: (t_start, tid, phase_name)
    open_slice: Dict[int, Tuple[float, int, str]] = {}
    flown: Dict[int, bool] = {}     # rid -> a flow chain has started
    t_end = evs[-1][0]

    def close(rid: int, t: float, flow_out: bool) -> None:
        """Emit the open slice of ``rid`` ending at ``t`` (+ flow)."""
        sl = open_slice.pop(rid, None)
        if sl is None:
            return
        ts, tid, phase = sl
        te.append({"ph": "X", "pid": _PID_SERVE, "tid": tid,
                   "name": f"req {rid} {phase}", "cat": "request",
                   "ts": us(ts), "dur": max(us(t) - us(ts), 0.001),
                   "args": {"rid": rid}})
        mid = us(ts) + (us(t) - us(ts)) / 2
        if not flown.get(rid):
            te.append({"ph": "s", "pid": _PID_SERVE, "tid": tid,
                       "cat": "request", "name": f"req {rid}",
                       "id": rid, "ts": mid})
            flown[rid] = True
        else:
            te.append({"ph": "t" if flow_out else "f", "bp": "e",
                       "pid": _PID_SERVE, "tid": tid, "cat": "request",
                       "name": f"req {rid}", "id": rid, "ts": mid})

    def open_(rid: int, t: float, tid: int, phase: str) -> None:
        open_slice[rid] = (t, tid, phase)

    for t, etype, rid, slot, arg, dur in evs:
        if etype == "REQ_ARRIVE":
            open_(rid, t, _TID_QUEUE, "queued")
        elif etype in ("ADMIT", "RESUME"):
            close(rid, t, flow_out=True)
            open_(rid, t, 1 + slot, "prefill")
        elif etype == "FIRST_TOKEN":
            close(rid, t, flow_out=True)
            open_(rid, t, 1 + slot, "decode")
        elif etype == "PREEMPT":
            close(rid, t, flow_out=True)
            open_(rid, t, _TID_QUEUE, "queued (preempted)")
            te.append({"ph": "i", "pid": _PID_SERVE, "tid": 1 + slot,
                       "name": f"preempt req {rid}", "cat": "sched",
                       "ts": us(t), "s": "t"})
        elif etype == "FINISH":
            close(rid, t, flow_out=False)
        elif etype == "PREFILL_CHUNK" and dur:
            te.append({"ph": "X", "pid": _PID_SERVE, "tid": 1 + slot,
                       "name": "prefill_chunk", "cat": "chunk",
                       "ts": max(us(t) - round(dur, 3), 0.0),
                       "dur": round(dur, 3),
                       "args": {"rid": rid, "span": arg}})
        elif etype == "DECODE_TICK":
            te.append({"ph": "i", "pid": _PID_SERVE, "tid": _TID_QUEUE,
                       "name": "decode_tick", "cat": "sched",
                       "ts": us(t), "s": "p",
                       "args": {"tick": arg}})
        elif etype == "EVICT":
            te.append({"ph": "i", "pid": _PID_SERVE, "tid": _TID_QUEUE,
                       "name": f"evict req {rid}", "cat": "sched",
                       "ts": us(t), "s": "t", "args": {"blocks": arg}})
        elif etype == "ROUTE_MISS":
            te.append({"ph": "i", "pid": _PID_ROUTER, "tid": 0,
                       "name": "route_miss", "cat": "router",
                       "ts": us(t), "s": "t", "args": {"sig": arg}})
        elif etype == "PROFILE_SWAP":
            te.append({"ph": "i", "pid": _PID_ROUTER, "tid": 0,
                       "name": "profile_swap", "cat": "router",
                       "ts": us(t), "s": "p", "args": {"profile": arg}})
        elif etype == "TUNE_CYCLE":
            # emitted at cycle END with the cycle wall time; render the
            # slice backwards from t so it covers the work it timed
            if dur:
                te.append({"ph": "X", "pid": _PID_ROUTER, "tid": 1,
                           "name": "tune_cycle", "cat": "tuner",
                           "ts": max(us(t) - round(dur, 3), 0.0),
                           "dur": round(dur, 3), "args": {"cycle": arg}})
            else:
                te.append({"ph": "i", "pid": _PID_ROUTER, "tid": 1,
                           "name": "tune_cycle", "cat": "tuner",
                           "ts": us(t), "s": "t", "args": {"cycle": arg}})

    # close anything still open at the end of the capture window
    for rid in list(open_slice):
        close(rid, t_end, flow_out=False)
    return doc


def _events_to_json(events: List[Event]) -> list:
    if not events:
        return []
    t0 = events[0][0]
    return [[round((t - t0) * 1e6, 3), etype, rid, slot, arg, dur]
            for t, etype, rid, slot, arg, dur in events]


def _events_from_json(rows: list) -> List[Event]:
    return [(float(r[0]) * 1e-6, r[1], int(r[2]), int(r[3]), r[4],
             None if r[5] is None else float(r[5])) for r in rows]


def write_trace(path: os.PathLike, events: Optional[List[Event]] = None,
                *, slots: Optional[int] = None,
                log: Optional[EventLog] = None) -> pathlib.Path:
    """Write a self-contained trace file: a valid Chrome-trace-event
    JSON (open it in Perfetto / ``chrome://tracing`` as-is) that also
    embeds the raw ring under ``reproTrace`` so the CLI can re-derive
    the per-request metrics or re-export later.  ``events=None`` dumps
    the live :data:`TRACE` ring."""
    log = log if log is not None else TRACE
    if events is None:
        events = log.snapshot()
    # every part of the document from the events as the file keeps them
    # (µs rounded to 3 places): a re-export of the file is then the same
    # document, where durations taken from unrounded host clock readings
    # differed in their last place
    events = _events_from_json(_events_to_json(
        sorted(events, key=lambda e: e[0])))
    doc = perfetto(events, slots=slots)
    doc["reproTrace"] = {
        "schema": TRACE_SCHEMA_VERSION,
        "capacity": log.capacity,
        "dropped": log.dropped,
        "events": _events_to_json(events),
    }
    doc["otherData"] = {"per_request": sorted(
        per_request(events).values(), key=lambda r: r["rid"])}
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text(json.dumps(doc, sort_keys=True) + "\n")
    tmp.replace(p)
    return p


def load_events(path: os.PathLike) -> List[Event]:
    """Raw events back out of a :func:`write_trace` file."""
    doc = json.loads(pathlib.Path(path).read_text())
    raw = doc.get("reproTrace")
    if raw is None:
        raise ValueError(f"{path}: not a repro trace (no reproTrace key)")
    schema = int(raw.get("schema", -1))
    if schema != TRACE_SCHEMA_VERSION:
        raise ValueError(f"{path}: trace schema {schema} != supported "
                         f"{TRACE_SCHEMA_VERSION}")
    return _events_from_json(raw["events"])
