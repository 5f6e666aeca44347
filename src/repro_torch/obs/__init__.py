"""repro_torch.obs — process-local observability (counterpart of repro.obs).

A metric registry (:class:`Counter`, :class:`Gauge`, log-bucket
:class:`Histogram` with p50/p95/p99), the span recorder (:func:`span`,
:func:`capture`, :func:`spans`), device tallies (:func:`tally`,
:func:`tallies`: counts summed on the device, read once), the Router's
shape log and decision memo :data:`ROUTES` (with
:meth:`RouteLog.windowed`, the online tuner's feed),
and the flight recorder :data:`TRACE` (its reducer and Perfetto export in
:mod:`.trace`).  ``python -m repro_torch.obs`` prints the live registry
and re-exports a trace.

Spans record only inside a *capture*: while ``torch.profiler`` runs, or
inside ``with obs.capture():``.  Outside one a span costs one flag check.
Inside one each span appends a record (name, start and end on
``time.perf_counter_ns``, its parent's index, an optional request id and
attributes, optionally its device time) to a bounded buffer, and, while
the profiler runs, opens a ``record_function`` of its name, so that it
shows beside the kernels it launched in the profiler's trace.

``REPRO_OBS=0`` disables everything: metric helpers hand out a shared
null object, spans never record, and the route log is bypassed with one
attribute check.
"""
from __future__ import annotations

import collections as _collections
import math
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY", "ROUTES",
    "TRACE", "counter", "gauge", "histogram", "span", "capture",
    "capturing", "mark", "spans", "span_drops", "SpanRecord", "tally",
    "tallies", "enabled",
    "set_enabled", "report_str", "reset",
]

# bucket i covers [BASE**i, BASE**(i+1)); worst-case percentile error
# sqrt(BASE) - 1 ~ 4.4%
_BASE = 2.0 ** 0.125
_LOG_BASE = math.log(_BASE)


def _env_enabled(value: Optional[str]) -> bool:
    """``REPRO_OBS`` parse: only explicit off values disable."""
    return (value or "1").strip().lower() not in ("0", "false", "off", "no")


_ENABLED = _env_enabled(os.environ.get("REPRO_OBS"))


def enabled() -> bool:
    """Whether observability is collecting (the ``REPRO_OBS`` switch)."""
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Programmatic kill switch: flips the registry, the route log, the
    flight recorder and spans together (``TRACE.set_enabled`` toggles the
    recorder alone)."""
    global _ENABLED
    _ENABLED = bool(on)
    ROUTES.on = _ENABLED
    TRACE.on = _ENABLED


# --------------------------------------------------------------------------
# Metrics.
# --------------------------------------------------------------------------

class Counter:
    """Monotonic event count."""
    kind = "counter"
    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0

    def inc(self, k: int = 1) -> None:
        self.n += k

    @property
    def value(self) -> int:
        return self.n

    def to_json(self) -> dict:
        return {"type": "counter", "value": self.n}


class Gauge:
    """Last-write-wins instantaneous value."""
    kind = "gauge"
    __slots__ = ("v",)

    def __init__(self) -> None:
        self.v = 0.0

    def set(self, v: float) -> None:
        self.v = float(v)

    @property
    def value(self) -> float:
        return self.v

    def to_json(self) -> dict:
        return {"type": "gauge", "value": self.v}


class Histogram:
    """Log-bucketed distribution with exact count/sum/min/max;
    non-positive samples land in a zero bucket."""
    kind = "histogram"
    __slots__ = ("buckets", "zeros", "n", "total", "vmin", "vmax")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.zeros = 0
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, v: float) -> None:
        v = float(v)
        self.n += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if v <= 0.0:
            self.zeros += 1
            return
        i = int(math.floor(math.log(v) / _LOG_BASE))
        self.buckets[i] = self.buckets.get(i, 0) + 1

    @property
    def count(self) -> int:
        return self.n

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def percentile(self, q: float) -> float:
        """Value at percentile ``q`` in [0, 100], to bucket resolution;
        q<=0 and q>=100 return the exact observed extremes."""
        if self.n == 0:
            return 0.0
        if q <= 0.0:
            return self.vmin
        if q >= 100.0:
            return self.vmax
        rank = max(1, math.ceil(q / 100.0 * self.n))
        seen = self.zeros
        if rank <= seen:
            return 0.0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if rank <= seen:
                return min(max(_BASE ** (i + 0.5), self.vmin), self.vmax)
        return self.vmax

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    def to_json(self) -> dict:
        return {"type": "histogram", "count": self.n,
                "sum": self.total, "mean": self.mean,
                "min": self.vmin if self.n else 0.0,
                "max": self.vmax if self.n else 0.0,
                "p50": self.p50, "p95": self.p95, "p99": self.p99}


class _Null:
    """Shared no-op metric handed out when observability is disabled."""
    kind = "null"
    __slots__ = ()
    n = 0
    v = 0.0
    value = 0
    count = 0
    total = 0.0
    mean = 0.0
    p50 = p95 = p99 = 0.0

    def inc(self, k: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def record(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def to_json(self) -> dict:
        return {"type": "null"}


_NULL = _Null()


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Registry:
    """Process-local metric store: one object per (name, labels)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: Dict[str, Any]):
        if not _ENABLED:
            return _NULL
        key = _key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(key, cls())
        if not isinstance(m, cls):
            raise TypeError(f"metric {key!r} is a {m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def get(self, name: str, **labels):
        """Lookup without creating; None when never recorded."""
        return self._metrics.get(_key(name, labels))

    def collect(self, prefix: str = "") -> Dict[str, Any]:
        return {k: m for k, m in sorted(self._metrics.items())
                if k.startswith(prefix)}

    def snapshot(self) -> Dict[str, dict]:
        return {k: m.to_json() for k, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


REGISTRY = Registry()


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return REGISTRY.histogram(name, **labels)


def reset() -> None:
    """Clear every metric, the route log, the span buffer, the device
    tallies AND the flight recorder."""
    REGISTRY.reset()
    ROUTES.reset()
    _REC.reset()
    _TALLIES.clear()
    TRACE.reset()


# --------------------------------------------------------------------------
# Spans.
# --------------------------------------------------------------------------

#: open ``capture()`` blocks
_CAPTURES = 0


class SpanRecord(NamedTuple):
    """One recorded span.  ``parent`` is the index in :func:`spans` of the
    span open around it on its thread (-1: none, or dropped); ``t1_ns`` is
    None while it is open; ``device_ms`` is the time the current CUDA
    stream took between its edges (``span(..., device=True)`` on a CUDA
    device), else None."""
    name: str
    t0_ns: int
    t1_ns: Optional[int]
    parent: int
    rid: Optional[int]
    attrs: Optional[Dict[str, Any]]
    device_ms: Optional[float]


class _Recorder:
    """The bounded span buffer: past ``CAP`` records it counts drops and
    overwrites nothing."""
    CAP = 1 << 17

    def __init__(self) -> None:
        self.buf: List[list] = []
        self.drops = 0
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> List[int]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add(self, rec: list) -> int:
        with self.lock:
            if len(self.buf) >= self.CAP:
                self.drops += 1
                return -1
            self.buf.append(rec)
            return len(self.buf) - 1

    def reset(self) -> None:
        with self.lock:
            self.buf = []
            self.drops = 0


_REC = _Recorder()


def capturing() -> bool:
    """Whether spans record now: inside :func:`capture` or while
    ``torch.profiler`` runs, with observability on."""
    return bool((_CAPTURES or _profiler._is_profiler_enabled) and _ENABLED)


class capture:
    """``with obs.capture(): ...`` records spans with no profiler running
    (the records stay in the buffer until :func:`reset`)."""

    def __enter__(self) -> "capture":
        global _CAPTURES
        _CAPTURES += 1
        return self

    def __exit__(self, *exc) -> None:
        global _CAPTURES
        _CAPTURES -= 1


class _NullSpan:
    """What :func:`span` hands out outside a capture: records nothing."""
    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    """A span inside a capture (see :func:`span`)."""
    __slots__ = ("rec", "_device", "_ranged", "_rf", "_events")

    def __init__(self, name: str, rid, device: bool, ranged: bool,
                 attrs) -> None:
        self.rec = [name, 0, None, -1, rid, attrs or None, None]
        self._device, self._ranged = device, ranged
        self._rf = None
        self._events = None

    @property
    def t0_ns(self) -> int:
        return self.rec[1]

    def set(self, **attrs) -> None:
        """Add attributes to the record (one known only once it opened)."""
        if self.rec[5] is None:
            self.rec[5] = {}
        self.rec[5].update(attrs)

    def __enter__(self) -> "_Span":
        st = _REC.stack()
        self.rec[3] = st[-1] if st else -1
        st.append(_REC.add(self.rec))
        if self._ranged and _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.rec[0])
            self._rf.__enter__()
        if self._device and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = self.rec[6] = [start, None]
        self.rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.rec[2] = time.perf_counter_ns()
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events[1] = end
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _REC.stack().pop()


def span(name: str, rid: Optional[int] = None, device: bool = False,
         ranged: bool = True, **attrs):
    """A host section: ``with obs.span("serve.prefill", rid=7): ...``.

    Outside a capture it is a shared no-op (one flag check: no clock, no
    ``record_function``, no record).  Inside one it records its name, its
    start and end, its parent span, ``rid`` and ``attrs`` (more can be
    added once it is open: ``with obs.span(...) as sp: if sp:
    sp.set(k=v)``); ``device=True`` also records a CUDA event pair on the
    current stream at its edges, read back by :func:`spans`.  While the
    profiler runs it opens a ``record_function`` of its name, unless
    ``ranged=False``: for sections tens of times a model call (a layer's
    halves, its syncs), where the profiler's ranges would cost the step
    several percent.
    """
    if not ((_CAPTURES or _profiler._is_profiler_enabled) and _ENABLED):
        return _NULL_SPAN
    return _Span(name, rid, device, ranged, attrs)


def mark(name: str, t0_ns: int) -> None:
    """A cheap record from ``t0_ns`` to now under the innermost open span,
    with no profiler range: for sections too frequent for a
    ``record_function`` each.  Call it only where :func:`capturing` held
    when ``t0_ns`` was read."""
    t1 = time.perf_counter_ns()
    st = _REC.stack()
    _REC.add([name, t0_ns, t1, st[-1] if st else -1, None, None, None])


def _resolve(rec: list) -> Optional[float]:
    ev = rec[6]
    if ev is None or isinstance(ev, float):
        return ev
    if ev[1] is None:
        return None                      # still open
    ev[1].synchronize()
    rec[6] = float(ev[0].elapsed_time(ev[1]))
    return rec[6]


def spans() -> List[SpanRecord]:
    """Every record in the buffer, in the order the spans opened (cheap
    records where they closed); device times are read back here, which
    may wait for the device."""
    with _REC.lock:
        buf = list(_REC.buf)
    out = []
    for rec in buf:
        dev = _resolve(rec)
        out.append(SpanRecord(rec[0], rec[1], rec[2], rec[3], rec[4],
                              dict(rec[5]) if rec[5] else None, dev))
    return out


def span_drops() -> int:
    """Records the full buffer refused since the last :func:`reset`."""
    return _REC.drops


# --------------------------------------------------------------------------
# Device tallies: counts a step computes on the device, summed there.
# --------------------------------------------------------------------------

class _Tally:
    __slots__ = ("fields", "sums", "calls")

    def __init__(self, fields: Tuple[str, ...], sums: torch.Tensor) -> None:
        self.fields, self.sums, self.calls = fields, sums, 0


_TALLIES: Dict[str, _Tally] = {}


def tally(name: str, fields: Tuple[str, ...], values: torch.Tensor) -> None:
    """Add ``values`` (one integer a field, on the device the step runs
    on) into the tally ``name``: one device add, never a read, so a step
    that tallies waits for nothing.  Call it where :func:`capturing`
    holds: a tally then covers the captured steps (the traced slice)."""
    t = _TALLIES.get(name)
    if t is None:
        t = _TALLIES[name] = _Tally(fields, torch.zeros(
            len(fields), dtype=torch.int64, device=values.device))
    t.sums.add_(values)
    t.calls += 1


def tallies() -> Dict[str, Dict[str, int]]:
    """Each tally by field, with its number of calls under ``calls``:
    one copy to the host a tally, which waits for the device."""
    return {name: dict(zip(t.fields, t.sums.tolist()), calls=t.calls)
            for name, t in list(_TALLIES.items())}


# --------------------------------------------------------------------------
# The Router shape log (and decision memo).
# --------------------------------------------------------------------------

def _bucket_index(x: int) -> int:
    """Geometric size class of ``x >= 1`` (growth 2): the bucket
    [2**i, 2**(i+1)) holding it (``repro.tune.classes.bucket_index``)."""
    return max(1, int(x)).bit_length() - 1


class RouteLog:
    """Every ``Router.route`` decision, keyed by the full call signature.

    A live entry is ``key -> [count, policy, gen, decision]`` with
    ``key = (op, letter, trans, dims, id(policy))``.  The entry holds the
    policy, so the ``is`` check on a hit cannot alias a recycled ``id()``;
    ``gen`` is bumped by :meth:`reset`, which stales every memoized
    decision.  Past ``CAP`` distinct keys the live entries fold into the
    aggregate histogram and the memo restarts (counts are never lost).
    Only the memo-hit increment is lock-free; ``note``, compaction,
    snapshots and reset take the lock.
    """
    CAP = 32768
    #: windowed() bucket width (seconds) and retention
    WINDOW_S = 1.0
    MAX_WINDOW_BUCKETS = 64

    def __init__(self) -> None:
        self.on = _ENABLED
        self.gen = 0
        self.hits: Dict[tuple, list] = {}
        self._agg: Dict[tuple, int] = {}
        self._lock = threading.Lock()
        # windowed() state: closed buckets (t_start, t_end, counts)
        # newest-first, and the cumulative counts at the last close
        self._win = _collections.deque(maxlen=self.MAX_WINDOW_BUCKETS)
        self._win_prev: Dict[tuple, int] = {}
        self._win_t: Optional[float] = None

    def note(self, key: tuple, pol, decision) -> None:
        """First sighting of ``key``: memoize the decision, count = 1."""
        with self._lock:
            self.hits[key] = [1, pol, self.gen, decision]
            if len(self.hits) > self.CAP:
                self._compact_locked()

    @staticmethod
    def _agg_key(key: tuple, d) -> tuple:
        op, letter, trans, dims = key[0], key[1], key[2], key[3]
        if op == "matmul":
            m = 1
            for x in dims[:-2]:
                m *= int(x)
            mnk = (m, int(dims[-1]), int(dims[-2]))
        elif op in ("batched_gemm", "ragged_gemm"):
            # per-group problem (C, N, K) — the unit the Router priced
            mnk = (int(dims[1]), int(dims[3]), int(dims[2]))
        else:
            mnk = (int(dims[0]), int(dims[1]), int(dims[2]))
        cls = "-".join(str(_bucket_index(x)) for x in mnk)
        return (op, letter, trans, cls, d.use_kernel, d.source)

    def _compact_locked(self) -> None:
        for key, h in self.hits.items():
            ak = self._agg_key(key, h[3])
            self._agg[ak] = self._agg.get(ak, 0) + h[0]
        self.hits.clear()

    def histogram(self) -> Dict[tuple, int]:
        """(op, dtype, trans, size-class, use_kernel, source) -> calls."""
        with self._lock:
            out = dict(self._agg)
            live = list(self.hits.items())
        for key, h in live:
            ak = self._agg_key(key, h[3])
            out[ak] = out.get(ak, 0) + h[0]
        return out

    def shape_counts(self) -> Dict[Tuple[str, str, str], int]:
        """Counts per (op, dtype, size-class)."""
        out: Dict[Tuple[str, str, str], int] = {}
        for (op, letter, _tr, cls, *_rest), n in self.histogram().items():
            k = (op, letter, cls)
            out[k] = out.get(k, 0) + n
        return out

    def windowed(self, n_buckets: int = 8, *,
                 bucket_s: Optional[float] = None,
                 decay: Optional[float] = None,
                 now: Optional[float] = None):
        """Time-bucketed :meth:`shape_counts`, the online tuner's feed.

        Buckets are closed at observation time: each call diffs the
        cumulative counts against the snapshot taken at the last close,
        so recording adds nothing to the memo-hit path.  A caller polling
        every ``bucket_s`` seconds gets fixed-width buckets; a slower one
        gets one bucket spanning the gap.  The port's Router counts every
        executed call (the reference counts trace-time calls), so these
        are execution counts.

        Returns newest-first ``[open, closed_1, ...]`` (up to
        ``n_buckets``), each ``(op, dtype, size-class) -> n``; with
        ``decay`` in (0, 1], one dict of weights with bucket *i* weighted
        ``decay**i``.  ``now`` injects a clock for tests.
        """
        if n_buckets < 1:
            raise ValueError("n_buckets must be >= 1")
        width = bucket_s or self.WINDOW_S
        t = time.monotonic() if now is None else now
        cur = self.shape_counts()
        with self._lock:
            if self._win_t is None:
                self._win_t = t
            elif t - self._win_t >= width:
                delta = {k: cur[k] - self._win_prev.get(k, 0)
                         for k in cur
                         if cur[k] > self._win_prev.get(k, 0)}
                self._win.appendleft((self._win_t, t, delta))
                self._win_prev = cur
                self._win_t = t
            open_bucket = {k: cur[k] - self._win_prev.get(k, 0)
                           for k in cur
                           if cur[k] > self._win_prev.get(k, 0)}
            buckets = [open_bucket] + [c for (_a, _b, c) in
                                       list(self._win)[:n_buckets - 1]]
        if decay is None:
            return buckets
        if not 0.0 < decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")
        folded: Dict[Tuple[str, str, str], float] = {}
        for i, counts in enumerate(buckets):
            w = decay ** i
            for k, n in counts.items():
                folded[k] = folded.get(k, 0.0) + w * n
        return folded

    def snapshot(self) -> List[dict]:
        """Rows of the histogram, most-routed first."""
        return [{"op": op, "dtype": letter, "trans": trans,
                 "size_class": cls, "use_kernel": kernel, "source": source,
                 "count": n}
                for (op, letter, trans, cls, kernel, source), n in sorted(
                    self.histogram().items(),
                    key=lambda kv: (-kv[1], kv[0]))]

    def kernel_share(self) -> Tuple[int, int]:
        """(routed to the kernel, routed in all) over every route() call."""
        hist = self.histogram()
        return (sum(n for k, n in hist.items() if k[4]),
                sum(hist.values()))

    @property
    def total(self) -> int:
        return sum(self.histogram().values())

    def reset(self) -> None:
        with self._lock:
            self.hits.clear()
            self._agg.clear()
            self._win.clear()
            self._win_prev = {}
            self._win_t = None
            self.gen += 1

    def invalidate(self) -> None:
        """The active tuning profile changed: stale every memoized
        decision.  The live counts fold into the aggregate first, so they
        survive; the next route of each key recomputes and re-memoizes."""
        with self._lock:
            self._compact_locked()
            self.gen += 1


ROUTES = RouteLog()

from repro_torch.obs import trace  # noqa: E402

#: The process-global per-request event ring (see :mod:`.trace`).
TRACE = trace.TRACE
TRACE.on = TRACE.on and _ENABLED


def report_str() -> str:
    """Human-readable dump of the live registry and route histogram."""
    lines = ["== repro_torch.obs report =="]
    metrics = REGISTRY.collect()
    if not metrics and not ROUTES.total:
        lines.append("(empty — nothing recorded, or REPRO_OBS=0)")
    for key, m in metrics.items():
        if m.kind == "counter":
            lines.append(f"  {key:<44s} {m.value}")
        elif m.kind == "gauge":
            lines.append(f"  {key:<44s} {m.value:.6g}")
        else:
            lines.append(
                f"  {key:<44s} n={m.count} mean={m.mean:.1f} "
                f"p50={m.p50:.1f} p95={m.p95:.1f} p99={m.p99:.1f}")
    rows = ROUTES.snapshot()
    if rows:
        lines.append(f"  -- router shape histogram "
                     f"({ROUTES.total} decisions) --")
        for r in rows[:20]:
            lines.append(
                f"  {r['op']:<13s} {r['dtype']}/{r['trans']} "
                f"class={r['size_class']:<10s} "
                f"{'kernel' if r['use_kernel'] else 'library':<7s} "
                f"{r['source']:<10s} x{r['count']}")
        if len(rows) > 20:
            lines.append(f"  ... {len(rows) - 20} more rows")
    return "\n".join(lines)
