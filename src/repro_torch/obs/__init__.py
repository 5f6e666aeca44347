"""repro_torch.obs — process-local observability (counterpart of repro.obs).

The parts serving and the Router touch: a metric registry
(:class:`Counter`, :class:`Gauge`, log-bucket :class:`Histogram` with
p50/p95/p99), :func:`span` wall-clock sections (each also opens a
``torch.profiler.record_function`` so host sections line up with device
kernels in a profiler trace), the Router's shape log and decision memo
:data:`ROUTES`, and the flight recorder :data:`TRACE`.  ``BENCH_*``
export, the trace reducer and the Perfetto export are not ported yet.

``REPRO_OBS=0`` disables everything: metric helpers hand out a shared
null object, :func:`span` skips the clock, and the route log is bypassed
with one attribute check.
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY", "ROUTES",
    "TRACE", "counter", "gauge", "histogram", "span", "reset",
]

# bucket i covers [BASE**i, BASE**(i+1)); worst-case percentile error
# sqrt(BASE) - 1 ~ 4.4%
_BASE = 2.0 ** 0.125
_LOG_BASE = math.log(_BASE)


def _env_enabled(value: Optional[str]) -> bool:
    """``REPRO_OBS`` parse: only explicit off values disable."""
    return (value or "1").strip().lower() not in ("0", "false", "off", "no")


_ENABLED = _env_enabled(os.environ.get("REPRO_OBS"))


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
    """Clear every metric, the route log AND the flight recorder."""
    REGISTRY.reset()
    ROUTES.reset()
    TRACE.reset()


# --------------------------------------------------------------------------
# Spans.
# --------------------------------------------------------------------------

_span_stack = threading.local()


class span:
    """Wall-clock section: ``with span("serve.prefill"): ...``

    Nested spans record under their dotted path (``span.b.a_us``).  Each
    span also opens ``torch.profiler.record_function`` (the counterpart of
    ``jax.profiler.TraceAnnotation``): nearly free when no profiler runs,
    and the host section shows beside the device kernels when one does.
    """
    __slots__ = ("name", "_t0", "_path", "_rf")

    def __init__(self, name: str) -> None:
        self.name = name
        self._t0 = 0.0
        self._path = ""
        self._rf = None

    def __enter__(self) -> "span":
        if not _ENABLED:
            return self
        import torch
        stack = getattr(_span_stack, "names", None)
        if stack is None:
            stack = _span_stack.names = []
        stack.append(self.name)
        self._path = ".".join(stack)
        self._rf = torch.profiler.record_function(self._path)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if not self._path:
            return
        dt_us = (time.perf_counter() - self._t0) * 1e6
        self._rf.__exit__(*exc)
        self._rf = None
        stack = _span_stack.names
        if stack and stack[-1] == self.name:
            stack.pop()
        REGISTRY.histogram(f"span.{self._path}_us").record(dt_us)
        self._path = ""


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

    def __init__(self) -> None:
        self.on = _ENABLED
        self.gen = 0
        self.hits: Dict[tuple, list] = {}
        self._agg: Dict[tuple, int] = {}
        self._lock = threading.Lock()

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
