"""repro_torch.obs — process-local observability (counterpart of repro.obs).

A metric registry (:class:`Counter`, :class:`Gauge`, log-bucket
:class:`Histogram` with p50/p95/p99), :func:`span` wall-clock sections
(each also opens a ``torch.profiler.record_function`` so host sections
line up with device kernels in a profiler trace), the Router's shape log
and decision memo :data:`ROUTES` (with :meth:`RouteLog.windowed`, the
online tuner's feed), the flight recorder :data:`TRACE` (its reducer and
Perfetto export in :mod:`.trace`), and :func:`export_bench`, which writes
a schema'd ``BENCH_<name>.json`` under :func:`bench_root` —
``build/repro_torch/bench/`` in the checkout, never the repository root.
``python -m repro_torch.obs`` lists, shows and diffs those files and
re-exports a trace.

``REPRO_OBS=0`` disables everything: metric helpers hand out a shared
null object, :func:`span` skips the clock, and the route log is bypassed
with one attribute check.
"""
from __future__ import annotations

import collections as _collections
import json
import math
import os
import pathlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY", "ROUTES",
    "TRACE", "counter", "gauge", "histogram", "span", "enabled",
    "set_enabled", "export_bench", "load_bench", "diff_bench",
    "report_str", "reset", "bench_root", "record_trajectory",
    "BENCH_SCHEMA_VERSION",
]

BENCH_SCHEMA_VERSION = 1
#: where BENCH files land when set (``bench_root``)
BENCH_DIR_ENV = "REPRO_TORCH_BENCH_DIR"

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


# --------------------------------------------------------------------------
# BENCH_<name>.json export.
# --------------------------------------------------------------------------

def bench_root() -> pathlib.Path:
    """Where BENCH files land: ``$REPRO_TORCH_BENCH_DIR``, else
    ``build/repro_torch/bench/`` in the checkout (the repository root
    holds the reference's own BENCH files)."""
    env = os.environ.get(BENCH_DIR_ENV)
    if env:
        return pathlib.Path(env).expanduser()
    return pathlib.Path(__file__).resolve().parents[3] / "build" / \
        "repro_torch" / "bench"


def _write_json(out: pathlib.Path, doc: dict) -> None:
    tmp = out.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    tmp.replace(out)        # atomic: a reader never sees a torn file


def export_bench(name: str, meta: Optional[dict] = None, *,
                 root: Optional[os.PathLike] = None) -> pathlib.Path:
    """Write the live registry and route log as ``BENCH_<name>.json``
    (schema-versioned, sorted keys; ``python -m repro_torch.obs diff``
    compares two).  An existing file's ``trajectory`` list is kept."""
    doc = {
        "bench": name,
        "schema": BENCH_SCHEMA_VERSION,
        "created_unix": time.time(),
        "meta": dict(meta or {}),
        "metrics": REGISTRY.snapshot(),
        "router": ROUTES.snapshot(),
    }
    path = pathlib.Path(root) if root else bench_root()
    path.mkdir(parents=True, exist_ok=True)
    out = path / f"BENCH_{name}.json"
    if out.exists():
        try:
            prev = json.loads(out.read_text()).get("trajectory")
            if prev:
                doc["trajectory"] = prev
        except (OSError, ValueError):
            pass        # a corrupt old file is overwritten
    _write_json(out, doc)
    return out


def record_trajectory(name: str, entry: dict, *,
                      root: Optional[os.PathLike] = None) -> pathlib.Path:
    """Append one row (stamped with the time and, where git answers, the
    commit) to ``BENCH_<name>.json``'s ``trajectory``, creating a
    skeleton document if there is none."""
    path = pathlib.Path(root) if root else bench_root()
    path.mkdir(parents=True, exist_ok=True)
    out = path / f"BENCH_{name}.json"
    try:
        doc = json.loads(out.read_text())
    except (OSError, ValueError):
        doc = {"bench": name, "schema": BENCH_SCHEMA_VERSION,
               "created_unix": time.time(), "meta": {}, "metrics": {},
               "router": []}
    row = {"recorded_unix": time.time()}
    commit = _git_head()
    if commit:
        row["commit"] = commit
    row.update(entry)
    doc.setdefault("trajectory", []).append(row)
    _write_json(out, doc)
    return out


_GIT_HEAD_CACHE: Optional[Tuple[Optional[str]]] = None


def _git_head() -> Optional[str]:
    """Short commit hash of the checkout holding this file, or None
    (memoized per process)."""
    global _GIT_HEAD_CACHE
    if _GIT_HEAD_CACHE is None:
        import subprocess
        try:
            head = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=pathlib.Path(__file__).resolve().parent, timeout=5,
                capture_output=True, text=True, check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            head = None
        _GIT_HEAD_CACHE = (head or None,)
    return _GIT_HEAD_CACHE[0]


def load_bench(path: os.PathLike) -> dict:
    doc = json.loads(pathlib.Path(path).read_text())
    schema = int(doc.get("schema", -1))
    if schema != BENCH_SCHEMA_VERSION:
        raise ValueError(f"{path}: BENCH schema {schema} != supported "
                         f"{BENCH_SCHEMA_VERSION}")
    return doc


def _scalar_metrics(doc: dict) -> Dict[str, float]:
    """A BENCH doc flattened to comparable scalars (counter and gauge
    values, histogram count/mean/p50/p95/p99)."""
    out: Dict[str, float] = {}
    for key, m in doc.get("metrics", {}).items():
        t = m.get("type")
        if t in ("counter", "gauge"):
            out[key] = float(m["value"])
        elif t == "histogram":
            for f in ("count", "mean", "p50", "p95", "p99"):
                out[f"{key}.{f}"] = float(m[f])
    return out


def diff_bench(a: dict, b: dict) -> List[Tuple[str, Optional[float],
                                               Optional[float],
                                               Optional[float]]]:
    """Rows of (metric, old, new, pct_change); None marks one-sided keys."""
    am, bm = _scalar_metrics(a), _scalar_metrics(b)
    rows: List[Tuple[str, Optional[float], Optional[float],
                     Optional[float]]] = []
    for key in sorted(set(am) | set(bm)):
        old, new = am.get(key), bm.get(key)
        pct = None
        if old is not None and new is not None and old != 0:
            pct = (new - old) / abs(old) * 100.0
        rows.append((key, old, new, pct))
    return rows


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
