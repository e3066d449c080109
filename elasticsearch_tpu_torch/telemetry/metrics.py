"""Node-local metrics registry: counters, gauges, fixed-bucket
histograms.

The engine's analogue of the reference's stats surfaces (ref:
`_nodes/stats` backed by NodeService.stats() aggregating per-service
counters; ThreadPool/TransportService/SearchService each keep their
own). Redesigned as one injectable registry instead of scattered
per-service fields:

- every metric is get-or-create by ``(name, labels)`` so call sites
  never pre-register;
- the **clock is injectable** (``clock=scheduler.now``), so timers read
  virtual time under ``DeterministicTaskQueue`` and the whole registry
  is replayable from a seed;
- histograms use FIXED bucket boundaries (no t-digest state), so two
  runs that observe the same values report identical bucket counts;
- ``to_dict()`` renders the `_nodes/stats` ``telemetry`` section.

Hot-path contract: components hold ``self.telemetry`` (default None)
and guard every call site with one ``is not None`` branch — the same
pattern as ``profile.active()`` — so an un-wired node pays a single
branch per instrumented site.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

# default latency buckets, in milliseconds (upper bounds; +inf implied).
# The sub-millisecond decades exist for DEVICE stages: on a fast query,
# launch/readback/topk land in the 1-500µs range, and without them every
# `search.stage.*` observation collapsed into the lowest ms bucket —
# making the histograms blind exactly where the device path is fastest.
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05,
    0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0,
    1000.0, 5000.0, 10000.0, 30000.0)

LabelKey = Tuple[Tuple[str, str], ...]


class Counter:
    """Monotonic counter (floats allowed: e.g. backoff seconds).
    Writes are locked: increments arrive from transport-executor and
    REST threads concurrently, and ``+=`` is not atomic."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def to_dict(self) -> Dict[str, Any]:
        v = self.value
        return {"type": "counter",
                "value": int(v) if float(v).is_integer() else v}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def to_dict(self) -> Dict[str, Any]:
        v = self.value
        return {"type": "gauge",
                "value": int(v) if float(v).is_integer() else v}


def _ambient_trace_id() -> Optional[str]:
    """The ambient trace id (telemetry/context.py), read straight off
    that module's thread-local (resolved lazily to avoid the
    package-import cycle): the untraced cost is one getattr returning
    None — the same cost model as ``profile.active()``."""
    global _ctx_tls
    tls = _ctx_tls
    if tls is None:
        try:
            from elasticsearch_tpu_torch.telemetry import context as _c
        except ImportError:     # mid-package-import edge
            return None
        tls = _ctx_tls = _c._tls
    ctx = getattr(tls, "ctx", None)
    return ctx.trace_id if ctx is not None else None


_ctx_tls = None


class Histogram:
    """Fixed-boundary histogram with count/sum/min/max. Boundaries are
    upper bounds; one overflow bucket catches the tail. ``counts``
    holds DISJOINT per-bucket tallies internally; ``to_dict`` serializes
    them CUMULATIVELY under Prometheus-style ``le_*`` names (so
    ``le_inf`` always equals ``count``). Observations are locked so
    count/sum/buckets stay mutually consistent under concurrent
    writers.

    **Exemplars**: every bucket keeps ONE bounded slot — the last
    (value, trace.id) observed under an ambient trace context
    (OpenMetrics exemplar semantics, last-write-wins: deterministic
    under the seeded scheduler). A p99 spike in `_nodes/stats` then
    navigates to a concrete traced+profiled request via
    ``GET /_traces?exemplar_for=<metric>``. The slots array allocates
    lazily on the first traced observation; an un-traced observation
    pays one thread-local getattr."""

    __slots__ = ("buckets", "counts", "count", "sum", "min", "max",
                 "exemplars", "_lock", "_cum_cache", "renders")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS_MS):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        # per-bucket (value, trace_id) slot; None until the first
        # observation that has an ambient trace
        self.exemplars: Optional[List[Optional[Tuple[float, str]]]] = None
        self._lock = threading.Lock()
        # cached cumulative `le_*` render, invalidated by observe();
        # `renders` counts full recomputes so tests can pin that a
        # stats poll against a quiet histogram is O(1), not O(buckets)
        self._cum_cache: Optional[Dict[str, int]] = None
        self.renders = 0

    def observe(self, v: float) -> None:
        trace_id = _ambient_trace_id()
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            idx = len(self.buckets)
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    idx = i
                    break
            self.counts[idx] += 1
            self._cum_cache = None
            if trace_id is not None:
                if self.exemplars is None:
                    self.exemplars = [None] * (len(self.buckets) + 1)
                self.exemplars[idx] = (v, trace_id)

    def _bucket_label(self, idx: int) -> str:
        return (f"le_{self.buckets[idx]:g}"
                if idx < len(self.buckets) else "le_inf")

    def exemplar_list(self) -> List[Dict[str, Any]]:
        """Non-empty exemplar slots as dicts (highest bucket first —
        the tail latency one navigates to first)."""
        with self._lock:
            slots = list(self.exemplars) if self.exemplars else []
        out = []
        for idx in range(len(slots) - 1, -1, -1):
            slot = slots[idx]
            if slot is not None:
                out.append({"bucket": self._bucket_label(idx),
                            "value": slot[0], "trace_id": slot[1]})
        return out

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            cum = self._cum_cache
            if cum is None:
                cum = {}
                acc = 0
                for b, c in zip(self.buckets, self.counts[:-1]):
                    acc += c
                    cum[f"le_{b:g}"] = acc
                cum["le_inf"] = acc + self.counts[-1]
                self._cum_cache = cum
                self.renders += 1
        out = {"type": "histogram", "count": self.count, "sum": self.sum,
               "min": self.min, "max": self.max, "buckets": dict(cum)}
        if self.exemplars is not None:
            out["exemplars"] = {
                self._bucket_label(i): {"value": s[0], "trace_id": s[1]}
                for i, s in enumerate(self.exemplars) if s is not None}
        return out


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create registry keyed by (name, labels); thread-safe.

    ``clock`` is a zero-arg seconds function (``time.monotonic`` by
    default, a Scheduler's ``now`` under the deterministic harness).
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelKey], Any] = {}

    # -- get-or-create ----------------------------------------------------

    def _get(self, name: str, factory: Callable[[], Any],
             labels: Dict[str, Any]):
        key = (name, _label_key(labels))
        # the hot path: an existing series, read without the lock (a dict
        # read is atomic; creation below stays locked)
        m = self._metrics.get(key)
        if m is not None:
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = factory()
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, Counter, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, Gauge, labels)

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS_MS,
                  **labels) -> Histogram:
        return self._get(name, lambda: Histogram(buckets), labels)

    # -- convenience ------------------------------------------------------

    def inc(self, name: str, n: float = 1.0, **labels) -> None:
        self.counter(name, **labels).inc(n)

    def set_gauge(self, name: str, v: float, **labels) -> None:
        self.gauge(name, **labels).set(v)

    def observe(self, name: str, v: float, **labels) -> None:
        self.histogram(name, **labels).observe(v)

    @contextmanager
    def timer(self, name: str, **labels):
        """Time a block into a latency histogram (milliseconds), on the
        injected clock."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.observe(name, (self.clock() - t0) * 1000.0, **labels)

    # -- cardinality control ----------------------------------------------

    def prune_label(self, label: str, value: str) -> int:
        """Drop every series (counter, gauge, histogram — exemplar
        slots die with the histogram) whose labels carry
        ``label=value``; returns the number of series removed. The seam
        TenantAccounting's LRU eviction uses so a tenant churn storm
        cannot grow the registry (or `_nodes/stats` renders of it)
        without bound."""
        pair = (label, str(value))
        with self._lock:
            doomed = [k for k in self._metrics if pair in k[1]]
            for k in doomed:
                del self._metrics[k]
        return len(doomed)

    # -- introspection ----------------------------------------------------

    def get_value(self, name: str, **labels):
        """Current value of a counter/gauge (0 when never touched)."""
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
        return 0 if m is None else getattr(m, "value", None)

    def scalar_snapshot(self) -> Dict[Tuple[str, LabelKey], float]:
        """One scalar per series — counters/gauges by value, histograms
        as two derived series ``<name>.count`` / ``<name>.sum`` — the
        O(metrics) feed for the history ring (telemetry/history.py).
        No bucket arrays are rendered or copied, so a ring of N
        snapshots costs O(N × metrics), not O(N × metrics × buckets)."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[Tuple[str, LabelKey], float] = {}
        for (name, lk), m in items:
            if isinstance(m, Histogram):
                out[(f"{name}.count", lk)] = float(m.count)
                out[(f"{name}.sum", lk)] = float(m.sum)
            else:
                out[(name, lk)] = float(m.value)
        return out

    def exemplars_of(self, name: str) -> List[Dict[str, Any]]:
        """Exemplar slots of every histogram series under ``name``
        (labeled series carry their labels) — the lookup behind
        ``GET /_traces?exemplar_for=<metric>``. Metric names resolve
        exactly, or with a ``.latency`` suffix fallback so the phase
        shorthand ``search.phase.query`` finds
        ``search.phase.query.latency``."""
        with self._lock:
            items = list(self._metrics.items())
        out: List[Dict[str, Any]] = []
        for (mname, lk), metric in items:
            if mname != name and mname != f"{name}.latency":
                continue
            if not isinstance(metric, Histogram):
                continue
            for ex in metric.exemplar_list():
                if lk:
                    ex["labels"] = dict(lk)
                ex["metric"] = mname
                out.append(ex)
        return out

    def to_dict(self) -> Dict[str, Any]:
        """The `_nodes/stats` ``telemetry.metrics`` shape: unlabeled
        metrics render flat; labeled metrics render as a series list,
        both sorted for stable output."""
        with self._lock:
            items = dict(self._metrics)
        series: Dict[str, List[LabelKey]] = {}
        for name, lk in items:
            series.setdefault(name, []).append(lk)
        out: Dict[str, Any] = {}
        for name in sorted(series):
            keys = series[name]
            if keys == [()]:
                out[name] = items[(name, ())].to_dict()
                continue
            out[name] = [
                {"labels": dict(lk), **items[(name, lk)].to_dict()}
                for lk in sorted(keys)]
        return out
