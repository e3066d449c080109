"""Metrics time-series history: a bounded ring of periodic scalar
snapshots over the node's ``MetricsRegistry``.

PR-2's counters are monotonic — a point-in-time read cannot tell a
compile *storm* (300 compiles in the last minute) from an old node
that compiled 300 kernels at boot. The ring converts counters into
trends without external scraping: each sample is the registry's
``scalar_snapshot()`` (counters/gauges by value, histograms as
``.count``/``.sum`` scalars — O(metrics), never bucket arrays), and
``rate()``/``delta()`` answer "how much did X move over the last
window" from ring samples alone.

Determinism contract: samples are stamped at ``k × interval``
boundaries of the injected clock, and queries read ONLY the ring
(never the live registry), so a chaos-seeded run renders byte-identical
rates on replay. Two capture modes:

- **lazy** (default): callers invoke ``advance()`` before reading —
  health indicators and ``_nodes/stats?history=true`` do. No scheduled
  task means no perturbation of the seeded task-queue interleaving.
- **active**: ``start(scheduler)`` schedules a recurring tick every
  ``interval`` seconds (settings ``telemetry.history.interval`` /
  ``telemetry.history.retention``).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.telemetry.metrics import (
    LabelKey,
    MetricsRegistry,
    _label_key,
)

DEFAULT_INTERVAL_S = 10.0
DEFAULT_RETENTION_S = 600.0

Sample = Tuple[float, Dict[Tuple[str, LabelKey], float]]


class MetricsHistory:
    """Bounded ring of ``(timestamp, scalar_snapshot)`` samples."""

    def __init__(self, registry: MetricsRegistry,
                 clock: Callable[[], float],
                 interval: float = DEFAULT_INTERVAL_S,
                 retention: float = DEFAULT_RETENTION_S):
        if interval <= 0:
            raise ValueError(f"history interval must be > 0, got {interval}")
        self.registry = registry
        self.clock = clock
        self.interval = float(interval)
        self.capacity = max(2, int(retention / interval) + 1)
        self._ring: Deque[Sample] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._task = None  # active-mode Cancellable

    # -- capture ----------------------------------------------------------

    def advance(self) -> bool:
        """Take a snapshot if a new ``k × interval`` boundary has been
        crossed since the last sample. Returns True when a sample was
        captured. Safe to call on every read path: a quiet clock makes
        this a two-comparison no-op."""
        now = self.clock()
        boundary = (now // self.interval) * self.interval
        with self._lock:
            if self._ring and self._ring[-1][0] >= boundary:
                return False
            # capture outside the ring lock would race a concurrent
            # advance into out-of-order timestamps; snapshot is cheap
            # (O(metrics) scalars) so hold it
            self._ring.append((boundary, self.registry.scalar_snapshot()))
            return True

    def start(self, scheduler) -> None:
        """Active mode: recurring sweep on the scheduler clock. Opt-in
        (``telemetry.history.active``) because a scheduled task changes
        the seeded task-queue interleaving of existing chaos suites."""
        if self._task is not None:
            return

        def _tick() -> None:
            self.advance()
            self._task = scheduler.schedule(
                self.interval, _tick, "metrics-history-tick")

        self._task = scheduler.schedule(
            self.interval, _tick, "metrics-history-tick")

    def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()

    # -- cardinality control ----------------------------------------------

    def prune_label(self, label: str, value: str) -> int:
        """Scrub every ring sample of series labeled ``label=value``;
        returns the number of (sample, series) entries removed. Paired
        with ``MetricsRegistry.prune_label``: when TenantAccounting
        evicts a tenant, its history must go with its live series —
        otherwise ``memory_bytes()``/``to_dict()`` keep paying for
        (and rendering) tenants that no longer exist, and the
        cardinality cap only bounds half the cost."""
        pair = (label, str(value))
        removed = 0
        with self._lock:
            for _, snap in self._ring:
                doomed = [k for k in snap if pair in k[1]]
                for k in doomed:
                    del snap[k]
                removed += len(doomed)
        return removed

    # -- queries (ring-only: replay-deterministic) ------------------------

    def samples(self) -> List[Sample]:
        with self._lock:
            return list(self._ring)

    def _window(self, window: float) -> Tuple[Optional[Sample],
                                              Optional[Sample]]:
        """(oldest sample inside the window, newest sample); the window
        is anchored at the newest SAMPLE, not the live clock, so replay
        does not depend on when the report was rendered."""
        with self._lock:
            if len(self._ring) < 2:
                return None, None
            newest = self._ring[-1]
            floor_ts = newest[0] - window
            oldest = None
            for s in self._ring:
                if s[0] >= floor_ts:
                    oldest = s
                    break
            if oldest is None or oldest[0] >= newest[0]:
                return None, None
            return oldest, newest

    def delta(self, name: str, window: float, **labels) -> float:
        """Increase of a scalar series over the trailing window (0.0
        when the ring can't cover it). Missing-in-older-sample series
        count from 0 — a counter born mid-window is all delta."""
        oldest, newest = self._window(window)
        if oldest is None or newest is None:
            return 0.0
        key = (name, _label_key(labels))
        return newest[1].get(key, 0.0) - oldest[1].get(key, 0.0)

    def rate(self, name: str, window: float, **labels) -> float:
        """Per-second rate over the trailing window, using SAMPLE
        timestamps for the denominator (not the nominal window)."""
        oldest, newest = self._window(window)
        if oldest is None or newest is None:
            return 0.0
        elapsed = newest[0] - oldest[0]
        if elapsed <= 0:
            return 0.0
        key = (name, _label_key(labels))
        return (newest[1].get(key, 0.0) - oldest[1].get(key, 0.0)) / elapsed

    def rate_total(self, name: str, window: float) -> float:
        """Summed per-second rate across ALL label series of ``name``
        (e.g. ``indexing_pressure.rejections`` over every stage)."""
        oldest, newest = self._window(window)
        if oldest is None or newest is None:
            return 0.0
        elapsed = newest[0] - oldest[0]
        if elapsed <= 0:
            return 0.0
        total = 0.0
        for (mname, lk), v in newest[1].items():
            if mname == name:
                total += v - oldest[1].get((mname, lk), 0.0)
        return total / elapsed

    def delta_total(self, name: str, window: float) -> float:
        """Summed increase across ALL label series of ``name`` over the
        trailing window — "how many breaker trips in the last minute,
        any breaker"."""
        oldest, newest = self._window(window)
        if oldest is None or newest is None:
            return 0.0
        total = 0.0
        for (mname, lk), v in newest[1].items():
            if mname == name:
                total += v - oldest[1].get((mname, lk), 0.0)
        return total

    def series(self, name: str, **labels) -> List[Tuple[float, float]]:
        """(timestamp, value) points for one series across the ring."""
        key = (name, _label_key(labels))
        out = []
        with self._lock:
            for ts, snap in self._ring:
                if key in snap:
                    out.append((ts, snap[key]))
        return out

    def memory_bytes(self) -> int:
        """Deterministic estimate of ring residency: per-sample deque
        slot + dict overhead, per-entry key/value cost. An estimate by
        design — ``sys.getsizeof`` walks differ across interpreter
        builds and would break byte-identical replay."""
        with self._lock:
            entries = sum(len(snap) for _, snap in self._ring)
            n = len(self._ring)
        return n * 120 + entries * 112

    def to_dict(self, window: Optional[float] = None) -> Dict[str, Any]:
        """The ``_nodes/stats?history=true`` view: ring stats plus every
        series' windowed delta/rate (scalars only, no per-point dump —
        the full ring is available via ``series()`` for tooling)."""
        with self._lock:
            ring = list(self._ring)
        w = window if window is not None else self.capacity * self.interval
        out: Dict[str, Any] = {
            "interval_s": self.interval,
            "capacity": self.capacity,
            "samples": len(ring),
            "memory_bytes": self.memory_bytes(),
        }
        if ring:
            out["newest_ts"] = ring[-1][0]
            out["oldest_ts"] = ring[0][0]
        series: Dict[str, Any] = {}
        if len(ring) >= 2:
            newest, oldest = ring[-1], ring[0]
            floor_ts = newest[0] - w
            for s in ring:
                if s[0] >= floor_ts:
                    oldest = s
                    break
            elapsed = newest[0] - oldest[0]
            for (mname, lk), v in sorted(newest[1].items()):
                d = v - oldest[1].get((mname, lk), 0.0)
                label = mname if not lk else (
                    mname + "{" + ",".join(f"{k}={val}" for k, val in lk)
                    + "}")
                series[label] = {
                    "value": v, "delta": d,
                    "rate_per_s": (d / elapsed) if elapsed > 0 else 0.0,
                }
        out["window_s"] = w
        out["series"] = series
        return out
