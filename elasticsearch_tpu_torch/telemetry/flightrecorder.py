"""Launch-path flight recorder (a copy of the jax-free
elasticsearch_tpu/telemetry/flightrecorder.py): a bounded, always-on
per-node ring of every kernel launch and every device->host readback.

Cheap enough to stay on (a deque append per event, no allocation when no
recorder is ambient), bounded (fixed ``capacity``, oldest event drops),
and deterministic under an injected clock (all timestamps and durations
read ONE clock).

Two event sources feed the ring:

- ``telemetry/engine.py``'s ``tracked_kernel`` wrapper records a
  ``launch`` event per tracked call (kernel id, shape key, dispatch
  nanos), enriched by the cohort annotation ``annotate_launch`` installs
  around a batched launch (cohort fill / capacity / queue-wait nanos,
  search/batching.py);
- ``ops/device.py``'s ``readback()`` funnel records every device->host
  transfer with its call-site label.

Both stamp the ambient trace/span (telemetry/context.py). The regime
classifier tags each event ``fast|degraded`` from an EMA of observed
dispatch+readback latency (hysteresis: enter above
``degraded_enter_ms``, exit below ``degraded_exit_ms``).

Surfaces: ``GET /_flight_recorder`` (the filtered ring),
``GET /_flight_recorder/waterfall/{trace_id}`` (``build_waterfall``: the
trace's spans with the events that ran under each), the
``telemetry.flight_recorder`` block of ``GET /_nodes/stats``, and the
slowlog entries (the per-trace summary).
"""

from __future__ import annotations

import threading
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

DEFAULT_CAPACITY = 4096

# regime thresholds (ms, on the recorder's clock): a degraded device
# shows up as dispatch round-trips jumping from sub-ms to tens of ms —
# enter well above fast-path noise, exit with hysteresis so one lucky
# launch doesn't flap the gauge
DEGRADED_ENTER_MS = 25.0
DEGRADED_EXIT_MS = 10.0
_EMA_ALPHA = 0.3

FAST = "fast"
DEGRADED = "degraded"

# cohort fill-ratio histogram bucket upper bounds (percent)
FILL_BUCKETS_PCT = (10, 25, 50, 75, 90, 100)

_tls = threading.local()
_telectx = None     # telemetry/context.py, imported at first use


def current() -> Optional["FlightRecorder"]:
    """The ambient per-node recorder (installed by the REST dispatch, the
    fast path's drain thread and the HTTP front's fallback workers;
    carried across thread boundaries by ``telemetry/context.bind``); None
    costs one getattr."""
    return getattr(_tls, "rec", None)


@contextmanager
def activate(rec: Optional["FlightRecorder"]):
    """Install ``rec`` as the ambient recorder for the duration."""
    prev = getattr(_tls, "rec", None)
    _tls.rec = rec
    try:
        yield rec
    finally:
        _tls.rec = prev


def launch_info() -> Optional[Dict[str, Any]]:
    return getattr(_tls, "launch_info", None)


@contextmanager
def annotate_launch(cohort: int, capacity: int, queue_wait_ns: int = 0):
    """Cohort annotation for the launches inside the body: the batcher
    wraps its ONE device call with the cohort's fill/capacity and the
    queue wait its oldest rider paid, and ``tracked_kernel``'s launch event
    picks it up (telemetry/engine.py) — enrichment, not double count."""
    prev = getattr(_tls, "launch_info", None)
    _tls.launch_info = {"cohort": int(cohort), "capacity": int(capacity),
                        "queue_wait_ns": int(queue_wait_ns)}
    try:
        yield
    finally:
        _tls.launch_info = prev


class FlightRecorder:
    """Bounded per-node ring of launch/readback events + the regime
    classifier. All time comes from ``clock`` (seconds; the scheduler's
    virtual clock under the deterministic harness)."""

    def __init__(self, node: str = "",
                 clock: Optional[Callable[[], float]] = None,
                 capacity: int = DEFAULT_CAPACITY,
                 metrics: Any = None,
                 degraded_enter_ms: float = DEGRADED_ENTER_MS,
                 degraded_exit_ms: float = DEGRADED_EXIT_MS):
        import time as _time
        self.node = node
        self.clock = clock or _time.monotonic
        self.capacity = int(capacity)
        self.metrics = metrics
        self._counters = (None, {})     # (registry, name -> Counter)
        self.degraded_enter_ms = float(degraded_enter_ms)
        self.degraded_exit_ms = float(degraded_exit_ms)
        self._lock = threading.Lock()
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self._seq = 0
        # regime state
        self.regime = FAST
        self._lat_ema_ms = 0.0
        self._regime_since = self.clock()
        self._regime_seconds = {FAST: 0.0, DEGRADED: 0.0}
        self.regime_flips = 0
        self.last_flip: Optional[Dict[str, Any]] = None
        # aggregates (monotonic; the ring is bounded, these are not —
        # they are a handful of scalars)
        self.launches = 0
        self.readbacks = 0
        self.readback_bytes = 0
        self._fill_hist = {b: 0 for b in FILL_BUCKETS_PCT}
        self._fill_slots = 0          # summed cohort capacity
        self._fill_filled = 0         # summed cohort occupancy
        self._readback_by_site: Dict[str, Dict[str, float]] = {}
        # optional TenantAccounting sink: launch-ms and readback bytes
        # charged to the ambient tenant (telemetry/tenants.py)
        self.tenants = None
        # optional WorkloadAccounting sink: launch-ms charged to the
        # ambient workload class (telemetry/workload.py)
        self.workloads = None

    # -- clock ------------------------------------------------------------

    def _now_ns(self) -> int:
        return int(self.clock() * 1e9)

    # -- regime classifier ------------------------------------------------

    def _observe_latency(self, ms: float, cause: str) -> None:
        """Feed one observed dispatch/readback latency; flip the regime
        with hysteresis and record the flip cause (the event that
        pushed the EMA over the line)."""
        if ms >= 5000.0:
            # compile-length outlier (first launch per shape): the
            # compile tracker owns those; feeding them here would flip
            # every cold node straight to degraded
            return
        self._lat_ema_ms = (ms if self._lat_ema_ms == 0.0
                            else (1.0 - _EMA_ALPHA) * self._lat_ema_ms
                            + _EMA_ALPHA * ms)
        if self.regime == FAST \
                and self._lat_ema_ms >= self.degraded_enter_ms:
            self._flip(DEGRADED, cause, ms)
        elif self.regime == DEGRADED \
                and self._lat_ema_ms <= self.degraded_exit_ms:
            self._flip(FAST, cause, ms)

    def _flip(self, to: str, cause: str, ms: float) -> None:
        now = self.clock()
        self._regime_seconds[self.regime] += max(0.0,
                                                 now - self._regime_since)
        self.regime = to
        self._regime_since = now
        self.regime_flips += 1
        self.last_flip = {"to": to, "cause": cause,
                          "observed_ms": round(ms, 3),
                          "ema_ms": round(self._lat_ema_ms, 3),
                          "t_ns": int(now * 1e9)}
        if self.metrics is not None:
            self.metrics.inc("flight.regime_flips")
            self.metrics.set_gauge("flight.regime",
                                   1.0 if to == DEGRADED else 0.0)

    def regime_seconds(self) -> Dict[str, float]:
        """Cumulative seconds per regime including the open interval —
        the counters the history ring / health indicators window over."""
        out = dict(self._regime_seconds)
        out[self.regime] += max(0.0, self.clock() - self._regime_since)
        return {k: round(v, 3) for k, v in out.items()}

    def _counter(self, name: str):
        """The registry's unlabeled counter ``name``, looked up once per
        registry: every event increments a few, and the lookup (a key
        built and sorted, a dict probe) costs more than the add."""
        cached = self._counters
        if cached[0] is not self.metrics:
            cached = self._counters = (self.metrics, {})
        c = cached[1].get(name)
        if c is None:
            c = cached[1][name] = self.metrics.counter(name)
        return c

    def _sync_regime_metrics(self) -> None:
        """Publish regime-seconds into the metrics registry as counters
        (set via inc-by-delta so scalar_snapshot sees monotonic
        values)."""
        if self.metrics is None:
            return
        secs = self.regime_seconds()
        for regime, total in secs.items():
            c = self._counter(f"flight.regime_seconds.{regime}")
            delta = total - c.value
            if delta > 0:
                c.inc(delta)

    # -- event recording --------------------------------------------------

    def _ambient_trace(self) -> Dict[str, Any]:
        global _telectx
        if _telectx is None:    # telemetry/context.py imports this module
            from elasticsearch_tpu_torch.telemetry import context
            _telectx = context
        ctx = _telectx.current()
        out: Dict[str, Any] = {}
        if ctx is not None:
            out["trace_id"] = ctx.trace_id
            if ctx.span_id is not None:
                out["span_id"] = ctx.span_id
        tenant = _telectx.current_tenant()
        if tenant is not None:
            out["tenant"] = tenant
        wclass = _telectx.current_workload_class()
        if wclass is not None:
            out["workload_class"] = wclass
        return out

    def record_launch(self, kernel: str, shape: str,
                      dispatch_ns: int = 0,
                      cohort: int = 1, capacity: int = 1,
                      queue_wait_ns: int = 0) -> None:
        """One kernel launch: called by the ``tracked_kernel`` wrapper with
        the cohort annotation (if any) already folded in by the
        caller."""
        dispatch_ms = dispatch_ns / 1e6
        fill_pct = 100.0 * cohort / capacity if capacity else 100.0
        with self._lock:
            self._seq += 1
            ev = {"kind": "launch", "seq": self._seq, "node": self.node,
                  "t_ns": self._now_ns(), "kernel": kernel,
                  "shape": shape, "cohort": int(cohort),
                  "capacity": int(capacity),
                  "fill_pct": round(fill_pct, 1),
                  "queue_wait_ns": int(queue_wait_ns),
                  "dispatch_ns": int(dispatch_ns),
                  **self._ambient_trace()}
            self._observe_latency(dispatch_ms, f"launch {kernel}")
            ev["regime"] = self.regime
            self._ring.append(ev)
            self.launches += 1
            self._fill_slots += int(capacity)
            self._fill_filled += int(cohort)
            for b in FILL_BUCKETS_PCT:
                if fill_pct <= b:
                    self._fill_hist[b] += 1
                    break
        if self.metrics is not None:
            self._counter("flight.launches").inc()
            self._counter("flight.launch.slots").inc(capacity)
            self._counter("flight.launch.filled").inc(cohort)
            self._sync_regime_metrics()
        if self.tenants is not None:
            self.tenants.record_launch(ev.get("tenant"), dispatch_ms)
        if self.workloads is not None:
            self.workloads.record_launch(ev.get("workload_class"),
                                         dispatch_ms)

    def record_readback(self, site: str, nbytes: int,
                        duration_ns: int = 0) -> None:
        """One device→host transfer through the ``ops/device.readback``
        funnel, attributed to its call site."""
        duration_ms = duration_ns / 1e6
        with self._lock:
            self._seq += 1
            ev = {"kind": "readback", "seq": self._seq,
                  "node": self.node, "t_ns": self._now_ns(),
                  "site": site, "nbytes": int(nbytes),
                  "duration_ns": int(duration_ns),
                  **self._ambient_trace()}
            self._observe_latency(duration_ms, f"readback {site}")
            ev["regime"] = self.regime
            self._ring.append(ev)
            self.readbacks += 1
            self.readback_bytes += int(nbytes)
            slot = self._readback_by_site.setdefault(
                site, {"count": 0, "bytes": 0})
            slot["count"] += 1
            slot["bytes"] += int(nbytes)
        if self.metrics is not None:
            self._counter("flight.readbacks").inc()
            self._counter("flight.readback.bytes").inc(nbytes)
            self._sync_regime_metrics()
        if self.tenants is not None:
            self.tenants.record_readback(ev.get("tenant"), nbytes)

    # -- queries ----------------------------------------------------------

    def events(self, kind: Optional[str] = None,
               kernel: Optional[str] = None,
               site: Optional[str] = None,
               trace_id: Optional[str] = None,
               since_ns: Optional[int] = None,
               limit: int = 256, offset: int = 0) -> List[Dict[str, Any]]:
        """Newest-first filtered view of the ring (the
        ``GET /_flight_recorder`` dump)."""
        with self._lock:
            evs = list(self._ring)
        out = []
        for ev in reversed(evs):
            if kind is not None and ev["kind"] != kind:
                continue
            if kernel is not None and ev.get("kernel") != kernel:
                continue
            if site is not None and ev.get("site") != site:
                continue
            if trace_id is not None and ev.get("trace_id") != trace_id:
                continue
            if since_ns is not None and ev["t_ns"] < since_ns:
                continue
            out.append(dict(ev))
        return out[offset:offset + limit]

    def events_for_trace(self, trace_id: str) -> List[Dict[str, Any]]:
        """Oldest-first events of one trace (waterfall stitching
        order: (t_ns, seq) — both deterministic under the seeded
        clock)."""
        with self._lock:
            evs = [dict(ev) for ev in self._ring
                   if ev.get("trace_id") == trace_id]
        evs.sort(key=lambda e: (e["t_ns"], e["seq"]))
        return evs

    def summary_for_trace(self, trace_id: str) -> Dict[str, Any]:
        """The slowlog enrichment: THIS request's launch/readback
        totals, pulled from the ring by trace id after the search
        finished."""
        launches = readbacks = filled = slots = 0
        worst = FAST
        for ev in self.events_for_trace(trace_id):
            if ev["kind"] == "launch":
                launches += 1
                filled += ev["cohort"]
                slots += ev["capacity"]
            else:
                readbacks += 1
            if ev.get("regime") == DEGRADED:
                worst = DEGRADED
        return {"launches": launches, "readbacks": readbacks,
                "cohort_fill_pct": (round(100.0 * filled / slots, 1)
                                    if slots else None),
                "regime": worst}

    def aggregates(self) -> Dict[str, Any]:
        """The ``flight_recorder`` block of ``GET /_nodes/stats``."""
        self._sync_regime_metrics()
        with self._lock:
            fill_hist = {f"le_{b}": n for b, n in self._fill_hist.items()}
            by_site = {s: dict(v)
                       for s, v in sorted(self._readback_by_site.items())}
        return {
            "ring": {"capacity": self.capacity, "events": len(self._ring),
                     "recorded_total": self._seq},
            "launches": self.launches,
            "readbacks": self.readbacks,
            "readback_bytes": self.readback_bytes,
            "readback_by_site": by_site,
            "fill_histogram_pct": fill_hist,
            "fill_pct_overall": (round(100.0 * self._fill_filled
                                       / self._fill_slots, 1)
                                 if self._fill_slots else None),
            "regime": {
                "current": self.regime,
                "latency_ema_ms": round(self._lat_ema_ms, 3),
                "flips": self.regime_flips,
                "last_flip": (dict(self.last_flip)
                              if self.last_flip else None),
                "seconds": self.regime_seconds(),
            },
        }

    def fill_percentiles(self) -> Dict[str, Optional[float]]:
        """p50/p99 cohort fill (percent) from the bounded histogram —
        CPU-side, no ring walk (bench row metadata)."""
        with self._lock:
            hist = dict(self._fill_hist)
        total = sum(hist.values())
        if not total:
            return {"p50": None, "p99": None}
        out = {}
        for q, key in ((0.50, "p50"), (0.99, "p99")):
            need = q * total
            run = 0
            val: Optional[float] = float(FILL_BUCKETS_PCT[-1])
            for b in FILL_BUCKETS_PCT:
                run += hist[b]
                if run >= need:
                    val = float(b)
                    break
            out[key] = val
        return out


# -- waterfall stitching ------------------------------------------------

def build_waterfall(trace_id: str,
                    node_slices: List[Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
    """Merge per-node (spans, flight events) slices of one trace into a
    single waterfall: the span tree of ``tracing.Tracer.trace`` with
    each span carrying the launch/readback ``events`` it paid for and
    per-hop nanos (REST parse → batcher wait → launch → readback →
    merge → fetch).

    ``node_slices``: ``[{"node": id, "spans": [...], "events": [...]},
    ...]`` — the coordinator's own slice plus each data node's
    ``FLIGHT_TRACE_ACTION`` response. Span ids are node-prefixed
    counters, so cross-node merge is collision-free; all ordering keys
    ((start_ms, span_id) for spans, (t_ns, seq, node) for events) are
    deterministic under seed replay. Returns None when no node held any
    span of the trace."""
    spans: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    nodes: List[str] = []
    for sl in node_slices:
        if sl.get("spans") or sl.get("events"):
            nodes.append(sl.get("node", ""))
        spans.extend(dict(s) for s in sl.get("spans") or [])
        events.extend(dict(e) for e in sl.get("events") or [])
    if not spans and not events:
        return None
    spans.sort(key=lambda s: (s["start_ms"], s["span_id"]))
    events.sort(key=lambda e: (e["t_ns"], e["seq"], e.get("node", "")))
    by_id = {s["span_id"]: {**s, "events": [], "children": []}
             for s in spans}
    unattached: List[Dict[str, Any]] = []
    for ev in events:
        slot = by_id.get(ev.get("span_id"))
        if slot is not None:
            slot["events"].append(ev)
        else:
            unattached.append(ev)
    roots = []
    for s in spans:
        node = by_id[s["span_id"]]
        parent = by_id.get(s["parent_id"]) if s["parent_id"] else None
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        # per-hop self time: the span's duration minus its children's —
        # what THIS hop (parse, batcher wait, merge, ...) cost on top
        # of what it delegated
        child_ms = sum(c["duration_ms"] for c in node["children"])
        node["self_ns"] = int(max(0.0, node["duration_ms"] - child_ms)
                              * 1e6)
    out = {"trace_id": trace_id, "nodes": sorted(set(nodes)),
           "span_count": len(spans), "event_count": len(events),
           "waterfall": roots}
    if unattached:
        # events recorded under the trace but outside any span the ring
        # still holds (aged-out span, span-less caller) stay visible
        out["unattached_events"] = unattached
    return out
