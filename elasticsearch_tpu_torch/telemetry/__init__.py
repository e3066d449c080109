"""Node telemetry (counterpart of elasticsearch_tpu/telemetry/__init__.py):
the node's metrics registry, tracer, history ring, flight recorder and
tenant and workload-class accounting, on one injectable clock.

One ``Telemetry`` bundle a node. Components keep ``telemetry = None``
(or ``metrics = None``, ``tenants = None``) by default and guard each
site with one ``is not None`` branch, so an unwired path pays a branch.

Surfaces: the ``telemetry`` section of ``GET /_nodes/stats``
(``?history=true`` adds the windowed ring), ``GET /_traces`` and
``/_traces/{trace_id}``, ``GET /_flight_recorder/waterfall/{trace_id}``,
``GET /_tenants/stats``, ``/_workload/stats``, ``/_cat/tenants``,
``/_cat/workload``, and ``trace.id`` echoed on `_search` answers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from elasticsearch_tpu_torch.telemetry.metrics import (  # noqa: F401
    DEFAULT_BUCKETS_MS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from elasticsearch_tpu_torch.telemetry.history import (  # noqa: F401
    DEFAULT_INTERVAL_S,
    DEFAULT_RETENTION_S,
    MetricsHistory,
)
from elasticsearch_tpu_torch.telemetry.tracing import Span, Tracer  # noqa: F401
from elasticsearch_tpu_torch.telemetry.flightrecorder import (  # noqa: F401
    FlightRecorder,
)
from elasticsearch_tpu_torch.telemetry.tenants import (  # noqa: F401
    TenantAccounting,
)
from elasticsearch_tpu_torch.telemetry.workload import (  # noqa: F401
    WorkloadAccounting,
)


class Telemetry:
    """Metrics + tracer + history ring + flight recorder + tenant and
    workload accounting on one clock; the node-level handle."""

    def __init__(self, node: str = "",
                 clock: Optional[Callable[[], float]] = None,
                 max_traces: int = 128,
                 max_spans_per_trace: int = 512,
                 history_interval: float = DEFAULT_INTERVAL_S,
                 history_retention: float = DEFAULT_RETENTION_S,
                 settings_get: Optional[Callable[[str], Any]] = None):
        self.node = node
        self.metrics = MetricsRegistry(clock=clock)
        self.tracer = Tracer(clock=clock, node=node, max_traces=max_traces,
                             max_spans_per_trace=max_spans_per_trace)
        # the bounded time-series ring over the registry's scalars,
        # advanced lazily on its read paths (telemetry/history.py)
        self.history = MetricsHistory(
            self.metrics, self.metrics.clock,
            interval=history_interval, retention=history_retention)
        # the launch/readback ring on the same clock; its regime and fill
        # counters land in this registry
        self.flight = FlightRecorder(
            node=node, clock=self.metrics.clock, metrics=self.metrics)
        # bounded per-tenant and per-class accounting over the registry
        # (LRU cap + `_other` overflow); the flight recorder charges
        # launch ms and readback bytes through them. ``settings_get``
        # (the node's settings) sets their caps and SLO objectives
        get = settings_get or (lambda key, default=None: default)
        self.tenants = TenantAccounting.from_settings(
            get, self.metrics, history=self.history)
        self.flight.tenants = self.tenants
        self.workload = WorkloadAccounting.from_settings(
            get, self.metrics, history=self.history)
        self.flight.workloads = self.workload
        # `engine.compile.count` / `engine.compile.ms` from the process's
        # launch tracker (telemetry/engine.py; a weak sink)
        from elasticsearch_tpu_torch.telemetry import engine as _engine
        _engine.TRACKER.add_sink(self.metrics)
        metrics = self.metrics

        def _sink(stage: str, nanos: int) -> None:
            metrics.observe(f"search.stage.{stage}", nanos / 1e6)

        self._stage_sink = _sink

    def stage_sink(self) -> Callable[[str, int], None]:
        """The search/profile.py sink folding stage timings (launch,
        readback, topk, merge, ...) into ``search.stage.*`` latency
        histograms, whether or not ``profile: true`` was asked."""
        return self._stage_sink

    def to_dict(self, history: bool = False,
                history_window: Optional[float] = None) -> Dict[str, Any]:
        """The `_nodes/stats` ``telemetry`` section; ``history=True``
        (the ``?history=true`` param) appends the windowed ring view."""
        out = {
            "metrics": self.metrics.to_dict(),
            "traces": {
                "count": len(self.tracer._traces),
                "open_spans": len(self.tracer.open_spans()),
                "dropped_spans": self.tracer.dropped_spans_total,
            },
            "flight_recorder": self.flight.aggregates(),
            "tenants": {
                "cardinality": self.tenants.stats()["cardinality"],
                "top": self.tenants.top_n(),
            },
            "workload": {
                "cardinality": self.workload.stats()["cardinality"],
                "top": self.workload.top_n(),
            },
        }
        if history:
            self.history.advance()
            out["history"] = self.history.to_dict(window=history_window)
        return out
