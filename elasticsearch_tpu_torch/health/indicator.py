"""Health indicator core types (the port's copy of
elasticsearch_tpu/health/indicator.py).

Mirrors the reference's Health API contract (ref:
``org.elasticsearch.health``: ``HealthIndicatorService`` →
``HealthIndicatorResult{status, symptom, details, impacts, diagnosis}``
served by ``GET /_health_report``): each indicator inspects one
subsystem's live signals and renders a verdict — a status, a one-line
symptom, and when degraded a typed ``Diagnosis`` (cause → action →
affected resources) plus ``Impact``s naming what the degradation costs.

Status ordering (for worst-wins merges across nodes and the top-level
roll-up) follows the reference: GREEN < UNKNOWN < YELLOW < RED.

Determinism contract: indicators read ONLY their ``HealthContext``
seams (the injected clock, the history ring, service stats) — never
the wall clock, never unordered iteration — so the same signals render
the same report bytes. Every indicator is listed in
``DEFAULT_INDICATORS``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class HealthStatus:
    """Ordered status constants; ``worst()`` merges."""

    GREEN = "green"
    UNKNOWN = "unknown"
    YELLOW = "yellow"
    RED = "red"

    _ORDER = {GREEN: 0, UNKNOWN: 1, YELLOW: 2, RED: 3}

    @classmethod
    def worst(cls, *statuses: str) -> str:
        out = cls.GREEN
        for s in statuses:
            if cls._ORDER.get(s, 1) > cls._ORDER[out]:
                out = s
        return out


@dataclass
class Diagnosis:
    """Why the indicator is degraded and what to do about it (ref:
    ``Diagnosis{definition{cause, action}, affectedResources}``)."""

    id: str
    cause: str
    action: str
    affected_resources: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"id": self.id, "cause": self.cause, "action": self.action,
                "affected_resources": sorted(self.affected_resources)}


@dataclass
class Impact:
    """What the degradation costs users (severity 1 = worst, matching
    the reference's ImpactArea severity scale)."""

    id: str
    severity: int
    description: str
    impact_areas: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"id": self.id, "severity": self.severity,
                "description": self.description,
                "impact_areas": sorted(self.impact_areas)}


@dataclass
class HealthIndicatorResult:
    """One indicator's verdict on one node (merged cluster-wide by
    ``health/service.py``)."""

    name: str
    status: str
    symptom: str
    details: Dict[str, Any] = field(default_factory=dict)
    impacts: List[Impact] = field(default_factory=list)
    diagnoses: List[Diagnosis] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "status": self.status,
            "symptom": self.symptom,
            "details": self.details,
        }
        if self.impacts:
            out["impacts"] = [i.to_dict() for i in self.impacts]
        if self.diagnoses:
            out["diagnosis"] = [d.to_dict() for d in self.diagnoses]
        return out


@dataclass
class HealthContext:
    """Every seam an indicator may read. All optional: an indicator
    whose signal source is absent on this node (e.g. routing table on
    a non-master) reports UNKNOWN or scopes down, never raises.

    ``now`` is the injected scheduler clock; ``history`` the node's
    metrics ring (already ``advance()``d by the caller)."""

    node_id: str = ""
    now: Callable[[], float] = None  # injected; never time.time
    metrics: Any = None              # MetricsRegistry
    history: Any = None              # MetricsHistory
    cluster_state: Any = None        # applied ClusterState (or None)
    is_master: bool = False
    breaker_service: Any = None
    indexing_pressure: Any = None
    task_manager: Any = None
    recoveries: Optional[Dict[Tuple, Any]] = None  # data_node.recoveries
    state_lag: Optional[Dict[str, int]] = None     # master lag detector
    engine_totals: Optional[Dict[str, Any]] = None  # compile tracker
    mesh_stats: Optional[Dict[str, Any]] = None     # mesh executor
    watchdog: Any = None             # StalledProgressWatchdog
    flight: Any = None               # FlightRecorder (launch-path ring)
    tenants: Any = None              # TenantAccounting (per-tenant table)
    workload: Any = None             # WorkloadAccounting (per-class table)
    repositories: Any = None         # RepositoriesService (snapshot repos)
    snapshots: Any = None            # ClusterSnapshotService (in-flight)


class HealthIndicator:
    """Base class: subclasses set ``name`` and implement ``compute``.

    Every concrete indicator in ``health/`` MUST also be listed in
    ``health.indicators.DEFAULT_INDICATORS``, so a new indicator
    cannot silently miss the report.
    """

    name: str = ""

    def compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        raise NotImplementedError

    def safe_compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        """Never let one broken indicator take down the report."""
        try:
            return self.compute(ctx)
        except Exception as exc:  # noqa: BLE001 — diagnostic surface
            return HealthIndicatorResult(
                name=self.name, status=HealthStatus.UNKNOWN,
                symptom=f"indicator failed: {type(exc).__name__}",
                details={"error": str(exc)})
