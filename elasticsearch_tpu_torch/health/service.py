"""HealthService: runs the indicator catalog and merges node reports
(the port's copy of elasticsearch_tpu/health/service.py).

Ref: ``org.elasticsearch.health.HealthService`` — but where the
reference computes health on one elected health node, this engine fans
the computation out (``cluster:monitor/health_report[n]``) and merges
per-node local reports coordinator-side, because half the signals
(breakers, device memory, compile storms, task backlogs) are node-local by
nature. ``merge_node_reports`` is a pure function so the composition
is unit-testable without a cluster.

Merge semantics per indicator: worst status wins
(GREEN < UNKNOWN < YELLOW < RED); the symptom comes from the first
node (sorted id) reporting the worst status; details nest per node;
impacts/diagnoses union by id, with diagnosis ``affected_resources``
merged. Unreachable nodes land in top-level ``node_failures`` — an
unreachable node makes the report incomplete, not wrong.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.health.indicator import (
    HealthContext,
    HealthStatus,
)
from elasticsearch_tpu_torch.health.indicators import DEFAULT_INDICATORS


class UnknownIndicatorError(KeyError):
    """Asked for an indicator name that isn't in the catalog."""


class HealthService:
    """One per node. ``context_fn`` builds the node's
    ``HealthContext`` fresh per report (live stats seams)."""

    def __init__(self,
                 context_fn: Callable[[], HealthContext],
                 indicators=None):
        self.indicators = [cls() for cls in
                           (indicators or DEFAULT_INDICATORS)]
        self.context_fn = context_fn

    def indicator_names(self) -> List[str]:
        return [i.name for i in self.indicators]

    def local_report(self,
                     indicator: Optional[str] = None) -> Dict[str, Any]:
        """This node's verdicts: ``{node, status, indicators:{name:
        result}}``. ``indicator`` filters to one by name."""
        selected = self.indicators
        if indicator is not None:
            selected = [i for i in self.indicators if i.name == indicator]
            if not selected:
                raise UnknownIndicatorError(indicator)
        ctx = self.context_fn()
        # refresh the rate/stall substrate once per report, so every
        # indicator reads one consistent snapshot
        if ctx.history is not None:
            ctx.history.advance()
        if ctx.watchdog is not None:
            ctx.watchdog.sweep()
        results = {i.name: i.safe_compute(ctx).to_dict() for i in selected}
        return {
            "node": ctx.node_id,
            "status": HealthStatus.worst(
                *(r["status"] for r in results.values())),
            "indicators": results,
        }


def merge_node_reports(
        node_reports: Dict[str, Dict[str, Any]],
        node_failures: Optional[List[Dict[str, str]]] = None,
) -> Dict[str, Any]:
    """Compose per-node local reports into the cluster
    ``GET /_health_report`` body. Pure and order-independent: iteration
    is over sorted node ids, so any arrival order of fan-out responses
    renders identical bytes."""
    indicators: Dict[str, Dict[str, Any]] = {}
    names: List[str] = []
    for node_id in sorted(node_reports):
        for name in node_reports[node_id].get("indicators", {}):
            if name not in names:
                names.append(name)
    for name in names:
        status = HealthStatus.GREEN
        per_node: Dict[str, Any] = {}
        impacts: Dict[str, Dict[str, Any]] = {}
        diagnoses: Dict[str, Dict[str, Any]] = {}
        symptom = ""
        for node_id in sorted(node_reports):
            r = node_reports[node_id].get("indicators", {}).get(name)
            if r is None:
                continue
            worst = HealthStatus.worst(status, r["status"])
            if worst != status or not symptom:
                if r["status"] == worst:
                    symptom = r["symptom"]
                status = worst
            per_node[node_id] = r.get("details", {})
            for imp in r.get("impacts", []):
                impacts.setdefault(imp["id"], imp)
            for diag in r.get("diagnosis", []):
                prev = diagnoses.get(diag["id"])
                if prev is None:
                    diagnoses[diag["id"]] = dict(diag)
                else:
                    prev["affected_resources"] = sorted(
                        set(prev.get("affected_resources", []))
                        | set(diag.get("affected_resources", [])))
        entry: Dict[str, Any] = {
            "status": status,
            "symptom": symptom,
            "details": {"nodes": per_node},
        }
        if impacts:
            entry["impacts"] = [impacts[k] for k in sorted(impacts)]
        if diagnoses:
            entry["diagnosis"] = [diagnoses[k] for k in sorted(diagnoses)]
        indicators[name] = entry
    failures = sorted(node_failures or [],
                      key=lambda f: f.get("node", ""))
    top = HealthStatus.worst(
        *(e["status"] for e in indicators.values())) if indicators \
        else HealthStatus.UNKNOWN
    if failures and top == HealthStatus.GREEN:
        # a node we couldn't hear from caps confidence below green
        top = HealthStatus.UNKNOWN
    out: Dict[str, Any] = {"status": top, "indicators": indicators}
    if failures:
        out["node_failures"] = failures
    return out
