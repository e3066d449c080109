"""Tenant-scoped accounting: the observability half of ROADMAP item 5.

One bounded ``TenantAccounting`` table per node attributes every
dimension the engine already measures — search count/latency, shard
fan-out, device launch milliseconds, readback bytes, batcher cohort
slots, indexing bytes, rejections, breaker trips — to the tenant the
request carried (the ambient ``X-Tenant-Id``, see telemetry/context.py).
The reference engine's analogue is x-pack monitoring crossed with
search-groups-style request attribution; here the table is the seam the
``noisy_neighbor`` health indicator and ``GET /_tenants/stats`` read.

Cardinality is a hard invariant, not a hope:

- untagged work lands in the reserved ``_default`` bucket;
- at most ``max_tenants`` REAL tenant ids are live at once (LRU by
  last-recorded activity);
- admitting a new tenant at the cap EVICTS the least-recently-active
  one: its counters and latency histogram FOLD into the reserved
  ``_other`` bucket (totals are never lost), then its labeled series
  are pruned from the metrics registry AND scrubbed from the
  metrics-history ring (``prune_label`` on both), so exemplar slots,
  ``_nodes/stats?history=true`` renders, and ring residency all respect
  the same cap.

Every per-tenant scalar lives in the shared ``MetricsRegistry`` under a
``tenant=<id>`` label, so the history ring windows over them for free
and the health indicator can ask "who moved over the last minute"
without this module keeping a second time series.

SLO tracking rides the same table: each tenant may carry a latency
objective (``tenants.slo.default_ms`` plus per-tenant overrides); a
search slower than its objective burns error budget
(``tenant.slo.violations``), surfaced as a burn percentage against the
allowed violation rate implied by ``SLO_TARGET_AVAILABILITY``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.telemetry.metrics import (
    Histogram,
    MetricsRegistry,
    _label_key,
)
from elasticsearch_tpu_torch.telemetry.shaping import (
    SLO_TARGET_AVAILABILITY,
    budget_burn_pct,
    latency_summary,
    quantile_ms as _quantile_ms,
    sum_buckets_into,
)

DEFAULT_TENANT = "_default"        # untagged requests
OVERFLOW_TENANT = "_other"         # folded evictions past the LRU cap
RESERVED_TENANTS = (DEFAULT_TENANT, OVERFLOW_TENANT)

DEFAULT_MAX_TENANTS = 64
MAX_TENANTS_SETTING = "tenants.max"
SLO_DEFAULT_MS_SETTING = "tenants.slo.default_ms"
SLO_OBJECTIVES_SETTING = "tenants.slo.objectives"

TENANT_LABEL = "tenant"

LATENCY_METRIC = "tenant.search.latency"

# counters folded into _other when their tenant is evicted (the
# latency histogram merges separately, bucket-wise)
_FOLD_COUNTERS = (
    "tenant.search.requests",
    "tenant.search.failed",
    "tenant.search.shards",
    "tenant.launch.ms",
    "tenant.cohort.slots",
    "tenant.readback.bytes",
    "tenant.indexing.bytes",
    "tenant.rejections",
    "tenant.breaker.trips",
    "tenant.slo.violations",
)


class TenantAccounting:
    """Bounded per-node tenant table over a shared MetricsRegistry."""

    def __init__(self, metrics: MetricsRegistry,
                 history=None,
                 max_tenants: int = DEFAULT_MAX_TENANTS,
                 slo_default_ms: Optional[float] = None,
                 slo_objectives: Optional[Dict[str, float]] = None):
        self.metrics = metrics
        self.history = history
        self.max_tenants = max(1, int(max_tenants))
        self.slo_default_ms = (float(slo_default_ms)
                               if slo_default_ms is not None else None)
        self.slo_objectives = {str(k): float(v)
                               for k, v in (slo_objectives or {}).items()}
        self._lock = threading.Lock()
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._reserved_used = set()
        self.evictions = 0

    @classmethod
    def from_settings(cls, settings_get, metrics: MetricsRegistry,
                      history=None) -> "TenantAccounting":
        raw_cap = settings_get(MAX_TENANTS_SETTING)
        raw_slo = settings_get(SLO_DEFAULT_MS_SETTING)
        raw_obj = settings_get(SLO_OBJECTIVES_SETTING)
        return cls(
            metrics, history=history,
            max_tenants=(int(raw_cap) if raw_cap is not None
                         else DEFAULT_MAX_TENANTS),
            slo_default_ms=(float(raw_slo) if raw_slo is not None
                            else None),
            slo_objectives=(raw_obj if isinstance(raw_obj, dict)
                            else None))

    # -- admission / LRU ---------------------------------------------------

    def resolve(self, tenant: Optional[str]) -> str:
        """Canonicalize a raw tenant id to its accounting bucket: None/
        empty → ``_default``; a known tenant refreshes its LRU slot; a
        NEW tenant at the cap evicts the least-recently-active one into
        ``_other`` first, then is admitted."""
        t = str(tenant) if tenant else DEFAULT_TENANT
        if t in RESERVED_TENANTS:
            with self._lock:
                self._reserved_used.add(t)
            return t
        evicted = None
        with self._lock:
            if t in self._lru:
                self._lru.move_to_end(t)
                return t
            if len(self._lru) >= self.max_tenants:
                evicted, _ = self._lru.popitem(last=False)
                self.evictions += 1
                self._reserved_used.add(OVERFLOW_TENANT)
            self._lru[t] = None
        if evicted is not None:
            self._fold_into_other(evicted)
        return t

    def _peek(self, name: str, tenant: str):
        """A live series without get-or-create (eviction must not mint
        series for tenants that never recorded one)."""
        key = (name, _label_key({TENANT_LABEL: tenant}))
        with self.metrics._lock:
            return self.metrics._metrics.get(key)

    def _fold_into_other(self, tenant: str) -> None:
        """Fold an evicted tenant's totals into ``_other`` (counters by
        value, the latency histogram bucket-wise — exemplar slots do
        NOT fold: they die with the pruned series), then prune its
        labeled series from the registry and scrub the history ring."""
        for name in _FOLD_COUNTERS:
            src = self._peek(name, tenant)
            if src is not None and src.value:
                self.metrics.inc(name, src.value,
                                 **{TENANT_LABEL: OVERFLOW_TENANT})
        src_h = self._peek(LATENCY_METRIC, tenant)
        if isinstance(src_h, Histogram):
            dst = self.metrics.histogram(
                LATENCY_METRIC, **{TENANT_LABEL: OVERFLOW_TENANT})
            with src_h._lock:
                counts = list(src_h.counts)
                cnt, sm = src_h.count, src_h.sum
                mn, mx = src_h.min, src_h.max
            with dst._lock:
                for i, c in enumerate(counts):
                    dst.counts[i] += c
                dst.count += cnt
                dst.sum += sm
                if mn is not None:
                    dst.min = mn if dst.min is None else min(dst.min, mn)
                if mx is not None:
                    dst.max = mx if dst.max is None else max(dst.max, mx)
                dst._cum_cache = None
        self.metrics.prune_label(TENANT_LABEL, tenant)
        if self.history is not None:
            self.history.prune_label(TENANT_LABEL, tenant)

    def active_tenants(self) -> List[str]:
        """Sorted live bucket ids: admitted tenants plus any reserved
        bucket that has recorded activity."""
        with self._lock:
            out = set(self._lru) | set(self._reserved_used)
        return sorted(out)

    # -- SLO ---------------------------------------------------------------

    def objective_ms(self, tenant: str) -> Optional[float]:
        return self.slo_objectives.get(tenant, self.slo_default_ms)

    # -- recording sinks (one branch per instrumented site) ----------------

    def record_search(self, tenant: Optional[str], took_ms: float,
                      failed: bool = False, shards: int = 0) -> None:
        t = self.resolve(tenant)
        lbl = {TENANT_LABEL: t}
        m = self.metrics
        m.inc("tenant.search.requests", **lbl)
        m.observe(LATENCY_METRIC, float(took_ms), **lbl)
        if failed:
            m.inc("tenant.search.failed", **lbl)
        if shards:
            m.inc("tenant.search.shards", int(shards), **lbl)
        obj = self.objective_ms(t)
        if obj is not None and took_ms > obj:
            m.inc("tenant.slo.violations", **lbl)

    def record_launch(self, tenant: Optional[str], launch_ms: float) -> None:
        if launch_ms > 0:
            self.metrics.inc("tenant.launch.ms", float(launch_ms),
                             **{TENANT_LABEL: self.resolve(tenant)})

    def record_cohort(self, tenant: Optional[str], slots: int = 1) -> None:
        self.metrics.inc("tenant.cohort.slots", int(slots),
                         **{TENANT_LABEL: self.resolve(tenant)})

    def record_readback(self, tenant: Optional[str], nbytes: int) -> None:
        if nbytes:
            self.metrics.inc("tenant.readback.bytes", int(nbytes),
                             **{TENANT_LABEL: self.resolve(tenant)})

    def record_indexing(self, tenant: Optional[str], nbytes: int) -> None:
        if nbytes:
            self.metrics.inc("tenant.indexing.bytes", int(nbytes),
                             **{TENANT_LABEL: self.resolve(tenant)})

    def record_rejection(self, tenant: Optional[str],
                         stage: str = "") -> None:
        # stage is folded (not a label): tenant is the only accounting
        # dimension here, so cardinality stays tenant-bounded
        self.metrics.inc("tenant.rejections",
                         **{TENANT_LABEL: self.resolve(tenant)})

    def record_breaker_trip(self, tenant: Optional[str],
                            breaker: str = "") -> None:
        self.metrics.inc("tenant.breaker.trips",
                         **{TENANT_LABEL: self.resolve(tenant)})

    # -- shaping (ONE impl behind /_tenants/stats, /_cat/tenants, ---------
    # -- and the _nodes/stats top-N slice) ---------------------------------

    def _value(self, name: str, tenant: str) -> float:
        m = self._peek(name, tenant)
        return float(m.value) if m is not None else 0.0

    def _tenant_entry(self, t: str) -> Dict[str, Any]:
        hist = self._peek(LATENCY_METRIC, t)
        if isinstance(hist, Histogram):
            hd = hist.to_dict()
            buckets = hd["buckets"]
            lat = latency_summary(buckets, hd["count"], hd["sum"])
        else:
            buckets = {}
            lat = latency_summary({}, 0, 0.0)
        requests = self._value("tenant.search.requests", t)
        violations = self._value("tenant.slo.violations", t)
        obj = self.objective_ms(t)
        burn = budget_burn_pct(requests, violations)
        return {
            "search": {
                "count": int(requests),
                "failed": int(self._value("tenant.search.failed", t)),
                "shard_fanout": int(self._value("tenant.search.shards", t)),
                "latency": lat,
                "latency_buckets": dict(buckets),
            },
            "device": {
                "launch_ms": round(self._value("tenant.launch.ms", t), 3),
                "readback_bytes": int(
                    self._value("tenant.readback.bytes", t)),
                "cohort_slots": int(self._value("tenant.cohort.slots", t)),
            },
            "indexing": {
                "bytes": int(self._value("tenant.indexing.bytes", t)),
                "rejections": int(self._value("tenant.rejections", t)),
                "breaker_trips": int(
                    self._value("tenant.breaker.trips", t)),
            },
            "slo": {
                "objective_ms": obj,
                "violations": int(violations),
                "budget_burn_pct": burn,
            },
        }

    def stats(self) -> Dict[str, Any]:
        """The per-node ``_tenants/stats`` section: every live bucket's
        dimensioned totals, deterministically ordered."""
        return {
            "cardinality": {
                "live": len(self.active_tenants()),
                "max": self.max_tenants,
                "evictions": self.evictions,
            },
            "tenants": {t: self._tenant_entry(t)
                        for t in self.active_tenants()},
        }

    def top_n(self, n: int = 8) -> List[Dict[str, Any]]:
        """The `_nodes/stats` slice: the N busiest tenants by search
        count (launch-ms, then name, break ties)."""
        rows = []
        for t in self.active_tenants():
            e = self._tenant_entry(t)
            rows.append({
                "tenant": t,
                "search_count": e["search"]["count"],
                "p99_ms": e["search"]["latency"]["p99_ms"],
                "launch_ms": e["device"]["launch_ms"],
                "cohort_slots": e["device"]["cohort_slots"],
                "rejections": e["indexing"]["rejections"],
                "slo_violations": e["slo"]["violations"],
            })
        rows.sort(key=lambda r: (-r["search_count"], -r["launch_ms"],
                                 r["tenant"]))
        return rows[:max(0, int(n))]


# ---------------------------------------------------------------------------
# cluster shaping: deterministic merge + the cat render — ONE impl, two
# surfaces (the `_cat/health` pattern)
# ---------------------------------------------------------------------------

def merge_tenant_stats(per_node: Dict[str, Dict[str, Any]],
                       node_failures: Optional[List[Dict[str, Any]]] = None
                       ) -> Dict[str, Any]:
    """Merge per-node ``TenantAccounting.stats()`` sections into the
    cluster ``_tenants/stats`` body. Deterministic: nodes iterate in
    sorted id order, tenants in sorted id order, and p50/p99 recompute
    from the SUMMED latency buckets (quantiles of quantiles would
    depend on node count, summed cumulative buckets do not)."""
    tenants: Dict[str, Dict[str, Any]] = {}
    cardinality = {"live": 0, "max": 0, "evictions": 0}
    for node_id in sorted(per_node):
        section = per_node[node_id] or {}
        card = section.get("cardinality", {})
        cardinality["max"] = max(cardinality["max"],
                                 int(card.get("max", 0)))
        cardinality["evictions"] += int(card.get("evictions", 0))
        for t in sorted(section.get("tenants", {})):
            e = section["tenants"][t]
            agg = tenants.setdefault(t, {
                "search": {"count": 0, "failed": 0, "shard_fanout": 0},
                "_lat_count": 0, "_lat_sum": 0.0, "_lat_buckets": {},
                "device": {"launch_ms": 0.0, "readback_bytes": 0,
                           "cohort_slots": 0},
                "indexing": {"bytes": 0, "rejections": 0,
                             "breaker_trips": 0},
                "slo": {"objective_ms": None, "violations": 0},
            })
            for k in ("count", "failed", "shard_fanout"):
                agg["search"][k] += int(e["search"][k])
            lat = e["search"]["latency"]
            agg["_lat_count"] += int(lat["count"])
            agg["_lat_sum"] += float(lat["sum_ms"])
            sum_buckets_into(agg["_lat_buckets"],
                             e["search"].get("latency_buckets", {}))
            agg["device"]["launch_ms"] = round(
                agg["device"]["launch_ms"]
                + float(e["device"]["launch_ms"]), 3)
            for k in ("readback_bytes", "cohort_slots"):
                agg["device"][k] += int(e["device"][k])
            for k in ("bytes", "rejections", "breaker_trips"):
                agg["indexing"][k] += int(e["indexing"][k])
            if agg["slo"]["objective_ms"] is None:
                agg["slo"]["objective_ms"] = e["slo"]["objective_ms"]
            agg["slo"]["violations"] += int(e["slo"]["violations"])
    out_tenants: Dict[str, Any] = {}
    for t in sorted(tenants):
        agg = tenants[t]
        buckets = agg.pop("_lat_buckets")
        count = agg.pop("_lat_count")
        sum_ms = agg.pop("_lat_sum")
        agg["search"]["latency"] = {
            "count": count, "sum_ms": round(sum_ms, 3),
            "p50_ms": _quantile_ms(buckets, 0.50),
            "p99_ms": _quantile_ms(buckets, 0.99)}
        agg["slo"]["budget_burn_pct"] = budget_burn_pct(
            agg["search"]["count"], agg["slo"]["violations"])
        out_tenants[t] = agg
    cardinality["live"] = len(out_tenants)
    out: Dict[str, Any] = {
        "cardinality": cardinality,
        "tenants": out_tenants,
        "nodes": sorted(per_node),
    }
    if node_failures:
        out["node_failures"] = node_failures
    return out


_CAT_COLUMNS = ("tenant", "search.count", "search.p50_ms",
                "search.p99_ms", "slo.violations", "slo.burn_pct",
                "launch.ms", "readback.bytes", "indexing.bytes",
                "rejections")


def render_cat_tenants(merged: Dict[str, Any]) -> str:
    """``GET /_cat/tenants``: the merged stats as aligned text columns,
    one tenant per row, sorted by tenant id — the same shaping helper
    as the JSON surface, a different render."""
    rows = [_CAT_COLUMNS]
    for t in sorted(merged.get("tenants", {})):
        e = merged["tenants"][t]
        rows.append((
            t,
            str(e["search"]["count"]),
            f"{e['search']['latency']['p50_ms']:g}",
            f"{e['search']['latency']['p99_ms']:g}",
            str(e["slo"]["violations"]),
            f"{e['slo']['budget_burn_pct']:g}",
            f"{e['device']['launch_ms']:g}",
            str(e["device"]["readback_bytes"]),
            str(e["indexing"]["bytes"]),
            str(e["indexing"]["rejections"]),
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(_CAT_COLUMNS))]
    return "\n".join(
        " ".join(cell.ljust(widths[i]) for i, cell in enumerate(row)).rstrip()
        for row in rows)
