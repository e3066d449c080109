"""Workload-class accounting: the request-class half of ROADMAP item 5b.

Tenants answer *who* a request belongs to; workload classes answer
*what kind* of work it is. The taxonomy is the Rally-style macro
harness's request mix — ``interactive`` search (bm25/bool/knn),
``bulk`` indexing, ``aggs``, ``scroll``/PIT drains, and ``async``
search — and the label rides the same ambient context rail as
trace.id/tenant (telemetry/context.py ``X-Workload-Class``), so
coordinator phases, batcher cohorts, flight-recorder events, slowlog
entries, and tasks all attribute by class without threading an
argument anywhere.

The table is the TenantAccounting pattern verbatim: one bounded
``WorkloadAccounting`` per node over the shared ``MetricsRegistry``
(``workload=<class>`` labels, so the history ring windows per-class
rates for free), a reserved ``_default`` bucket for unclassified work,
an ``_other`` fold past the LRU cap (the taxonomy is small, but a
caller-supplied header can mint arbitrary classes — cardinality stays
a hard invariant, not a hope), fold-on-evict with registry AND
history-ring pruning, and deterministic bucket-bound p50/p99 through
``telemetry/shaping.py`` (the ONE quantile recompute ``/_tenants/stats``
uses too).

SLO objectives are per class (``workload.slo.objectives`` setting with
built-in defaults: interactive work is held to a tight latency bound,
drains get a loose one); a request slower than its class objective
burns that class's error budget, and the ``workload_slo`` health
indicator goes YELLOW/RED on windowed burn with a typed diagnosis
naming the burning class.
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
    quantile_ms,
    sum_buckets_into,
)

DEFAULT_CLASS = "_default"         # unclassified requests
OVERFLOW_CLASS = "_other"          # folded evictions past the LRU cap
RESERVED_CLASSES = (DEFAULT_CLASS, OVERFLOW_CLASS)

# the macro-harness taxonomy (callers may mint others via the header;
# the LRU cap bounds them)
CLASS_INTERACTIVE = "interactive"
CLASS_BULK = "bulk"
CLASS_AGGS = "aggs"
CLASS_SCROLL = "scroll"
CLASS_ASYNC = "async"
KNOWN_CLASSES = (CLASS_INTERACTIVE, CLASS_BULK, CLASS_AGGS,
                 CLASS_SCROLL, CLASS_ASYNC)

DEFAULT_MAX_CLASSES = 16
MAX_CLASSES_SETTING = "workload.max"
SLO_DEFAULT_MS_SETTING = "workload.slo.default_ms"
SLO_OBJECTIVES_SETTING = "workload.slo.objectives"

# built-in per-class latency objectives (virtual ms under the sim,
# wall ms in production): interactive search is the tight bound the
# fleet's users feel; drains and background work get loose ones.
# A class absent here (bulk) carries no latency objective by default —
# its health is the acked-write contract, not a latency SLO.
DEFAULT_SLO_OBJECTIVES_MS = {
    CLASS_INTERACTIVE: 100.0,
    CLASS_AGGS: 500.0,
    CLASS_SCROLL: 1000.0,
    CLASS_ASYNC: 5000.0,
}

WORKLOAD_LABEL = "workload"

LATENCY_METRIC = "workload.search.latency"

# counters folded into _other when their class is evicted (the
# latency histogram merges separately, bucket-wise)
_FOLD_COUNTERS = (
    "workload.search.requests",
    "workload.search.failed",
    "workload.cohort.slots",
    "workload.launch.ms",
    "workload.indexing.bytes",
    "workload.rejections",
    "workload.slo.violations",
)


def classify_search_request(body: Optional[Dict[str, Any]],
                            scroll: Optional[Any] = None) -> str:
    """Derive the workload class of a search request from its shape —
    the boundary-side half of the taxonomy (an explicit
    ``X-Workload-Class`` header always wins upstream of this):
    cursor-plane work (scroll open, PIT search) is ``scroll``,
    aggregation-bearing bodies are ``aggs``, everything else —
    bm25/bool/knn alike — is ``interactive``."""
    body = body or {}
    if scroll is not None or body.get("pit"):
        return CLASS_SCROLL
    if body.get("aggs") or body.get("aggregations"):
        return CLASS_AGGS
    return CLASS_INTERACTIVE


class WorkloadAccounting:
    """Bounded per-node workload-class table over a shared
    MetricsRegistry (the TenantAccounting pattern)."""

    def __init__(self, metrics: MetricsRegistry,
                 history=None,
                 max_classes: int = DEFAULT_MAX_CLASSES,
                 slo_default_ms: Optional[float] = None,
                 slo_objectives: Optional[Dict[str, float]] = None):
        self.metrics = metrics
        self.history = history
        self.max_classes = max(1, int(max_classes))
        self.slo_default_ms = (float(slo_default_ms)
                               if slo_default_ms is not None else None)
        objectives = dict(DEFAULT_SLO_OBJECTIVES_MS)
        for k, v in (slo_objectives or {}).items():
            objectives[str(k)] = float(v)
        self.slo_objectives = objectives
        self._lock = threading.Lock()
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._reserved_used = set()
        self.evictions = 0

    @classmethod
    def from_settings(cls, settings_get, metrics: MetricsRegistry,
                      history=None) -> "WorkloadAccounting":
        raw_cap = settings_get(MAX_CLASSES_SETTING)
        raw_slo = settings_get(SLO_DEFAULT_MS_SETTING)
        raw_obj = settings_get(SLO_OBJECTIVES_SETTING)
        return cls(
            metrics, history=history,
            max_classes=(int(raw_cap) if raw_cap is not None
                         else DEFAULT_MAX_CLASSES),
            slo_default_ms=(float(raw_slo) if raw_slo is not None
                            else None),
            slo_objectives=(raw_obj if isinstance(raw_obj, dict)
                            else None))

    # -- admission / LRU ---------------------------------------------------

    def resolve(self, wclass: Optional[str]) -> str:
        """Canonicalize a raw class label to its accounting bucket:
        None/empty → ``_default``; a known class refreshes its LRU
        slot; a NEW class at the cap evicts the least-recently-active
        one into ``_other`` first, then is admitted."""
        c = str(wclass) if wclass else DEFAULT_CLASS
        if c in RESERVED_CLASSES:
            with self._lock:
                self._reserved_used.add(c)
            return c
        evicted = None
        with self._lock:
            if c in self._lru:
                self._lru.move_to_end(c)
                return c
            if len(self._lru) >= self.max_classes:
                evicted, _ = self._lru.popitem(last=False)
                self.evictions += 1
                self._reserved_used.add(OVERFLOW_CLASS)
            self._lru[c] = None
        if evicted is not None:
            self._fold_into_other(evicted)
        return c

    def _peek(self, name: str, wclass: str):
        """A live series without get-or-create (eviction must not mint
        series for classes that never recorded one)."""
        key = (name, _label_key({WORKLOAD_LABEL: wclass}))
        with self.metrics._lock:
            return self.metrics._metrics.get(key)

    def _fold_into_other(self, wclass: str) -> None:
        """Fold an evicted class's totals into ``_other`` (counters by
        value, the latency histogram bucket-wise), then prune its
        labeled series from the registry and scrub the history ring —
        the same both-halves prune TenantAccounting does."""
        for name in _FOLD_COUNTERS:
            src = self._peek(name, wclass)
            if src is not None and src.value:
                self.metrics.inc(name, src.value,
                                 **{WORKLOAD_LABEL: OVERFLOW_CLASS})
        src_h = self._peek(LATENCY_METRIC, wclass)
        if isinstance(src_h, Histogram):
            dst = self.metrics.histogram(
                LATENCY_METRIC, **{WORKLOAD_LABEL: OVERFLOW_CLASS})
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
        self.metrics.prune_label(WORKLOAD_LABEL, wclass)
        if self.history is not None:
            self.history.prune_label(WORKLOAD_LABEL, wclass)

    def active_classes(self) -> List[str]:
        """Sorted live bucket ids: admitted classes plus any reserved
        bucket that has recorded activity."""
        with self._lock:
            out = set(self._lru) | set(self._reserved_used)
        return sorted(out)

    # -- SLO ---------------------------------------------------------------

    def objective_ms(self, wclass: str) -> Optional[float]:
        return self.slo_objectives.get(wclass, self.slo_default_ms)

    # -- recording sinks (one branch per instrumented site) ----------------

    def record_search(self, wclass: Optional[str], took_ms: float,
                      failed: bool = False) -> None:
        c = self.resolve(wclass)
        lbl = {WORKLOAD_LABEL: c}
        m = self.metrics
        m.inc("workload.search.requests", **lbl)
        m.observe(LATENCY_METRIC, float(took_ms), **lbl)
        if failed:
            m.inc("workload.search.failed", **lbl)
        obj = self.objective_ms(c)
        if obj is not None and took_ms > obj:
            m.inc("workload.slo.violations", **lbl)

    def record_launch(self, wclass: Optional[str],
                      launch_ms: float) -> None:
        if launch_ms > 0:
            self.metrics.inc("workload.launch.ms", float(launch_ms),
                             **{WORKLOAD_LABEL: self.resolve(wclass)})

    def record_cohort(self, wclass: Optional[str], slots: int = 1) -> None:
        self.metrics.inc("workload.cohort.slots", int(slots),
                         **{WORKLOAD_LABEL: self.resolve(wclass)})

    def record_indexing(self, wclass: Optional[str], nbytes: int) -> None:
        if nbytes:
            self.metrics.inc("workload.indexing.bytes", int(nbytes),
                             **{WORKLOAD_LABEL: self.resolve(wclass)})

    def record_rejection(self, wclass: Optional[str],
                         stage: str = "") -> None:
        # stage is folded (not a label): class is the only accounting
        # dimension here, so cardinality stays class-bounded
        self.metrics.inc("workload.rejections",
                         **{WORKLOAD_LABEL: self.resolve(wclass)})

    # -- shaping (ONE impl behind /_workload/stats, /_cat/workload, --------
    # -- and the _nodes/stats slice) ---------------------------------------

    def _value(self, name: str, wclass: str) -> float:
        m = self._peek(name, wclass)
        return float(m.value) if m is not None else 0.0

    def _class_entry(self, c: str) -> Dict[str, Any]:
        hist = self._peek(LATENCY_METRIC, c)
        if isinstance(hist, Histogram):
            hd = hist.to_dict()
            buckets = hd["buckets"]
            lat = latency_summary(buckets, hd["count"], hd["sum"])
        else:
            buckets = {}
            lat = latency_summary({}, 0, 0.0)
        requests = self._value("workload.search.requests", c)
        violations = self._value("workload.slo.violations", c)
        return {
            "search": {
                "count": int(requests),
                "failed": int(self._value("workload.search.failed", c)),
                "latency": lat,
                "latency_buckets": dict(buckets),
            },
            "device": {
                "launch_ms": round(
                    self._value("workload.launch.ms", c), 3),
                "cohort_slots": int(
                    self._value("workload.cohort.slots", c)),
            },
            "indexing": {
                "bytes": int(self._value("workload.indexing.bytes", c)),
                "rejections": int(self._value("workload.rejections", c)),
            },
            "slo": {
                "objective_ms": self.objective_ms(c),
                "violations": int(violations),
                "budget_burn_pct": budget_burn_pct(requests, violations),
            },
        }

    def stats(self) -> Dict[str, Any]:
        """The per-node ``_workload/stats`` section: every live
        bucket's dimensioned totals, deterministically ordered."""
        return {
            "cardinality": {
                "live": len(self.active_classes()),
                "max": self.max_classes,
                "evictions": self.evictions,
            },
            "classes": {c: self._class_entry(c)
                        for c in self.active_classes()},
        }

    def top_n(self, n: int = 8) -> List[Dict[str, Any]]:
        """The `_nodes/stats` slice: the N busiest classes by search
        count (cohort slots, then name, break ties)."""
        rows = []
        for c in self.active_classes():
            e = self._class_entry(c)
            rows.append({
                "class": c,
                "search_count": e["search"]["count"],
                "p99_ms": e["search"]["latency"]["p99_ms"],
                "cohort_slots": e["device"]["cohort_slots"],
                "rejections": e["indexing"]["rejections"],
                "slo_violations": e["slo"]["violations"],
            })
        rows.sort(key=lambda r: (-r["search_count"],
                                 -r["cohort_slots"], r["class"]))
        return rows[:max(0, int(n))]


# ---------------------------------------------------------------------------
# cluster shaping: deterministic merge + the cat render — ONE impl, two
# surfaces (the `_cat/health` pattern, sharing telemetry/shaping.py with
# the tenant merge)
# ---------------------------------------------------------------------------

def merge_workload_stats(per_node: Dict[str, Dict[str, Any]],
                         node_failures: Optional[List[Dict[str, Any]]]
                         = None) -> Dict[str, Any]:
    """Merge per-node ``WorkloadAccounting.stats()`` sections into the
    cluster ``_workload/stats`` body. Deterministic: nodes iterate in
    sorted id order, classes in sorted id order, and p50/p99 recompute
    from the SUMMED latency buckets via telemetry/shaping.py (the same
    recompute merge_tenant_stats uses)."""
    classes: Dict[str, Dict[str, Any]] = {}
    cardinality = {"live": 0, "max": 0, "evictions": 0}
    for node_id in sorted(per_node):
        section = per_node[node_id] or {}
        card = section.get("cardinality", {})
        cardinality["max"] = max(cardinality["max"],
                                 int(card.get("max", 0)))
        cardinality["evictions"] += int(card.get("evictions", 0))
        for c in sorted(section.get("classes", {})):
            e = section["classes"][c]
            agg = classes.setdefault(c, {
                "search": {"count": 0, "failed": 0},
                "_lat_count": 0, "_lat_sum": 0.0, "_lat_buckets": {},
                "device": {"launch_ms": 0.0, "cohort_slots": 0},
                "indexing": {"bytes": 0, "rejections": 0},
                "slo": {"objective_ms": None, "violations": 0},
            })
            for k in ("count", "failed"):
                agg["search"][k] += int(e["search"][k])
            lat = e["search"]["latency"]
            agg["_lat_count"] += int(lat["count"])
            agg["_lat_sum"] += float(lat["sum_ms"])
            sum_buckets_into(agg["_lat_buckets"],
                             e["search"].get("latency_buckets", {}))
            agg["device"]["launch_ms"] = round(
                agg["device"]["launch_ms"]
                + float(e["device"]["launch_ms"]), 3)
            agg["device"]["cohort_slots"] += int(
                e["device"]["cohort_slots"])
            for k in ("bytes", "rejections"):
                agg["indexing"][k] += int(e["indexing"][k])
            if agg["slo"]["objective_ms"] is None:
                agg["slo"]["objective_ms"] = e["slo"]["objective_ms"]
            agg["slo"]["violations"] += int(e["slo"]["violations"])
    out_classes: Dict[str, Any] = {}
    for c in sorted(classes):
        agg = classes[c]
        buckets = agg.pop("_lat_buckets")
        count = agg.pop("_lat_count")
        sum_ms = agg.pop("_lat_sum")
        agg["search"]["latency"] = {
            "count": count, "sum_ms": round(sum_ms, 3),
            "p50_ms": quantile_ms(buckets, 0.50),
            "p99_ms": quantile_ms(buckets, 0.99)}
        agg["slo"]["budget_burn_pct"] = budget_burn_pct(
            agg["search"]["count"], agg["slo"]["violations"])
        out_classes[c] = agg
    cardinality["live"] = len(out_classes)
    out: Dict[str, Any] = {
        "cardinality": cardinality,
        "classes": out_classes,
        "nodes": sorted(per_node),
    }
    if node_failures:
        out["node_failures"] = node_failures
    return out


_CAT_COLUMNS = ("class", "search.count", "search.p50_ms",
                "search.p99_ms", "slo.objective_ms", "slo.violations",
                "slo.burn_pct", "cohort.slots", "indexing.bytes",
                "rejections")


def render_cat_workload(merged: Dict[str, Any]) -> str:
    """``GET /_cat/workload``: the merged stats as aligned text
    columns, one class per row, sorted by class id — the same shaping
    helper as the JSON surface, a different render."""
    rows = [_CAT_COLUMNS]
    for c in sorted(merged.get("classes", {})):
        e = merged["classes"][c]
        obj = e["slo"]["objective_ms"]
        rows.append((
            c,
            str(e["search"]["count"]),
            f"{e['search']['latency']['p50_ms']:g}",
            f"{e['search']['latency']['p99_ms']:g}",
            "-" if obj is None else f"{obj:g}",
            str(e["slo"]["violations"]),
            f"{e['slo']['budget_burn_pct']:g}",
            str(e["device"]["cohort_slots"]),
            str(e["indexing"]["bytes"]),
            str(e["indexing"]["rejections"]),
        ))
    widths = [max(len(r[i]) for r in rows)
              for i in range(len(_CAT_COLUMNS))]
    return "\n".join(
        " ".join(cell.ljust(widths[i])
                 for i, cell in enumerate(row)).rstrip()
        for row in rows)


# re-exported so callers needing the availability target import one name
__all__ = [
    "CLASS_AGGS", "CLASS_ASYNC", "CLASS_BULK", "CLASS_INTERACTIVE",
    "CLASS_SCROLL", "DEFAULT_CLASS", "KNOWN_CLASSES", "OVERFLOW_CLASS",
    "SLO_TARGET_AVAILABILITY", "WORKLOAD_LABEL", "WorkloadAccounting",
    "classify_search_request", "merge_workload_stats",
    "render_cat_workload",
]
