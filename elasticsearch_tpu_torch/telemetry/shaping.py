"""Shared stat-shaping helpers: ONE quantile/burn implementation
behind every accounting surface.

``/_tenants/stats`` and ``/_workload/stats`` both merge per-node
sections by summing cumulative latency buckets and recomputing
quantiles from the SUM (quantiles of quantiles would depend on node
count; summed cumulative buckets do not). The recompute lived inside
``telemetry/tenants.py`` until the workload table needed the identical
shaping — extracting it here is the ``_cat/health`` convention: one
implementation, many surfaces, no drift.

Everything here is deterministic: bucket-bound estimates with no
interpolation and no sketch state, so two runs observing the same
values render byte-identical numbers.
"""

from __future__ import annotations

from typing import Any, Dict

from elasticsearch_tpu_torch.telemetry.metrics import DEFAULT_BUCKETS_MS

# availability target error-budget burn is computed against: with
# 0.99, a bucket is allowed 1% of its requests over objective before
# its budget reads 100% burned
SLO_TARGET_AVAILABILITY = 0.99


def quantile_ms(cum_buckets: Dict[str, int], q: float) -> float:
    """Deterministic quantile estimate from a cumulative ``le_*``
    bucket render: the upper bound of the first bucket whose cumulative
    count covers the quantile. The overflow bucket reports the largest
    finite boundary (no interpolation, no t-digest state — two runs
    observing the same values render the same number)."""
    total = cum_buckets.get("le_inf", 0)
    if total <= 0:
        return 0.0
    need = q * total
    for b in DEFAULT_BUCKETS_MS:
        if cum_buckets.get(f"le_{b:g}", 0) >= need:
            return float(b)
    return float(DEFAULT_BUCKETS_MS[-1])


def latency_summary(cum_buckets: Dict[str, int], count: int,
                    sum_ms: float) -> Dict[str, Any]:
    """The ``latency`` sub-document every accounting surface renders:
    count/sum plus bucket-bound p50/p99 from ONE recompute."""
    return {"count": int(count), "sum_ms": round(float(sum_ms), 3),
            "p50_ms": quantile_ms(cum_buckets, 0.50),
            "p99_ms": quantile_ms(cum_buckets, 0.99)}


def sum_buckets_into(agg: Dict[str, int],
                     buckets: Dict[str, int]) -> None:
    """Accumulate one node's cumulative bucket render into the merge
    accumulator (the summed-bucket half the quantile recompute reads)."""
    for b, c in (buckets or {}).items():
        agg[b] = agg.get(b, 0) + int(c)


def budget_burn_pct(requests: float, violations: float,
                    target: float = SLO_TARGET_AVAILABILITY) -> float:
    """Error-budget burn as a percentage of the violation rate the
    availability target allows. Zero requests with violations reads
    fully burned (a violation with no budget to spend it from)."""
    allowed = (1.0 - target) * requests
    if allowed > 0:
        return round(100.0 * violations / allowed, 1)
    return 100.0 if violations else 0.0
