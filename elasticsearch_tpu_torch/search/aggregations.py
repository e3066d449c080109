"""Aggregations: the bucket/metric/pipeline tree beside the top-k
collector (counterpart of elasticsearch_tpu/search/aggregations.py,
reduced to this slice's types).

The query phase hands every segment's match mask to the host (after the
live mask and ``min_score``, before ``post_filter``); every bucket is a
boolean refinement of those masks and every metric a vectorized
reduction over the masked columnar doc values; sub-aggs recurse over the
refined masks. The reduction moves to the device (ops/aggs.py) under
the reference's rules, which decide which answers are float32:

- a keyword ``terms`` agg on a segment of at least
  ``DEVICE_AGG_MIN_DOCS`` docs counts through the field's ord-major
  permutation;
- ``sum``/``min``/``max``/``avg``/``value_count``/``stats`` without a
  ``missing`` value take one fused launch per segment when every
  contributing segment clears the doc gate and the column is
  single-valued and exact in float32 (``_f32_exact``: |v| <= 2^24);
  ``extended_stats`` stays on the host (its float32 sum of squares
  cancels);
- a fixed-interval ``histogram``/``date_histogram`` whose sub-aggs are
  all such metrics scatters counts and metric columns on the device
  (bucket ids computed on the host in float64), up to
  ``AGG_BUCKET_CAP`` buckets; calendar intervals stay on the host.

A gate that routes to the host is a rule; a device error raises and
fails the request (no host fallback hides the card).

Served types:
- metrics: avg, sum, min, max, value_count, stats, extended_stats,
  cardinality, percentiles, percentile_ranks, weighted_avg;
- buckets: terms (keyword, else numeric), histogram, date_histogram
  (fixed and calendar), range, date_range, filter, filters, missing,
  global;
- sibling pipelines: avg_bucket, sum_bucket, min_bucket, max_bucket,
  stats_bucket, extended_stats_bucket, percentiles_bucket (and the
  sibling forms of cumulative_sum, derivative, bucket_sort);
- parent pipelines: cumulative_sum, derivative, bucket_sort.

Every other type the reference knows answers ``SliceUnsupported`` (a
typed 400) wherever it stands in the tree (``check_aggs_in_slice``,
before anything is computed); a name it does not know is a
``ParsingException`` where the tree reaches it, as in the reference.
"""

from __future__ import annotations

import contextvars
import math
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.ops import aggs as agg_ops
from elasticsearch_tpu_torch.ops.device import readback
from elasticsearch_tpu_torch.search.context import SegmentContext, ShardStats
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.queries import (ParsingException,
                                                    parse_query)
from elasticsearch_tpu_torch.search.sketches import (DEFAULT_COMPRESSION,
                                                     TDigest)

# A collect context: (segment, host mask bool [n_docs], mapper) triples
# covering the shard's segments.
CollectCtx = List[Tuple[Any, np.ndarray, Any]]

# every type the reference knows
METRIC_AGGS = {"avg", "sum", "min", "max", "value_count", "stats",
               "extended_stats", "cardinality", "percentiles",
               "percentile_ranks", "top_hits", "weighted_avg",
               "geo_bounds", "geo_centroid", "scripted_metric",
               "boxplot", "top_metrics", "string_stats", "matrix_stats",
               "median_absolute_deviation", "t_test"}
BUCKET_AGGS = {"terms", "histogram", "date_histogram", "range",
               "date_range", "filter",
               "filters", "missing", "global", "composite", "nested",
               "significant_terms", "significant_text", "sampler",
               "diversified_sampler", "rare_terms", "multi_terms",
               "adjacency_matrix", "auto_date_histogram", "ip_range",
               "variable_width_histogram", "children", "parent",
               "geo_distance", "geohash_grid", "geotile_grid"}
PIPELINE_AGGS = {"avg_bucket", "sum_bucket", "min_bucket", "max_bucket",
                 "stats_bucket", "extended_stats_bucket",
                 "percentiles_bucket", "cumulative_sum", "derivative",
                 "bucket_sort", "cumulative_cardinality"}
PARENT_PIPELINES = {"cumulative_sum", "derivative",
                    "cumulative_cardinality", "bucket_sort",
                    "moving_fn", "moving_avg", "serial_diff",
                    "bucket_script", "bucket_selector",
                    "moving_percentiles", "normalize"}

# the types this slice serves
SLICE_AGGS = {"avg", "sum", "min", "max", "value_count", "stats",
              "extended_stats", "cardinality", "percentiles",
              "percentile_ranks", "weighted_avg",
              "terms", "histogram", "date_histogram", "range",
              "date_range", "filter", "filters", "missing", "global",
              "avg_bucket", "sum_bucket", "min_bucket", "max_bucket",
              "stats_bucket", "extended_stats_bucket",
              "percentiles_bucket", "cumulative_sum", "derivative",
              "bucket_sort"}
DEFERRED_AGGS = (METRIC_AGGS | BUCKET_AGGS | PIPELINE_AGGS
                 | PARENT_PIPELINES) - SLICE_AGGS

_NODE_KEYS = ("aggs", "aggregations", "meta")


def check_aggs_in_slice(spec: Dict[str, Any]) -> None:
    """Raise ``SliceUnsupported`` when any node of the aggs tree, at any
    depth, is a type the reference knows and this slice defers."""
    for name, node in (spec or {}).items():
        if not isinstance(node, dict):
            continue
        for t in node:
            if t in DEFERRED_AGGS:
                raise SliceUnsupported(
                    f"aggregation [{name}] of type [{t}] is a later slice "
                    f"of the port")
        sub = node.get("aggs", node.get("aggregations"))
        if isinstance(sub, dict):
            check_aggs_in_slice(sub)


# the request's DeviceSegmentCache, scoped per compute_aggs call
_DEVICE_CACHE: "contextvars.ContextVar" = contextvars.ContextVar(
    "agg_device_cache", default=None)


def compute_aggs(spec: Dict[str, Any], ctx: CollectCtx, mapper,
                 device_cache) -> Dict[str, Any]:
    """Evaluate an aggs tree; returns the ``aggregations`` response
    object. ``device_cache`` (the index's DeviceSegmentCache) is scoped
    to this computation through a contextvar, so concurrent searches of
    other indices never share it and nothing outlives the call."""
    check_aggs_in_slice(spec)
    token = _DEVICE_CACHE.set(device_cache)
    try:
        return _compute_aggs(spec, ctx, mapper)
    finally:
        _DEVICE_CACHE.reset(token)


def _compute_aggs(spec: Dict[str, Any], ctx: CollectCtx,
                  mapper) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    pipelines: List[Tuple[str, str, Dict[str, Any]]] = []
    for name, node in spec.items():
        agg_type, body, sub = _split_node(name, node)
        if agg_type in PIPELINE_AGGS:
            pipelines.append((name, agg_type, body))
            continue
        out[name] = _compute_one(agg_type, body, sub, ctx, mapper)
    for name, agg_type, body in pipelines:
        out[name] = _compute_pipeline(agg_type, body, out)
    return out


def _split_node(name, node):
    sub = node.get("aggs", node.get("aggregations", {}))
    types = [k for k in node if k not in _NODE_KEYS]
    if len(types) != 1:
        raise ParsingException(
            f"Expected exactly one aggregation type under [{name}], "
            f"got {types}")
    agg_type = types[0]
    if agg_type not in METRIC_AGGS | BUCKET_AGGS | PIPELINE_AGGS:
        raise ParsingException(f"Unknown aggregation type [{agg_type}]")
    return agg_type, node[agg_type] or {}, sub


def _compute_one(agg_type, body, sub, ctx, mapper):
    if agg_type in METRIC_AGGS:
        return _metric(agg_type, body, ctx)
    return _bucket(agg_type, body, sub, ctx, mapper)


# ---------------------------------------------------------------------------
# value sources
# ---------------------------------------------------------------------------

def _numeric_values(ctx: CollectCtx, field: str) -> np.ndarray:
    """All values (multi-value aware) of ``field`` for masked docs: the
    doc mask repeated over the per-doc value counts selects every value
    position."""
    chunks = []
    for seg, mask, _m in ctx:
        nv = seg.numerics.get(field)
        if nv is None:
            continue
        m = mask[: seg.n_docs] & ~nv.missing
        if not m.any():
            continue
        sel = np.repeat(m, np.diff(nv.offsets))
        chunks.append(nv.all_values[sel])
    return np.concatenate(chunks) if chunks else np.zeros(0)


def _first_values_and_mask(seg, mask, field):
    nv = seg.numerics.get(field)
    if nv is None:
        return None, None
    m = mask[: seg.n_docs] & ~nv.missing
    return nv.values, m


# at this many docs a segment's collectors ride the device; below it a
# host bincount wins
DEVICE_AGG_MIN_DOCS = 200_000

# zero-count gap fill materializes one bucket per step: cap the span so
# one sparse value pair (0 and 1e12 at interval 1) cannot exhaust memory
MAX_HISTOGRAM_BUCKETS = 65536


def _check_bucket_cap(n: int, agg_type: str) -> None:
    if n > MAX_HISTOGRAM_BUCKETS:
        raise IllegalArgumentException(
            f"[{agg_type}] would materialize [{n}] buckets "
            f"(> [{MAX_HISTOGRAM_BUCKETS}]); narrow the range or "
            "widen the interval")


def _upload(dev, host: np.ndarray) -> torch.Tensor:
    """A segment's host column [n_docs] (a mask, bucket ids), padded
    with zeros to the device segment's width and uploaded."""
    n = dev.n_docs
    return torch.from_numpy(np.pad(host[:n], (
        0, dev.n_docs_padded - n))).to(dev.device)


def _masked_ord_counts(kv, mask, n_docs) -> np.ndarray:
    """Per-ord value counts [n_terms] over masked docs: ragged expansion
    and a bincount."""
    m = mask[:n_docs]
    sel = np.repeat(m, np.diff(kv.offsets))
    return np.bincount(kv.all_ords[sel], minlength=len(kv.terms))


def _keyword_terms_counts(ctx: CollectCtx, field: str) -> Dict[str, int]:
    """term -> doc count over masked docs: the device collector through
    the ord-major permutation from DEVICE_AGG_MIN_DOCS docs, a host
    bincount below."""
    counts: Dict[str, int] = {}
    dev_cache = _DEVICE_CACHE.get()
    for seg, mask, _m in ctx:
        kv = seg.keywords.get(field)
        if kv is None:
            continue
        bc = None
        if seg.n_docs >= DEVICE_AGG_MIN_DOCS:
            dev = dev_cache.get(seg)
            om = dev.keyword_ord_major(field)
            if om is not None:
                bc = agg_ops.terms_counts_per_term(om[0], om[1],
                                                   _upload(dev, mask))
        if bc is None:
            bc = _masked_ord_counts(kv, mask, seg.n_docs)
        for o in np.nonzero(bc)[0]:
            term = kv.terms[int(o)]
            counts[term] = counts.get(term, 0) + int(bc[o])
    return counts


def _keyword_membership_mask(seg, field: str, term: str) -> np.ndarray:
    """bool [n_docs]: docs holding ``term`` in the keyword field
    (multi-value aware)."""
    kv = seg.keywords.get(field)
    out = np.zeros(seg.n_docs, bool)
    if kv is None:
        return out
    try:
        tid = kv.terms.index(term)
    except ValueError:
        return out
    positions = np.nonzero(kv.all_ords == tid)[0]
    docs = np.searchsorted(kv.offsets, positions, side="right") - 1
    out[docs] = True
    return out


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _metric(agg_type, body, ctx):
    field = body.get("field")
    missing_val = body.get("missing")

    if agg_type == "cardinality":
        # keyword or numeric distinct count (exact; the reference's
        # HLL++ is an approximation)
        distinct = set()
        for seg, mask, _m in ctx:
            kv = seg.keywords.get(field)
            if kv is not None:
                bc = _masked_ord_counts(kv, mask, seg.n_docs)
                distinct.update(kv.terms[int(o)]
                                for o in np.nonzero(bc)[0])
                continue
            nv = seg.numerics.get(field)
            if nv is not None:
                m = mask[: seg.n_docs] & ~nv.missing
                distinct.update(np.unique(nv.values[m]).tolist())
        return {"value": len(distinct)}

    if agg_type == "weighted_avg":
        vfield = body.get("value", {}).get("field")
        wfield = body.get("weight", {}).get("field")
        num = 0.0
        den = 0.0
        for seg, mask, _m in ctx:
            vv, vm = _first_values_and_mask(seg, mask, vfield)
            wv, wm = _first_values_and_mask(seg, mask, wfield)
            if vv is None or wv is None:
                continue
            m = vm & wm
            num += float((vv[m] * wv[m]).sum())
            den += float(wv[m].sum())
        return {"value": num / den if den else None}

    if missing_val is None and agg_type in (
            "sum", "min", "max", "avg", "value_count", "stats"):
        # one fused device launch per segment column when every
        # contributing segment clears the gates; extended_stats stays on
        # the host (its float32 sum of squares cancels: values ~1e7 over
        # 1M docs give std errors in the thousands)
        dev = _device_metric_stats(ctx, field)
        if dev is not None:
            return _shape_metric_from_stats(agg_type, dev)

    values = _numeric_values(ctx, field)
    if missing_val is not None:
        # docs matched but missing the field count as the `missing` value
        n_missing = 0
        for seg, mask, _m in ctx:
            nv = seg.numerics.get(field)
            miss = (nv.missing if nv is not None
                    else np.ones(seg.n_docs, bool))
            n_missing += int((mask[: seg.n_docs] & miss).sum())
        values = np.concatenate([values,
                                 np.full(n_missing, float(missing_val))])

    n = len(values)
    if agg_type == "value_count":
        return {"value": int(n)}
    if n == 0:
        if agg_type == "stats":
            return {"count": 0, "min": None, "max": None, "avg": None,
                    "sum": 0.0}
        if agg_type == "extended_stats":
            return {"count": 0, "min": None, "max": None, "avg": None,
                    "sum": 0.0, "sum_of_squares": None, "variance": None,
                    "std_deviation": None}
        if agg_type in ("percentiles", "percentile_ranks"):
            return {"values": {}}
        return {"value": None}
    if agg_type == "avg":
        return {"value": float(values.mean())}
    if agg_type == "sum":
        return {"value": float(values.sum())}
    if agg_type == "min":
        return {"value": float(values.min())}
    if agg_type == "max":
        return {"value": float(values.max())}
    if agg_type == "stats":
        return {"count": n, "min": float(values.min()),
                "max": float(values.max()), "avg": float(values.mean()),
                "sum": float(values.sum())}
    if agg_type == "extended_stats":
        var = float(values.var())
        return {"count": n, "min": float(values.min()),
                "max": float(values.max()), "avg": float(values.mean()),
                "sum": float(values.sum()),
                "sum_of_squares": float((values ** 2).sum()),
                "variance": var, "std_deviation": math.sqrt(var)}
    if agg_type == "percentiles":
        percents = body.get("percents", [1, 5, 25, 50, 75, 95, 99])
        digest = TDigest.from_values(values, _digest_compression(body))
        return {"values": {str(float(p)): digest.quantile(float(p))
                           for p in percents}}
    # percentile_ranks
    targets = body.get("values", [])
    digest = TDigest.from_values(values, _digest_compression(body))
    return {"values": {str(float(t)): digest.cdf(float(t)) * 100.0
                       for t in targets}}


def _digest_compression(body) -> int:
    """Centroid budget of the percentile family (``{"tdigest":
    {"compression": N}}``)."""
    td = body.get("tdigest") or {}
    try:
        return max(16, int(td.get("compression", DEFAULT_COMPRESSION)))
    except (TypeError, ValueError):
        raise ParsingException(
            f"invalid tdigest compression [{td.get('compression')!r}]")


def _shape_metric_from_stats(agg_type, stats):
    """The response object of a simple numeric metric from its (count,
    sum, min, max, sum_sq) moments, shaped as the host branch shapes it
    (the empty shapes too)."""
    n, s, mn, mx, ss = stats
    if agg_type == "value_count":
        return {"value": int(n)}
    if n == 0:
        if agg_type == "stats":
            return {"count": 0, "min": None, "max": None, "avg": None,
                    "sum": 0.0}
        return {"value": None}
    avg = s / n
    if agg_type == "avg":
        return {"value": avg}
    if agg_type == "sum":
        return {"value": s}
    if agg_type == "min":
        return {"value": mn}
    if agg_type == "max":
        return {"value": mx}
    return {"count": n, "min": mn, "max": mx, "avg": avg, "sum": s}


def _single_valued(nv) -> bool:
    """Whether a numeric column holds at most one value per doc (the
    device columns carry first values only). Cached on the immutable
    column."""
    cached = getattr(nv, "_single_valued", None)
    if cached is None:
        cached = bool(np.all(np.diff(nv.offsets) <= 1))
        nv._single_valued = cached
    return cached


# device columns are float32: past 2^24 the mantissa no longer holds
# integers exactly, so sums over large-magnitude fields (epoch-ms dates
# at ~1.7e12) would drift by minutes where the host float64 path is
# exact; such columns stay on the host
F32_EXACT_MAX = float(2 ** 24)


def _f32_exact(nv) -> bool:
    """Whether a column's values survive the float32 device column
    (|v| <= 2^24). Cached on the immutable column."""
    cached = getattr(nv, "_f32_exact", None)
    if cached is None:
        finite = nv.values[np.isfinite(nv.values)]
        cached = bool(finite.size == 0
                      or float(np.abs(finite).max()) <= F32_EXACT_MAX)
        nv._f32_exact = cached
    return cached


def _device_metric_stats(ctx, field):
    """Combined (count, sum, min, max, sum_sq) from one fused device
    launch per segment, or None (the host path) when a contributing
    segment is below DEVICE_AGG_MIN_DOCS or its column is multi-valued
    or not exact in float32."""
    if field is None:
        return None
    rows = [(seg, mask) for seg, mask, _m in ctx
            if seg.numerics.get(field) is not None]
    for seg, _mask in rows:
        nv = seg.numerics[field]
        if seg.n_docs < DEVICE_AGG_MIN_DOCS or not _single_valued(nv) \
                or not _f32_exact(nv):
            return None
    if not rows:
        return None
    dev_cache = _DEVICE_CACHE.get()
    parts = []
    for seg, mask in rows:
        dev = dev_cache.get(seg)
        parts.append(agg_ops.masked_metric_stats(
            dev.numerics[field], dev.numeric_missing[field],
            _upload(dev, mask)))
    n = sum(p[0] for p in parts)
    s = sum(p[1] for p in parts)
    ss = sum(p[4] for p in parts)
    mns = [p[2] for p in parts if p[2] is not None]
    mxs = [p[3] for p in parts if p[3] is not None]
    return (n, s, min(mns) if mns else None,
            max(mxs) if mxs else None, ss)


# sub-agg types the fused per-bucket device columns serve (not
# extended_stats: see _metric)
DEVICE_METRIC_SUBAGGS = {"sum", "min", "max", "avg", "value_count",
                         "stats"}


def _device_histogram_submetrics(regular_sub):
    """[(name, agg_type, field)] when EVERY sub-agg is a simple numeric
    metric the fused per-bucket columns serve; None otherwise."""
    sub_metrics = []
    for name, node in (regular_sub or {}).items():
        types = [k for k in node if k not in _NODE_KEYS]
        if len(types) != 1:
            return None
        t = types[0]
        b = node[t] or {}
        if t not in DEVICE_METRIC_SUBAGGS \
                or node.get("aggs") or node.get("aggregations") \
                or b.get("missing") is not None or b.get("script"):
            return None
        sub_metrics.append((name, t, b.get("field")))
    return sub_metrics


def _device_histogram_buckets(ctx, field, interval, min_doc_count,
                              gap_fill, key_of, is_date, regular_sub):
    """A fixed-interval histogram by device scatter-add: per-bucket doc
    counts plus every simple numeric metric sub-agg as per-bucket
    columns, one launch per (segment, column). The finished bucket list,
    or None (the host path) when a rule says so: a segment below
    DEVICE_AGG_MIN_DOCS, a multi-valued or inexact metric column, a
    non-metric sub-agg, or a bucket span past AGG_BUCKET_CAP."""
    sub_metrics = _device_histogram_submetrics(regular_sub)
    if sub_metrics is None:
        return None
    moments = _device_histogram_moments(ctx, field, interval, sub_metrics)
    if moments is None:
        return None
    lo, counts, mcols = moments
    buckets = []
    for i in range(len(counts)):
        count = int(counts[i])
        if (count == 0 and not gap_fill) or count < min_doc_count:
            continue
        key = key_of(lo + i)
        b = {"key": key}
        if is_date:
            b["key_as_string"] = _ms_to_iso(key)
        b["doc_count"] = count
        for name, t, _f in sub_metrics:
            acc = mcols[name]
            c = int(acc[0][i])
            b[name] = _shape_metric_from_stats(t, (
                c, float(acc[1][i]),
                float(acc[2][i]) if c else None,
                float(acc[3][i]) if c else None,
                float(acc[4][i])))
        buckets.append(b)
    return buckets


def _device_histogram_moments(ctx, field, interval, sub_metrics):
    """(lo_step, counts [nb], {name: [cnt, sum, min, max, sum_sq]
    arrays}) by device scatter-add, or None for the host path."""
    if field is None:
        return None
    seg_rows = []
    lo = hi = None
    for seg, mask, _m in ctx:
        nv = seg.numerics.get(field)
        if nv is None:
            continue
        if seg.n_docs < DEVICE_AGG_MIN_DOCS:
            return None
        for _n, _t, mf in sub_metrics:
            mnv = seg.numerics.get(mf)
            if mnv is not None and (not _single_valued(mnv)
                                    or not _f32_exact(mnv)):
                return None
        m = mask[: seg.n_docs] & ~nv.missing
        steps = np.floor(
            np.nan_to_num(nv.values) / interval).astype(np.int64)
        if m.any():
            smin, smax = int(steps[m].min()), int(steps[m].max())
            lo = smin if lo is None else min(lo, smin)
            hi = smax if hi is None else max(hi, smax)
        seg_rows.append((seg, m, steps))
    if lo is None:
        return None
    nb = hi - lo + 1
    if agg_ops.pow2_buckets(nb) == 0:
        return None
    dev_cache = _DEVICE_CACHE.get()
    counts = np.zeros(nb, np.int64)
    mcols = {name: [np.zeros(nb, np.int64), np.zeros(nb),
                    np.full(nb, np.inf), np.full(nb, -np.inf),
                    np.zeros(nb)]
             for name, _t, _f in sub_metrics}
    for seg, m, steps in seg_rows:
        dev = dev_cache.get(seg)
        dmask = _upload(dev, m)
        ids = np.clip(steps - lo, 0, nb - 1).astype(np.int32)
        dids = _upload(dev, ids)
        counts += agg_ops.bucket_counts(dids, dmask, nb)
        for name, _t, mf in sub_metrics:
            dval = dev.numerics.get(mf)
            if dval is None:
                continue
            cnt, s, mn, mx, ss = agg_ops.bucket_metric_columns(
                dids, dmask, dval, dev.numeric_missing[mf], nb)
            acc = mcols[name]
            acc[0] += cnt
            acc[1] += s
            acc[2] = np.minimum(acc[2], np.where(cnt > 0, mn, np.inf))
            acc[3] = np.maximum(acc[3], np.where(cnt > 0, mx, -np.inf))
            acc[4] += ss
    return lo, counts, mcols


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------

def _refine(ctx: CollectCtx, submasks: List[np.ndarray]) -> CollectCtx:
    return [(seg, mask & sub, m)
            for (seg, mask, m), sub in zip(ctx, submasks)]


def _split_parent_pipelines(sub: Dict[str, Any]):
    """(regular sub-aggs, parent pipelines): parent pipelines are
    declared INSIDE a multi-bucket agg and run across its buckets."""
    regular, parents = {}, {}
    for name, node in (sub or {}).items():
        types = [k for k in node if k not in _NODE_KEYS]
        if len(types) == 1 and types[0] in PARENT_PIPELINES:
            parents[name] = (types[0], node[types[0]] or {})
        else:
            regular[name] = node
    return regular, parents


def _bucket_metric_value(bucket: Dict[str, Any], path: str):
    if path in ("_count", ""):
        return bucket.get("doc_count")
    name, _, leaf = path.partition(".")
    v = bucket.get(name)
    if isinstance(v, dict):
        return v.get(leaf or "value")
    return None


def _apply_parent_pipelines(parents, buckets: List[Dict[str, Any]]):
    """Run parent pipelines across a finished bucket list, writing their
    per-bucket results under the declared names."""
    for name, (ptype, body) in parents.items():
        path = body.get("buckets_path", "_count")
        if ptype == "cumulative_sum":
            cum = 0.0
            for b in buckets:
                v = _bucket_metric_value(b, path)
                cum += v or 0.0
                b[name] = {"value": cum}
        elif ptype == "derivative":
            prev = None
            for b in buckets:
                v = _bucket_metric_value(b, path)
                if prev is not None and v is not None:
                    b[name] = {"value": v - prev}
                prev = v
        else:   # bucket_sort
            for entry in reversed(body.get("sort", [])):
                if isinstance(entry, str):
                    p, order = entry, "asc"
                else:
                    (p, spec2), = entry.items()
                    order = (spec2 if isinstance(spec2, str)
                             else spec2.get("order", "asc"))
                buckets.sort(
                    key=lambda b, _p=p: (
                        _bucket_metric_value(b, _p) is None,
                        _bucket_metric_value(b, _p) or 0),
                    reverse=(order == "desc"))
            frm = int(body.get("from", 0))
            size = body.get("size")
            del buckets[: frm]
            if size is not None:
                del buckets[int(size):]
    return buckets


def _bucket_result(sub: Dict[str, Any], bucket_ctx: CollectCtx, mapper,
                   doc_count: int, extra: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(extra)
    out["doc_count"] = doc_count
    if sub:
        regular, _parents = _split_parent_pipelines(sub)
        if regular:
            out.update(_compute_aggs(regular, bucket_ctx, mapper))
    return out


def _doc_count(ctx: CollectCtx) -> int:
    return sum(int(msk.sum()) for _, msk, _m in ctx)


def _bucket(agg_type, body, sub, ctx, mapper):
    if agg_type == "global":
        # ignores the query mask (ref: GlobalAggregator)
        global_ctx = [(seg, seg.live.copy(), m) for seg, _msk, m in ctx]
        out = {"doc_count": _doc_count(global_ctx)}
        if sub:
            out.update(_compute_aggs(sub, global_ctx, mapper))
        return out

    if agg_type == "filter":
        bucket_ctx = _refine(ctx, _query_masks(parse_query(body), ctx,
                                               mapper))
        return _bucket_result(sub, bucket_ctx, mapper,
                              _doc_count(bucket_ctx), {})

    if agg_type == "filters":
        buckets = {}
        for fname, fspec in body.get("filters", {}).items():
            bucket_ctx = _refine(ctx, _query_masks(parse_query(fspec), ctx,
                                                   mapper))
            buckets[fname] = _bucket_result(sub, bucket_ctx, mapper,
                                            _doc_count(bucket_ctx), {})
        return {"buckets": buckets}

    if agg_type == "missing":
        field = body.get("field")
        submasks = []
        for seg, mask, _m in ctx:
            present = np.zeros(seg.n_docs, bool)
            nv = seg.numerics.get(field)
            if nv is not None:
                present |= ~nv.missing
            kv = seg.keywords.get(field)
            if kv is not None:
                present |= (kv.offsets[1:] - kv.offsets[:-1]) > 0
            pf = seg.postings.get(field)
            if pf is not None:
                present |= pf.field_lengths > 0
            submasks.append(~present)
        bucket_ctx = _refine(ctx, submasks)
        return _bucket_result(sub, bucket_ctx, mapper,
                              _doc_count(bucket_ctx), {})

    if agg_type == "terms":
        field = body.get("field")
        size = int(body.get("size", 10))
        order = body.get("order", {"_count": "desc"})
        counts = _keyword_terms_counts(ctx, field)
        if not counts:
            # no keyword counts (not a keyword field, or nothing
            # matched): the numeric terms agg, as the reference answers
            return _numeric_terms(body, sub, ctx, mapper)
        (order_key, order_dir), = (order.items() if isinstance(order, dict)
                                   else [("_count", "desc")])
        rev = order_dir == "desc"
        if order_key == "_count":
            items = sorted(counts.items(), key=lambda kv_: (
                -kv_[1] if rev else kv_[1], kv_[0]))
        else:  # _key
            items = sorted(counts.items(), key=lambda kv_: kv_[0],
                           reverse=rev)
        buckets = []
        for term, count in items[:size]:
            # the membership scan runs only for sub-aggs that read it
            bucket_ctx = (_refine(
                ctx, [_keyword_membership_mask(seg, field, term)
                      for seg, _m2, _m3 in ctx]) if sub else ctx)
            buckets.append(_bucket_result(sub, bucket_ctx, mapper, count,
                                          {"key": term}))
        other = sum(c for _, c in items[size:])
        _apply_parent_pipelines(_split_parent_pipelines(sub)[1], buckets)
        return {"doc_count_error_upper_bound": 0,
                "sum_other_doc_count": other, "buckets": buckets}

    if agg_type in ("histogram", "date_histogram"):
        return _histogram(agg_type, body, sub, ctx, mapper)

    if agg_type == "range":
        field = body.get("field")
        buckets = []
        for r in body.get("ranges", []):
            frm = r.get("from")
            to = r.get("to")
            submasks, count = _range_masks(
                ctx, field, None if frm is None else float(frm),
                None if to is None else float(to))
            key = r.get("key", f"{frm if frm is not None else '*'}-"
                               f"{to if to is not None else '*'}")
            extra = {"key": key}
            if frm is not None:
                extra["from"] = float(frm)
            if to is not None:
                extra["to"] = float(to)
            buckets.append(_bucket_result(sub, _refine(ctx, submasks),
                                          mapper, count, extra))
        return {"buckets": buckets}

    # date_range
    field = body.get("field")
    ft = mapper.field_type(field) if mapper is not None else None
    buckets = []
    for r in body.get("ranges", []):
        frm = _date_bound_ms(r.get("from"), ft)
        to = _date_bound_ms(r.get("to"), ft)
        submasks, count = _range_masks(ctx, field, frm, to)
        frm_s = _ms_to_iso(frm) if frm is not None else "*"
        to_s = _ms_to_iso(to) if to is not None else "*"
        extra = {"key": r.get("key", f"{frm_s}-{to_s}")}
        if frm is not None:
            extra["from"] = frm
            extra["from_as_string"] = frm_s
        if to is not None:
            extra["to"] = to
            extra["to_as_string"] = to_s
        buckets.append(_bucket_result(sub, _refine(ctx, submasks),
                                      mapper, count, extra))
    return {"buckets": buckets}


def _range_masks(ctx, field, frm, to):
    """(per-segment masks of the docs in [frm, to), their count)."""
    submasks = []
    count = 0
    for seg, mask, _m in ctx:
        vv, m = _first_values_and_mask(seg, mask, field)
        if vv is None:
            submasks.append(np.zeros(seg.n_docs, bool))
            continue
        in_r = m.copy()
        if frm is not None:
            in_r &= vv >= frm
        if to is not None:
            in_r &= vv < to
        submasks.append(in_r)
        count += int(in_r.sum())
    return submasks, count


def _date_bound_ms(v, ft) -> Optional[float]:
    """A date_range bound in epoch ms: epoch millis, the field's date
    formats, or ``now`` date math (now-7d, now+1h/d)."""
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v)
    m = re.fullmatch(r"now(?:([+-]\d+)([smhdwMy]))?(?:/([smhdwMy]))?", s)
    if m:
        import time as _time
        ms = _time.time() * 1000.0
        if m.group(1):
            mult = {"s": 1e3, "m": 60e3, "h": 3600e3, "d": 86400e3,
                    "w": 7 * 86400e3, "M": 30 * 86400e3,
                    "y": 365 * 86400e3}
            ms += int(m.group(1)) * mult[m.group(2)]
        if m.group(3):      # rounding: floor to the unit start
            u = m.group(3)
            if u in ("w", "M", "y"):
                # calendar boundaries (ISO weeks, month and year starts)
                cal = {"w": "week", "M": "month", "y": "year"}[u]
                ms = float(_calendar_floor_ms(np.array([ms]), cal)[0])
            else:
                fixed = {"s": 1e3, "m": 60e3, "h": 3600e3, "d": 86400e3}[u]
                ms = math.floor(ms / fixed) * fixed
        return ms
    if ft is not None and hasattr(ft, "parse"):
        return float(ft.parse(s))
    raise IllegalArgumentException(f"cannot parse date range bound [{v}]")


def _histogram(agg_type, body, sub, ctx, mapper):
    field = body.get("field")
    cal_unit = (_calendar_unit(body) if agg_type == "date_histogram"
                else None)
    if agg_type == "histogram":
        interval = float(body["interval"])
    elif cal_unit is None:
        interval = _date_interval_ms(body)
    min_doc_count = int(body.get("min_doc_count", 0))
    # INTEGER step space keeps bucket membership exact: for fixed
    # intervals step = floor(v / interval); calendar intervals floor to
    # true calendar boundaries
    if cal_unit is not None:
        def step_of(vv):
            return _calendar_floor_ms(vv, cal_unit).astype(np.int64)

        def key_of(step):
            return float(step)
    else:
        def step_of(vv):
            return np.floor(vv / interval).astype(np.int64)

        def key_of(step):
            return step * interval
    regular_sub, parent_pipes = (_split_parent_pipelines(sub)
                                 if sub else ({}, {}))
    if cal_unit is None:
        # the device reduction (fixed intervals only: calendar steps are
        # epoch-ms keys, not a dense id space)
        dev_buckets = _device_histogram_buckets(
            ctx, field, interval, min_doc_count,
            gap_fill=(body.get("extended_bounds") is None
                      and min_doc_count == 0),
            key_of=key_of, is_date=(agg_type == "date_histogram"),
            regular_sub=regular_sub)
        if dev_buckets is not None:
            _apply_parent_pipelines(parent_pipes, dev_buckets)
            return {"buckets": dev_buckets}
    step_counts: Dict[int, int] = {}
    for seg, mask, _m in ctx:
        vv, m = _first_values_and_mask(seg, mask, field)
        if vv is None:
            continue
        uniq, cnts = np.unique(step_of(vv[m]), return_counts=True)
        for u, c in zip(uniq, cnts):
            step_counts[int(u)] = step_counts.get(int(u), 0) + int(c)
    buckets = []
    all_steps = sorted(step_counts)
    if all_steps and body.get("extended_bounds") is None \
            and min_doc_count == 0:
        # fill gaps between min and max (ES's histogram default), capped
        if cal_unit is not None:
            filled, cur = [], all_steps[0]
            while cur <= all_steps[-1]:
                filled.append(cur)
                _check_bucket_cap(len(filled), agg_type)
                cur = _calendar_next_ms(cur, cal_unit)
            all_steps = filled
        else:
            _check_bucket_cap(all_steps[-1] - all_steps[0] + 1, agg_type)
            all_steps = list(range(all_steps[0], all_steps[-1] + 1))
    for step in all_steps:
        count = step_counts.get(step, 0)
        if count < min_doc_count:
            continue
        key = key_of(step)
        extra = {"key": key}
        if agg_type == "date_histogram":
            extra["key_as_string"] = _ms_to_iso(key)
        if regular_sub:
            # per-bucket doc masks only when sub-aggs read them
            submasks = []
            for seg, mask, _m in ctx:
                vv, m = _first_values_and_mask(seg, mask, field)
                if vv is None:
                    submasks.append(np.zeros(seg.n_docs, bool))
                    continue
                submasks.append(m & (step_of(vv) == step))
            bucket_ctx = _refine(ctx, submasks)
        else:
            bucket_ctx = ctx
        buckets.append(_bucket_result(sub, bucket_ctx, mapper, count, extra))
    _apply_parent_pipelines(parent_pipes, buckets)
    return {"buckets": buckets}


def _numeric_terms(body, sub, ctx, mapper):
    field = body.get("field")
    size = int(body.get("size", 10))
    counts: Dict[float, int] = {}
    for seg, mask, _m in ctx:
        nv = seg.numerics.get(field)
        if nv is None:
            continue
        m = mask[: seg.n_docs] & ~nv.missing
        vals, cnts = np.unique(nv.values[m], return_counts=True)
        for v, c in zip(vals, cnts):
            counts[float(v)] = counts.get(float(v), 0) + int(c)
    ordered = sorted(counts.items(), key=lambda kv_: (-kv_[1], kv_[0]))
    buckets = []
    for val, count in ordered[:size]:
        submasks = []
        for seg, _m2, _m3 in ctx:
            nv = seg.numerics.get(field)
            if nv is None:
                submasks.append(np.zeros(seg.n_docs, bool))
            else:
                submasks.append(~nv.missing & (nv.values == val))
        key = int(val) if float(val).is_integer() else val
        buckets.append(_bucket_result(sub, _refine(ctx, submasks), mapper,
                                      count, {"key": key}))
    other = sum(c for _, c in ordered[size:])
    _apply_parent_pipelines(_split_parent_pipelines(sub)[1], buckets)
    return {"doc_count_error_upper_bound": 0, "sum_other_doc_count": other,
            "buckets": buckets}


def _query_masks(q, ctx: CollectCtx, mapper) -> List[np.ndarray]:
    """A filter query executed per segment on the request's device
    segments: its host masks [n_docs], each read back through the
    funnel."""
    cache = _DEVICE_CACHE.get()
    stats = ShardStats([seg for seg, _m2, _m3 in ctx])
    masks = []
    for seg, _m2, _m3 in ctx:
        _, mask = q.execute(SegmentContext(seg, cache.get(seg), mapper,
                                           stats))
        masks.append(readback("search.aggregations.filter_mask",
                              mask[: seg.n_docs]))
    return masks


# calendar units whose bucket length varies: these floor to calendar
# boundaries instead of fixed-ms multiples
_CALENDAR_UNITS = {"year": "year", "1y": "year", "quarter": "quarter",
                   "1q": "quarter", "month": "month", "1M": "month",
                   "week": "week", "1w": "week"}


def _calendar_unit(body) -> Optional[str]:
    v = body.get("calendar_interval")
    return _CALENDAR_UNITS.get(v) if v is not None else None


def _calendar_floor_ms(values, unit: str) -> np.ndarray:
    """Floor epoch-ms values to calendar bucket starts (UTC)."""
    ms = np.nan_to_num(np.asarray(values, np.float64)).astype(np.int64)
    dt = ms.astype("datetime64[ms]")
    if unit == "year":
        start = dt.astype("datetime64[Y]")
    elif unit == "month":
        start = dt.astype("datetime64[M]")
    elif unit == "quarter":
        m = dt.astype("datetime64[M]").astype(np.int64)
        start = (m - (m % 3)).astype("datetime64[M]")
    else:  # week: ISO weeks start Monday (1970-01-01 is a Thursday)
        days = ms // 86_400_000
        dow = (days + 3) % 7
        start = ((days - dow) * 86_400_000).astype("datetime64[ms]")
    return start.astype("datetime64[ms]").astype(np.int64).astype(
        np.float64)


def _calendar_next_ms(ms: float, unit: str) -> int:
    """Start of the calendar bucket after bucket-start ``ms``."""
    d = np.datetime64(int(ms), "ms")
    if unit == "year":
        n = d.astype("datetime64[Y]") + 1
    elif unit == "month":
        n = d.astype("datetime64[M]") + 1
    elif unit == "quarter":
        n = d.astype("datetime64[M]") + 3
    else:
        return int(ms) + 604_800_000
    return int(n.astype("datetime64[ms]").astype(np.int64))


_INTERVALS_MS = {
    "second": 1000, "1s": 1000, "minute": 60_000, "1m": 60_000,
    "hour": 3_600_000, "1h": 3_600_000, "day": 86_400_000, "1d": 86_400_000,
    "week": 604_800_000, "1w": 604_800_000, "month": 2_592_000_000,
    "1M": 2_592_000_000, "quarter": 7_776_000_000, "year": 31_536_000_000,
    "1y": 31_536_000_000,
}


def _date_interval_ms(body) -> float:
    for key in ("calendar_interval", "fixed_interval", "interval"):
        if key in body:
            val = body[key]
            if val in _INTERVALS_MS:
                return float(_INTERVALS_MS[val])
            # fixed forms like "30m", "12h", "500ms"
            m = re.fullmatch(r"(\d+)(ms|s|m|h|d)", str(val))
            if m:
                mult = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
                        "d": 86_400_000}[m.group(2)]
                return float(int(m.group(1)) * mult)
            raise ParsingException(f"unknown interval [{val}]")
    raise ParsingException("date_histogram requires an interval")


def _ms_to_iso(ms: float) -> str:
    import datetime as dt
    return dt.datetime.fromtimestamp(ms / 1000.0, dt.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.000Z")


# ---------------------------------------------------------------------------
# sibling pipelines (over sibling agg results)
# ---------------------------------------------------------------------------

def _extract_bucket_values(path: str, results: Dict[str, Any]) -> List[float]:
    agg_name, _, metric = path.partition(">")
    agg = results.get(agg_name)
    if agg is None or "buckets" not in agg:
        raise IllegalArgumentException(
            f"No bucket aggregation found at path [{path}]")
    values = []
    buckets = agg["buckets"]
    iterable = buckets.values() if isinstance(buckets, dict) else buckets
    for b in iterable:
        if metric:
            node = b.get(metric.strip())
            values.append(node.get("value") if isinstance(node, dict)
                          else None)
        else:
            values.append(b.get("doc_count"))
    return [v for v in values if v is not None]


def _compute_pipeline(agg_type, body, results):
    path = body.get("buckets_path", "")
    if agg_type == "cumulative_sum":
        agg_name, _, metric = path.partition(">")
        agg = results.get(agg_name, {})
        cum = 0.0
        for b in agg.get("buckets", []):
            v = (b.get(metric, {}).get("value") if metric
                 else b.get("doc_count")) or 0.0
            cum += v
            b["cumulative_sum"] = {"value": cum}
        return {"value": cum}
    if agg_type == "derivative":
        agg_name, _, metric = path.partition(">")
        agg = results.get(agg_name, {})
        prev = None
        for b in agg.get("buckets", []):
            v = (b.get(metric, {}).get("value") if metric
                 else b.get("doc_count"))
            if prev is not None and v is not None:
                b["derivative"] = {"value": v - prev}
            prev = v
        return {"value": None}
    if agg_type == "bucket_sort":
        return {}
    values = _extract_bucket_values(path, results)
    if not values:
        # multi-value pipelines keep their response shape on empty input
        if agg_type == "percentiles_bucket":
            pcts = body.get("percents") or [1.0, 5.0, 25.0, 50.0, 75.0,
                                            95.0, 99.0]
            return {"values": {str(float(p)): None for p in pcts}}
        if agg_type == "extended_stats_bucket":
            return {"count": 0, "min": None, "max": None, "avg": None,
                    "sum": 0.0, "sum_of_squares": None,
                    "variance": None, "std_deviation": None,
                    "std_deviation_bounds": {"upper": None,
                                             "lower": None}}
        return {"value": None}
    if agg_type == "avg_bucket":
        return {"value": float(np.mean(values))}
    if agg_type == "sum_bucket":
        return {"value": float(np.sum(values))}
    if agg_type == "min_bucket":
        return {"value": float(np.min(values))}
    if agg_type == "max_bucket":
        return {"value": float(np.max(values))}
    arr = np.asarray(values, float)
    if agg_type == "stats_bucket":
        return {"count": len(arr), "min": float(arr.min()),
                "max": float(arr.max()), "avg": float(arr.mean()),
                "sum": float(arr.sum())}
    if agg_type == "extended_stats_bucket":
        sigma = float(body.get("sigma", 2.0))
        mean = float(arr.mean())
        var = float(arr.var())
        std = float(np.sqrt(var))
        return {"count": len(arr), "min": float(arr.min()),
                "max": float(arr.max()), "avg": mean,
                "sum": float(arr.sum()),
                "sum_of_squares": float((arr * arr).sum()),
                "variance": var, "std_deviation": std,
                "std_deviation_bounds": {
                    "upper": mean + sigma * std,
                    "lower": mean - sigma * std}}
    # percentiles_bucket: linear interpolation, the estimator of the
    # percentiles metric (the reference's engine diverges from ES's
    # nearest-input rule on purpose, and the port answers as it does)
    pcts = body.get("percents") or [1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0]
    return {"values": {str(float(p)): float(np.percentile(arr, p))
                       for p in pcts}}
