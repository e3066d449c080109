"""Aggregations: the bucket/metric/pipeline tree beside the top-k
collector (counterpart of elasticsearch_tpu/search/aggregations.py).

The query phase hands every segment's match mask to the host (after the
live mask and ``min_score``, before ``post_filter``); every bucket is a
boolean refinement of those masks and every metric a vectorized
reduction over the masked columnar doc values; sub-aggs recurse over the
refined masks. The masks of every shard of every searched index form
one collect context, evaluated in one pass. The reduction moves to the
device (ops/aggs.py) under the reference's rules, which decide which
answers are float32:

- a keyword ``terms`` agg on a segment of at least
  ``DEVICE_AGG_MIN_DOCS`` docs counts through the field's ord-major
  permutation (so do ``significant_terms``' foreground and background
  and ``rare_terms``);
- ``sum``/``min``/``max``/``avg``/``value_count``/``stats`` without a
  ``missing`` value take one fused launch per segment when every
  contributing segment clears the doc gate and the column is
  single-valued and exact in float32 (``_f32_exact``: |v| <= 2^24);
  ``extended_stats`` stays on the host (its float32 sum of squares
  cancels);
- a fixed-interval ``histogram``/``date_histogram`` (and the fixed
  roundings of ``auto_date_histogram``) whose sub-aggs are all such
  metrics scatters counts and metric columns on the device (bucket ids
  computed on the host in float64), up to ``AGG_BUCKET_CAP`` buckets;
  calendar intervals stay on the host.

A gate that routes to the host is a rule; a device error raises and
fails the request (no host fallback hides the card). Every other type is
host numpy, as in the reference, with the same answers; where the
reference loops over documents in Python (``composite``'s grouping,
``top_hits``' sort, the grid cells) the port groups by integer codes and
sorts with ``lexsort`` in the reference's order.

Served types:
- metrics: avg, sum, min, max, value_count, stats, extended_stats,
  cardinality, percentiles, percentile_ranks, weighted_avg, top_hits,
  geo_bounds, geo_centroid, scripted_metric, boxplot, top_metrics,
  string_stats, matrix_stats, median_absolute_deviation, t_test;
- buckets: terms (keyword, else numeric), histogram, date_histogram
  (fixed and calendar), auto_date_histogram, variable_width_histogram,
  range, date_range, ip_range, geo_distance, geohash_grid, geotile_grid,
  filter, filters, adjacency_matrix, missing, global, nested, children,
  parent, sampler, diversified_sampler, composite, significant_terms,
  significant_text, rare_terms, multi_terms;
- sibling pipelines: avg_bucket, sum_bucket, min_bucket, max_bucket,
  stats_bucket, extended_stats_bucket, percentiles_bucket,
  cumulative_cardinality (and the sibling forms of cumulative_sum,
  derivative, bucket_sort);
- parent pipelines: cumulative_sum, derivative, cumulative_cardinality,
  bucket_sort, moving_fn, moving_avg, serial_diff, moving_percentiles,
  normalize, bucket_script, bucket_selector.

A name none of these is a ``ParsingException`` where the tree reaches
it, as in the reference. Internal carriers (cardinality's exact value
set ``_set``, percentiles' digest ``_digest``) feed
``cumulative_cardinality`` and ``moving_percentiles`` and are stripped
from the response.
"""

from __future__ import annotations

import contextvars
import json
import math
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   ScriptException)
from elasticsearch_tpu_torch.common.geo import _UNITS as GEO_UNITS
from elasticsearch_tpu_torch.common.geo import (geohash_codes,
                                                geohash_strings,
                                                geotile_codes,
                                                geotile_strings,
                                                haversine_meters,
                                                parse_geo_point)
from elasticsearch_tpu_torch.ops import aggs as agg_ops
from elasticsearch_tpu_torch.ops.device import readback
from elasticsearch_tpu_torch.script.contexts import DocValues
from elasticsearch_tpu_torch.script.interp import (PainlessError,
                                                   compile_painless)
from elasticsearch_tpu_torch.script.painless import ParseError
from elasticsearch_tpu_torch.search import profile as _prof
from elasticsearch_tpu_torch.search.context import SegmentContext, ShardStats
from elasticsearch_tpu_torch.search.join import _join_field, _relation_docs
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

_NODE_KEYS = ("aggs", "aggregations", "meta")


# the request's DeviceSegmentCache, scoped per compute_aggs call
_DEVICE_CACHE: "contextvars.ContextVar" = contextvars.ContextVar(
    "agg_device_cache", default=None)


def compute_aggs(spec: Dict[str, Any], ctx: CollectCtx, mapper,
                 device_cache) -> Dict[str, Any]:
    """Evaluate an aggs tree; returns the ``aggregations`` response
    object. ``device_cache`` (the index's DeviceSegmentCache) is scoped
    to this computation through a contextvar, so concurrent searches of
    other indices never share it and nothing outlives the call."""
    token = _DEVICE_CACHE.set(device_cache)
    try:
        out = _compute_aggs(spec, ctx, mapper)
    finally:
        _DEVICE_CACHE.reset(token)
    _strip_internal(out)
    return out


def _strip_internal(node) -> None:
    """Drop the internal carriers (a Python set under ``_set``, a TDigest
    under ``_digest``) from a finished tree; a user ``_source`` is never
    walked."""
    if isinstance(node, dict):
        if isinstance(node.get("_set"), set):
            del node["_set"]
        if isinstance(node.get("_digest"), TDigest):
            del node["_digest"]
        for k, v in node.items():
            if k != "_source":
                _strip_internal(v)
    elif isinstance(node, list):
        for v in node:
            _strip_internal(v)


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
        return _metric(agg_type, body, ctx, mapper)
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

def _geo_points(ctx: CollectCtx, field: str):
    """(lats, lons) of the masked docs' first points, over the
    segments in order."""
    lat_chunks, lon_chunks = [], []
    for seg, mask, _m in ctx:
        nlat = seg.numerics.get(f"{field}.lat")
        nlon = seg.numerics.get(f"{field}.lon")
        if nlat is None or nlon is None:
            continue
        m = mask[: seg.n_docs] & ~nlat.missing
        lat_chunks.append(nlat.values[m])
        lon_chunks.append(nlon.values[m])
    if not lat_chunks:
        return np.zeros(0), np.zeros(0)
    return np.concatenate(lat_chunks), np.concatenate(lon_chunks)


def _geo_bounds(lats, lons):
    if len(lats) == 0:
        return {}
    return {"bounds": {
        "top_left": {"lat": float(lats.max()), "lon": float(lons.min())},
        "bottom_right": {"lat": float(lats.min()),
                         "lon": float(lons.max())}}}


def _geo_centroid(lats, lons):
    if len(lats) == 0:
        return {"count": 0}
    return {"location": {"lat": float(lats.mean()),
                         "lon": float(lons.mean())},
            "count": int(len(lats))}


def _metric(agg_type, body, ctx, mapper):
    field = body.get("field")
    missing_val = body.get("missing")

    if agg_type == "geo_bounds":
        return _geo_bounds(*_geo_points(ctx, field))
    if agg_type == "geo_centroid":
        return _geo_centroid(*_geo_points(ctx, field))
    if agg_type == "scripted_metric":
        with _prof.span("aggs.script"):
            return scripted_metric_reduce(
                body, scripted_metric_states(body, ctx))
    if agg_type == "top_hits":
        with _prof.span("aggs.hits"):
            return _top_hits(body, ctx)
    if agg_type == "t_test":
        return _t_test(body, ctx, mapper)
    if agg_type == "median_absolute_deviation":
        # exact while the sample fits the centroid budget
        digest = TDigest.from_values(_numeric_values(ctx, field),
                                     _digest_compression(body))
        return {"value": digest.mad()}
    if agg_type == "boxplot":
        return shape_boxplot(TDigest.from_values(
            _numeric_values(ctx, field), _digest_compression(body)))
    if agg_type == "top_metrics":
        return _top_metrics(body, ctx)
    if agg_type == "string_stats":
        return _string_stats(body, ctx)
    if agg_type == "matrix_stats":
        return _matrix_stats(body, ctx)

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
        # the exact set travels for cumulative_cardinality (stripped
        # from the response)
        return {"value": len(distinct), "_set": distinct}

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
        # the digest travels for moving_percentiles' window merge
        # (stripped from the response)
        digest = TDigest.from_values(values, _digest_compression(body))
        return {"values": {str(float(p)): digest.quantile(float(p))
                           for p in percents},
                "_digest": digest}
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


def shape_boxplot(digest: TDigest) -> Dict[str, Any]:
    """The boxplot response of a digest: the five numbers and the
    1.5 IQR whiskers clamped to the digest's points."""
    if digest.is_empty():
        return {"min": None, "max": None, "q1": None, "q2": None,
                "q3": None}
    q1, q2, q3 = (digest.quantile(p) for p in (25, 50, 75))
    iqr = q3 - q1
    lo, hi = q1 - 1.5 * iqr, q3 + 1.5 * iqr
    pts = digest.data_points()
    within = pts[(pts >= lo) & (pts <= hi)]
    return {"min": float(digest.min), "max": float(digest.max),
            "q1": q1, "q2": q2, "q3": q3,
            "lower": float(within.min()) if len(within) else q1,
            "upper": float(within.max()) if len(within) else q3}


def _sort_field(spec, default_order="asc"):
    """(field, order) of one sort entry: ``"f"``, ``{"f": "desc"}`` or
    ``{"f": {"order": "desc"}}``."""
    if isinstance(spec, str):
        return spec, default_order
    (sfield, sdir), = spec.items()
    return sfield, (sdir.get("order", "asc") if isinstance(sdir, dict)
                    else str(sdir))


def _top_hits(body, ctx):
    """The first ``size`` matched docs: without ``sort`` in segment and
    docid order (not by score, as the reference); with one, ordered by
    (missing last, the key in the asked direction, docid, segment): one
    ``lexsort`` in the order of the reference's stable sort."""
    size = int(body.get("size", 3))
    sort_spec = body.get("sort")
    total = sum(int(mask[: seg.n_docs].sum()) for seg, mask, _m in ctx)
    if not sort_spec:
        hits = []
        for seg, mask, _m in ctx:
            for d in np.nonzero(mask[: seg.n_docs])[0][:size]:
                hits.append({"_id": seg.stored.ids[int(d)],
                             "_source": json.loads(
                                 seg.stored.source(int(d)))})
        hits = hits[:size]
    else:
        sfield, order = _sort_field(sort_spec[0] if isinstance(
            sort_spec, list) else sort_spec)
        desc = order == "desc"
        segs, docs, has, keys = [], [], [], []
        for si, (seg, mask, _m) in enumerate(ctx):
            d = np.nonzero(mask[: seg.n_docs])[0]
            nv = seg.numerics.get(sfield)
            h = (~nv.missing[d] if nv is not None
                 else np.zeros(len(d), bool))
            segs.append(np.full(len(d), si))
            docs.append(d)
            has.append(h)
            keys.append(np.where(h, nv.values[d], 0.0) if nv is not None
                        else np.zeros(len(d)))
        segs, docs, has, keys = (np.concatenate(a) if a else np.zeros(0)
                                 for a in (segs, docs, has, keys))
        top = np.lexsort((segs, docs, -keys if desc else keys,
                          ~has.astype(bool)))[:size]
        hits = []
        for i in top:
            seg, d = ctx[int(segs[i])][0], int(docs[i])
            hits.append({"_id": seg.stored.ids[d],
                         "_source": json.loads(seg.stored.source(d)),
                         "sort": [float(keys[i]) if has[i] else None]})
    return {"hits": {"total": {"value": total, "relation": "eq"},
                     "hits": hits}}


def _t_test(body, ctx, mapper):
    """Paired, homoscedastic or heteroscedastic (Welch, the default)
    two-sided p-value over two numeric sources, each with an optional
    filter (scipy.stats)."""
    ttype = str(body.get("type", "heteroscedastic"))
    if ttype not in ("paired", "homoscedastic", "heteroscedastic"):
        raise ParsingException(
            f"unsupported t_test type [{ttype}]; expected one of "
            "[paired, homoscedastic, heteroscedastic]")
    a_spec, b_spec = body.get("a") or {}, body.get("b") or {}

    def source_ctx(spec):
        if spec.get("filter") is None:
            return ctx
        return _refine(ctx, _query_masks(parse_query(spec["filter"]), ctx,
                                         mapper))

    from scipy import stats
    if ttype == "paired":
        if a_spec.get("filter") is not None \
                or b_spec.get("filter") is not None:
            raise ParsingException("paired t_test does not support filters")
        # pairs within a document: both fields present
        xa_parts, xb_parts = [], []
        for seg, mask, _m in ctx:
            va, ma = _first_values_and_mask(seg, mask, a_spec.get("field"))
            vb, mb = _first_values_and_mask(seg, mask, b_spec.get("field"))
            if va is None or vb is None:
                continue
            both = ma & mb
            xa_parts.append(va[both])
            xb_parts.append(vb[both])
        xa = np.concatenate(xa_parts) if xa_parts else np.zeros(0)
        xb = np.concatenate(xb_parts) if xb_parts else np.zeros(0)
        if len(xa) < 2:
            return {"value": None}
        res = stats.ttest_rel(xa, xb)
    else:
        xa = _numeric_values(source_ctx(a_spec), a_spec.get("field"))
        xb = _numeric_values(source_ctx(b_spec), b_spec.get("field"))
        if len(xa) < 2 or len(xb) < 2:
            return {"value": None}
        res = stats.ttest_ind(xa, xb, equal_var=(ttype == "homoscedastic"))
    p = float(res.pvalue)
    return {"value": None if np.isnan(p) else p}


def _top_metrics(body, ctx):
    """The metric values of the top ``size`` docs by one sort field: a
    partial sort per segment, then a stable sort of the candidates."""
    metrics = body.get("metrics", [])
    if isinstance(metrics, dict):
        metrics = [metrics]
    sort_spec = body.get("sort", [])
    if isinstance(sort_spec, (str, dict)):
        sort_spec = [sort_spec]
    if not sort_spec:
        raise IllegalArgumentException("top_metrics requires [sort]")
    sfield, order = _sort_field(sort_spec[0])
    size = int(body.get("size", 1))
    rows = []          # (sort value, {metric: value})
    for seg, mask, _m in ctx:
        sv, sm = _first_values_and_mask(seg, mask, sfield)
        if sv is None:
            continue
        docs = np.nonzero(sm)[0]
        if len(docs) == 0:
            continue
        svals = sv[docs]
        if len(docs) > size:
            part = (np.argpartition(-svals, size - 1)[:size]
                    if order == "desc"
                    else np.argpartition(svals, size - 1)[:size])
            docs, svals = docs[part], svals[part]
        for d, sval in zip(docs, svals):
            mvals = {}
            for mspec in metrics:
                mf = mspec.get("field")
                nv = seg.numerics.get(mf)
                mvals[mf] = (float(nv.values[d])
                             if nv is not None and not nv.missing[d]
                             else None)
            rows.append((float(sval), mvals))
    rows.sort(key=lambda r: r[0], reverse=(order == "desc"))
    return {"top": [{"sort": [s], "metrics": mv} for s, mv in rows[:size]]}


def _string_stats(body, ctx):
    """Length stats and the Shannon entropy of the character
    distribution of a keyword field, per distinct term weighted by its
    count."""
    field = body.get("field")
    count = 0
    min_len = max_len = None
    total_len = 0
    char_counts: Dict[str, int] = {}
    for seg, mask, _m in ctx:
        kv = seg.keywords.get(field)
        if kv is None:
            continue
        bc = _masked_ord_counts(kv, mask, seg.n_docs)
        for o in np.nonzero(bc)[0]:
            term = kv.terms[int(o)]
            c = int(bc[o])
            count += c
            ln = len(term)
            total_len += ln * c
            min_len = ln if min_len is None else min(min_len, ln)
            max_len = ln if max_len is None else max(max_len, ln)
            for ch in term:
                char_counts[ch] = char_counts.get(ch, 0) + c
    if count == 0:
        return {"count": 0, "min_length": None, "max_length": None,
                "avg_length": None, "entropy": 0.0}
    total_chars = sum(char_counts.values())
    entropy = -sum((c / total_chars) * math.log2(c / total_chars)
                   for c in char_counts.values()) if total_chars else 0.0
    out = {"count": count, "min_length": min_len, "max_length": max_len,
           "avg_length": total_len / count, "entropy": entropy}
    if body.get("show_distribution"):
        out["distribution"] = {
            ch: c / total_chars
            for ch, c in sorted(char_counts.items(), key=lambda kv_: -kv_[1])}
    return out


def _matrix_stats(body, ctx):
    """Per-field moments, covariance and correlation over the docs that
    carry every field."""
    fields = body.get("fields", [])
    cols = {f: [] for f in fields}
    for seg, mask, _m in ctx:
        nvs = [seg.numerics.get(f) for f in fields]
        if any(nv is None for nv in nvs):
            continue
        m = mask[: seg.n_docs].copy()
        for nv in nvs:
            m &= ~nv.missing
        for f, nv in zip(fields, nvs):
            cols[f].append(nv.values[m])
    arrs = {f: (np.concatenate(v) if v else np.zeros(0))
            for f, v in cols.items()}
    n = min((len(a) for a in arrs.values()), default=0)
    if n == 0:
        return {"doc_count": 0, "fields": []}
    mat = np.stack([arrs[f][:n] for f in fields])     # [F, n]
    mean = mat.mean(axis=1)
    centered = mat - mean[:, None]
    cov = ((centered @ centered.T) / (n - 1) if n > 1
           else np.zeros((len(fields), len(fields))))
    std = np.sqrt(np.diag(cov))
    out_fields = []
    for i, f in enumerate(fields):
        v = mat[i]
        var = float(cov[i, i])
        sd = math.sqrt(var) if var > 0 else 0.0
        skew = float(np.mean((v - mean[i]) ** 3)) / sd ** 3 if sd else 0.0
        kurt = float(np.mean((v - mean[i]) ** 4)) / sd ** 4 if sd else 0.0
        corr = {}
        for j, g in enumerate(fields):
            denom = std[i] * std[j]
            corr[g] = float(cov[i, j] / denom) if denom else 0.0
        out_fields.append({
            "name": f, "count": n, "mean": float(mean[i]),
            "variance": var, "skewness": skew, "kurtosis": kurt,
            "covariance": {g: float(cov[i, j])
                           for j, g in enumerate(fields)},
            "correlation": corr})
    return {"doc_count": n, "fields": out_fields}


class AggScriptError(ScriptException):
    """A script error an aggregation lets escape unwrapped, typed as the
    reference types it: the error's class name in snake case
    (``parse_error_exception``, ``painless_error_exception``)."""

    def __init__(self, exc: ScriptException):
        super().__init__(str(exc))
        name = type(exc).__name__
        if name.endswith("Exception"):
            name = name[: -len("Exception")]
        self.error_type = "".join(
            ("_" if c.isupper() and i else "") + c.lower()
            for i, c in enumerate(name)) + "_exception"


def _compile(source: str):
    try:
        return compile_painless(source)
    except ParseError as e:
        raise AggScriptError(e)


def _execute(script, bindings: Dict[str, Any]):
    try:
        return script.execute(bindings)
    except ScriptException as e:
        raise AggScriptError(e)


def _scripted_metric_scripts(body: Dict[str, Any]):
    """The four compiled scripts of a scripted_metric and its params."""
    def src(key):
        s = body.get(key)
        if isinstance(s, dict):
            s = s.get("source")
        return s

    map_src = src("map_script")
    if not map_src:
        raise ParsingException("[scripted_metric] requires [map_script]")
    params = dict(body.get("params", {}))
    init_s = _compile(src("init_script")) if src("init_script") else None
    map_s = _compile(map_src)
    combine_s = (_compile(src("combine_script"))
                 if src("combine_script") else None)
    reduce_s = (_compile(src("reduce_script"))
                if src("reduce_script") else None)
    return params, init_s, map_s, combine_s, reduce_s


def scripted_metric_states(body: Dict[str, Any],
                           ctx: CollectCtx) -> List[Any]:
    """init, then map once per matched doc, then combine, per segment:
    the states the reduce script consumes. The interpreter runs once per
    matched doc; no doc budget applies."""
    params, init_s, map_s, combine_s, _r = _scripted_metric_scripts(body)
    states = []
    for seg, mask, _m in ctx:
        state: Dict[str, Any] = {}
        base = {"state": state, "params": params}
        if init_s is not None:
            _execute(init_s, base)
        for d in np.nonzero(mask[: seg.n_docs])[0]:
            _execute(map_s, {**base, "doc": DocValues(seg, int(d))})
        states.append(_execute(combine_s, base)
                      if combine_s is not None else state)
    return states


def scripted_metric_reduce(body: Dict[str, Any],
                           states: List[Any]) -> Dict[str, Any]:
    """The reduce script over every segment's state (the states
    themselves without one)."""
    params, _i, _m, _c, reduce_s = _scripted_metric_scripts(body)
    if reduce_s is None:
        return {"value": states}
    return {"value": _execute(reduce_s, {"states": states,
                                         "params": params})}


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
        elif ptype == "cumulative_cardinality":
            seen: set = set()
            metric = path.partition(".")[0]
            for b in buckets:
                s2 = b.get(metric, {}).get("_set")
                if s2 is not None:
                    seen |= s2
                b[name] = {"value": len(seen)}
        elif ptype in ("moving_fn", "moving_avg"):
            _moving_fn(name, ptype, body, path, buckets)
        elif ptype == "serial_diff":
            lag = int(body.get("lag", 1))
            series = [_bucket_metric_value(b, path) for b in buckets]
            for i, b in enumerate(buckets):
                if i >= lag and series[i] is not None \
                        and series[i - lag] is not None:
                    b[name] = {"value": series[i] - series[i - lag]}
        elif ptype == "moving_percentiles":
            _moving_percentiles(name, body, path, buckets)
        elif ptype == "normalize":
            _normalize(name, body, path, buckets)
        elif ptype in ("bucket_script", "bucket_selector"):
            with _prof.span("aggs.script"):
                _bucket_script(name, ptype, body, buckets)
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


def _moving_fn(name, ptype, body, path, buckets):
    """``moving_fn``'s window ends before the current bucket;
    ``moving_avg``'s includes it. The closed script set: min, max, sum,
    else the unweighted average."""
    window = int(body.get("window", 5))
    script = str(body.get("script", ""))
    fn = (min if "min(" in script else
          max if "max(" in script else
          sum if "sum(" in script and "unweighted" not in script
          else None)
    include_current = ptype == "moving_avg"
    series = [_bucket_metric_value(b, path) for b in buckets]
    for i, b in enumerate(buckets):
        end = i + 1 if include_current else i
        win = [v for v in series[max(0, end - window): end] if v is not None]
        if not win:
            b[name] = {"value": None}
        elif fn is None:
            b[name] = {"value": sum(win) / len(win)}
        else:
            b[name] = {"value": fn(win)}


def _moving_percentiles(name, body, path, buckets):
    """Percentiles of the merged digests of a sibling ``percentiles``
    metric over the window ``[i - window + shift, i + shift)``."""
    window = int(body.get("window", 5))
    shift = int(body.get("shift", 0))
    metric = path.partition(".")[0].partition(">")[0]
    digests = []
    pcts = None
    for b in buckets:
        node = b.get(metric) or {}
        digests.append(node.get("_digest"))
        if pcts is None and node.get("values"):
            pcts = [float(p) for p in node["values"]]
    pcts = pcts or [1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0]
    for i, b in enumerate(buckets):
        lo = max(0, i - window + shift)
        hi = max(lo, min(len(buckets), i + shift))
        win = [d for d in digests[lo:hi] if d is not None and not d.is_empty()]
        if not win:
            b[name] = {"values": {}}
            continue
        merged = TDigest.merge_all(win)
        b[name] = {"values": {str(p): merged.quantile(p) for p in pcts}}


def _normalize(name, body, path, buckets):
    """A bucket metric rescaled across the whole bucket list."""
    method = str(body.get("method", "percent_of_sum"))
    series = [_bucket_metric_value(b, path) for b in buckets]
    vals = np.asarray([v for v in series if v is not None], np.float64)
    n = len(vals)
    lo = float(vals.min()) if n else 0.0
    hi = float(vals.max()) if n else 0.0
    total = float(vals.sum()) if n else 0.0
    mean = float(vals.mean()) if n else 0.0
    std = float(vals.std()) if n else 0.0
    emax = float(np.exp(vals - vals.max()).sum()) if n else 0.0

    def norm_one(v):
        if v is None:
            return None
        if method == "rescale_0_1":
            return 0.0 if hi == lo else (v - lo) / (hi - lo)
        if method == "rescale_0_100":
            return 0.0 if hi == lo else 100.0 * (v - lo) / (hi - lo)
        if method == "percent_of_sum":
            return None if total == 0 else v / total
        if method == "mean":
            return 0.0 if hi == lo else (v - mean) / (hi - lo)
        if method in ("z-score", "zscore"):
            return None if std == 0 else (v - mean) / std
        if method == "softmax":
            return None if emax == 0 else float(np.exp(v - hi)) / emax
        raise IllegalArgumentException(f"invalid normalize method [{method}]")

    for b, v in zip(buckets, series):
        b[name] = {"value": norm_one(v)}


def _bucket_script(name, ptype, body, buckets):
    """``bucket_script`` writes a computed value per bucket,
    ``bucket_selector`` keeps the buckets its predicate holds for; the
    Painless interpreter runs with ``params`` bound to the resolved
    ``buckets_path`` values. A runtime error fails the request
    (``script_exception``); only a division by zero degrades to a null
    value."""
    paths = body.get("buckets_path") or {}
    if isinstance(paths, str):
        paths = {"_value": paths}
    spec = body.get("script", "")
    src = spec.get("source", "") if isinstance(spec, dict) else str(spec)
    static = spec.get("params", {}) if isinstance(spec, dict) else {}
    try:
        script = _compile(src)
    except PainlessError as e:
        raise ParsingException(f"[{ptype}] script compile error: {e}")
    gap = str(body.get("gap_policy", "skip"))
    selector = ptype == "bucket_selector"
    keep = []
    for b in buckets:
        vals = {k: _bucket_metric_value(b, p) for k, p in paths.items()}
        missing = any(v is None for v in vals.values())
        if missing and gap != "insert_zeros":
            # skip: bucket_script writes nothing, bucket_selector keeps
            keep.append(b)
            continue
        if missing:
            vals = {k: (0.0 if v is None else v) for k, v in vals.items()}
        try:
            result = script.execute({"params": {**static, **vals}})
        except ZeroDivisionError:
            result = None
        except PainlessError as e:
            raise ScriptException(f"[{ptype}] runtime error: {e} in [{src}]")
        if selector:
            if bool(result):
                keep.append(b)
        else:
            try:
                value = None if result is None else float(result)
            except (TypeError, ValueError):
                raise ScriptException(
                    f"[{ptype}] script returned a non-numeric value "
                    f"[{result!r}] in [{src}]")
            b[name] = {"value": value}
    if selector:
        buckets[:] = keep


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


_BUCKET_FNS: Dict[str, Any] = {}


def _bucket(agg_type, body, sub, ctx, mapper):
    fn = _BUCKET_FNS.get(agg_type)
    if fn is not None:
        return fn(agg_type, body, sub, ctx, mapper)
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


def _bucket_agg(*types):
    def register(fn):
        for t in types:
            _BUCKET_FNS[t] = fn
        return fn
    return register


def _needs_masks(sub) -> bool:
    """Whether a bucket's sub-aggs read its doc masks (parent pipelines
    read only the finished buckets)."""
    return bool(sub) and bool(_split_parent_pipelines(sub)[0])


def _group_masks(ctx, row_seg, row_doc, row_group, n_groups):
    """Per group, its per-segment doc masks: the rows (segment, docid)
    of each group, sorted by group once."""
    order = np.argsort(row_group, kind="stable")
    bounds = np.searchsorted(row_group[order], np.arange(n_groups + 1))
    for g in range(n_groups):
        rows = order[bounds[g]: bounds[g + 1]]
        submasks = []
        for si, (seg, _mask, _m) in enumerate(ctx):
            sm = np.zeros(seg.n_docs, bool)
            sm[row_doc[rows[row_seg[rows] == si]]] = True
            submasks.append(sm)
        yield submasks


def _unique_rows(codes: np.ndarray, radix: List[int]):
    """``np.unique(codes, axis=0, return_inverse=True,
    return_counts=True)`` for rows of non-negative integer codes, column
    ``j`` below ``radix[j]``: the rows as one mixed-radix int64 key where
    it fits (a 1-D unique, an order of magnitude faster at millions of
    rows), else the row-wise unique. The rows come back in the same
    lexicographic order."""
    if float(np.prod(np.asarray(radix, np.float64))) < 2.0 ** 62:
        key = np.zeros(len(codes), np.int64)
        for j, r in enumerate(radix):
            key = key * r + codes[:, j]
        ukey, inverse, counts = np.unique(key, return_inverse=True,
                                          return_counts=True)
        rows = np.zeros((len(ukey), len(radix)), np.int64)
        for j in range(len(radix) - 1, -1, -1):
            rows[:, j] = ukey % radix[j]
            ukey = ukey // radix[j]
        return rows, inverse.reshape(-1), counts
    rows, inverse, counts = np.unique(codes, axis=0, return_inverse=True,
                                      return_counts=True)
    return rows, inverse.reshape(-1), counts


# ---- composite -------------------------------------------------------------

def _composite_source_values(stype, sbody, seg):
    """One source's per-doc (first) key values over one segment:
    ``(terms, values, valid)`` where a keyword source gives the
    segment's terms and its first ords, a numeric one None and float64
    keys; ``(None, None, None)`` when the segment lacks the field."""
    field = sbody.get("field")
    if stype == "terms":
        kv = seg.keywords.get(field)
        if kv is not None:
            return kv.terms, kv.ords, kv.ords >= 0
        nv = seg.numerics.get(field)
        if nv is not None:
            return None, nv.values, ~nv.missing
        return None, None, None
    nv = seg.numerics.get(field)
    if nv is None:
        return None, None, None
    if stype == "histogram":
        interval = float(sbody["interval"])
        return None, np.floor(nv.values / interval) * interval, ~nv.missing
    if stype == "date_histogram":
        cal_unit = _calendar_unit(sbody)
        if cal_unit is not None:
            return None, _calendar_floor_ms(nv.values, cal_unit), ~nv.missing
        interval = _date_interval_ms(sbody)
        return None, np.floor(nv.values / interval) * interval, ~nv.missing
    raise ParsingException(f"Unknown composite source type [{stype}]")


def _cmp_table(uniq, after_v, numeric: bool) -> np.ndarray:
    """int [1 + U]: the reference's comparison (-1, 0, 1) of the missing
    key (slot 0) and of each distinct value with the ``after`` value."""
    out = np.zeros(1 + len(uniq), np.int64)
    if after_v is None:
        out[1:] = 1
        return out
    out[0] = -1
    if numeric and isinstance(after_v, (int, float)):
        u = np.asarray(uniq, np.float64)
        out[1:] = np.where(u == after_v, 0, np.where(u < after_v, -1, 1))
    else:
        out[1:] = [0 if x == after_v else (-1 if x < after_v else 1)
                   for x in uniq]
    return out


@_bucket_agg("composite")
def _composite(agg_type, body, sub, ctx, mapper):
    """Paginable multi-source buckets with ``after`` cursoring. Each
    source's values become codes, 1 + their rank among its distinct
    values across the segments (0: the missing bucket); a doc's key is
    its row of codes, and the groups order by the codes, negated for
    ``desc`` sources: the reference's ``_composite_cmp`` (missing first
    on asc, last on desc) over integers."""
    sources = body.get("sources", [])
    if not sources:
        raise ParsingException("composite requires [sources]")
    size = int(body.get("size", 10))
    after = body.get("after")
    names, orders, missing_ok, specs = [], [], [], []
    for src in sources:
        (name, spec), = src.items()
        (stype, sbody), = spec.items()
        names.append(name)
        orders.append(sbody.get("order", "asc"))
        missing_ok.append(bool(sbody.get("missing_bucket", False)))
        specs.append((stype, sbody))
    with _prof.span("aggs.group"):
        groups, row_group, counts, uniq, page, row_seg, row_doc = \
            _composite_groups(ctx, specs, names, orders, missing_ok, after,
                              size)

    def key_of(g):
        return {n: (None if groups[g, j] == 0
                    else uniq[j][int(groups[g, j]) - 1])
                for j, n in enumerate(names)}

    if _needs_masks(sub):
        pos = np.full(len(groups), -1, np.int64)
        pos[page] = np.arange(len(page))
        in_page = pos[row_group] >= 0
        masks = _group_masks(ctx, row_seg[in_page], row_doc[in_page],
                             pos[row_group[in_page]], len(page))
    else:
        masks = (None for _ in page)
    buckets = []
    for g, submasks in zip(page, masks):
        bucket_ctx = ctx if submasks is None else _refine(ctx, submasks)
        buckets.append(_bucket_result(sub, bucket_ctx, mapper,
                                      int(counts[g]), {"key": key_of(g)}))
    _apply_parent_pipelines(_split_parent_pipelines(sub)[1], buckets)
    out: Dict[str, Any] = {"buckets": buckets}
    if buckets:
        out["after_key"] = buckets[-1]["key"]
    return out


def _composite_groups(ctx, specs, names, orders, missing_ok, after, size):
    """The composite's groups: (rows of codes [G, S], each matched row's
    group, the groups' doc counts, each source's distinct values, the
    page's groups in order, each row's segment and docid)."""
    n_src = len(specs)
    extracted = [[_composite_source_values(stype, sbody, seg)
                  for stype, sbody in specs] for seg, _mask, _m in ctx]
    # the matched docs whose every source has a value (or a missing
    # bucket), and each source's distinct values
    rows = []
    distinct = [[] for _ in range(n_src)]
    for si, (seg, mask, _m) in enumerate(ctx):
        docs = np.nonzero(mask[: seg.n_docs])[0]
        oks = []
        keep = np.ones(len(docs), bool)
        for j, (_t, vals, valid) in enumerate(extracted[si]):
            ok = (valid[docs] if vals is not None
                  else np.zeros(len(docs), bool))
            if not missing_ok[j]:
                keep &= ok
            oks.append(ok)
        docs = docs[keep]
        oks = [ok[keep] for ok in oks]
        for j, (terms, vals, _v) in enumerate(extracted[si]):
            if vals is None:
                continue
            present = vals[docs][oks[j]]
            if terms is not None:
                distinct[j].extend(terms[int(o)] for o in np.unique(present))
            else:
                distinct[j].append(np.unique(present))
        rows.append((docs, oks))
    uniq, numeric = [], []
    for j in range(n_src):
        parts = distinct[j]
        if parts and all(isinstance(p, np.ndarray) for p in parts):
            uniq.append([float(v) for v in np.unique(np.concatenate(parts))])
            numeric.append(True)
        else:
            vals = set()
            for p in parts:
                vals.update(p.tolist() if isinstance(p, np.ndarray) else [p])
            uniq.append(sorted(vals))
            numeric.append(False)
    # each row's codes: 1 + its rank per source, 0 for the missing bucket
    codes, row_seg, row_doc = [], [], []
    ranks = [None if num else {v: i for i, v in enumerate(u)}
             for u, num in zip(uniq, numeric)]
    for si, (docs, oks) in enumerate(rows):
        cols = []
        for j, (terms, vals, _v) in enumerate(extracted[si]):
            c = np.zeros(len(docs), np.int64)
            if vals is not None and len(docs):
                ok = oks[j]
                rank = ranks[j]
                if terms is not None:
                    present = np.unique(vals[docs][ok])
                    lut = np.zeros(len(terms), np.int64)
                    lut[present] = [1 + rank[terms[int(o)]] for o in present]
                    c[ok] = lut[vals[docs][ok]]
                elif numeric[j]:
                    c[ok] = 1 + np.searchsorted(np.asarray(uniq[j]),
                                                vals[docs][ok])
                else:
                    c[ok] = [1 + rank[float(v)] for v in vals[docs][ok]]
            cols.append(c)
        codes.append(np.stack(cols, axis=1) if cols
                     else np.zeros((len(docs), 0), np.int64))
        row_seg.append(np.full(len(docs), si))
        row_doc.append(docs)
    codes = (np.concatenate(codes) if codes
             else np.zeros((0, n_src), np.int64))
    row_seg = np.concatenate(row_seg) if row_seg else np.zeros(0, np.int64)
    row_doc = np.concatenate(row_doc) if row_doc else np.zeros(0, np.int64)
    groups, row_group, counts = _unique_rows(
        codes, [len(u) + 1 for u in uniq])
    # the composite order: per source ascending codes (missing first),
    # negated for desc (missing last)
    sort_cols = [groups[:, j] if orders[j] != "desc" else -groups[:, j]
                 for j in range(n_src)]
    ordered = np.lexsort(sort_cols[::-1]) if len(groups) else \
        np.zeros(0, np.int64)
    if after is not None and len(ordered):
        cmp = np.zeros(len(groups), np.int64)
        for j in range(n_src - 1, -1, -1):
            cj = _cmp_table(uniq[j], after.get(names[j]),
                            numeric[j])[groups[:, j]]
            if orders[j] == "desc":
                cj = -cj
            cmp = np.where(cj != 0, cj, cmp)
        ordered = ordered[cmp[ordered] > 0]
    return (groups, row_group, counts, uniq, ordered[:size], row_seg,
            row_doc)


# ---- the terms family -------------------------------------------------------

def _jlh(fg_counts, bg_counts, fg_total, bg_total, min_doc_count):
    """[(score, term, fg, bg)] of the terms whose foreground rate beats
    the background's, JLH-scored, best first (ties by term)."""
    scored = []
    for term, fg in fg_counts.items():
        if fg < min_doc_count:
            continue
        bg = bg_counts.get(term, fg)
        fg_rate = fg / max(fg_total, 1)
        bg_rate = bg / max(bg_total, 1)
        if fg_rate <= bg_rate:
            continue
        score = (fg_rate - bg_rate) * (fg_rate / max(bg_rate, 1e-12))
        scored.append((score, term, fg, bg))
    scored.sort(key=lambda t: (-t[0], t[1]))
    return scored


@_bucket_agg("significant_terms")
def _significant_terms(agg_type, body, sub, ctx, mapper):
    """Keyword terms whose foreground (matched) rate is anomalously high
    against the background (every live doc of every segment)."""
    field = body.get("field")
    size = int(body.get("size", 10))
    min_doc_count = int(body.get("min_doc_count", 3))
    fg_counts = _keyword_terms_counts(ctx, field)
    bg_ctx = [(seg, seg.live.copy(), m) for seg, _msk, m in ctx]
    bg_counts = _keyword_terms_counts(bg_ctx, field)
    fg_total = _doc_count(ctx)
    bg_total = _doc_count(bg_ctx)
    buckets = []
    for score, term, fg, bg in _jlh(fg_counts, bg_counts, fg_total,
                                    bg_total, min_doc_count)[:size]:
        bucket_ctx = (_refine(ctx, [_keyword_membership_mask(seg, field, term)
                                    for seg, _m2, _m3 in ctx])
                      if sub else ctx)
        buckets.append(_bucket_result(
            sub, bucket_ctx, mapper, fg,
            {"key": term, "score": score, "bg_count": bg}))
    _apply_parent_pipelines(_split_parent_pipelines(sub)[1], buckets)
    return {"doc_count": fg_total, "bg_count": bg_total, "buckets": buckets}


@_bucket_agg("significant_text")
def _significant_text(agg_type, body, sub, ctx, mapper):
    """The text of the first ``shard_size`` matched docs of each segment,
    analyzed again with the field's index analyzer (the postings' terms),
    JLH-scored against the postings' doc frequencies. Sub-aggregations
    are refused, as in the reference."""
    if sub:
        raise ParsingException(
            "significant_text does not support sub-aggregations")
    field = body.get("field")
    size = int(body.get("size", 10))
    min_doc_count = int(body.get("min_doc_count", 3))
    shard_size = int(body.get("shard_size", 200))
    filter_dup = bool(body.get("filter_duplicate_text", False))
    analyzer = mapper.analysis.resolve(
        getattr(mapper.field_type(field), "analyzer_name", None))
    fg_counts: Dict[str, int] = {}
    fg_total = 0
    bg_df: Dict[str, int] = {}
    bg_total = 0
    seen_text = set()
    for seg, mask, _m in ctx:
        pf = seg.postings.get(field)
        if pf is not None:
            for t, df in zip(pf.terms, pf.doc_freq):
                bg_df[t] = bg_df.get(t, 0) + int(df)
        bg_total += int(seg.live.sum())
        for d in np.nonzero(mask[: seg.n_docs])[0][:shard_size]:
            try:
                src = json.loads(seg.stored.source(int(d)))
            except ValueError:
                continue
            text = src.get(field)
            if not isinstance(text, str):
                continue
            if filter_dup:
                h = hash(text)
                if h in seen_text:
                    continue
                seen_text.add(h)
            fg_total += 1
            for term in {t.term for t in analyzer.analyze(text)}:
                fg_counts[term] = fg_counts.get(term, 0) + 1
    return {"doc_count": fg_total, "bg_count": bg_total,
            "buckets": [{"key": term, "doc_count": fg, "score": score,
                         "bg_count": bg}
                        for score, term, fg, bg in _jlh(
                            fg_counts, bg_df, fg_total, bg_total,
                            min_doc_count)[:size]]}


@_bucket_agg("rare_terms")
def _rare_terms(agg_type, body, sub, ctx, mapper):
    """The terms of at most ``max_doc_count`` docs (default 1),
    ascending by count, then key; the counts are exact."""
    field = body.get("field")
    max_dc = int(body.get("max_doc_count", 1))
    if not 1 <= max_dc <= 100:
        raise ParsingException("[max_doc_count] must be in [1, 100]")
    counts = _keyword_terms_counts(ctx, field)
    buckets = []
    for c, term in sorted((c, t) for t, c in counts.items() if c <= max_dc):
        bucket_ctx = (_refine(ctx, [_keyword_membership_mask(seg, field, term)
                                    for seg, _m2, _m3 in ctx])
                      if sub else ctx)
        buckets.append(_bucket_result(sub, bucket_ctx, mapper, c,
                                      {"key": term}))
    _apply_parent_pipelines(_split_parent_pipelines(sub)[1], buckets)
    return {"buckets": buckets}


@_bucket_agg("multi_terms")
def _multi_terms(agg_type, body, sub, ctx, mapper):
    """Compound keys over several sources, counted like ``terms``: the
    first value per doc per source, each source's values as codes, the
    rows of codes made unique with counts (``_unique_rows``), keys
    spelled per distinct row."""
    terms_spec = body.get("terms") or []
    if len(terms_spec) < 2:
        raise ParsingException(
            "multi_terms requires at least two terms sources")
    size = int(body.get("size", 10))
    fields = [t.get("field") for t in terms_spec]
    counts: Dict[tuple, int] = {}
    seg_rows = []
    for seg, mask, _m in ctx:
        docs = np.nonzero(mask[: seg.n_docs])[0]
        cols = []
        for f in fields:
            kv = seg.keywords.get(f)
            if kv is not None:
                vals = np.asarray(kv.ords, np.int64)[docs]
                cols.append(("k", kv, vals, vals >= 0))
                continue
            nv = seg.numerics.get(f)
            if nv is not None:
                cols.append(("n", None, nv.values[docs], ~nv.missing[docs]))
                continue
            cols.append(("x", None, np.full(len(docs), -1),
                         np.zeros(len(docs), bool)))
        seg_rows.append((seg, docs, cols))
        valid = np.ones(len(docs), bool)
        for _, _, _, has in cols:
            valid &= has
        if not valid.any():
            continue
        # each source's values as codes, the rows of codes made unique
        uniq = []
        for _k, _kv, vals, _h in cols:
            u, inv = np.unique(np.asarray(vals, np.float64)[valid],
                               return_inverse=True)
            uniq.append((u, inv.reshape(-1)))
        rows, _inv, row_counts = _unique_rows(
            np.stack([inv for _u, inv in uniq], axis=1),
            [len(u) for u, _inv in uniq])
        for row, rc in zip(rows, row_counts):
            key = tuple(
                kv.terms[int(u[row[j]])] if kind == "k" else float(u[row[j]])
                for j, ((kind, kv, _v, _h), (u, _i)) in enumerate(
                    zip(cols, uniq)))
            counts[key] = counts.get(key, 0) + int(rc)
    # numeric keys keep numeric order on ties; a field keyword in one
    # index and numeric in another never compares str with float
    top = sorted(counts.items(),
                 key=lambda kv_: (-kv_[1], tuple((isinstance(x, str), x)
                                                 for x in kv_[0])))[:size]
    buckets = []
    for key, c in top:
        submasks = []
        for seg, docs, cols in seg_rows:
            m = np.zeros(seg.n_docs, bool)
            valid = np.ones(len(docs), bool)
            for (kind, kv, vals, has), want in zip(cols, key):
                if kind == "k":
                    tid = (kv.terms.index(want)
                           if isinstance(want, str) and want in kv.terms
                           else -2)
                    valid &= has & (vals == tid)
                else:
                    valid &= (has & (vals == want)
                              if isinstance(want, float)
                              else np.zeros(len(docs), bool))
            m[docs[valid]] = True
            submasks.append(m)
        buckets.append(_bucket_result(
            sub, _refine(ctx, submasks), mapper, c,
            {"key": list(key),
             "key_as_string": "|".join(str(k) for k in key)}))
    _apply_parent_pipelines(_split_parent_pipelines(sub)[1], buckets)
    return {"buckets": buckets, "doc_count_error_upper_bound": 0,
            "sum_other_doc_count": max(0, sum(counts.values())
                                       - sum(c for _, c in top))}


# ---- numeric, ip and date buckets ---------------------------------------------

@_bucket_agg("variable_width_histogram")
def _variable_width_histogram(agg_type, body, sub, ctx, mapper):
    """At most ``buckets`` variable-width buckets over the first values:
    quantile seeds and two Lloyd passes over the sorted values, as the
    reference clusters them."""
    field = body.get("field")
    target = int(body.get("buckets", 10))
    parts = []
    for seg, mask, _m in ctx:
        vv, m = _first_values_and_mask(seg, mask, field)
        if vv is not None and m.any():
            parts.append(vv[m])
    values = np.sort(np.concatenate(parts)) if parts else np.zeros(0)
    if values.size == 0:
        return {"buckets": []}
    k = min(target, len(np.unique(values)))
    centroids = np.quantile(values, (np.arange(k) + 0.5) / k)
    for _ in range(2):
        bounds = (centroids[:-1] + centroids[1:]) / 2.0
        assign = np.searchsorted(bounds, values)
        centroids = np.array([
            values[assign == i].mean() if (assign == i).any()
            else centroids[i] for i in range(k)])
    bounds = (centroids[:-1] + centroids[1:]) / 2.0
    buckets = []
    for i in range(k):
        lo = -np.inf if i == 0 else bounds[i - 1]
        hi = np.inf if i == k - 1 else bounds[i]
        submasks = []
        count = 0
        bmin = bmax = None
        for seg, mask, _m in ctx:
            vv, m = _first_values_and_mask(seg, mask, field)
            if vv is None:
                submasks.append(np.zeros(seg.n_docs, bool))
                continue
            in_b = (m & (vv >= lo) & (vv < hi) if i < k - 1
                    else m & (vv >= lo))
            submasks.append(in_b)
            count += int(in_b.sum())
            if in_b.any():
                lo_v, hi_v = float(vv[in_b].min()), float(vv[in_b].max())
                bmin = lo_v if bmin is None else min(bmin, lo_v)
                bmax = hi_v if bmax is None else max(bmax, hi_v)
        if count == 0:
            continue
        buckets.append(_bucket_result(
            sub, _refine(ctx, submasks), mapper, count,
            {"key": float(centroids[i]), "min": bmin, "max": bmax}))
    _apply_parent_pipelines(_split_parent_pipelines(sub)[1], buckets)
    return {"buckets": buckets}


@_bucket_agg("ip_range")
def _ip_range(agg_type, body, sub, ctx, mapper):
    """Ranges or CIDR masks over an ip field's numeric doc values."""
    import ipaddress
    field = body.get("field")
    buckets = []
    for r in body.get("ranges", []):
        if "mask" in r:
            net = ipaddress.ip_network(r["mask"], strict=False)
            frm = float(int(net.network_address))
            # +1 in integer space before the float: at IPv6 magnitudes
            # a float +1.0 is lost
            to = float(int(net.broadcast_address) + 1)
            key = r.get("key", r["mask"])
        else:
            frm = (float(int(ipaddress.ip_address(r["from"])))
                   if r.get("from") is not None else None)
            to = (float(int(ipaddress.ip_address(r["to"])))
                  if r.get("to") is not None else None)
            key = r.get("key", f"{r.get('from', '*')}-{r.get('to', '*')}")
        submasks, count = _range_masks(ctx, field, frm, to)
        extra = {"key": key}
        if "mask" in r:
            extra["mask"] = r["mask"]
        if r.get("from") is not None:
            extra["from"] = r["from"]
        if r.get("to") is not None:
            extra["to"] = r["to"]
        buckets.append(_bucket_result(sub, _refine(ctx, submasks), mapper,
                                      count, extra))
    return {"buckets": buckets}


@_bucket_agg("auto_date_histogram")
def _auto_date_histogram(agg_type, body, sub, ctx, mapper):
    """The smallest rounding of the ladder whose floor-based bucket
    count fits ``buckets``, then that date_histogram with gap fill."""
    field = body.get("field")
    target = int(body.get("buckets", 10))
    lo = hi = None
    for seg, mask, _m in ctx:
        vv, m = _first_values_and_mask(seg, mask, field)
        if vv is None or not m.any():
            continue
        vals = vv[m]
        lo = float(vals.min()) if lo is None else min(lo, vals.min())
        hi = float(vals.max()) if hi is None else max(hi, vals.max())
    if lo is None:
        return {"buckets": [], "interval": "1s"}
    ladder = [("1s", {"fixed_interval": "1s"}),
              ("1m", {"fixed_interval": "1m"}),
              ("1h", {"fixed_interval": "1h"}),
              ("1d", {"fixed_interval": "1d"}),
              ("7d", {"calendar_interval": "week"}),
              ("1M", {"calendar_interval": "month"}),
              ("1q", {"calendar_interval": "quarter"}),
              ("1y", {"calendar_interval": "year"})]
    chosen_label, chosen = ladder[-1]
    label_to_key = {"7d": "week", "1q": "quarter"}
    for label, spec in ladder:
        unit = _INTERVALS_MS[label_to_key.get(label, label)]
        count = int(np.floor(hi / unit)) - int(np.floor(lo / unit)) + 1
        if count <= target:
            chosen_label, chosen = label, spec
            break
    inner = dict(chosen, field=field, min_doc_count=0)
    out = _histogram("date_histogram", inner, sub, ctx, mapper)
    out["interval"] = chosen_label
    return out


# ---- geo buckets ------------------------------------------------------------

@_bucket_agg("geo_distance")
def _geo_distance(agg_type, body, sub, ctx, mapper):
    """Range buckets by haversine distance from an origin, on the host
    float64 columns (bucket counts are exact there), each segment's
    distances computed once for every ring, of its matched points
    only."""
    field = body.get("field")
    o_lat, o_lon = parse_geo_point(body.get("origin"))
    unit = body.get("unit", "m")
    scale = GEO_UNITS.get(unit)
    if scale is None:
        raise IllegalArgumentException(
            f"unknown distance unit [{unit}] for geo_distance aggregation")
    # per segment: its matched points' docids and distances
    points: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    buckets = []
    for r in body.get("ranges", []):
        frm = r.get("from")
        to = r.get("to")
        submasks = []
        count = 0
        for si, (seg, mask, _m) in enumerate(ctx):
            nlat = seg.numerics.get(f"{field}.lat")
            nlon = seg.numerics.get(f"{field}.lon")
            in_r = np.zeros(seg.n_docs, bool)
            if nlat is None or nlon is None:
                submasks.append(in_r)
                continue
            if si not in points:
                docs = np.nonzero(mask[: seg.n_docs] & ~nlat.missing)[0]
                points[si] = (docs, haversine_meters(
                    nlat.values[docs], nlon.values[docs], o_lat, o_lon))
            docs, dist = points[si]
            keep = np.ones(len(docs), bool)
            if frm is not None:
                keep &= dist >= float(frm) * scale
            if to is not None:
                keep &= dist < float(to) * scale
            in_r[docs[keep]] = True
            submasks.append(in_r)
            count += int(keep.sum())
        key = r.get("key", f"{frm if frm is not None else '*'}-"
                           f"{to if to is not None else '*'}")
        extra = {"key": key}
        if frm is not None:
            extra["from"] = float(frm)
        if to is not None:
            extra["to"] = float(to)
        buckets.append(_bucket_result(sub, _refine(ctx, submasks), mapper,
                                      count, extra))
    return {"buckets": buckets}


@_bucket_agg("geohash_grid", "geotile_grid")
def _geo_grid(agg_type, body, sub, ctx, mapper):
    """Grid cells of the matched points as integer codes, counted over
    the code space (``_small_unique``); only the distinct cells are
    spelled as keys, ordered by count descending, then key. A bucket's
    doc masks are built only when sub-aggs read them, and not at all
    when they are point metrics (``_point_metrics``)."""
    field = body.get("field")
    is_hash = agg_type == "geohash_grid"
    precision = int(body.get("precision", 5 if is_hash else 7))
    size = int(body.get("size", 10000))
    code_fn = geohash_codes if is_hash else geotile_codes
    spell = geohash_strings if is_hash else geotile_strings
    row_seg, row_doc, row_code = [], [], []
    with _prof.span("aggs.cells"):
        for si, (seg, mask, _m) in enumerate(ctx):
            nlat = seg.numerics.get(f"{field}.lat")
            nlon = seg.numerics.get(f"{field}.lon")
            if nlat is None or nlon is None:
                continue
            docs = np.nonzero(mask[: seg.n_docs] & ~nlat.missing)[0]
            row_seg.append(np.full(len(docs), si))
            row_doc.append(docs)
            row_code.append(code_fn(nlat.values[docs], nlon.values[docs],
                                    precision))
        if not row_code:
            return {"buckets": []}
        codes, row_key = _small_unique(np.concatenate(row_code),
                                       5 * precision if is_hash
                                       else 2 * precision)
        if len(codes) == 0:
            return {"buckets": []}
        keys = spell(codes, precision)
        counts = np.bincount(row_key, minlength=len(keys))
        top = np.lexsort((keys, -counts))[:size]
    masks = (None for _ in top)
    points = None
    if _needs_masks(sub):
        pos = np.full(len(keys), -1, np.int64)
        pos[top] = np.arange(len(top))
        in_top = pos[row_key] >= 0
        rows = (np.concatenate(row_seg)[in_top],
                np.concatenate(row_doc)[in_top], pos[row_key[in_top]])
        point_subs = _point_metric_subs(sub)
        if point_subs is not None:
            points = _point_metrics(ctx, *rows, len(top), point_subs)
        else:
            masks = _group_masks(ctx, *rows, len(top))
    buckets = []
    for i, (k, submasks) in enumerate(zip(top, masks)):
        extra = {"key": str(keys[k])}
        if points is not None:
            buckets.append(dict(extra, doc_count=int(counts[k]),
                                **points[i]))
            continue
        bucket_ctx = ctx if submasks is None else _refine(ctx, submasks)
        buckets.append(_bucket_result(sub, bucket_ctx, mapper,
                                      int(counts[k]), extra))
    return {"buckets": buckets}


def _small_unique(codes: np.ndarray, bits: int):
    """``np.unique(codes, return_inverse=True)`` of non-negative codes
    below ``2^bits``: a bincount over the code space where it is small
    (no sort of the points), else the sort."""
    if bits > 24:
        uniq, inverse = np.unique(codes, return_inverse=True)
        return uniq, inverse.reshape(-1)
    present = np.bincount(codes, minlength=1 << bits) > 0
    rank = np.cumsum(present) - 1
    return np.nonzero(present)[0], rank[codes]


_POINT_METRICS = {"geo_centroid": _geo_centroid, "geo_bounds": _geo_bounds}


def _point_metric_subs(sub):
    """[(name, metric fn, field)] when every sub-agg is a geo_centroid or
    geo_bounds without sub-aggs of its own (a map layer's shape), else
    None."""
    out = []
    for name, node in sub.items():
        types = [k for k in node if k not in _NODE_KEYS]
        if len(types) != 1 or types[0] not in _POINT_METRICS \
                or node.get("aggs") or node.get("aggregations"):
            return None
        out.append((name, _POINT_METRICS[types[0]],
                    (node[types[0]] or {}).get("field")))
    return out


def _point_metrics(ctx, row_seg, row_doc, row_group, n_groups, subs):
    """Each group's point metrics from its rows' points, gathered once
    and sliced per group: the rows sorted by group keep their (segment,
    docid) order, so each group's points are the sequence ``_geo_points``
    reads from the group's doc masks, and its sums the same."""
    order = np.argsort(row_group, kind="stable")
    bounds = np.searchsorted(row_group[order], np.arange(n_groups + 1))
    seg_of, doc_of = row_seg[order], row_doc[order]
    cols = {}
    for field in {f for _n, _fn, f in subs}:
        lat = np.zeros(len(order))
        lon = np.zeros(len(order))
        present = np.zeros(len(order), bool)
        for si, (seg, _mask, _m) in enumerate(ctx):
            nlat = seg.numerics.get(f"{field}.lat")
            nlon = seg.numerics.get(f"{field}.lon")
            if nlat is None or nlon is None:
                continue
            at = np.nonzero(seg_of == si)[0]
            d = doc_of[at]
            lat[at] = nlat.values[d]
            lon[at] = nlon.values[d]
            present[at] = ~nlat.missing[d]
        cols[field] = (lat, lon, present)
    out = []
    for g in range(n_groups):
        lo, hi = bounds[g], bounds[g + 1]
        res = {}
        for name, fn, field in subs:
            lat, lon, present = cols[field]
            sel = present[lo:hi]
            res[name] = fn(lat[lo:hi][sel], lon[lo:hi][sel])
        out.append(res)
    return out


# ---- joins, nesting, samplers, matrices ----------------------------------------

@_bucket_agg("children", "parent")
def _children_parent(agg_type, body, sub, ctx, mapper):
    """``children``: from the matched parents to their children of the
    given relation; ``parent``: from the matched children of the
    relation to their parents, through the ``{join}#parent`` keyword
    doc values, over every segment (a parent and its children may live
    in different segments), live docs only."""
    jf = _join_field(mapper)
    if jf is None:
        raise ParsingException(
            f"[{agg_type}] aggregation requires a [join] field in the "
            "mapping")
    rel_type = body.get("type")
    if not rel_type:
        raise ParsingException(f"[{agg_type}] requires [type]")
    if jf.parent_of(rel_type) is None:
        raise ParsingException(
            f"unknown join relation type [{rel_type}] for [{agg_type}]")
    keys: set = set()
    for seg, mask, _m in ctx:
        if agg_type == "children":
            keys.update(seg.stored.ids[int(d)]
                        for d in np.nonzero(mask[: seg.n_docs])[0])
        else:
            pkv = seg.keywords.get(f"{jf.name}#parent")
            if pkv is None:
                continue
            is_child = _relation_docs(seg, jf.name, [rel_type])
            child_docs = np.nonzero(mask[: seg.n_docs] & is_child)[0]
            keys.update(pkv.terms[int(o)]
                        for o in pkv.ords[child_docs] if o >= 0)
    submasks = []
    count = 0
    for seg, mask, _m in ctx:
        out = np.zeros(seg.n_docs, bool)
        if agg_type == "children":
            pkv = seg.keywords.get(f"{jf.name}#parent")
            if pkv is not None:
                want = np.asarray([i for i, t in enumerate(pkv.terms)
                                   if t in keys], np.int64)
                out = (_relation_docs(seg, jf.name, [rel_type])
                       & np.isin(pkv.ords[: seg.n_docs], want))
        else:
            for pid in keys:
                d = seg.docid_for(pid)
                if d >= 0:
                    out[d] = True
        out &= seg.live[: seg.n_docs]
        submasks.append(out)
        count += int(out.sum())
    bucket_ctx = _refine([(seg, seg.live.copy(), m) for seg, _msk, m in ctx],
                         submasks)
    res = {"doc_count": count}
    if sub:
        res.update(_compute_aggs(sub, bucket_ctx, mapper))
    return res


@_bucket_agg("nested")
def _nested(agg_type, body, sub, ctx, mapper):
    """``doc_count`` is the number of nested objects under ``path`` in
    the matched docs (the most values any subfield holds per doc); the
    flattened columns already hold every object's values, so sub-aggs
    run over the matched docs."""
    prefix = body.get("path", "") + "."
    n_objects = 0
    for seg, mask, _m in ctx:
        counts = None
        for cols in (seg.numerics, seg.keywords):
            for fname, dv in cols.items():
                if fname.startswith(prefix):
                    c = dv.offsets[1:] - dv.offsets[:-1]
                    counts = c if counts is None else np.maximum(counts, c)
        if counts is not None:
            n_objects += int(counts[mask[: seg.n_docs]].sum())
    out = {"doc_count": n_objects}
    if sub:
        out.update(_compute_aggs(sub, ctx, mapper))
    return out


@_bucket_agg("sampler", "diversified_sampler")
def _sampler(agg_type, body, sub, ctx, mapper):
    """The first ``shard_size`` matched docs of each segment by docid
    (not the best scored, as the reference); ``diversified_sampler``
    also skips a doc once ``max_docs_per_value`` docs sharing one of its
    values of ``field`` were taken."""
    shard_size = int(body.get("shard_size", 100))
    div_field = body.get("field") if agg_type == "diversified_sampler" \
        else None
    max_per_value = int(body.get("max_docs_per_value", 1))
    submasks = []
    for seg, mask, _m in ctx:
        docs = np.nonzero(mask[: seg.n_docs])[0]
        if div_field is not None:
            per_value: Dict[Any, int] = {}
            picked = []
            kv = seg.keywords.get(div_field)
            nv = seg.numerics.get(div_field)
            for d in docs:
                if kv is not None:
                    vals = tuple(kv.get(int(d))) or ("",)
                elif nv is not None and not nv.missing[d]:
                    vals = (float(nv.values[d]),)
                else:
                    vals = ("",)
                if any(per_value.get(v, 0) >= max_per_value for v in vals):
                    continue
                for v in vals:
                    per_value[v] = per_value.get(v, 0) + 1
                picked.append(int(d))
                if len(picked) >= shard_size:
                    break
            docs = np.asarray(picked, np.int64)
        else:
            docs = docs[:shard_size]
        sm = np.zeros(seg.n_docs, bool)
        sm[docs] = True
        submasks.append(sm)
    bucket_ctx = _refine(ctx, submasks)
    return _bucket_result(sub, bucket_ctx, mapper, _doc_count(bucket_ctx),
                          {})


@_bucket_agg("adjacency_matrix")
def _adjacency_matrix(agg_type, body, sub, ctx, mapper):
    """One bucket per named filter and per intersecting pair
    (``A&B``), names sorted, empty buckets left out."""
    sep = body.get("separator", "&")
    masks = {fname: _query_masks(parse_query(fspec), ctx, mapper)
             for fname, fspec in body.get("filters", {}).items()}
    names = sorted(masks)
    buckets = []
    for i, a in enumerate(names):
        for key, submasks in [(a, masks[a])] + [
                (f"{a}{sep}{b}", [ma & mb for ma, mb in
                                  zip(masks[a], masks[b])])
                for b in names[i + 1:]]:
            bucket_ctx = _refine(ctx, submasks)
            count = _doc_count(bucket_ctx)
            if count:
                buckets.append(_bucket_result(sub, bucket_ctx, mapper,
                                              count, {"key": key}))
    _apply_parent_pipelines(_split_parent_pipelines(sub)[1], buckets)
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
    if agg_type == "cumulative_cardinality":
        # the running distinct count over a sibling histogram's
        # cardinality sub-aggs: the union of their exact sets
        agg_name, _, metric = path.partition(">")
        seen: set = set()
        for b in results.get(agg_name, {}).get("buckets", []):
            s = b.get(metric, {}).get("_set")
            if s is not None:
                seen |= s
            b["cumulative_cardinality"] = {"value": len(seen)}
        return {"value": len(seen)}
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
