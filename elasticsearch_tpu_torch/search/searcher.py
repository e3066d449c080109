"""Shard searcher: the query and fetch phases over one shard (counterpart
of elasticsearch_tpu/search/searcher.py).

The query phase takes one of two executors, where the reference takes
them:

- the plan path: a score-sorted query with no ``min_score`` and at most
  a ``_score`` search_after compiles into a LogicalPlan
  (search/plan.py), binds per segment and launches through the
  PlanBatcher when one is set;
- the dense executor, for everything else (field sorts, ``min_score``,
  trees the plan compiler refuses): per segment the query executes into
  dense (scores, mask) columns (search/queries.py), the collector chain
  is mask algebra (live, min_score, post_filter, search_after), the
  primary sort key is a column, and a stable top-k (ops/topk.py
  ``masked_topk``) picks the winners, read back with their scores,
  the segment's total and its max score through one readback.

Per-segment rows merge host-side by (-key, segment, docid), Lucene's
tie order; a multi-key sort re-sorts the winners by their full sort
values on the host (exact unless more than k docs tie on the primary
key, as in the reference). Sorts: ``_score``, ``_doc`` and number,
boolean and date fields, whose keys are the float32 doc-value columns
(ops/device.py: a date is exact to its float32 spacing only); the
sort values a hit carries are the float64 doc values. Keyword sorts and
``_geo_distance`` are later slices.

With ``collect_masks`` (a body with aggregations) the plan path is
skipped and the dense executor also hands each segment's match mask to
the host (``QueryResult.agg_masks``): after the live mask and
``min_score``, before ``post_filter``, as the reference's aggregations
see it.

After the query phase the rescorer (``rescore``, the reference's
QueryRescorer) may re-score the top ``window_size`` docs with a second
query run on the dense executor.
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.mapper import KeywordFieldType
from elasticsearch_tpu_torch.index.segment import Segment
from elasticsearch_tpu_torch.ops.device import readback
from elasticsearch_tpu_torch.ops.topk import masked_topk
from elasticsearch_tpu_torch.search import profile as _prof
from elasticsearch_tpu_torch.search.batching import execute_solo
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    SegmentContext,
                                                    ShardStats)
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.plan import bind_plan, compile_plan
from elasticsearch_tpu_torch.search.queries import parse_query

MAX_TOPK = 10000
_F32_MAX = float(np.finfo(np.float32).max)


@dataclass(slots=True)
class DocAddress:
    segment_idx: int
    docid: int
    score: float
    sort_values: Tuple = ()
    sort_key: float = 0.0  # the device key used for ordering (score or field)


@dataclass
class QueryResult:
    """Per-shard query-phase result: doc addresses and scores only; the
    fetch phase loads what the page shows."""

    docs: List[DocAddress]
    total_hits: int
    max_score: Optional[float]
    # block-max pruning ran on some segment: total_hits is a LOWER bound
    # (the service reports hits.total.relation "gte")
    total_lower_bound: bool = False
    # with collect_masks: (segment, host match mask bool [n_docs]) per
    # segment, for the aggregation phase
    agg_masks: Optional[List[Tuple[Segment, np.ndarray]]] = None


@dataclass
class SortKey:
    field: str           # "_score" | "_doc" | field name
    order: str           # "asc" | "desc"


class ShardSearcher:
    def __init__(self, segments: List[Segment], mapper,
                 cache: DeviceSegmentCache, k1: float = 1.2,
                 b: float = 0.75):
        self.segments = segments
        self.mapper = mapper
        self.cache = cache
        self.stats = ShardStats(segments)
        self.k1 = k1
        self.b = b
        # set by SearchService: continuous batching of plan launches
        self.batcher = None

    def _contexts(self) -> List[SegmentContext]:
        return [SegmentContext(seg, self.cache.get(seg), self.mapper,
                               self.stats, self.k1, self.b)
                for seg in self.segments]

    # ------------------------------------------------------------ query
    def query_phase(self, query, size: int, post_filter=None,
                    min_score: Optional[float] = None,
                    sort: Optional[Any] = None,
                    search_after: Optional[List[Any]] = None,
                    track_total_hits=True, allow_plan: bool = True,
                    cache_key: Optional[str] = None,
                    collect_masks: bool = False) -> QueryResult:
        """Exact top-``size`` (at most MAX_TOPK) and exact total.
        ``cache_key`` (the request's query JSON) lets repeats reuse their
        bound plans, which hold the uploaded selections' host arrays.
        A ``track_total_hits`` other than true (false or a threshold)
        licenses block-max pruning on the plan path, as Lucene only
        collects TOP_SCORES under a total-hits threshold: the hits stay
        exact, and when a segment pruned the total is a lower bound
        (``total_lower_bound``). ``allow_plan=False`` asks the dense
        executor for a query the plan path would take, as
        ``collect_masks`` does (which also fills ``agg_masks``)."""
        k = min(max(size, 1), MAX_TOPK)
        sort_spec = _parse_sort(sort)
        plan_after: Optional[float] = None
        if search_after is not None and sort_spec is None \
                and len(search_after) == 1:
            # _score cursor: the plan launch applies it, so every page of
            # a score-paged walk stays on one executor (their float32
            # sums differ in the last bits)
            plan_after = float(search_after[0])
        plannable = (allow_plan and sort_spec is None and min_score is None
                     and (search_after is None or plan_after is not None)
                     and not collect_masks)
        if plannable:
            with _prof.span("compile"):
                plan = compile_plan(query, self, post_filter)
            if plan is not None:
                return self._plan_query_phase(plan, k, track_total_hits,
                                              plan_after, cache_key)
        return self._dense_query_phase(query, k, post_filter, min_score,
                                       sort_spec, search_after,
                                       track_total_hits, collect_masks)

    def _plan_query_phase(self, plan, k: int, track_total_hits,
                          after_score: Optional[float],
                          cache_key: Optional[str]) -> QueryResult:
        """Bind and launch a compiled LogicalPlan per segment; merge by
        (-score, segment, docid)."""
        _prof.note("collector", "FusedPlanTopDocsCollector")
        allow_prune = track_total_hits is not True and after_score is None
        bkey_base = None
        if cache_key is not None:
            # the segment set pins shard-level stats (idf, avg length);
            # k and allow_prune pin the pruning, so a pruned bind is
            # never served to an exact ask; the live version pins the
            # docs that verified its θ (and an ids factor's mask)
            bkey_base = (tuple(s.name for s in self.segments), self.k1,
                         self.b, cache_key, k, allow_prune)
        per_segment = []
        total = 0
        lower_bound = False
        for seg_idx, ctx in enumerate(self._contexts()):
            if ctx.segment.n_docs == 0:
                continue

            def bind(ctx=ctx):
                with _prof.span("bind"):
                    return bind_plan(plan, ctx, k, allow_prune)
            if bkey_base is None:
                bp = bind()
            else:
                bp = ctx.device.bound_plan(
                    bkey_base + (ctx.segment.live_version,), bind)
            lower_bound = lower_bound or bp.pruned
            with _prof.span("launch"):
                if self.batcher is not None:
                    vals, ids, seg_total = self.batcher.execute(
                        bp, ctx, k, self.k1, self.b, after_score)
                else:
                    vals, ids, seg_total = execute_solo(
                        bp, ctx, k, self.k1, self.b, after_score)
            if track_total_hits:
                total += int(seg_total)
            keep = vals > -np.inf
            if keep.any():
                per_segment.append((seg_idx, vals[keep], ids[keep]))
        if not per_segment:
            return QueryResult([], total, None, lower_bound)
        with _prof.span("merge"):
            all_vals = np.concatenate([v for _, v, _ in per_segment])
            all_segs = np.concatenate(
                [np.full(len(i), s, np.int32) for s, _, i in per_segment])
            all_ids = np.concatenate([i for _, _, i in per_segment])
            # one segment's rows are already (-score, docid)-ordered
            order = np.lexsort((all_ids, all_segs, -all_vals))[:k]
            docs = [DocAddress(int(all_segs[i]), int(all_ids[i]),
                               float(all_vals[i]), (),
                               sort_key=float(all_vals[i])) for i in order]
        return QueryResult(docs, total, docs[0].score, lower_bound)

    def _dense_query_phase(self, query, k: int, post_filter, min_score,
                           sort_spec, search_after, track_total_hits,
                           collect_masks: bool = False) -> QueryResult:
        """The dense executor: per segment, dense (scores, mask) columns,
        the collector chain as mask algebra, the primary key's stable
        top-k, one readback of (keys, docids, scores, total, max); with
        ``collect_masks`` also each segment's aggregation mask, read
        back on its own."""
        per_segment = []
        total = 0
        max_score = None
        agg_masks = [] if collect_masks else None
        for seg_idx, ctx in enumerate(self._contexts()):
            if ctx.segment.n_docs == 0 or not query.can_match(ctx):
                if collect_masks:
                    agg_masks.append((ctx.segment,
                                      np.zeros(ctx.segment.n_docs, bool)))
                continue
            _prof.note("collector", "DenseColumnTopDocsCollector")
            with _prof.span("score"):
                scores, mask = query.execute(ctx)
            mask = mask & ctx.live
            if min_score is not None:
                mask = mask & (scores >= float(min_score))
            if collect_masks:
                agg_masks.append((ctx.segment, readback(
                    "search.searcher.agg_mask",
                    mask[: ctx.segment.n_docs])))
            if post_filter is not None:
                _, pf_mask = post_filter.execute(ctx)
                mask = mask & pf_mask
            # the totals and the max score count before search_after
            seg_total = mask.sum(dtype=torch.int64)
            seg_max = torch.where(mask, scores, float("-inf")).amax()
            key = _primary_sort_key(ctx, self.mapper, scores, sort_spec)
            if search_after is not None:
                mask = mask & _search_after_mask(ctx, self.mapper, scores,
                                                 sort_spec, search_after)
            with _prof.span("topk"):
                vals, ids = masked_topk(key, mask,
                                        min(k, ctx.n_docs_padded))
                # the winners' scores gathered here, so only k of them
                # cross
                win = scores[ids.clamp(max=ctx.n_docs_padded - 1).long()]
            with _prof.span("readback"):
                vals, ids, win, seg_total, seg_max = readback(
                    "search.searcher.dense_topk", vals, ids, win,
                    seg_total.reshape(1), seg_max.reshape(1))
            if track_total_hits:
                total += int(seg_total[0])
            if _needs_max_score(sort_spec) and np.isfinite(seg_max[0]):
                m = float(seg_max[0])
                max_score = m if max_score is None else max(max_score, m)
            keep = np.isfinite(vals)
            per_segment.append((seg_idx, vals[keep], ids[keep], win[keep]))

        if not per_segment:
            return QueryResult([], total, None, agg_masks=agg_masks)
        with _prof.span("merge"):
            docs = self._merge_dense(per_segment, k, sort_spec)
        return QueryResult(docs, total, max_score, agg_masks=agg_masks)

    def _merge_dense(self, per_segment, k: int, sort_spec):
        """The per-segment winners merged by (-key, segment, docid), with
        their sort values; a multi-key sort re-sorts them on the host."""
        all_keys = np.concatenate([v for _, v, _, _ in per_segment])
        all_segs = np.concatenate(
            [np.full(len(i), s, np.int32) for s, _, i, _ in per_segment])
        all_ids = np.concatenate([i for _, _, i, _ in per_segment])
        all_scores = np.concatenate([sc for _, _, _, sc in per_segment])
        order = np.lexsort((all_ids, all_segs, -all_keys))[:k]
        docs = []
        for idx in order:
            seg_idx, docid = int(all_segs[idx]), int(all_ids[idx])
            score = float(all_scores[idx])
            sv = _sort_values(self.segments[seg_idx], docid, score,
                              sort_spec)
            docs.append(DocAddress(seg_idx, docid, score, sv,
                                   sort_key=float(all_keys[idx])))
        # multi-key: re-sort the winners by the full key on the host
        if sort_spec is not None and len(sort_spec) > 1:
            docs.sort(key=functools.cmp_to_key(
                lambda a, b: _host_sort_cmp(a, b, sort_spec)))
        return docs

    # ---------------------------------------------------------- rescore
    def rescore(self, docs: List[DocAddress],
                rescore_specs: List[Dict[str, Any]]) -> List[DocAddress]:
        """Query rescorer (ref: rescore/QueryRescorer.java): re-scores
        the top ``window_size`` docs with a second query, in order of
        the specs. The rescore query runs once per segment on the dense
        executor; only the window's docs of that segment come back (one
        readback). A matched doc scores ``query_weight`` x its score
        combined by ``score_mode`` (total, multiply, avg, max, min,
        validated by the caller) with ``rescore_query_weight`` x the
        rescore score; an unmatched doc keeps ``query_weight`` x its
        score. The window re-sorts by (-score, segment, docid)."""
        for spec in rescore_specs:
            window = int(spec.get("window_size", 10))
            qspec = spec.get("query", {})
            rq = parse_query(qspec["rescore_query"])
            qw = float(qspec.get("query_weight", 1.0))
            rqw = float(qspec.get("rescore_query_weight", 1.0))
            mode = qspec.get("score_mode", "total")
            head, tail = docs[:window], docs[window:]
            contexts = self._contexts()
            for seg_idx in sorted({d.segment_idx for d in head}):
                mine = [d for d in head if d.segment_idx == seg_idx]
                ctx = contexts[seg_idx]
                scores, mask = rq.execute(ctx)
                ids = torch.tensor([d.docid for d in mine],
                                   dtype=torch.int64, device=scores.device)
                s_h, m_h = readback("search.searcher.rescore", scores[ids],
                                    mask[ids])
                for d, s, m in zip(mine, s_h, m_h):
                    new = qw * d.score
                    if m:
                        new = _RESCORE_COMBINE[mode](new, rqw * float(s))
                    d.score = new
                    d.sort_key = new
            head.sort(key=lambda d: (-d.score, d.segment_idx, d.docid))
            docs = head + tail
        return docs

    # ------------------------------------------------------------ fetch
    def fetch_phase(self, docs: List[DocAddress],
                    source: bool = True) -> List[Dict[str, Any]]:
        """``_id``, ``_score``, the sort values under a sort and, with
        ``source``, the stored ``_source`` of each doc (segments built
        without sources have none to show)."""
        hits = []
        for d in docs:
            seg = self.segments[d.segment_idx]
            hit: Dict[str, Any] = {
                "_id": seg.stored.ids[d.docid],
                "_score": d.score if d.score == d.score else None}
            if d.sort_values:
                hit["sort"] = list(d.sort_values)
            if source:
                src = seg.stored.source(d.docid)
                if src:
                    hit["_source"] = json.loads(src)
            hits.append(hit)
        return hits


# a rescored doc's new score from (query_weight x score, rescore_weight x
# rescore score), per score_mode
_RESCORE_COMBINE = {
    "total": lambda base, rs: base + rs,
    "multiply": lambda base, rs: base * rs,
    "avg": lambda base, rs: (base + rs) / 2.0,
    "max": max,
    "min": min,
}


# ---------------------------------------------------------------------------
# sort helpers
# ---------------------------------------------------------------------------

def _parse_sort(sort) -> Optional[List[SortKey]]:
    if not sort:
        return None
    if isinstance(sort, (str, dict)):
        sort = [sort]
    keys = []
    for entry in sort:
        if isinstance(entry, str):
            field_name = entry
            order = "desc" if entry == "_score" else "asc"
        else:
            (field_name, spec), = entry.items()
            if isinstance(spec, str):
                order = spec
            else:
                order = spec.get("order",
                                 "desc" if field_name == "_score" else "asc")
        if field_name == "_geo_distance":
            raise SliceUnsupported("a _geo_distance sort is a later slice "
                                   "of the port")
        keys.append(SortKey(field_name, order))
    return keys


def _needs_max_score(sort_spec) -> bool:
    return sort_spec is None


def _numeric_sort_column(ctx, mapper, field: str):
    if isinstance(mapper.field_type(field), KeywordFieldType):
        raise SliceUnsupported(f"a sort on the keyword field [{field}] is "
                               f"a later slice of the port")
    return ctx.numeric_column(field)


def _primary_sort_key(ctx, mapper, scores, sort_spec) -> torch.Tensor:
    """Device key column for the top-k (max-selected): negated for
    ascending; a missing value sorts last either way."""
    if sort_spec is None or sort_spec[0].field == "_score":
        key = scores
        if sort_spec and sort_spec[0].order == "asc":
            key = -key
        return key
    sk = sort_spec[0]
    if sk.field == "_doc":
        # exact below 2^24 docs, the padded doc limit of a segment
        key = -torch.arange(ctx.n_docs_padded, dtype=torch.float32,
                            device=scores.device)
        return key if sk.order == "asc" else -key
    col, miss = _numeric_sort_column(ctx, mapper, sk.field)
    missing_val = _F32_MAX if sk.order == "asc" else -_F32_MAX
    key = torch.where(miss, missing_val, col)
    return -key if sk.order == "asc" else key


def _sort_values(seg: Segment, docid: int, score: float,
                 sort_spec) -> Tuple:
    if sort_spec is None:
        return ()
    out = []
    for sk in sort_spec:
        if sk.field == "_score":
            out.append(score)
        elif sk.field == "_doc":
            out.append(docid)
        else:
            nv = seg.numerics.get(sk.field)
            v = None
            if nv is not None and not nv.missing[docid]:
                v = float(nv.values[docid])
            out.append(v)
    return tuple(out)


def _host_sort_cmp(a: DocAddress, b: DocAddress, sort_spec) -> int:
    """Full-precision winner comparison; missing values sort last
    whatever the direction, as the device keys do."""
    for sk, x, y in zip(sort_spec, a.sort_values, b.sort_values):
        if x == y:
            continue
        if x is None:
            return 1
        if y is None:
            return -1
        c = -1 if x < y else 1
        return c if sk.order == "asc" else -c
    if a.segment_idx != b.segment_idx:
        return -1 if a.segment_idx < b.segment_idx else 1
    return -1 if a.docid < b.docid else (1 if a.docid > b.docid else 0)


def _search_after_mask(ctx, mapper, scores, sort_spec,
                       after: List[Any]) -> torch.Tensor:
    """Docs strictly after the cursor in sort order. With a single
    non-unique sort key, docs tied with the cursor are excluded, as in
    ES: reliable paging needs a trailing ``_doc`` key, which applies
    here when the sort's last key is ``_doc`` and ``after`` carries its
    value."""
    if sort_spec is None or sort_spec[0].field == "_score":
        after_val = float(np.float32(float(after[0])))
        strictly = scores < after_val
        tied = scores == after_val
    else:
        sk = sort_spec[0]
        col, miss = _numeric_sort_column(ctx, mapper, sk.field)
        after_val = float(np.float32(float(after[0])))
        if sk.order == "asc":
            strictly = (~miss) & (col > after_val)
        else:
            strictly = (~miss) & (col < after_val)
        tied = (~miss) & (col == after_val)
    if (sort_spec is not None and len(sort_spec) >= 2
            and sort_spec[-1].field == "_doc" and len(after) >= 2):
        docids = torch.arange(ctx.n_docs_padded, device=scores.device)
        return strictly | (tied & (docids > int(after[-1])))
    return strictly
