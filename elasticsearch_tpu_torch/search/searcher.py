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
key, as in the reference). Sorts: ``_score``, ``_doc``, number, boolean
and date fields, whose keys are the float32 doc-value columns
(ops/device.py: a date is exact to its float32 spacing only), and
keyword fields, whose key is the segment-local first ordinal as a
float32 column (``DeviceSegment.keyword_ord_column``: exact below 2^24
terms in a segment). The sort values a hit carries are the float64 doc
values and the keyword's first term. Keyword ordinals order docs within
a segment only, so a keyword primary sort keeps every segment's winners,
re-sorts them on the host by term (``_host_sort_cmp``) and only then
cuts to k; a keyword ``search_after`` cursor carries the term, which
each segment re-ranks in its own term list (``_keyword_after_masks``).
A missing value sorts last in either order. A ``_geo_distance`` sort
(one geo_point field and its origin, ``unit`` and ``order``) keys on
the haversine distance in meters, float32 over the lat/lon columns
(common/geo.py); its sort values are the float64 host distances in the
unit, and its ``search_after`` cursor, given in the unit, compares in
meters against the float32 column, as the reference's.

The fetch phase (``fetch_phase``) builds each hit of the page:
``_source`` filtered by includes and excludes with wildcards
(``_filter_source``), ``docvalue_fields`` and ``fields`` (doc values
first, then ``_source``), ``script_fields`` (an expression evaluated as
a column per segment on the device, the page's docs gathered there and
read back once) and ``highlight`` (``_highlight``: the unified, plain
and fvh highlighters over the stored ``_source``, host code once per
page; the query terms come from ``_collect_terms``, which visits the
match family, term(s), bool, constant_score, dis_max, script_score,
boosting and function_score only, as the reference's).

With ``collect_masks`` (a body with aggregations) the plan path is
skipped and the dense executor also hands each segment's match mask to
the host (``QueryResult.agg_masks``): after the live mask and
``min_score``, before ``post_filter``, as the reference's aggregations
see it.

Before either executor the query is rewritten against the shard
(``QueryBuilder.rewrite``: more_like_this resolves its like-docs and
terms there), under the profile's ``rewrite`` stage.

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

import bisect
import fnmatch

from elasticsearch_tpu_torch.common import geo
from elasticsearch_tpu_torch.common.errors import ParsingException
from elasticsearch_tpu_torch.index.segment import Segment
from elasticsearch_tpu_torch.ops.device import readback
from elasticsearch_tpu_torch.ops.topk import masked_topk
from elasticsearch_tpu_torch.search import plan as plan_mod
from elasticsearch_tpu_torch.search import profile as _prof
from elasticsearch_tpu_torch.search.batching import execute_solo
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    SegmentContext,
                                                    ShardStats)
from elasticsearch_tpu_torch.search.plan import bind_plan, compile_plan
from elasticsearch_tpu_torch.search import queries as q
from elasticsearch_tpu_torch.search.queries import (parse_query,
                                                    resolve_script_source)
from elasticsearch_tpu_torch.search.script import (ScriptContext, _DocColumn,
                                                   as_column, compile_script)

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
    field: str           # "_score" | "_doc" | "_geo_distance" | field name
    order: str           # "asc" | "desc"
    # a _geo_distance key's point field, origin and unit
    geo_field: str = ""
    geo_lat: float = 0.0
    geo_lon: float = 0.0
    geo_unit: str = "m"


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
        # set on a dfs_query_then_fetch copy whose ``stats`` span every
        # shard of the request: the key of those statistics
        self.dfs_key = None
        # the engine epoch of ``segments`` (search/service.py sets it;
        # the request cache files an answer under it)
        self.epoch = -1

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
                    collect_masks: bool = False,
                    after_key: Optional[Tuple] = None) -> QueryResult:
        """Exact top-``size`` (at most MAX_TOPK) and exact total.
        ``cache_key`` (the request's query JSON) lets repeats reuse their
        bound plans, which hold the uploaded selections' host arrays.
        A ``track_total_hits`` other than true (false or a threshold)
        licenses block-max pruning on the plan path, as Lucene only
        collects TOP_SCORES under a total-hits threshold: the hits stay
        exact, and when a segment pruned the total is a lower bound
        (``total_lower_bound``). ``allow_plan=False`` asks the dense
        executor for a query the plan path would take, as
        ``collect_masks`` does (which also fills ``agg_masks``), and as
        a scroll's cursor ``after_key`` does: (key, segment, docid,
        primary sort value) of the last doc a page emitted, the page
        then holding the docs strictly after it in (key desc, segment
        asc, docid asc) order (``_after_key_mask``). The query and
        post_filter are rewritten against this shard first
        (``QueryBuilder.rewrite``)."""
        k = min(max(size, 1), MAX_TOPK)
        sort_spec = _parse_sort(sort)
        with _prof.span("rewrite"):
            query = query.rewrite(self)
            if post_filter is not None:
                post_filter = post_filter.rewrite(self)
        plan_after: Optional[float] = None
        if search_after is not None and sort_spec is None \
                and len(search_after) == 1:
            # _score cursor: the plan launch applies it, so every page of
            # a score-paged walk stays on one executor (their float32
            # sums differ in the last bits)
            plan_after = float(search_after[0])
        plannable = (allow_plan and sort_spec is None and min_score is None
                     and (search_after is None or plan_after is not None)
                     and after_key is None and not collect_masks)
        if plannable:
            with _prof.span("compile"):
                plan = compile_plan(query, self, post_filter)
            if plan is not None:
                return self._plan_query_phase(plan, k, track_total_hits,
                                              plan_after, cache_key)
        return self._dense_query_phase(query, k, post_filter, min_score,
                                       sort_spec, search_after,
                                       track_total_hits, collect_masks,
                                       after_key)

    def _plan_query_phase(self, plan, k: int, track_total_hits,
                          after_score: Optional[float],
                          cache_key: Optional[str]) -> QueryResult:
        """Bind and launch a compiled LogicalPlan per segment; merge by
        (-score, segment, docid)."""
        _prof.note("collector", "FusedPlanTopDocsCollector")
        allow_prune = track_total_hits is not True and after_score is None
        bkey_base = None
        if cache_key is not None:
            # the segment set pins shard-level stats (idf, avg length),
            # and dfs_key the request-wide stats of a dfs search, so a
            # default and a dfs search of one body never share a bind;
            # k and allow_prune pin the pruning, so a pruned bind is
            # never served to an exact ask; the live version pins the
            # docs that verified its θ (and an ids factor's mask); the
            # conversion threshold pins which groups became masks
            bkey_base = (tuple(s.name for s in self.segments), self.dfs_key,
                         self.k1, self.b, cache_key, k, allow_prune,
                         plan_mod.FILTER_CACHE_MIN_BLOCKS)
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

    def _dense_query_phase(self, *args, **kwargs) -> QueryResult:
        """The dense executor (``_dense_segments``), its host readbacks
        charged to the ``request`` breaker while the shard's phase runs
        (the cache's ``bigarrays``, utils/bigarrays.py, set by the node):
        each segment's aggregation mask and its top-k rows, all released
        when the phase ends. A charge past the limit raises a typed
        CircuitBreakingException (a 429 when every shard failed). The
        reference charges the [ND] score column it reads back; the port
        gathers the winners' scores on the card and never reads that
        column back, so a body whose column trips the reference's
        breaker may answer here."""
        charged: list = []
        try:
            return self._dense_segments(charged, *args, **kwargs)
        finally:
            for acc in charged:
                acc.close()

    def _charge(self, charged: list, label: str, *arrays) -> None:
        """Charge host readbacks to the ``request`` breaker; the
        accounted arrays go to ``charged`` (released by the caller)."""
        bigarrays = getattr(self.cache, "bigarrays", None)
        if bigarrays is None:
            return
        for a in arrays:
            charged.append(bigarrays.adopt(a, label))

    def _dense_segments(self, charged: list, query, k: int, post_filter,
                        min_score, sort_spec, search_after, track_total_hits,
                        collect_masks: bool = False,
                        after_key: Optional[Tuple] = None) -> QueryResult:
        """The dense executor: per segment, dense (scores, mask) columns,
        the collector chain as mask algebra, the primary key's stable
        top-k, one readback of (keys, docids, scores, total, max); with
        ``collect_masks`` also each segment's aggregation mask, read
        back on its own. Each readback is charged into ``charged``."""
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
                host_mask = readback("search.searcher.agg_mask",
                                     mask[: ctx.segment.n_docs])
                self._charge(charged, "agg_mask_readback", host_mask)
                agg_masks.append((ctx.segment, host_mask))
            if post_filter is not None:
                _, pf_mask = post_filter.execute(ctx)
                mask = mask & pf_mask
            # the totals and the max score count before search_after
            seg_total = mask.sum(dtype=torch.int64)
            seg_max = torch.where(mask, scores, float("-inf")).amax()
            key = _primary_sort_key(ctx, scores, sort_spec)
            if search_after is not None:
                mask = mask & _search_after_mask(ctx, scores, sort_spec,
                                                 search_after)
            if after_key is not None:
                mask = mask & self._after_key_mask(ctx, seg_idx, key,
                                                   sort_spec, after_key)
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
            self._charge(charged, "dense_topk_readback", vals, ids, win)
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

    def _after_key_mask(self, ctx, seg_idx: int, key: torch.Tensor,
                        sort_spec, after_key: Tuple) -> torch.Tensor:
        """The docs of segment ``seg_idx`` strictly after a scroll's
        cursor (key, segment, docid[, primary sort value]) in (key desc,
        segment asc, docid asc) order: before the cursor's segment a key
        below the cursor's, in it a lower key or an equal one at a
        higher docid, after it a key at most the cursor's. A keyword
        primary sort's keys are this segment's own ordinals, so the
        cursor's term is ranked in the segment's term list
        (``_keyword_after_masks``) instead."""
        ck, cseg, cdoc = after_key[0], after_key[1], after_key[2]
        if _primary_is_keyword(self.segments, sort_spec):
            term = after_key[3] if len(after_key) > 3 else None
            strictly, tied = _keyword_after_masks(
                ctx, sort_spec[0].field, term, sort_spec[0].order)
        else:
            strictly, tied = key < ck, key == ck
        if seg_idx < cseg:
            return strictly
        if seg_idx > cseg:
            return strictly | tied
        docids = torch.arange(ctx.n_docs_padded, device=key.device)
        return strictly | (tied & (docids > cdoc))

    def _merge_dense(self, per_segment, k: int, sort_spec):
        """The per-segment winners merged by (-key, segment, docid), with
        their sort values; a multi-key sort re-sorts them on the host. A
        keyword primary sort's keys are segment-local ordinals, so every
        winner is kept, re-sorted on the host by term, then cut to k."""
        all_keys = np.concatenate([v for _, v, _, _ in per_segment])
        all_segs = np.concatenate(
            [np.full(len(i), s, np.int32) for s, _, i, _ in per_segment])
        all_ids = np.concatenate([i for _, _, i, _ in per_segment])
        all_scores = np.concatenate([sc for _, _, _, sc in per_segment])
        string_primary = _primary_is_keyword(self.segments, sort_spec)
        order = (np.arange(len(all_keys)) if string_primary
                 else np.lexsort((all_ids, all_segs, -all_keys))[:k])
        docs = []
        for idx in order:
            seg_idx, docid = int(all_segs[idx]), int(all_ids[idx])
            score = float(all_scores[idx])
            sv = _sort_values(self.segments[seg_idx], docid, score,
                              sort_spec)
            docs.append(DocAddress(seg_idx, docid, score, sv,
                                   sort_key=float(all_keys[idx])))
        # multi-key or keyword: re-sort the winners by the full key on
        # the host
        if sort_spec is not None and (len(sort_spec) > 1 or string_primary):
            docs.sort(key=functools.cmp_to_key(
                lambda a, b: _host_sort_cmp(a, b, sort_spec)))
            docs = docs[:k]
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
            rq = parse_query(qspec["rescore_query"]).rewrite(self)
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
    def fetch_phase(self, docs: List[DocAddress], source_filter: Any = True,
                    docvalue_fields: Optional[List[str]] = None,
                    highlight: Optional[Dict[str, Any]] = None,
                    highlight_query=None,
                    script_fields: Optional[Dict[str, Any]] = None,
                    fields: Optional[List[Any]] = None,
                    version: bool = False,
                    seq_no_primary_term: bool = False
                    ) -> List[Dict[str, Any]]:
        """Each hit of the page: ``_id``, ``_score``, the sort values
        under a sort, ``_version`` and ``_seq_no``/``_primary_term`` when
        asked (from the metadata columns; a doc without them has none),
        the ``_source`` as ``source_filter`` (true, false,
        a field, a list or ``{includes, excludes}``) keeps it (a segment
        built without sources has none to show), then ``fields`` from
        ``docvalue_fields``, ``fields`` and ``script_fields``, and
        ``highlight`` for ``highlight_query``'s terms."""
        script_vals = (self._script_field_values(script_fields, docs)
                       if script_fields else None)
        hits = []
        for pos, d in enumerate(docs):
            seg = self.segments[d.segment_idx]
            hit: Dict[str, Any] = {
                "_id": seg.stored.ids[d.docid],
                "_score": d.score if d.score == d.score else None}
            if d.sort_values:
                hit["sort"] = list(d.sort_values)
            for meta in (("_version",) if version else ()) + (
                    ("_seq_no", "_primary_term") if seq_no_primary_term
                    else ()):
                nv = seg.numerics.get(meta)
                vs = nv.get(d.docid) if nv is not None else None
                if vs:
                    hit[meta] = int(vs[0])
            parsed: List[Any] = []

            def get_source(seg=seg, d=d, parsed=parsed):
                if not parsed:
                    src = seg.stored.source(d.docid)
                    parsed.append(json.loads(src) if src else {})
                return parsed[0]

            if source_filter is not False and seg.stored.source(d.docid):
                hit["_source"] = _filter_source(get_source(), source_filter)
            if docvalue_fields:
                out = {}
                for f in docvalue_fields:
                    vs = _doc_values(seg, f, d.docid)
                    if vs:
                        out[f] = vs
                hit["fields"] = out
            if fields:
                # the fields retrieval API: doc values, else _source
                out = hit.setdefault("fields", {})
                for f in fields:
                    fname = f if isinstance(f, str) else f.get("field")
                    vs = _doc_values(seg, fname, d.docid)
                    if not vs:
                        v = _get_path(get_source(), fname)
                        if v is not None:
                            vs = v if isinstance(v, list) else [v]
                    if vs:
                        out[fname] = vs
            if script_vals:
                out = hit.setdefault("fields", {})
                for fname, vals in script_vals.items():
                    out[fname] = [float(vals[pos])]
            if highlight:
                hit["highlight"] = self._highlight(get_source(), highlight,
                                                   highlight_query)
            hits.append(hit)
        return hits

    def _script_field_values(self, script_fields: Dict[str, Any],
                             docs: List[DocAddress]) -> Dict[str, np.ndarray]:
        """Each script field's value at each doc of the page: the script
        evaluates ONCE per segment as a float32 column on the device (the
        reference's columnar ScriptFieldsPhase), the page's docs of that
        segment are gathered there, and every field's gathered values
        come back in one readback. A statement script has no scored
        context here and raises a ScriptException, as the reference's."""
        contexts = self._contexts()
        seg_pos: Dict[int, List[int]] = {}
        for pos, d in enumerate(docs):
            seg_pos.setdefault(d.segment_idx, []).append(pos)
        names = list(script_fields)
        parts = []
        order = []
        for fname in names:
            spec = script_fields[fname]
            source, params = resolve_script_source(
                spec.get("script", spec) if isinstance(spec, dict) else spec)
            compiled = compile_script(source)
            for seg_idx, ctx in enumerate(contexts):
                def doc_columns(field, ctx=ctx):
                    return _DocColumn(*ctx.numeric_column(field))
                col = as_column(compiled(ScriptContext(doc_columns, params)),
                                ctx.n_docs_padded, ctx.device.device)
                pos = seg_pos.get(seg_idx)
                if pos:
                    ids = torch.tensor([docs[i].docid for i in pos],
                                       dtype=torch.int64, device=col.device)
                    parts.append(col[ids])
                    order.append((fname, pos))
        out = {fname: np.zeros(len(docs), np.float32) for fname in names}
        if parts:
            vals = readback("search.searcher.script_fields",
                            torch.cat(parts))
            at = 0
            for fname, pos in order:
                out[fname][pos] = vals[at:at + len(pos)]
                at += len(pos)
        return out

    def _highlight(self, source: Dict[str, Any], spec: Dict[str, Any],
                   query) -> Dict[str, List[str]]:
        """The unified highlighter's analogue (the reference's): passages
        snapped to sentence ends, scored by (distinct matched terms,
        matches, earliest); ``type: plain`` or ``number_of_fragments: 0``
        wraps the whole value; ``type: fvh`` centres fragments on match
        runs, trims them at ``boundary_chars`` within
        ``boundary_max_scan`` and merges the spans of ``matched_fields``.
        Per-field options (else the top level's): ``fragment_size``
        (100), ``number_of_fragments`` (5), ``no_match_size`` (0),
        ``order`` ("score" or "none"), ``pre_tags``/``post_tags``. A
        field's value analyzes with its index analyzer; each of fvh's
        ``matched_fields`` with its own search analyzer, over the same
        value (the reference's choices)."""
        query_terms = _collect_terms(query, self.mapper) if query else {}
        mapper = self.mapper
        out: Dict[str, List[str]] = {}
        for fname, fspec in (spec.get("fields", {}) or {}).items():
            fspec = fspec or {}

            def opt(name, default, fspec=fspec):
                return fspec.get(name, spec.get(name, default))
            pre = opt("pre_tags", ["<em>"])[0]
            post = opt("post_tags", ["</em>"])[0]
            frag_size = int(opt("fragment_size", 100))
            n_frags = int(opt("number_of_fragments", 5))
            no_match = int(opt("no_match_size", 0))
            order = str(opt("order", "score"))
            value = _get_path(source, fname)
            if not isinstance(value, str):
                continue
            htype = str(opt("type", "unified"))
            if htype == "fvh":
                matched = opt("matched_fields", None) or [fname]
                if isinstance(matched, str):
                    matched = [matched]
                if fname not in matched:
                    matched = [fname] + list(matched)
                spans = []
                for m in matched:
                    mterms = query_terms.get(m, set())
                    if mterms:
                        man = mapper.search_analyzer(mapper.field_type(m))
                        spans.extend((t.start_offset, t.end_offset, t.term)
                                     for t in man.analyze(value)
                                     if t.term in mterms)
                spans.sort()
                spans = spans[:int(opt("phrase_limit", 256))]
            else:
                terms = query_terms.get(fname, set())
                analyzer = mapper.index_analyzer(mapper.field_type(fname))
                spans = [(t.start_offset, t.end_offset, t.term)
                         for t in analyzer.analyze(value)
                         if t.term in terms] if terms else []
            if not spans:
                if no_match > 0 and value:
                    out[fname] = [value[:_snap_end(value, no_match)]]
                continue
            if n_frags == 0 or htype == "plain":
                out[fname] = [_wrap_spans(
                    value, [(st, en) for st, en, _t in spans], pre, post)]
                continue
            if htype == "fvh":
                passages = _fvh_fragments(
                    value, spans, frag_size,
                    str(opt("boundary_chars", ".,!? \t\n")),
                    int(opt("boundary_max_scan", 20)))
            else:
                passages = _build_passages(value, frag_size)
            scored = []
            for pi, (ps, pe) in enumerate(passages):
                inside = [sp for sp in spans if sp[0] >= ps and sp[1] <= pe]
                if not inside:
                    continue
                distinct = len({t for _s, _e, t in inside})
                scored.append(((distinct, len(inside), -ps), pi, inside))
            scored.sort(key=lambda r: r[0], reverse=True)
            chosen = scored[:n_frags]
            if order != "score":
                chosen.sort(key=lambda r: r[1])
            frags = []
            for _score, pi, inside in chosen:
                ps, pe = passages[pi]
                frags.append(_wrap_spans(
                    value[ps:pe],
                    [(st - ps, en - ps) for st, en, _t in inside],
                    pre, post).strip())
            if frags:
                out[fname] = frags
        return out


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
                spec = {}
            else:
                order = spec.get("order",
                                 "desc" if field_name == "_score" else "asc")
            if field_name == "_geo_distance":
                keys.append(_geo_sort_key(spec))
                continue
        keys.append(SortKey(field_name, order))
    return keys


def _geo_sort_key(spec: Dict[str, Any]) -> SortKey:
    """A ``_geo_distance`` sort entry: exactly one point field with its
    origin, beside ``order`` (asc by default), ``unit`` (m), ``mode``,
    ``distance_type`` and ``ignore_unmapped``."""
    entries = [(k, v) for k, v in spec.items()
               if k not in ("order", "unit", "mode", "distance_type",
                            "ignore_unmapped")]
    if len(entries) != 1:
        raise ParsingException("[_geo_distance] sort requires exactly one "
                               "point field with an origin")
    geo_field, origin = entries[0]
    lat, lon = geo.parse_geo_point(origin)
    return SortKey("_geo_distance", spec.get("order", "asc"),
                   geo_field=geo_field, geo_lat=lat, geo_lon=lon,
                   geo_unit=spec.get("unit", "m"))


def _geo_column(ctx, sk: SortKey):
    """(float32 meters [n_docs_padded], missing) of a _geo_distance key."""
    lat, miss = ctx.numeric_column(f"{sk.geo_field}.lat")
    lon, _ = ctx.numeric_column(f"{sk.geo_field}.lon")
    return geo.haversine_meters(lat, lon, sk.geo_lat, sk.geo_lon,
                                xp=torch), miss


def _needs_max_score(sort_spec) -> bool:
    return sort_spec is None


def _is_keyword_sort(seg: Segment, field: str) -> bool:
    """The reference's rule: a field sorts by keyword ordinals in a
    segment that holds keyword doc values and no numeric ones for it."""
    return (seg.numerics.get(field) is None
            and seg.keywords.get(field) is not None)


def _primary_is_keyword(segments: List[Segment], sort_spec) -> bool:
    if sort_spec is None:
        return False
    f = sort_spec[0].field
    if f in ("_score", "_doc"):
        return False
    return any(_is_keyword_sort(seg, f) for seg in segments)


def _primary_sort_key(ctx, scores, sort_spec) -> torch.Tensor:
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
    if sk.field == "_geo_distance":
        col, miss = _geo_column(ctx, sk)
    elif _is_keyword_sort(ctx.segment, sk.field):
        # segment-local ordinals: lexicographic within the segment
        col, miss = ctx.keyword_ord_column(sk.field)
    else:
        col, miss = ctx.numeric_column(sk.field)
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
        elif sk.field == "_geo_distance":
            # the float64 host distance, in the sort's unit
            nlat = seg.numerics.get(f"{sk.geo_field}.lat")
            nlon = seg.numerics.get(f"{sk.geo_field}.lon")
            v = None
            if nlat is not None and not nlat.missing[docid]:
                v = geo.meters_to_unit(float(geo.haversine_meters(
                    float(nlat.values[docid]), float(nlon.values[docid]),
                    sk.geo_lat, sk.geo_lon)), sk.geo_unit)
            out.append(v)
        else:
            nv = seg.numerics.get(sk.field)
            v = None
            if nv is not None and not nv.missing[docid]:
                v = float(nv.values[docid])
            elif nv is None:
                kv = seg.keywords.get(sk.field)
                if kv is not None:
                    lo, hi = kv.offsets[docid], kv.offsets[docid + 1]
                    if hi > lo:
                        v = kv.terms[kv.all_ords[lo]]
            out.append(v)
    return tuple(out)


def _keyword_after_masks(ctx, field: str, term, order: str):
    """(strictly after, tied) masks of a keyword cursor value in THIS
    segment's ordinal space: the cursor term is re-ranked in the
    segment's own sorted term list (``bisect``), so a term absent here
    ties with no doc. A None term means the cursor doc had no value:
    missing sorts last, so only the missing docs tie."""
    real = ctx.all_true()
    kv = ctx.segment.keywords.get(field)
    none = torch.zeros_like(real)
    if kv is None:
        # the segment lacks the field: every doc is missing
        return (none, real) if term is None else (real, none)
    col, miss = ctx.keyword_ord_column(field)
    if term is None:
        return none, real & miss
    r_left = bisect.bisect_left(kv.terms, term)
    r_right = bisect.bisect_right(kv.terms, term)
    if order == "asc":
        strictly = (real & ~miss & (col >= r_right)) | (real & miss)
    else:
        strictly = (real & ~miss & (col < r_left)) | (real & miss)
    tied = (real & ~miss & (col == r_left)) if r_left < r_right else none
    return strictly, tied


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


def _search_after_mask(ctx, scores, sort_spec,
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
    elif _is_keyword_sort(ctx.segment, sort_spec[0].field):
        # the cursor carries the term
        strictly, tied = _keyword_after_masks(
            ctx, sort_spec[0].field, after[0], sort_spec[0].order)
    else:
        sk = sort_spec[0]
        if sk.field == "_geo_distance":
            # the cursor travels in the sort's unit; compare in meters
            col, miss = _geo_column(ctx, sk)
            after_val = float(np.float32(
                float(after[0]) / geo.meters_to_unit(1.0, sk.geo_unit)))
        else:
            col, miss = ctx.numeric_column(sk.field)
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


# ---------------------------------------------------------------------------
# fetch helpers
# ---------------------------------------------------------------------------

def _filter_source(source: Dict[str, Any], source_filter):
    """``_source``: true, false, a field, a list of fields or
    ``{includes, excludes}`` (``include``/``exclude`` too), with
    ``fnmatch`` wildcards; a pattern also keeps everything under it."""
    if source_filter is True:
        return source
    if source_filter is False:
        return None
    includes: List[str] = []
    excludes: List[str] = []
    if isinstance(source_filter, str):
        includes = [source_filter]
    elif isinstance(source_filter, list):
        includes = source_filter
    elif isinstance(source_filter, dict):
        includes = source_filter.get("includes",
                                     source_filter.get("include", []))
        excludes = source_filter.get("excludes",
                                     source_filter.get("exclude", []))
        if isinstance(includes, str):
            includes = [includes]
        if isinstance(excludes, str):
            excludes = [excludes]

    def match(path: str, patterns: List[str]) -> bool:
        return any(fnmatch.fnmatch(path, p) or path.startswith(p + ".")
                   for p in patterns)

    def walk(obj, prefix=""):
        """Keep every leaf not excluded and, with includes, included;
        an object emptied by the filter goes."""
        if not isinstance(obj, dict):
            return obj
        out = {}
        for k, v in obj.items():
            path = f"{prefix}{k}"
            if excludes and match(path, excludes):
                continue
            if isinstance(v, dict):
                sub = walk(v, f"{path}.")
                if sub:
                    out[k] = sub
            elif not includes or match(path, includes):
                out[k] = v
        return out
    return walk(source)


def _get_path(source: Dict[str, Any], path: str):
    node = source
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _doc_values(seg: Segment, field: str, docid: int) -> List[Any]:
    """A doc's doc values of ``field``: the numeric ones (float64), else
    the keyword ones (terms ascending); [] without."""
    nv = seg.numerics.get(field)
    vs = nv.get(docid) if nv is not None else []
    if not vs:
        kv = seg.keywords.get(field)
        if kv is not None:
            vs = kv.get(docid)
    return vs


def _collect_terms(query, mapper) -> Dict[str, set]:
    """The query's terms per field, for highlighting: the match family
    (match, multi_match), term(s), and through bool (must, should,
    filter), constant_score, dis_max, script_score, boosting (positive)
    and function_score; any other query (a phrase, a multi-term query,
    ...) contributes none, as in the reference."""
    out: Dict[str, set] = {}

    def visit(node):
        if node is None:
            return
        if isinstance(node, q.MatchQuery):
            analyzer = mapper.analysis.resolve(getattr(
                mapper.field_type(node.field), "search_analyzer_name",
                "standard"))
            out.setdefault(node.field, set()).update(
                analyzer.terms(str(node.query)))
        elif isinstance(node, q.MultiMatchQuery):
            for f in node.fields:
                visit(q.MatchQuery(f, node.query))
        elif isinstance(node, q.TermQuery):
            out.setdefault(node.field, set()).add(str(node.value))
        elif isinstance(node, q.TermsQuery):
            out.setdefault(node.field, set()).update(
                str(v) for v in node.values)
        elif isinstance(node, q.BoolQuery):
            for clause in node.must + node.should + node.filter:
                visit(clause)
        elif isinstance(node, q.ConstantScoreQuery):
            visit(node.filter_query)
        elif isinstance(node, q.DisMaxQuery):
            for sub in node.queries:
                visit(sub)
        elif isinstance(node, q.ScriptScoreQuery):
            visit(node.query)
        elif isinstance(node, q.BoostingQuery):
            visit(node.positive)
        elif isinstance(node, q.FunctionScoreQuery):
            visit(node.query)

    visit(query)
    return out


def _fvh_fragments(text: str, spans, frag_size: int,
                   boundary_chars: str, boundary_max_scan: int):
    """FVH fragments: each centres on a match run and trims to the
    nearest boundary char within ``boundary_max_scan``."""
    bset = set(boundary_chars)
    n = len(text)

    def snap(pos: int, forward: bool) -> int:
        pos = max(0, min(n, pos))
        rng = (range(pos, min(n, pos + boundary_max_scan)) if forward
               else range(pos, max(0, pos - boundary_max_scan), -1))
        for i in rng:
            if 0 <= i < n and text[i] in bset:
                return i + 1    # cut just past the boundary char
        return pos

    frags = []
    covered_to = -1
    for s, _e, _t in sorted(spans):
        if s <= covered_to:
            continue
        lo = snap(s - frag_size // 2, forward=False) \
            if s > frag_size // 2 else 0
        hi = snap(lo + frag_size, forward=True)
        frags.append((lo, min(hi, n)))
        covered_to = hi
    return frags


def _wrap_spans(text: str, spans, pre: str, post: str) -> str:
    """Wrap (start, end) character spans of ``text`` in pre/post tags;
    of overlapping spans the first wins."""
    parts = []
    last = 0
    for s, e in sorted(spans):
        if s < last:
            continue
        parts.append(text[last:s])
        parts.append(pre + text[s:e] + post)
        last = e
    parts.append(text[last:])
    return "".join(parts)


_SENTENCE_ENDS = ".!?\n"


def _snap_end(text: str, at: int) -> int:
    """An end offset near ``at`` snapped forward to a sentence end (within
    40 chars), else a space (within 20), else ``at``."""
    n = len(text)
    if at >= n:
        return n
    for i in range(at, min(n, at + 40)):
        if text[i] in _SENTENCE_ENDS:
            return i + 1
    for i in range(at, min(n, at + 20)):
        if text[i].isspace():
            return i
    return at


def _build_passages(text: str, frag_size: int):
    """Sentence-snapped passages of about ``frag_size`` chars covering
    the text."""
    passages = []
    start = 0
    n = len(text)
    while start < n:
        end = _snap_end(text, start + max(frag_size, 1))
        if end <= start:
            end = min(n, start + max(frag_size, 1))
        passages.append((start, end))
        start = end
        while start < n and text[start].isspace():
            start += 1
    return passages
