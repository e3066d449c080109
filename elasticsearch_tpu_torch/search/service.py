"""`_search` on the plan path and the dense executor (counterpart of
the single-node part of elasticsearch_tpu/search/service.py
`SearchService.search`, reduced): parse the body, run the query phase
then the fetch phase on the index's one shard, shape the response.

The body may carry ``query`` (default ``match_all``), ``size``,
``from``, ``post_filter``, ``min_score``, ``sort`` (keyword fields
too), ``search_after``, ``track_total_hits`` (true, false or a
threshold), ``_source`` (true, false, a field, a list or ``{includes,
excludes}``), ``docvalue_fields``, ``fields``, ``script_fields``,
``highlight`` (search/searcher.py ``fetch_phase``), ``knn``, ``rank``,
``rescore`` (one QueryRescorer or a list: the query phase collects the
largest ``window_size`` docs, the rescorers re-score them in order,
then ``from``/``size`` cut the page; not with ``sort``),
``aggs``/``aggregations`` (search/aggregations.py over the dense
executor's match masks; the response carries ``aggregations``, on an
empty index too), ``collapse``, ``terminate_after`` and ``suggest``
(search/suggest.py, host only). Everything else (``version``,
``seq_no_primary_term``, ``stored_fields``, ``explain``, ``pit``,
``slice``, ``timeout``, ...) is a later slice and answers a typed 400.

``collapse: {"field": f}`` keeps the first hit of each value of ``f``
(its first doc value; a text field's dynamic ``.keyword``; docs without
one form one null group) and stamps the value into the hit's
``fields``. The query phase collects ``max(from + size, 5 (from +
size))`` docs first, so a page can hold fewer groups than asked when the
first groups fill that window, as the reference's.

``terminate_after: n`` keeps the shard's first n docs of the query
phase; when the shard matched more, the total is n, relation "gte",
and the response says ``terminated_early``.

Hybrid retrieval: top-level ``knn`` sections (one or a list). With
``rank: {"rrf": {...}}`` the query and each knn section run as separate
branches, fused by reciprocal rank (score = the sum over branches of
1 / (rank_constant + rank)); aggregations ride the query branch alone.
Without it, a pure kNN body (one section, no query, ``_source: false``,
nothing else that shapes the response) rides the KnnBatcher's cohort
launch; any other body merges its knn sections into the query as
``bool.should`` clauses (the score sum) and runs on the dense executor. A kNN branch served by the batcher needs an
index of one segment, no ``filter`` and a candidate cut within its
largest bucket (4096); otherwise the dense executor serves it.

Under a ``sort`` each hit carries its ``sort`` values, the page is
ordered by them (missing last), and ``max_score`` is null, as the
reference gives them.

Query-computed hit decorations (the reference's ``add_hit_fields``
walk): after the fetch phase every builder of the query and the
post_filter that has ``add_hit_fields`` (nested's ``inner_hits``,
percolate's ``_percolator_document_slot``) decorates each hit of the
page, and every builder with ``release`` (percolate's candidate
segment) releases what it holds on the device when the request ends,
answered or not. A ``percolate`` document given by ``index`` and ``id``
is read from that index (search/percolate.py
``resolve_percolate_refs``) before the query parses.

``profile: true`` answers what the same body answers without it, plus
``profile.shards``: one shard's tree (search/profile.py
``shard_profile_tree``: the query's stages split into device and host
nanos, the collector, the ``aggs.collect`` scope, the kernels the
request launched and its cohorts' attribution records, its readback
bytes and the HBM admissions and evictions of its window) and its fetch
time, and ``profile.coordinator`` with the phases' nanos.

``track_total_hits``: true (the default) counts exactly, relation "eq".
false or an integer license block-max pruning (search/plan.py): the hits
stay exact and the total is a lower bound, relation "gte", when a
segment pruned; an integer also clamps the total to itself, "gte" when
the count exceeds it; false omits ``hits.total``.
"""

from __future__ import annotations

import functools
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.search import profile as _prof
from elasticsearch_tpu_torch.search.aggregations import compute_aggs
from elasticsearch_tpu_torch.search.batching import (_CUT_BUCKETS,
                                                     KnnBatcher, PlanBatcher)
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    ShardStats)
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.percolate import resolve_percolate_refs
from elasticsearch_tpu_torch.search.queries import (MatchAllQuery,
                                                    QueryBuilder,
                                                    parse_query)
from elasticsearch_tpu_torch.search.searcher import (MAX_TOPK, DocAddress,
                                                     ShardSearcher,
                                                     _host_sort_cmp,
                                                     _parse_sort)
from elasticsearch_tpu_torch.search.suggest import compute_suggest

DEFAULT_SIZE = 10
BODY_KEYS = {"query", "size", "from", "post_filter", "track_total_hits",
             "_source", "sort", "search_after", "min_score", "knn", "rank",
             "rescore", "aggs", "aggregations", "profile", "highlight",
             "docvalue_fields", "fields", "script_fields", "collapse",
             "terminate_after", "suggest"}
# a body with any of these (truthy) asks more than the k nearest ids and
# scores, so its kNN takes the dense executor, not the cohort launch
_NOT_PURE_KNN = ("sort", "post_filter", "min_score", "search_after",
                 "track_total_hits", "rescore", "aggs", "aggregations",
                 "highlight", "fields", "suggest", "collapse",
                 "docvalue_fields", "script_fields", "terminate_after")
_RESCORE_MODES = ("total", "multiply", "avg", "max", "min")


def _knn_clauses(knn) -> List[Dict[str, Any]]:
    """Top-level knn section(s) -> knn query clauses; the top-level ``k``
    becomes the clause's cut (KnnQuery keeps the k nearest per segment,
    the gather half of ES's gather-then-merge kNN)."""
    specs = knn if isinstance(knn, list) else [knn]
    out = []
    for spec in specs:
        if not isinstance(spec, dict):
            raise IllegalArgumentException("[knn] must be an object or an "
                                           "array of objects")
        clause = {k: v for k, v in spec.items() if k != "k"}
        if spec.get("k") is not None:
            clause["k"] = int(spec["k"])
        out.append({"knn": clause})
    return out


def _rescore_specs(body: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The body's rescorers as a list (none: empty), each with a
    ``query.rescore_query`` and a known ``score_mode``."""
    spec = body.get("rescore")
    if spec is None:
        return []
    if body.get("sort") is not None:
        raise IllegalArgumentException(
            "Cannot use [sort] option in conjunction with [rescore].")
    specs = [spec] if isinstance(spec, dict) else spec
    for r in specs:
        q = r.get("query") if isinstance(r, dict) else None
        if not isinstance(q, dict) or "rescore_query" not in q:
            raise IllegalArgumentException(
                "[rescore] requires [query.rescore_query]")
        mode = q.get("score_mode", "total")
        if mode not in _RESCORE_MODES:
            raise IllegalArgumentException(f"illegal score_mode [{mode}]")
    return specs


def _doc_field_value(searcher: ShardSearcher, d: DocAddress, field: str):
    """A doc's first doc value of ``field`` (a collapse key), None when
    it has none: the keyword values first (a text field's dynamic
    ``.keyword`` when the field has none), then the numeric one."""
    seg = searcher.segments[d.segment_idx]
    kv = seg.keywords.get(field)
    if kv is None:
        kv = seg.keywords.get(f"{field}.keyword")
    if kv is not None:
        vs = kv.get(d.docid)
        if vs:
            return vs[0]
    nv = seg.numerics.get(field)
    if nv is not None and not nv.missing[d.docid]:
        return float(nv.values[d.docid])
    return None


def _query_nodes(query, out=None, seen=None) -> List[QueryBuilder]:
    """Every builder of a parsed query tree (its attributes that are
    builders, or lists and tuples of them), each once."""
    if out is None:
        out, seen = [], set()
    if id(query) in seen:
        return out
    seen.add(id(query))
    out.append(query)
    for v in vars(query).values():
        for item in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(item, QueryBuilder):
                _query_nodes(item, out, seen)
    return out


def _merge_knn_into_query(body: Dict[str, Any]) -> Dict[str, Any]:
    """Top-level knn sections without rrf combine with the query by
    score sum (the modern ES hybrid default): a bool should of all
    parts."""
    body = dict(body)
    clauses = _knn_clauses(body.pop("knn"))
    q = body.get("query")
    if q is None and len(clauses) == 1:
        body["query"] = clauses[0]
    else:
        body["query"] = {"bool": {
            "should": ([q] if q is not None else []) + clauses}}
    return body


class _CoordinatorRewriteContext:
    """A searcher-shaped view over every shard of the index, for the
    coordinator's rewrite (the reference's): ``segments`` spans all
    shards, so a like-doc resolves wherever it lives, and ``stats`` are
    index-wide."""

    def __init__(self, shard_searchers: List[ShardSearcher]):
        self.segments = [seg for s in shard_searchers for seg in s.segments]
        self.mapper = shard_searchers[0].mapper
        self.stats = ShardStats(self.segments)


class SearchService:
    """Owns the node's PlanBatcher and KnnBatcher: every plan-path
    search and every batched kNN branch of the node launches through
    them."""

    def __init__(self, cache: DeviceSegmentCache, indices=None):
        self.cache = cache
        # the node's indices by name: a percolate document by index/id
        # is read from them
        self.indices = indices
        self.plan_batcher = PlanBatcher()
        self.knn_batcher = KnnBatcher()

    def search(self, index: str, svc, body: Dict[str, Any]) -> Dict[str, Any]:
        """``svc``: the index's IndexService (mapper, engine, k1, b)."""
        t0 = time.time()
        extra = sorted(set(body) - BODY_KEYS)
        if extra:
            raise SliceUnsupported(
                f"search body keys {extra} are a later slice of the port "
                f"(this one takes {sorted(BODY_KEYS)})")
        rank_spec = body.get("rank")
        if rank_spec is not None and not isinstance(rank_spec, dict):
            raise IllegalArgumentException("[rank] must be an object")
        body = dict(body)
        for key in ("query", "post_filter"):
            if body.get(key):
                body[key] = resolve_percolate_refs(body[key], self.indices)
        searcher = self._searcher(svc)
        if not body.get("profile"):
            response = self._search(index, searcher, body)
        else:
            response = self._profiled(index, searcher, body)
        return {"took": int((time.time() - t0) * 1000), **response}

    def _search(self, index: str, searcher: ShardSearcher,
                body: Dict[str, Any]) -> Dict[str, Any]:
        rank_spec = body.get("rank")
        if rank_spec and rank_spec.get("rrf") is not None:
            return self._rrf_search(index, searcher, body)
        if body.get("knn") is not None:
            response = self._pure_knn_search(index, searcher, body)
            if response is not None:
                return response
            return self._execute(index, searcher,
                                 _merge_knn_into_query(body))
        return self._execute(index, searcher, body)

    def _profiled(self, index: str, searcher: ShardSearcher,
                  body: Dict[str, Any]) -> Dict[str, Any]:
        """``_search`` under a profile recorder (search/profile.py): the
        response with ``profile`` (the module docstring)."""
        churn0 = self.cache.churn_counters()
        t0 = time.monotonic_ns()
        with _prof.profiling() as rec:
            response = self._search(index, searcher, body)
        total_ns = time.monotonic_ns() - t0
        fetch_ns = rec.pop("fetch", 0)
        aggs_ns = rec.get("aggs.collect")
        adm, ev = self.cache.churn_counters()
        if adm - churn0[0] or ev - churn0[1]:
            # HBM churn in this request's window (node-wide: a
            # concurrent request's uploads can land in it)
            counters = rec.setdefault("_counters", {})
            counters["hbm_admissions"] = adm - churn0[0]
            counters["hbm_evictions"] = ev - churn0[1]
        entry = _prof.shard_profile_tree(f"[{index}][0]", body, rec,
                                         total_ns - fetch_ns)
        entry["fetch"] = {"type": "fetch", "description": "",
                          "time_in_nanos": fetch_ns,
                          "breakdown": {"load_stored_fields": fetch_ns}}
        coord: Dict[str, Any] = {"phases": {
            "query_ns": entry["searches"][0]["query"][0]["time_in_nanos"],
            "fetch_ns": fetch_ns}}
        if aggs_ns is not None:
            coord["phases"]["aggs_ns"] = aggs_ns
            coord["reduce_batches"] = 1
        response["profile"] = {"shards": [entry], "coordinator": coord}
        return response

    def _searcher(self, svc) -> ShardSearcher:
        searcher = ShardSearcher(svc.engine.segments, svc.mapper, self.cache,
                                 svc.k1, svc.b)
        searcher.batcher = self.plan_batcher
        return searcher

    def _execute(self, index: str, searcher: ShardSearcher,
                 body: Dict[str, Any]) -> Dict[str, Any]:
        """The query and fetch phases of one body on the index's shard:
        the response without ``took``. ``knn`` has been merged into the
        query or served by the caller; ``rank`` is the caller's."""
        track_total = body.get("track_total_hits", True)
        if not isinstance(track_total, int) or (
                not isinstance(track_total, bool) and track_total < 0):
            raise IllegalArgumentException(
                f"[track_total_hits] must be true, false or a "
                f"non-negative integer, got [{track_total}]")
        size = int(body.get("size", DEFAULT_SIZE))
        from_ = int(body.get("from", 0))
        if size < 0 or from_ < 0:
            raise IllegalArgumentException(
                "[size] and [from] must be non-negative")
        if from_ + size > MAX_TOPK:
            raise IllegalArgumentException(
                f"Result window is too large, from + size must be less "
                f"than or equal to: [{MAX_TOPK}]")
        with _prof.span("rewrite"):
            query = (parse_query(body["query"]) if body.get("query")
                     else MatchAllQuery())
            # the coordinator's rewrite: doc-resolving queries (a
            # more_like_this like-doc) see every shard's segments
            query = query.rewrite(_CoordinatorRewriteContext([searcher]))
            post_filter = (parse_query(body["post_filter"])
                           if body.get("post_filter") else None)
        nodes = _query_nodes(query) + (_query_nodes(post_filter)
                                       if post_filter is not None else [])
        try:
            return self._execute_query(index, searcher, body, query,
                                       post_filter, nodes, track_total,
                                       size, from_)
        finally:
            for node in nodes:
                if hasattr(node, "release"):
                    node.release()

    def _execute_query(self, index: str, searcher: ShardSearcher,
                       body: Dict[str, Any], query, post_filter, nodes,
                       track_total, size: int, from_: int):
        sort = body.get("sort")
        search_after = body.get("search_after")
        if search_after is not None and not isinstance(search_after, list):
            raise IllegalArgumentException(
                "[search_after] must be an array of sort values")
        rescore = _rescore_specs(body)
        aggs_spec = body.get("aggs", body.get("aggregations"))
        collapse_field = (body.get("collapse") or {}).get("field")
        terminate_after = body.get("terminate_after")
        # a rescorer's window may exceed the page
        query_k = max([from_ + size] + [int(r.get("window_size", 10))
                                        for r in rescore])
        if collapse_field:
            # over-collect so that enough groups survive the collapse
            query_k = max(query_k, (from_ + size) * 5)
        # repeats of the same query JSON reuse their bound plans
        cache_key = json.dumps([body.get("query"), body.get("post_filter")],
                               sort_keys=True, default=str)
        result = searcher.query_phase(
            query, query_k, post_filter,
            min_score=body.get("min_score"), sort=sort,
            search_after=search_after, track_total_hits=track_total,
            cache_key=cache_key, collect_masks=bool(aggs_spec))
        docs = result.docs
        if terminate_after:
            # the shard stops collecting after terminate_after docs
            docs = docs[:int(terminate_after)]
        if rescore:
            docs = searcher.rescore(docs, rescore)
        sort_spec = _parse_sort(sort)
        if sort_spec is not None and any(d.sort_values for d in docs):
            # the page orders by the real sort values (float64 doc
            # values, missing last), not the float32 device keys
            docs = sorted(docs, key=functools.cmp_to_key(
                lambda a, b: _host_sort_cmp(a, b, sort_spec)))
        if collapse_field:
            # the first hit of each key; docs without one share a group
            seen = set()
            kept = []
            for d in docs:
                key = _doc_field_value(searcher, d, collapse_field)
                if key not in seen:
                    seen.add(key)
                    kept.append(d)
            docs = kept
        page = docs[from_:from_ + size]
        with _prof.span("fetch"):
            hits = searcher.fetch_phase(
                page, source_filter=body.get("_source", True),
                docvalue_fields=[f if isinstance(f, str) else f.get("field")
                                 for f in body.get("docvalue_fields", [])],
                highlight=body.get("highlight"), highlight_query=query,
                script_fields=body.get("script_fields"),
                fields=body.get("fields"))
        for d, h in zip(page, hits):
            h["_index"] = index
            if collapse_field:
                h.setdefault("fields", {})[collapse_field] = [
                    _doc_field_value(searcher, d, collapse_field)]
        # query-computed decorations: inner_hits, percolator slots
        for node in nodes:
            if hasattr(node, "add_hit_fields"):
                for h in hits:
                    node.add_hit_fields(h)
        total = result.total_hits
        relation = "gte" if result.total_lower_bound else "eq"
        if not isinstance(track_total, bool) and total > track_total:
            total, relation = track_total, "gte"
        terminated_early = None
        if terminate_after:
            terminated_early = result.total_hits > int(terminate_after)
            if terminated_early:
                total, relation = int(terminate_after), "gte"
        response = {
            "timed_out": False,
            "_shards": {"total": 1, "successful": 1, "skipped": 0,
                        "failed": 0},
            "hits": {"total": {"value": total, "relation": relation},
                     "max_score": result.max_score, "hits": hits},
        }
        if track_total is False:
            # ES omits hits.total when tracking is disabled
            del response["hits"]["total"]
        if terminated_early is not None:
            response["terminated_early"] = terminated_early
        if aggs_spec:
            with _prof.span("aggs.collect"):
                response["aggregations"] = compute_aggs(
                    aggs_spec,
                    [(seg, mask, searcher.mapper)
                     for seg, mask in result.agg_masks],
                    searcher.mapper, searcher.cache)
        if body.get("suggest"):
            response["suggest"] = compute_suggest(body["suggest"],
                                                  [(index, searcher)])
        return response

    # ---------------------------------------------------------------- kNN
    def _pure_knn_search(self, index: str, searcher: ShardSearcher,
                         body: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """A pure top-level kNN body (one section, no query, ids and
        scores only) through the batched cohort launch: the response
        without ``took``, or None, and the caller takes the dense
        executor, which serves everything."""
        if body.get("query") is not None \
                or body.get("_source", True) is not False:
            return None
        if any(body.get(x) for x in _NOT_PURE_KNN):
            return None
        if int(body.get("from", 0) or 0) != 0:
            return None
        clauses = _knn_clauses(body["knn"])
        if len(clauses) != 1:
            return None
        spec = clauses[0]["knn"]
        size = int(body.get("size", DEFAULT_SIZE))
        # the candidate cut mirrors KnnQuery: k, else num_candidates
        cut = spec.get("k") or spec.get("num_candidates")
        window = min(int(cut), size) if cut else size
        hits = self._knn_branch_hits(index, searcher, spec, window)
        if hits is None:
            return None
        seg = searcher.segments[0]
        vv = seg.vectors.get(spec.get("field"))
        # the version before the mask: a delete between the two reads
        # is counted again at the next request, never kept
        version = seg.live_version
        n_match = 0 if vv is None else vv.live_count(seg.live, version)
        total = min(int(cut), n_match) if cut else n_match
        return {
            "timed_out": False,
            "_shards": {"total": 1, "successful": 1, "skipped": 0,
                        "failed": 0},
            "hits": {"total": {"value": total, "relation": "eq"},
                     "max_score": (hits[0]["_score"] if hits else None),
                     "hits": hits},
        }

    def _knn_branch_hits(self, index: str, searcher: ShardSearcher,
                         spec: Dict[str, Any],
                         window: int) -> Optional[List[Dict[str, Any]]]:
        """A kNN branch (a knn clause) through the KnnBatcher: concurrent
        requests share one product and top-k launch. Its hit dicts
        (``_index``, ``_id``, ``_score``), or None when the branch does
        not batch (a filter, several segments, no such vector field, a
        cut beyond the largest bucket): the dense executor serves it."""
        if spec.get("filter") is not None or len(searcher.segments) != 1:
            return None
        ctx = searcher._contexts()[0]
        field = spec.get("field")
        dv = ctx.device.vectors.get(field) if field else None
        if dv is None or dv.similarity not in ("cosine", "dot_product",
                                               "l2_norm"):
            return None
        qvec = np.asarray(spec.get("query_vector", ()), np.float32)
        if qvec.shape != (dv.dims,):
            return None
        k = spec.get("k")
        nc = spec.get("num_candidates")
        cut = min(int(k or nc or window), window)
        if dv.vectors.dtype != torch.float32:
            # quantized slab: nominate the full num_candidates before
            # the exact re-rank, then trim to the window
            cut = max(cut, min(int(nc or 3 * (k or 1000)),
                               ctx.n_docs_padded))
        if cut > _CUT_BUCKETS[-1]:
            return None
        _prof.note("collector", "KnnBatchTopDocsCollector")
        with _prof.span("launch"):
            scores, ids = self.knn_batcher.topk(ctx, field, qvec, cut)
        seg = ctx.segment
        hits = []
        for s, i in zip(scores[:window], ids[:window]):
            if i < 0 or i >= seg.n_docs or not np.isfinite(s):
                continue
            hits.append({"_index": index, "_id": seg.stored.ids[int(i)],
                         "_score": float(s)})
        return hits

    def _rrf_search(self, index: str, searcher: ShardSearcher,
                    body: Dict[str, Any]) -> Dict[str, Any]:
        """Reciprocal rank fusion over the query and knn branches (the
        modern ``rank.rrf`` API: score(d) = the sum over branches of
        1 / (rank_constant + rank of d)), each branch asked for
        ``window_size`` hits (default max(100, from + size)); ties by
        (index, id). The total counts the fused docs, "gte" when a
        branch filled its window."""
        rrf = body["rank"]["rrf"] or {}
        k_const = int(rrf.get("rank_constant", 60))
        size = int(body.get("size", DEFAULT_SIZE))
        from_ = int(body.get("from", 0))
        window = int(rrf.get("window_size",
                             rrf.get("rank_window_size",
                                     max(100, size + from_))))
        branches: List[Dict[str, Any]] = []
        if body.get("query") is not None:
            branches.append({"query": body["query"]})
        if body.get("knn") is not None:
            branches.extend({"query": c} for c in _knn_clauses(body["knn"]))
        if not branches:
            raise IllegalArgumentException(
                "rrf requires at least one of [query, knn]")
        passthrough = {k: v for k, v in body.items()
                       if k in ("_source", "fields", "post_filter",
                                "min_score", "track_total_hits",
                                "highlight")}
        scores: Dict[Tuple[str, str], float] = {}
        best_hit: Dict[Tuple[str, str], Dict[str, Any]] = {}
        truncated = False
        aggregations = None
        wants_aggs = "aggs" in body or "aggregations" in body
        wants_source = passthrough.get("_source", True) is not False
        for bi, br in enumerate(branches):
            # a pure knn branch rides the cohort launch when the fusion
            # needs only its ids and scores
            hits = None
            if (set(br["query"]) == {"knn"} and not wants_source
                    and not any(passthrough.get(x) for x in
                                ("highlight", "post_filter", "min_score",
                                 "fields"))
                    and not (bi == 0 and wants_aggs)):
                hits = self._knn_branch_hits(index, searcher,
                                             br["query"]["knn"], window)
            if hits is None:
                sub = {**passthrough, **br, "size": window}
                if bi == 0:
                    # the aggregations compute once, over the first
                    # (query) branch
                    for agg_key in ("aggs", "aggregations"):
                        if agg_key in body:
                            sub[agg_key] = body[agg_key]
                r = self._execute(index, searcher, sub)
                if bi == 0 and "aggregations" in r:
                    aggregations = r["aggregations"]
                hits = r["hits"]["hits"]
            if len(hits) >= window:
                truncated = True
            for rank_i, h in enumerate(hits):
                key = (h["_index"], h["_id"])
                scores[key] = scores.get(key, 0.0) + 1.0 / (
                    k_const + rank_i + 1)
                best_hit.setdefault(key, h)
        order = sorted(scores, key=lambda key: (-scores[key], key))
        hits = []
        for key in order[from_: from_ + size]:
            h = dict(best_hit[key])
            h["_score"] = scores[key]
            hits.append(h)
        out = {
            "timed_out": False,
            "_shards": {"total": 1, "successful": 1, "skipped": 0,
                        "failed": 0},
            "hits": {"total": {"value": len(scores),
                               "relation": "gte" if truncated else "eq"},
                     "max_score": hits[0]["_score"] if hits else None,
                     "hits": hits},
        }
        if aggregations is not None:
            out["aggregations"] = aggregations
        return out
