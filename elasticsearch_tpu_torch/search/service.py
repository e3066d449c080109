"""`_search` on the plan path and the dense executor (counterpart of
the single-node part of elasticsearch_tpu/search/service.py
`SearchService.search`, reduced): parse the body, run the query phase
then the fetch phase on the index's one shard, shape the response.

The body may carry ``query`` (default ``match_all``), ``size``,
``from``, ``post_filter``, ``min_score``, ``sort``, ``search_after``,
``track_total_hits`` (true, false or a threshold), ``_source`` (true
or false), ``knn`` and ``rank``. Everything else (aggregations, source
filtering, ...) is a later slice and answers a typed 400.

Hybrid retrieval: top-level ``knn`` sections (one or a list). With
``rank: {"rrf": {...}}`` the query and each knn section run as separate
branches, fused by reciprocal rank (score = the sum over branches of
1 / (rank_constant + rank)). Without it, a pure kNN body (one section,
no query, ``_source: false``, nothing else that shapes the response)
rides the KnnBatcher's cohort launch; any other body merges its knn
sections into the query as ``bool.should`` clauses (the score sum) and
runs on the dense executor. A kNN branch served by the batcher needs an
index of one segment, no ``filter`` and a candidate cut within its
largest bucket (4096); otherwise the dense executor serves it.

Under a ``sort`` each hit carries its ``sort`` values, the page is
ordered by them (missing last), and ``max_score`` is null, as the
reference gives them.

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

from elasticsearch_tpu_torch.search.batching import (_CUT_BUCKETS,
                                                     KnnBatcher, PlanBatcher)
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.queries import (MatchAllQuery,
                                                    parse_query)
from elasticsearch_tpu_torch.search.searcher import (MAX_TOPK, ShardSearcher,
                                                     _host_sort_cmp,
                                                     _parse_sort)

DEFAULT_SIZE = 10
BODY_KEYS = {"query", "size", "from", "post_filter", "track_total_hits",
             "_source", "sort", "search_after", "min_score", "knn", "rank"}
# a body with any of these (truthy) asks more than the k nearest ids and
# scores, so its kNN takes the dense executor, not the cohort launch
_NOT_PURE_KNN = ("sort", "post_filter", "min_score", "search_after",
                 "track_total_hits")


class IllegalArgumentException(ValueError):
    error_type = "illegal_argument_exception"


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


class SearchService:
    """Owns the node's PlanBatcher and KnnBatcher: every plan-path
    search and every batched kNN branch of the node launches through
    them."""

    def __init__(self, cache: DeviceSegmentCache):
        self.cache = cache
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
        searcher = self._searcher(svc)
        if rank_spec and rank_spec.get("rrf") is not None:
            response = self._rrf_search(index, searcher, body)
        elif body.get("knn") is not None:
            response = self._pure_knn_search(index, searcher, body)
            if response is None:
                response = self._execute(index, searcher,
                                         _merge_knn_into_query(body))
        else:
            response = self._execute(index, searcher, body)
        return {"took": int((time.time() - t0) * 1000), **response}

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
        source = body.get("_source", True)
        if not isinstance(source, bool):
            raise SliceUnsupported("_source filtering is a later slice "
                                   "(this one takes true or false)")
        size = int(body.get("size", DEFAULT_SIZE))
        from_ = int(body.get("from", 0))
        if size < 0 or from_ < 0:
            raise IllegalArgumentException(
                "[size] and [from] must be non-negative")
        if from_ + size > MAX_TOPK:
            raise IllegalArgumentException(
                f"Result window is too large, from + size must be less "
                f"than or equal to: [{MAX_TOPK}]")
        query = (parse_query(body["query"]) if body.get("query")
                 else MatchAllQuery())
        post_filter = (parse_query(body["post_filter"])
                       if body.get("post_filter") else None)
        sort = body.get("sort")
        search_after = body.get("search_after")
        if search_after is not None and not isinstance(search_after, list):
            raise IllegalArgumentException(
                "[search_after] must be an array of sort values")
        # repeats of the same query JSON reuse their bound plans
        cache_key = json.dumps([body.get("query"), body.get("post_filter")],
                               sort_keys=True, default=str)
        result = searcher.query_phase(
            query, from_ + size, post_filter,
            min_score=body.get("min_score"), sort=sort,
            search_after=search_after, track_total_hits=track_total,
            cache_key=cache_key)
        docs = result.docs
        sort_spec = _parse_sort(sort)
        if sort_spec is not None and any(d.sort_values for d in docs):
            # the page orders by the real sort values (float64 doc
            # values, missing last), not the float32 device keys
            docs = sorted(docs, key=functools.cmp_to_key(
                lambda a, b: _host_sort_cmp(a, b, sort_spec)))
        hits = searcher.fetch_phase(docs[from_:from_ + size], source)
        for h in hits:
            h["_index"] = index
        total = result.total_hits
        relation = "gte" if result.total_lower_bound else "eq"
        if not isinstance(track_total, bool) and total > track_total:
            total, relation = track_total, "gte"
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
                       if k in ("_source", "post_filter", "min_score",
                                "track_total_hits")}
        scores: Dict[Tuple[str, str], float] = {}
        best_hit: Dict[Tuple[str, str], Dict[str, Any]] = {}
        truncated = False
        wants_source = passthrough.get("_source", True) is not False
        for br in branches:
            # a pure knn branch rides the cohort launch when the fusion
            # needs only its ids and scores
            hits = None
            if (set(br["query"]) == {"knn"} and not wants_source
                    and not any(passthrough.get(x) for x in
                                ("post_filter", "min_score"))):
                hits = self._knn_branch_hits(index, searcher,
                                             br["query"]["knn"], window)
            if hits is None:
                sub = {**passthrough, **br, "size": window}
                hits = self._execute(index, searcher, sub)["hits"]["hits"]
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
        return {
            "timed_out": False,
            "_shards": {"total": 1, "successful": 1, "skipped": 0,
                        "failed": 0},
            "hits": {"total": {"value": len(scores),
                               "relation": "gte" if truncated else "eq"},
                     "max_score": hits[0]["_score"] if hits else None,
                     "hits": hits},
        }
