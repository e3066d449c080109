"""`_search` on the plan path (counterpart of the single-node part of
elasticsearch_tpu/search/service.py `SearchService.search`, reduced):
parse the body, run the query phase then the fetch phase on the index's
one shard, shape the response.

The body may carry ``query``, ``size``, ``from``, ``post_filter``,
``track_total_hits`` (true, false or a threshold) and ``_source`` (true
or false). Everything else (aggregations, sort, source filtering, ...)
is a later slice and answers a typed 400.

``track_total_hits``: true (the default) counts exactly, relation "eq".
false or an integer license block-max pruning (search/plan.py): the hits
stay exact and the total is a lower bound, relation "gte", when a
segment pruned; an integer also clamps the total to itself, "gte" when
the count exceeds it; false omits ``hits.total``.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict

from elasticsearch_tpu_torch.search.batching import PlanBatcher
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import MAX_TOPK, ShardSearcher

DEFAULT_SIZE = 10
BODY_KEYS = {"query", "size", "from", "post_filter", "track_total_hits",
             "_source"}


class IllegalArgumentException(ValueError):
    error_type = "illegal_argument_exception"


class SearchService:
    """Owns the node's PlanBatcher: every plan-path search of the node
    launches through it."""

    def __init__(self, cache: DeviceSegmentCache):
        self.cache = cache
        self.plan_batcher = PlanBatcher()

    def search(self, index: str, svc, body: Dict[str, Any]) -> Dict[str, Any]:
        """``svc``: the index's IndexService (mapper, engine, k1, b)."""
        t0 = time.time()
        extra = sorted(set(body) - BODY_KEYS)
        if extra:
            raise SliceUnsupported(
                f"search body keys {extra} are a later slice of the port "
                f"(this one takes {sorted(BODY_KEYS)})")
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
        if "query" not in body:
            raise SliceUnsupported("a search without a query (match_all) "
                                   "is a dense clause: a later slice")
        size = int(body.get("size", DEFAULT_SIZE))
        from_ = int(body.get("from", 0))
        if size < 0 or from_ < 0:
            raise IllegalArgumentException(
                "[size] and [from] must be non-negative")
        if from_ + size > MAX_TOPK:
            raise IllegalArgumentException(
                f"Result window is too large, from + size must be less "
                f"than or equal to: [{MAX_TOPK}]")
        query = parse_query(body["query"])
        post_filter = (parse_query(body["post_filter"])
                       if body.get("post_filter") else None)
        searcher = ShardSearcher(svc.engine.segments, svc.mapper, self.cache,
                                 svc.k1, svc.b)
        searcher.batcher = self.plan_batcher
        # repeats of the same query JSON reuse their bound plans
        cache_key = json.dumps([body["query"], body.get("post_filter")],
                               sort_keys=True, default=str)
        result = searcher.query_phase(query, from_ + size, post_filter,
                                      cache_key=cache_key,
                                      track_total_hits=track_total)
        hits = searcher.fetch_phase(result.docs[from_:from_ + size], source)
        for h in hits:
            h["_index"] = index
        total = result.total_hits
        relation = "gte" if result.total_lower_bound else "eq"
        if not isinstance(track_total, bool) and total > track_total:
            total, relation = track_total, "gte"
        response = {
            "took": int((time.time() - t0) * 1000),
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
