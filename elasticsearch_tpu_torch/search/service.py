"""`_search` on the plan path and the dense executor (counterpart of
the single-node part of elasticsearch_tpu/search/service.py
`SearchService.search`, reduced): parse the body, run the query phase
then the fetch phase on the index's one shard, shape the response.

The body may carry ``query`` (default ``match_all``), ``size``,
``from``, ``post_filter``, ``min_score``, ``sort``, ``search_after``,
``track_total_hits`` (true, false or a threshold) and ``_source`` (true
or false). Everything else (aggregations, source filtering, ...) is a
later slice and answers a typed 400. Under a ``sort`` each hit carries
its ``sort`` values, the page is ordered by them (missing last), and
``max_score`` is null, as the reference gives them.

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
from typing import Any, Dict

from elasticsearch_tpu_torch.search.batching import PlanBatcher
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.queries import (MatchAllQuery,
                                                    parse_query)
from elasticsearch_tpu_torch.search.searcher import (MAX_TOPK, ShardSearcher,
                                                     _host_sort_cmp,
                                                     _parse_sort)

DEFAULT_SIZE = 10
BODY_KEYS = {"query", "size", "from", "post_filter", "track_total_hits",
             "_source", "sort", "search_after", "min_score"}


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
        searcher = ShardSearcher(svc.engine.segments, svc.mapper, self.cache,
                                 svc.k1, svc.b)
        searcher.batcher = self.plan_batcher
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
