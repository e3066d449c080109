"""Shard searcher: the query and fetch phases over one shard (counterpart
of elasticsearch_tpu/search/searcher.py, plan branch only).

The query phase compiles the query into a LogicalPlan (search/plan.py),
binds it per segment and launches it, through the PlanBatcher when one
is set; the per-segment top-k rows merge host-side by (-score, segment,
docid), Lucene's tie order. A query the plan path cannot take raises
``SliceUnsupported``: the reference's dense executor is a later slice.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.index.segment import Segment
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    SegmentContext,
                                                    ShardStats)
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.plan import (bind_plan, compile_plan,
                                                 execute_bound)

MAX_TOPK = 10000


@dataclass(slots=True)
class DocAddress:
    segment_idx: int
    docid: int
    score: float


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
        return [SegmentContext(seg, self.cache.get(seg), self.stats,
                               self.k1, self.b)
                for seg in self.segments]

    # ------------------------------------------------------------ query
    def query_phase(self, query, size: int, post_filter=None,
                    cache_key: Optional[str] = None,
                    track_total_hits=True) -> QueryResult:
        """Exact top-``size`` (at most MAX_TOPK) and exact total.
        ``cache_key`` (the request's query JSON) lets repeats reuse their
        bound plans, which hold the uploaded selections' host arrays.
        A ``track_total_hits`` other than true (false or a threshold)
        licenses block-max pruning, as Lucene only collects TOP_SCORES
        under a total-hits threshold: the hits stay exact, and when a
        segment pruned the total is a lower bound (``total_lower_bound``)."""
        k = min(max(size, 1), MAX_TOPK)
        plan = compile_plan(query, self, post_filter)
        if plan is None:
            raise SliceUnsupported(
                "this query needs the dense executor (a clause nested "
                "below one bool level, a bool of must_not clauses only, "
                "a negative boost or a multi_match type other than "
                "best_fields/most_fields): a later slice of the port")
        allow_prune = track_total_hits is not True
        bkey_base = None
        if cache_key is not None:
            # the segment set pins shard-level stats (idf, avg length);
            # k and allow_prune pin the pruning, so a pruned bind is
            # never served to an exact ask; the live version pins the
            # docs that verified its θ
            bkey_base = (tuple(s.name for s in self.segments), self.k1,
                         self.b, cache_key, k, allow_prune)
        per_segment = []
        total = 0
        lower_bound = False
        for seg_idx, ctx in enumerate(self._contexts()):
            if ctx.segment.n_docs == 0:
                continue
            if bkey_base is None:
                bp = bind_plan(plan, ctx, k, allow_prune)
            else:
                bp = ctx.device.bound_plan(
                    bkey_base + (ctx.segment.live_version,),
                    lambda ctx=ctx: bind_plan(plan, ctx, k, allow_prune))
            lower_bound = lower_bound or bp.pruned
            if self.batcher is not None:
                vals, ids, seg_total = self.batcher.execute(
                    bp, ctx, k, self.k1, self.b)
            else:
                vals, ids, seg_total = execute_bound(bp, ctx, k, self.k1,
                                                     self.b)
            total += int(seg_total)
            keep = vals > -np.inf
            if keep.any():
                per_segment.append((seg_idx, vals[keep], ids[keep]))
        if not per_segment:
            return QueryResult([], total, None, lower_bound)
        all_vals = np.concatenate([v for _, v, _ in per_segment])
        all_segs = np.concatenate(
            [np.full(len(i), s, np.int32) for s, _, i in per_segment])
        all_ids = np.concatenate([i for _, _, i in per_segment])
        # one segment's rows are already (-score, docid)-ordered
        order = np.lexsort((all_ids, all_segs, -all_vals))[:k]
        docs = [DocAddress(int(all_segs[i]), int(all_ids[i]),
                           float(all_vals[i])) for i in order]
        return QueryResult(docs, total, docs[0].score, lower_bound)

    # ------------------------------------------------------------ fetch
    def fetch_phase(self, docs: List[DocAddress],
                    source: bool = True) -> List[Dict[str, Any]]:
        """``_id``, ``_score`` and, with ``source``, the stored
        ``_source`` of each doc (segments built without sources have
        none to show)."""
        hits = []
        for d in docs:
            seg = self.segments[d.segment_idx]
            hit: Dict[str, Any] = {"_id": seg.stored.ids[d.docid],
                                   "_score": d.score}
            if source:
                src = seg.stored.source(d.docid)
                if src:
                    hit["_source"] = json.loads(src)
            hits.append(hit)
        return hits
