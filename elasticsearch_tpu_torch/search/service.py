"""`_search` on the plan path and the dense executor (counterpart of
the single-node elasticsearch_tpu/search/service.py
`SearchService.search`, reduced): resolve the index expression, run
the query phase on every shard of every index it selects, merge, run
the fetch phase on the page's shards, shape the response.

``search(expression, body, search_type)``: the expression is a comma
list of index names and wildcard patterns, or ``_all``, ``*`` or empty
(index/service.py ``IndicesService.resolve``: an unknown concrete name
is a 404). Each shard is a ShardSearcher with its own statistics, and
the query phases run in turn, each through the node's PlanBatcher (one
cohort a shard), behind the reference's per-shard failure barrier: a
shard that raises becomes a ``_shards.failures`` entry and the others
answer, unless every shard failed (its error answers) or
``allow_partial_search_results`` is false (a 503
``search_phase_execution_exception``, 400 when every failure is the
client's). The shards' docs merge by (-score, shard, segment, docid),
or under a sort by the docs' real sort values then shard order (a
keyword's device key is a shard-local ordinal and never crosses
shards). Totals, ``relation``, the ``track_total_hits`` threshold and
``terminated_early`` sum over the shards; ``_shards`` counts them.
Before the loop, the mesh step (parallel/mesh_executor.py, the
reference's): a body of several shards of one index with no
post_filter, sort, min_score, search_after, aggs, rescore, collapse or
terminate_after goes to ``MeshSearchBackend.execute``, which runs one
launch a shard on the node's device list and merges on the device, bit
for bit the loop's answer, when there are as many devices as shards
(else a typed ``fallback.<reason>`` and the loop serves; on one card a
multi-shard body always falls back). A kNN body of several shards meets
the mesh or the loop merged into its query, as in the reference: each
shard's KnnQuery cuts to k, then drops the deleted docs.
``search_type=dfs_query_then_fetch`` scores every shard with one set
of statistics over all of the request's shards (a per-request copy of
each searcher; its bound plans are keyed apart from the default's), as
the reference's dfs phase; any other value than it and
``query_then_fetch`` is a 400.

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
(search/suggest.py, host only), ``version`` and ``seq_no_primary_term``
(each hit's ``_version``, ``_seq_no`` and ``_primary_term`` from the
documents' metadata columns, index/engine.py), ``pit`` and ``slice``
(below), and ``request_cache``. Everything else (``stored_fields``,
``explain``, ``timeout``, ...) is a later slice and answers a typed 400.

The search contexts (the reference's):

- **Scroll.** ``search(..., scroll="1m")`` opens a ScrollContext over
  the shard searchers of this request (their segment lists pinned) and
  answers its first page with ``_scroll_id``; ``scroll(id)`` answers the
  next ``size`` docs. Each shard keeps a cursor (key, segment, docid,
  primary sort value) of the last doc a page emitted, keyed on the
  shard's place in the searcher list (a failed shard keeps its cursor),
  and its query phase masks the docs at or before it
  (search/searcher.py ``_after_key_mask``). Every page runs on the
  dense executor (``allow_plan=False``: a cursor taken on one executor
  would re-emit or skip a boundary doc on the other), reports the first
  page's total, carries no aggregations after the first, and may reach
  past 10,000 docs. ``clear_scroll`` (``["_all"]`` clears every one)
  and expiry (``_reap``, at each call) close a context.
- **Sliced scroll.** ``slice: {"id", "max"}`` wraps the query in
  search/queries.py ``SliceQuery``.
- **Point in time.** ``open_pit(expression, keep_alive)`` pins the
  shard searchers (their segment lists) of the indices it resolves; a
  body with ``pit: {"id"}`` searches them (no index in the request:
  ``[indices] cannot be used with point in time``) and answers
  ``pit_id``. A pinned segment list shows no segment published after
  the PIT opened, but a delete refreshed since flips the pinned
  segment's live mask, so the PIT sees it, as the reference's does.
- **Segments a context outlives.** A merge while a context is open
  retires segments it still reads; its next page uploads them again
  through the device cache (charged to the ``hbm`` breaker). When the
  last context holding a retired segment closes or expires, its device
  copy leaves the cache and the breaker (``_release``).
- **Request cache.** A ``size: 0`` body (no scroll, no pit;
  ``request_cache: false`` opts out) is answered from an LRU of 256
  responses keyed on the index names, every shard's epoch (a refresh
  that publishes a segment or applies a delete bumps it), each index's
  ``index.creation_date``, the search type and the canonical body.
  ``request_cache_stats`` counts hits and misses.
- ``count`` is a size-0, exact-total search (so it meets the cache);
  ``explain`` scores one doc with the query on the dense executor.

Each request runs with the node's stored scripts ambient
(search/queries.py ``stored_scripts``), so a script given by ``id``
resolves in this node's store.

Tasks (transport/tasks.py): ``search``, ``scroll`` and ``count`` take
the request's cancellable ``task``. The search polls it before each
shard and between the query phase and the rest, and installs it as the
profile's cancellation poll and stage hook for the whole request, so
every ``profile.span`` entry (the device-launch boundaries: bind,
launch, score, topk, readback, the kNN and mesh launches) raises
TaskCancelledException once the task is cancelled, and ``_tasks``
shows the stage the search is in. A cancelled search answers that
400, never a partial answer: the per-shard failure barrier lets it
through. A plan-path body cancelled while it waits in a PlanBatcher
cohort leaves the cohort (search/batching.py).

The slow log: every search checks each searched index's
``index.search.slowlog.threshold.query.*`` against its took time
(search/slowlog.py) into ``slowlog_recent``, with its client id, tenant
and class.

Telemetry (``telemetry``, the node's bundle): ``accounted`` resolves a
search's tenant (header > body ``tenant`` > ``index.tenant.default``)
and workload class, and counts it in ``search.requests``,
``search.latency`` and the tenant's and class's rows; under the REST
root span each shard's query phase is a ``shard[{index}][{n}]`` span and
the fetch phase a ``fetch`` span, and a profiled answer names its
``trace.id``.

``collapse: {"field": f}`` keeps the first hit of each value of ``f``
(its first doc value; a text field's dynamic ``.keyword``; docs without
one form one null group) and stamps the value into the hit's
``fields``. The query phase collects ``max(from + size, 5 (from +
size))`` docs first, so a page can hold fewer groups than asked when the
first groups fill that window, as the reference's.

``terminate_after: n`` keeps each shard's first n docs of the query
phase; when a shard matched more, the total is the sum of the shards'
counts each clamped to n, relation "gte", and the response says
``terminated_early``.

Hybrid retrieval: top-level ``knn`` sections (one or a list). With
``rank: {"rrf": {...}}`` the query and each knn section run as separate
branches, fused by reciprocal rank (score = the sum over branches of
1 / (rank_constant + rank)); aggregations ride the query branch alone.
Without it, a pure kNN body (one section, no query, ``_source: false``,
nothing else that shapes the response) on one shard rides the
KnnBatcher's cohort launch; any other body merges its knn sections into
the query as ``bool.should`` clauses (the score sum) and runs on the
dense executor. A kNN branch (of a pure body or of ``rank.rrf``) is
served by the batcher only where the reference serves it so: one shard
of one segment, no ``filter`` and a candidate cut within its largest
bucket (4096); otherwise the dense executor serves it.

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
``profile.shards``: one tree a shard, named ``[index][n]`` with n the
shard's place in the request (search/profile.py
``shard_profile_tree``: its query phase's stages split into device and
host nanos, the collector, the kernels it launched and its cohorts'
attribution records, its readback bytes and the HBM admissions and
evictions of its window) with its fetch time; the aggregations reduce
once over every shard, so their ``aggs.collect`` scope stands in the
first shard's tree; and ``profile.coordinator`` with the phases' nanos
(``query_ns`` the sum of the shards', ``merge_ns`` the merge of their
docs and the collapse, ``fetch_ns``). A ``rank.rrf`` body runs its
branches as searches of their own and answers one tree for the whole
fusion.

``track_total_hits``: true (the default) counts exactly, relation "eq".
false or an integer license block-max pruning (search/plan.py): the hits
stay exact and the total is a lower bound, relation "gte", when a
segment pruned; an integer also clamps the total to itself, "gte" when
the count exceeds it; false omits ``hits.total``.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import logging
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException, SearchContextMissingException,
    SearchPhaseExecutionException, TaskCancelledException, error_type_of)
from elasticsearch_tpu_torch.common.settings import parse_time_value
from elasticsearch_tpu_torch.index.service import IndicesService
from elasticsearch_tpu_torch.ops.device import readback
from elasticsearch_tpu_torch.parallel.mesh_executor import MeshSearchBackend
from elasticsearch_tpu_torch.search import profile as _prof
from elasticsearch_tpu_torch.search.aggregations import compute_aggs
from elasticsearch_tpu_torch.search.batching import (_CUT_BUCKETS,
                                                     KnnBatcher, PlanBatcher)
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    ShardStats)
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.percolate import resolve_percolate_refs
from elasticsearch_tpu_torch.search.queries import (MatchAllQuery,
                                                    QueryBuilder, SliceQuery,
                                                    parse_query,
                                                    stored_scripts)
from elasticsearch_tpu_torch.search.searcher import (MAX_TOPK, DocAddress,
                                                     QueryResult,
                                                     ShardSearcher,
                                                     _host_sort_cmp,
                                                     _parse_sort)
from elasticsearch_tpu_torch.search.slowlog import (record_search_slowlog,
                                                    slowest_stage_summary)
from elasticsearch_tpu_torch.search.suggest import compute_suggest
from elasticsearch_tpu_torch.telemetry import context as _telectx
from elasticsearch_tpu_torch.telemetry import flightrecorder as _flight
from elasticsearch_tpu_torch.telemetry.workload import classify_search_request

logger = logging.getLogger("elasticsearch_tpu_torch.search")

DEFAULT_SIZE = 10
# the ``search_type`` URL parameter's values (None: the default)
SEARCH_TYPES = (None, "query_then_fetch", "dfs_query_then_fetch")
BODY_KEYS = {"query", "size", "from", "post_filter", "track_total_hits",
             "_source", "sort", "search_after", "min_score", "knn", "rank",
             "rescore", "aggs", "aggregations", "profile", "highlight",
             "docvalue_fields", "fields", "script_fields", "collapse",
             "terminate_after", "suggest", "allow_partial_search_results",
             "version", "seq_no_primary_term", "pit", "slice", "tenant"}
# a body with any of these (truthy) asks more than the k nearest ids and
# scores, so its kNN takes the dense executor, not the cohort launch
_NOT_PURE_KNN = ("sort", "post_filter", "min_score", "search_after",
                 "track_total_hits", "rescore", "aggs", "aggregations",
                 "highlight", "fields", "suggest", "collapse",
                 "docvalue_fields", "script_fields", "terminate_after",
                 "version", "seq_no_primary_term", "pit", "slice")
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
    """A searcher-shaped view over every shard of the request, for the
    coordinator's rewrite (the reference's): ``segments`` spans all
    shards, so a like-doc resolves wherever it lives, and ``stats`` are
    request-wide."""

    def __init__(self, shard_searchers: List[ShardSearcher]):
        self.segments = [seg for s in shard_searchers for seg in s.segments]
        self.mapper = shard_searchers[0].mapper
        self.stats = ShardStats(self.segments)


def _dfs_searchers(searchers: List[Tuple[str, ShardSearcher]]
                   ) -> List[Tuple[str, ShardSearcher]]:
    """The dfs phase: one ShardStats over every shard's segments, set on
    shallow copies of the searchers (never in place), each stamped with
    the key of those statistics (``dfs_key``), which its bound plans'
    cache key carries."""
    segments = [seg for _, s in searchers for seg in s.segments]
    stats = ShardStats(segments)
    key = ("dfs",) + tuple(seg.name for seg in segments)
    out = []
    for name, s in searchers:
        s2 = copy.copy(s)
        s2.stats = stats
        s2.dfs_key = key
        out.append((name, s2))
    return out


def _allow_partial(body: Dict[str, Any]) -> bool:
    value = body.get("allow_partial_search_results", True)
    if isinstance(value, bool):
        return value
    if str(value).lower() in ("true", "false"):
        return str(value).lower() == "true"
    raise IllegalArgumentException(
        f"Failed to parse value [{value}] as only [true] or [false] are "
        f"allowed.")


def _fold_rec(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Add a profile recorder's stages and records into another's."""
    for key, value in src.items():
        if key == "_kernels":
            kernels = dst.setdefault("_kernels", {})
            for k, slot in value.items():
                have = kernels.setdefault(k, [0, 0.0])
                have[0] += slot[0]
                have[1] += slot[1]
        elif key == "_device":
            dst.setdefault("_device", []).extend(value)
        elif key == "_notes":
            for k, v in value.items():
                dst.setdefault("_notes", {}).setdefault(k, v)
        elif key == "_counters":
            counters = dst.setdefault("_counters", {})
            for k, v in value.items():
                counters[k] = counters.get(k, 0) + v
        else:
            dst[key] = dst.get(key, 0) + value


class _ShardProfiles:
    """The ``profile: true`` recorders of one request: one a shard, over
    that shard's query phase (search/profile.py), each with the HBM
    admissions and evictions of its window, and the per-shard fetch
    nanos. The aggregations reduce once over every shard, so their
    ``aggs.collect`` scope and launches join the first shard's entry."""

    def __init__(self, cache: DeviceSegmentCache, body: Dict[str, Any]):
        self.cache = cache
        self.body = body
        self.shards: List[Tuple[str, Dict[str, Any], int]] = []
        self.fetch_ns: Dict[int, int] = {}
        self.merge_ns: Optional[int] = None
        self.aggs: Optional[Tuple[Dict[str, Any], int]] = None

    @contextlib.contextmanager
    def shard(self, shard_id: str):
        churn0 = self.cache.churn_counters()
        t0 = time.monotonic_ns()
        rec: Dict[str, Any] = {}
        try:
            with _prof.profiling() as rec:
                yield
        finally:
            total_ns = time.monotonic_ns() - t0
            adm, ev = self.cache.churn_counters()
            if adm - churn0[0] or ev - churn0[1]:
                # node-wide: a concurrent request's uploads can land in
                # this window
                counters = rec.setdefault("_counters", {})
                counters["hbm_admissions"] = adm - churn0[0]
                counters["hbm_evictions"] = ev - churn0[1]
            self.shards.append((shard_id, rec, total_ns))

    def section(self) -> Dict[str, Any]:
        """The response's ``profile``: ``shards`` and ``coordinator``."""
        entries = []
        for si, (shard_id, rec, total_ns) in enumerate(self.shards):
            if si == 0 and self.aggs is not None:
                agg_rec, agg_ns = self.aggs
                _fold_rec(rec, agg_rec)
                # the named host stages of the aggregation (aggs.group,
                # aggs.script, ...) beside the rest of its time, so the
                # stages sum to it once
                named = sum(v for k, v in agg_rec.items()
                            if k.startswith("aggs.") and k != "aggs.collect")
                rec["aggs.collect"] = max(0, agg_ns - named)
            entry = _prof.shard_profile_tree(shard_id, self.body, rec,
                                             total_ns)
            if si in self.fetch_ns:
                ns = self.fetch_ns[si]
                entry["fetch"] = {"type": "fetch", "description": "",
                                  "time_in_nanos": ns,
                                  "breakdown": {"load_stored_fields": ns}}
            entries.append(entry)
        coord: Dict[str, Any] = {"phases": {
            "query_ns": sum(e["searches"][0]["query"][0]["time_in_nanos"]
                            for e in entries),
            "fetch_ns": sum(self.fetch_ns.values())}}
        if self.merge_ns is not None:
            # the coordinator's merge of the shards' docs and collapse
            coord["phases"]["merge_ns"] = self.merge_ns
        if self.aggs is not None:
            coord["phases"]["aggs_ns"] = self.aggs[1]
            coord["reduce_batches"] = 1
        out = {"shards": entries, "coordinator": coord}
        ambient = _telectx.current()
        if ambient is not None:
            # the profiled request's trace resolves via GET /_traces/{id}
            out["trace.id"] = ambient.trace_id
        return out


@dataclass
class ScrollContext:
    """An open scroll: the request's shard searchers (their segment lists
    pinned), its body, and each shard's cursor (key, segment, docid,
    primary sort value) by the shard's place in the list."""

    scroll_id: str
    index_names: List[str]
    searchers: List[Tuple[str, ShardSearcher]]
    body: Dict[str, Any]
    keep_alive: float
    expires_at: float
    cursors: Dict[int, Tuple] = field(default_factory=dict)
    # the first page's total, reported on every page
    total_hits: int = 0


@dataclass
class PitContext:
    """An open point in time: pinned shard searchers, no cursor."""

    id: str
    index_names: List[str]
    searchers: List[Tuple[str, ShardSearcher]]
    keep_alive: float
    expires_at: float


class SearchService:
    """Owns the node's PlanBatcher and KnnBatcher: every plan-path
    search and every batched kNN branch of the node launches through
    them. ``indices`` (index/service.py IndicesService) holds the
    indices a search expression resolves over; ``stored_scripts`` (the
    node's search/script.py StoredScripts, or None) is where a script
    given by ``id`` resolves."""

    REQUEST_CACHE_MAX_ENTRIES = 256

    def __init__(self, cache: DeviceSegmentCache, indices: IndicesService,
                 devices=None, stored_scripts=None):
        self.cache = cache
        self.indices = indices
        self.stored_scripts = stored_scripts
        self.plan_batcher = PlanBatcher()
        self.knn_batcher = KnnBatcher()
        # the mesh (parallel/mesh_executor.py) over the node's device
        # list (the cache's one device by default): an eligible body of
        # several shards runs one launch a shard on its device and merges
        # there; anything else, and any shard count above the devices,
        # takes the per-shard loop. Its replica helpers split a cohort's
        # rows over the devices when there are two or more
        self.mesh_executor = MeshSearchBackend(
            devices if devices is not None else [cache.device], cache)
        self.plan_batcher.mesh = self.mesh_executor
        self._scrolls: Dict[str, ScrollContext] = {}
        self._pits: Dict[str, PitContext] = {}
        self._lock = threading.Lock()
        self._request_cache: "OrderedDict[tuple, Dict[str, Any]]" = \
            OrderedDict()
        self.request_cache_stats = {"hit_count": 0, "miss_count": 0}
        # the search slow log's newest entries (search/slowlog.py)
        self.slowlog_recent: List[Dict[str, Any]] = []
        # the node's Telemetry (telemetry/__init__.py), or None: search
        # metrics, tenant and class records, shard and fetch spans
        self.telemetry = None

    # ------------------------------------------------------------- PIT
    def open_pit(self, expression: str, keep_alive: str) -> str:
        """Pin the shard searchers of the indices ``expression``
        resolves; returns the PIT's id."""
        names = self.indices.resolve(expression)
        searchers = [(name, s) for name in names
                     for s in self._shard_searchers(self.indices[name])]
        ka = parse_time_value(keep_alive, "keep_alive")
        pit = PitContext(uuid.uuid4().hex, names, searchers, ka,
                         time.time() + ka)
        with self._lock:
            self._pits[pit.id] = pit
        return pit.id

    def close_pit(self, pit_id: str) -> bool:
        with self._lock:
            pit = self._pits.pop(pit_id, None)
        if pit is not None:
            self._release([pit])
        return pit is not None

    def open_pit_count(self) -> int:
        with self._lock:
            return len(self._pits)

    # ---------------------------------------------------------- search
    def search(self, expression: str, body: Dict[str, Any],
               search_type: Optional[str] = None,
               scroll: Optional[str] = None, task=None) -> Dict[str, Any]:
        """``_search`` over every shard of the indices ``expression``
        selects (``IndicesService.resolve``), as ``search_type``
        (``query_then_fetch``, the default, or ``dfs_query_then_fetch``)
        asks; ``scroll`` (a keep-alive) opens a scroll context. Under a
        cancellable ``task`` (transport/tasks.py) the search stops at
        the next poll once it is cancelled (``_task_scope``)."""
        with stored_scripts(self.stored_scripts), _task_scope(task):
            return self.accounted(
                expression, body, scroll,
                lambda: self._search_request(expression, body, search_type,
                                             scroll, task))

    def _default_tenant(self, expression: str) -> Optional[str]:
        """The ``index.tenant.default`` setting of a concretely named
        index (None for a pattern or an unknown name)."""
        if expression in self.indices:
            return self.indices[expression].settings.get(
                "index.tenant.default")
        return None

    def accounted(self, expression: str, body: Dict[str, Any],
                  scroll: Optional[str], run: Callable[[], Dict[str, Any]]
                  ) -> Dict[str, Any]:
        """``run()`` (one `_search`: the service's, or the fast path's in
        rest/api.py) under its tenant and workload class, counted in the
        node's metrics (``search.requests``, ``search.failed``,
        ``search.latency``, ``search.partial_results``) and in the
        tenant's and the class's search records, with the stage sink
        (``search.stage.*``) installed. The tenant is the ambient one
        (the ``X-Tenant-Id`` header), else the body's ``tenant``, else
        the index's ``index.tenant.default``; the class the ambient one
        (``X-Workload-Class``), else the request's shape
        (telemetry/workload.py ``classify_search_request``). Both are
        made ambient, so batcher entries, flight events, breaker trips,
        tasks, profile trees and slowlog entries see them."""
        tenant = _telectx.current_tenant()
        if tenant is None:
            resolved = ((body or {}).get("tenant")
                        or self._default_tenant(expression))
            if resolved is not None:
                with _telectx.activate_tenant(str(resolved)):
                    return self.accounted(expression, body, scroll, run)
        wclass = _telectx.current_workload_class()
        if wclass is None:
            with _telectx.activate_workload_class(
                    classify_search_request(body, scroll)):
                return self.accounted(expression, body, scroll, run)
        tele = self.telemetry
        if tele is None:
            return run()
        # every outcome counts: cache hits, failures and answers
        tele.metrics.inc("search.requests")
        t0 = tele.metrics.clock()
        try:
            with _prof.stage_sink(tele.stage_sink()):
                response = run()
        except Exception:
            took = (tele.metrics.clock() - t0) * 1000.0
            tele.metrics.inc("search.failed")
            tele.metrics.observe("search.latency", took)
            tele.tenants.record_search(tenant, took, failed=True)
            tele.workload.record_search(wclass, took, failed=True)
            raise
        took = (tele.metrics.clock() - t0) * 1000.0
        tele.metrics.observe("search.latency", took)
        tele.tenants.record_search(
            tenant, took, shards=response.get("_shards", {}).get("total", 0))
        tele.workload.record_search(wclass, took)
        if response.get("timed_out") or \
                response.get("_shards", {}).get("failed"):
            tele.metrics.inc("search.partial_results")
        return response

    def span(self, name: str, tags: Dict[str, Any]):
        """A span of the node's tracer under the ambient trace (the
        REST root span), or None when there is neither."""
        if self.telemetry is None or _telectx.current() is None:
            return None
        return self.telemetry.tracer.start_span(name, tags=tags)

    def _search_request(self, expression: str, body: Dict[str, Any],
                        search_type: Optional[str],
                        scroll: Optional[str], task=None) -> Dict[str, Any]:
        t0 = time.time()
        use_cache = body.get("request_cache")
        if "request_cache" in body or "tenant" in body:
            # the tenant was resolved by ``accounted``
            body = {k: v for k, v in body.items()
                    if k not in ("request_cache", "tenant")}
        extra = sorted(set(body) - BODY_KEYS)
        if extra:
            raise SliceUnsupported(
                f"search body keys {extra} are a later slice of the port "
                f"(this one takes {sorted(BODY_KEYS)})")
        if search_type not in SEARCH_TYPES:
            raise IllegalArgumentException(
                f"No search type for [{search_type}]")
        rank_spec = body.get("rank")
        if rank_spec is not None and not isinstance(rank_spec, dict):
            raise IllegalArgumentException("[rank] must be an object")
        pit_spec = body.get("pit")
        cache_key = None
        if pit_spec is not None:
            if expression not in ("_all", "*", ""):
                raise IllegalArgumentException(
                    "[indices] cannot be used with point in time")
            self._reap()
            pit_id = (pit_spec or {}).get("id")
            with self._lock:
                pit = self._pits.get(pit_id)
            if pit is None:
                raise SearchContextMissingException(pit_id or "?")
            if pit_spec.get("keep_alive"):
                pit.keep_alive = parse_time_value(pit_spec["keep_alive"],
                                                  "keep_alive")
            pit.expires_at = time.time() + pit.keep_alive
            names, searchers = pit.index_names, pit.searchers
        else:
            names = self.indices.resolve(expression)
            if (scroll is None and use_cache is not False
                    and int(body.get("size", DEFAULT_SIZE)) == 0):
                cache_key = json.dumps(body, sort_keys=True, default=str)
                epochs = tuple(engine.epoch for name in names
                               for engine in self.indices[name].shards)
                cached = self._cache_get((tuple(names), epochs,
                                          self._cache_identity(names),
                                          search_type, cache_key))
                if cached is not None:
                    cached["took"] = int((time.time() - t0) * 1000)
                    self.record_slowlog(names, cached["took"], body,
                                       cached, task)
                    return cached
            searchers = [(name, s) for name in names
                         for s in self._shard_searchers(self.indices[name])]
        body = dict(body)
        for key in ("query", "post_filter"):
            if body.get(key):
                body[key] = resolve_percolate_refs(body[key], self.indices)
        if search_type == "dfs_query_then_fetch" and len(searchers) > 1:
            searchers = _dfs_searchers(searchers)
        scroll_ctx = None
        if scroll is not None:
            if rank_spec and rank_spec.get("rrf") is not None:
                raise IllegalArgumentException(
                    "[rank] cannot be used with [scroll]")
            if body.get("knn") is not None:
                body = _merge_knn_into_query(body)
            keep_alive = parse_time_value(scroll, "scroll")
            scroll_ctx = ScrollContext(uuid.uuid4().hex, names, searchers,
                                       body, keep_alive,
                                       time.time() + keep_alive)
            with self._lock:
                self._scrolls[scroll_ctx.scroll_id] = scroll_ctx
        profiles = (_ShardProfiles(self.cache, body) if body.get("profile")
                    else None)
        if scroll_ctx is not None:
            response = self._execute(searchers, body, profiles, scroll_ctx)
            response["_scroll_id"] = scroll_ctx.scroll_id
        else:
            response = self._search(searchers, body, profiles)
        if pit_spec is not None:
            response["pit_id"] = pit.id
        response = {"took": int((time.time() - t0) * 1000), **response}
        self.record_slowlog(names, response["took"], body, response, task)
        if cache_key is not None:
            # filed under the epochs the searchers read, so a refresh
            # between the probe and the read never files stale data
            # under the fresh key
            epochs = tuple(s.epoch for _, s in searchers)
            self._cache_put((tuple(names), epochs,
                             self._cache_identity(names), search_type,
                             cache_key), response)
        return response

    # --------------------------------------------------- request cache
    def _cache_identity(self, names: List[str]) -> tuple:
        """Each index's creation date: a deleted and recreated index
        restarts its epochs, and must never meet the old entries."""
        return tuple(self.indices[n].settings.get("index.creation_date")
                     if n in self.indices else None for n in names)

    def _cache_get(self, key: tuple) -> Optional[Dict[str, Any]]:
        with self._lock:
            cached = self._request_cache.get(key)
            if cached is None:
                self.request_cache_stats["miss_count"] += 1
                return None
            self._request_cache.move_to_end(key)
            self.request_cache_stats["hit_count"] += 1
            return copy.deepcopy(cached)

    def _cache_put(self, key: tuple, response: Dict[str, Any]) -> None:
        with self._lock:
            self._request_cache[key] = copy.deepcopy(response)
            while len(self._request_cache) > self.REQUEST_CACHE_MAX_ENTRIES:
                self._request_cache.popitem(last=False)

    def record_slowlog(self, names: List[str], took_ms: int,
                      body: Dict[str, Any], response: Dict[str, Any],
                      task=None) -> None:
        """The search slow log (search/slowlog.py): each searched index's
        thresholds against the took time; the slowest stage from the
        profile when the body asked one, else from the task's stage
        timeline; the flight recorder's summary of the request's
        trace."""
        trace = _telectx.current()
        trace_id = trace.trace_id if trace is not None else None
        fr = _flight.current()
        record_search_slowlog(
            lambda n: self.indices[n].settings if n in self.indices
            else None, names, took_ms, body, self.slowlog_recent,
            trace_id=trace_id,
            slowest_stage=(slowest_stage_summary(response)
                           or (task.slowest_stage() if task is not None
                               else None)),
            flight=(fr.summary_for_trace(trace_id)
                    if fr is not None and trace_id else None),
            opaque_id=_telectx.current_opaque_id(),
            tenant=_telectx.current_tenant(),
            workload_class=_telectx.current_workload_class())

    # ---------------------------------------------------------- scroll
    def scroll(self, scroll_id: str, scroll: Optional[str] = None,
               task=None) -> Dict[str, Any]:
        """The next page of an open scroll (``scroll`` renews its
        keep-alive), polling ``task`` as ``search`` does."""
        t0 = time.time()
        self._reap()
        with self._lock:
            ctx = self._scrolls.get(scroll_id)
        if ctx is None:
            raise SearchContextMissingException(scroll_id)
        if scroll is not None:
            ctx.keep_alive = parse_time_value(scroll, "scroll")
        ctx.expires_at = time.time() + ctx.keep_alive
        with stored_scripts(self.stored_scripts), _task_scope(task):
            response = self._execute(ctx.searchers, ctx.body, None, ctx,
                                     continuing=True)
        response["_scroll_id"] = scroll_id
        return {"took": int((time.time() - t0) * 1000), **response}

    def scan(self, expression: str, body: Dict[str, Any],
             page: int = 1000):
        """Every matching hit, paged by a scroll of ``page`` docs."""
        body = dict(body or {})
        body["size"] = page
        r = self.search(expression, body, scroll="5m")
        sid = r["_scroll_id"]
        try:
            while r["hits"]["hits"]:
                yield from r["hits"]["hits"]
                r = self.scroll(sid)
        finally:
            self.clear_scroll([sid])

    def clear_scroll(self, scroll_ids: List[str]) -> int:
        """Close the scrolls named (``["_all"]``: every one); returns how
        many were open."""
        with self._lock:
            if scroll_ids == ["_all"]:
                freed = list(self._scrolls.values())
                self._scrolls.clear()
            else:
                freed = [c for c in (self._scrolls.pop(sid, None)
                                     for sid in scroll_ids) if c is not None]
        self._release(freed)
        return len(freed)

    def open_scroll_count(self) -> int:
        with self._lock:
            return len(self._scrolls)

    def _reap(self) -> None:
        """Close the scrolls and PITs whose keep-alive passed."""
        now = time.time()
        with self._lock:
            gone = [self._scrolls.pop(sid) for sid, c in
                    list(self._scrolls.items()) if c.expires_at < now]
            gone += [self._pits.pop(pid) for pid, c in
                     list(self._pits.items()) if c.expires_at < now]
        self._release(gone)

    def _release(self, contexts) -> None:
        """The contexts closed: a retired segment (a merge or a delete
        replaced it) that no open context still reads leaves the device
        cache and the breaker."""
        if not contexts:
            return
        with self._lock:
            held = {seg.name for c in (list(self._scrolls.values())
                                       + list(self._pits.values()))
                    for _, s in c.searchers for seg in s.segments}
        names = {seg.name for c in contexts for _, s in c.searchers
                 for seg in s.segments if seg.retired} - held
        if names:
            self.cache.evict(names)
            self.mesh_executor.evict(names)

    # --------------------------------------------------- count, explain
    def count(self, expression: str, body: Dict[str, Any], task=None
              ) -> Dict[str, Any]:
        """``_count``: a size-0 search with an exact total."""
        body = dict(body or {})
        body["size"] = 0
        body.pop("sort", None)
        body["track_total_hits"] = True
        response = self.search(expression, body, task=task)
        return {"count": response["hits"]["total"]["value"],
                "_shards": response["_shards"]}

    def explain(self, expression: str, doc_id: str,
                body: Dict[str, Any]) -> Dict[str, Any]:
        """``_explain``: the query run on the dense executor over the
        segment holding ``doc_id`` (the first index and shard that has
        it live), and that doc's match and score."""
        names = self.indices.resolve(expression)
        with stored_scripts(self.stored_scripts):
            query = (parse_query(body["query"]) if body.get("query")
                     else MatchAllQuery())
            for name in names:
                for searcher in self._shard_searchers(self.indices[name]):
                    q = query.rewrite(searcher)
                    for seg_idx, seg in enumerate(searcher.segments):
                        d = seg.docid_for(doc_id)
                        if d < 0:
                            continue
                        scores, mask = q.execute(
                            searcher._contexts()[seg_idx])
                        m, sc = readback("search.service.explain",
                                         mask[d:d + 1], scores[d:d + 1])
                        matched = bool(m[0])
                        return {"_index": name, "_id": doc_id,
                                "matched": matched, "explanation": {
                                    "value": float(sc[0]) if matched
                                    else 0.0,
                                    "description": (
                                        "sum of BM25 term scores "
                                        "(TPU dense kernel)" if matched
                                        else "no matching term"),
                                    "details": []}}
        return {"_index": names[0] if names else expression, "_id": doc_id,
                "matched": False,
                "explanation": {"value": 0.0,
                                "description": "document not found",
                                "details": []}}

    def _search(self, searchers, body: Dict[str, Any],
                profiles: Optional[_ShardProfiles]) -> Dict[str, Any]:
        rank_spec = body.get("rank")
        if rank_spec and rank_spec.get("rrf") is not None:
            if profiles is None:
                return self._rrf_search(searchers, body)
            return self._rrf_profiled(searchers, body)
        if body.get("knn") is not None:
            # a pure kNN body on one shard takes the cohort launch; any
            # other meets the mesh merged into its query
            response = self._pure_knn_search(searchers, body, profiles)
            if response is not None:
                if profiles is not None:
                    response["profile"] = profiles.section()
                return response
            body = _merge_knn_into_query(body)
        return self._execute(searchers, body, profiles)

    def _rrf_profiled(self, searchers, body: Dict[str, Any]
                      ) -> Dict[str, Any]:
        """``rank.rrf`` under ``profile: true``: its branches run as
        searches of their own, so one recorder spans the whole fusion
        and answers one entry, named after the first shard."""
        name = f"[{searchers[0][0]}][0]" if searchers else "[][0]"
        profiles = _ShardProfiles(self.cache, body)
        with profiles.shard(name):
            response = self._rrf_search(searchers, body)
        response["profile"] = profiles.section()
        return response

    def _shard_searchers(self, svc) -> List[ShardSearcher]:
        """One searcher a shard, each with the shard's own statistics and
        the epoch of the segment list it reads (the request cache files
        an answer under it)."""
        out = []
        for engine in svc.shards:
            snap = engine.acquire_searcher()
            searcher = ShardSearcher(snap.segments, svc.mapper, self.cache,
                                     svc.k1, svc.b)
            searcher.batcher = self.plan_batcher
            searcher.epoch = snap.epoch
            out.append(searcher)
        return out

    def _execute(self, searchers, body: Dict[str, Any],
                 profiles: Optional[_ShardProfiles] = None,
                 scroll_ctx: Optional[ScrollContext] = None,
                 continuing: bool = False) -> Dict[str, Any]:
        """The query phase on every shard (on the mesh when it takes the
        body: ``_mesh_query``), the merge, the fetch phase on the page's
        shards: the response without ``took``. ``knn`` has been merged
        into the query or served by the caller; ``rank`` is the
        caller's. Under ``scroll_ctx`` the page is the next ``size``
        docs after each shard's cursor (``continuing``: a page after the
        first)."""
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
        if from_ + size > MAX_TOPK and scroll_ctx is None:
            raise IllegalArgumentException(
                f"Result window is too large, from + size must be less "
                f"than or equal to: [{MAX_TOPK}]. Use the scroll API or "
                f"search_after")
        query = (parse_query(body["query"]) if body.get("query")
                 else MatchAllQuery())
        slice_spec = body.get("slice")
        if slice_spec is not None:
            query = SliceQuery(int(slice_spec.get("id", 0)),
                               int(slice_spec.get("max", 1)), query)
        if searchers:
            # the coordinator's rewrite: doc-resolving queries (a
            # more_like_this like-doc) see every shard's segments
            query = query.rewrite(_CoordinatorRewriteContext(
                [s for _, s in searchers]))
        post_filter = (parse_query(body["post_filter"])
                       if body.get("post_filter") else None)
        nodes = _query_nodes(query) + (_query_nodes(post_filter)
                                       if post_filter is not None else [])
        try:
            return self._execute_query(searchers, body, query, post_filter,
                                       nodes, track_total, size, from_,
                                       profiles, scroll_ctx, continuing)
        finally:
            for node in nodes:
                if hasattr(node, "release"):
                    node.release()

    def _query_shards(self, searchers, body: Dict[str, Any], query,
                      post_filter, track_total, query_k: int,
                      profiles: Optional[_ShardProfiles],
                      scroll_ctx: Optional[ScrollContext] = None,
                      continuing: bool = False):
        """The query phase on each shard in turn, behind the per-shard
        failure barrier (the reference's): a shard that raises becomes a
        ``_shards.failures`` entry and an empty result, unless every
        shard failed (the first failure is raised) or the body set
        ``allow_partial_search_results`` false (a
        SearchPhaseExecutionException). Returns the (index, searcher,
        QueryResult) of every shard and the failures. A scroll's pages
        take the dense executor from each shard's cursor; a failed shard
        keeps its cursor. A cancelled request (the poll ``search``
        installs) stops the loop between shards: its
        TaskCancelledException is the request's answer, never a shard
        failure."""
        rescore = _rescore_specs(body)
        terminate_after = body.get("terminate_after")
        # repeats of the same query JSON reuse their bound plans
        cache_key = (json.dumps([body.get("query"), body.get("post_filter")],
                                sort_keys=True, default=str)
                     if scroll_ctx is None and body.get("slice") is None
                     else None)
        aggs = bool(body.get("aggs", body.get("aggregations")))
        results = []
        failures: List[Dict[str, Any]] = []
        first_failure: Optional[BaseException] = None
        shard_ords: Dict[str, int] = {}
        for shard_idx, (index, searcher) in enumerate(searchers):
            shard_ord = shard_ords.get(index, 0)
            shard_ords[index] = shard_ord + 1
            # cooperative cancellation between shard executions
            _prof.checkpoint("query")
            scope = (profiles.shard(f"[{index}][{shard_idx}]")
                     if profiles is not None else contextlib.nullcontext())
            # parented to the REST root span through the ambient context
            shard_span = self.span(f"shard[{index}][{shard_ord}]",
                                   {"phase": "query", "outcome": "ok"})
            try:
                with scope:
                    result = searcher.query_phase(
                        query, query_k, post_filter,
                        min_score=body.get("min_score"),
                        sort=body.get("sort"),
                        search_after=body.get("search_after"),
                        track_total_hits=(False if continuing
                                          else track_total),
                        cache_key=cache_key,
                        collect_masks=aggs and not continuing,
                        allow_plan=scroll_ctx is None,
                        after_key=(scroll_ctx.cursors.get(shard_idx)
                                   if continuing else None))
                    if terminate_after:
                        # the shard stops collecting after
                        # terminate_after docs
                        result.docs = result.docs[:int(terminate_after)]
                    if rescore:
                        result.docs = searcher.rescore(result.docs, rescore)
            except TaskCancelledException:
                if shard_span is not None:
                    shard_span.finish(outcome="cancelled")
                raise
            except Exception as e:  # the per-shard failure barrier
                if shard_span is not None:
                    shard_span.tag("outcome", "failed")
                    shard_span.tag("error_type", error_type_of(e))
                if first_failure is None:
                    first_failure = e
                failures.append({
                    "shard": shard_ord, "index": index, "node": None,
                    "reason": {"type": error_type_of(e), "reason": str(e),
                               "phase": "query"}})
                result = QueryResult([], 0, None)
            if shard_span is not None:
                shard_span.finish()
            results.append((index, searcher, result))
        if failures:
            if len(failures) == len(results):
                raise first_failure
            if not _allow_partial(body):
                raise SearchPhaseExecutionException(
                    "query", f"{len(failures)} of {len(results)} shards "
                    f"failed and [allow_partial_search_results] is false",
                    failures)
        return results, failures

    def _mesh_query(self, searchers, body: Dict[str, Any], query,
                    post_filter, k: int,
                    profiles: Optional[_ShardProfiles]):
        """The mesh step before the shard loop (the reference's): a body
        of several shards of one index with nothing the mesh cannot
        serve (no post_filter, sort, min_score, search_after, aggs,
        rescore, collapse or terminate_after) goes to
        ``MeshSearchBackend.execute``. Returns (merged docs in the
        loop's ``_merge_shards`` form, total) or None, and the loop
        serves (as it does a scroll's pages and a sliced body). A profiled body that the mesh serves gets one entry,
        ``[index][_mesh]``. A mesh that raises counts
        ``fallback.error``, logs a warning and leaves the body to the
        loop, as the reference's; chip_smoke.py fails a run that counts
        one, so a device fault cannot hide behind the loop."""
        if (not _mesh_shaped(searchers) or post_filter is not None
                or any(body.get(key) is not None for key in (
                    "sort", "min_score", "search_after", "rescore",
                    "collapse", "terminate_after", "slice"))
                or body.get("aggs", body.get("aggregations"))):
            return None
        index = searchers[0][0]
        t0 = time.monotonic_ns()
        scope = (_prof.profiling() if profiles is not None
                 else contextlib.nullcontext({}))
        try:
            with scope as rec:
                served = self.mesh_executor.execute(
                    [s for _, s in searchers], query, k)
        except TaskCancelledException:     # the request's answer
            raise
        except Exception:  # the mesh is an optimization: the loop serves
            logger.warning("mesh serving failed; the per-shard loop "
                           "answers", exc_info=True)
            self.mesh_executor._fallback("error")
            return None
        if served is None:
            return None
        if profiles is not None:
            profiles.shards.append((f"[{index}][_mesh]", rec,
                                    time.monotonic_ns() - t0))
        docs, total = served
        merged = [(score, shard_idx,
                   DocAddress(seg_idx, docid, score, (), sort_key=score),
                   searchers[shard_idx][1], index)
                  for shard_idx, seg_idx, docid, score in docs]
        return merged, total

    def _execute_query(self, searchers, body: Dict[str, Any], query,
                       post_filter, nodes, track_total, size: int,
                       from_: int, profiles: Optional[_ShardProfiles],
                       scroll_ctx: Optional[ScrollContext] = None,
                       continuing: bool = False):
        sort = body.get("sort")
        search_after = body.get("search_after")
        if search_after is not None and not isinstance(search_after, list):
            raise IllegalArgumentException(
                "[search_after] must be an array of sort values")
        rescore = _rescore_specs(body)
        aggs_spec = body.get("aggs", body.get("aggregations"))
        collapse_field = (body.get("collapse") or {}).get("field")
        terminate_after = body.get("terminate_after")
        # a scroll's page is the next ``size`` docs; a rescorer's window
        # may exceed the page
        k = size if scroll_ctx is not None else from_ + size
        query_k = max([k] + [int(r.get("window_size", 10))
                             for r in rescore])
        if collapse_field:
            # over-collect so that enough groups survive the collapse
            query_k = max(query_k, k * 5)
        served = (self._mesh_query(searchers, body, query, post_filter,
                                   k, profiles)
                  if scroll_ctx is None else None)
        if served is None:
            results, failures = self._query_shards(
                searchers, body, query, post_filter, track_total, query_k,
                profiles, scroll_ctx, continuing)
        else:
            results, failures = [], []
        # between the phases: a search cancelled after its query phase
        # runs no merge, fetch or aggregation
        _prof.checkpoint("fetch")
        t0 = time.monotonic_ns()
        merged = (_merge_shards(results, sort) if served is None
                  else served[0])
        if collapse_field:
            # the first hit of each key; docs without one share a group
            seen = set()
            kept = []
            for entry in merged:
                key = _doc_field_value(entry[3], entry[2], collapse_field)
                if key not in seen:
                    seen.add(key)
                    kept.append(entry)
            merged = kept
        if scroll_ctx is None:
            page = merged[from_:from_ + size]
        else:
            page = merged[:size]
            for key, shard_idx, d, _, _ in page:
                # the primary sort value rides along: a keyword key is a
                # segment-local ordinal, so the next page ranks the term
                scroll_ctx.cursors[shard_idx] = (
                    key, d.segment_idx, d.docid,
                    d.sort_values[0] if d.sort_values else None)
        if profiles is not None:
            profiles.merge_ns = time.monotonic_ns() - t0
        hits = self._fetch(page, body, query, collapse_field, profiles)
        # query-computed decorations: inner_hits, percolator slots
        for node in nodes:
            if hasattr(node, "add_hit_fields"):
                for h in hits:
                    node.add_hit_fields(h)
        if served is None:
            total = sum(r.total_hits for _, _, r in results)
            scores = [r.max_score for _, _, r in results
                      if r.max_score is not None]
            relation = ("gte" if any(r.total_lower_bound
                                     for _, _, r in results) else "eq")
        else:
            # merged on the device: its total is exact
            total = served[1] if track_total else 0
            scores = [merged[0][0]] if merged else []
            relation = "eq"
        if scroll_ctx is not None:
            if continuing:
                total = scroll_ctx.total_hits
            else:
                scroll_ctx.total_hits = total
        if not isinstance(track_total, bool) and total > track_total:
            total, relation = track_total, "gte"
        terminated_early = None
        if terminate_after:
            # each shard reports at most terminate_after docs
            ta = int(terminate_after)
            terminated_early = any(r.total_hits > ta for _, _, r in results)
            if terminated_early:
                total = sum(min(r.total_hits, ta) for _, _, r in results)
                relation = "gte"
        shards = {"total": len(searchers),
                  "successful": len(searchers) - len(failures),
                  "skipped": 0, "failed": len(failures)}
        if failures:
            shards["failures"] = failures
        response = {
            "timed_out": False,
            "_shards": shards,
            "hits": {"total": {"value": total, "relation": relation},
                     "max_score": max(scores) if scores else None,
                     "hits": hits},
        }
        if track_total is False:
            # ES omits hits.total when tracking is disabled
            del response["hits"]["total"]
        if terminated_early is not None:
            response["terminated_early"] = terminated_early
        if aggs_spec and searchers and not continuing:
            _prof.checkpoint("aggs")
            response["aggregations"] = self._aggregate(aggs_spec, results,
                                                       profiles)
        if body.get("suggest"):
            response["suggest"] = compute_suggest(body["suggest"], searchers)
        if profiles is not None:
            response["profile"] = profiles.section()
        return response

    def _fetch(self, page, body: Dict[str, Any], query, collapse_field,
               profiles: Optional[_ShardProfiles]) -> List[Dict[str, Any]]:
        """The fetch phase of the page: each shard fetches its own hits
        in one call, and the hits come back in page order."""
        by_shard: Dict[int, List[Tuple[int, DocAddress]]] = {}
        shard_of: Dict[int, Tuple[str, ShardSearcher]] = {}
        for pos, (_, shard_idx, d, searcher, index) in enumerate(page):
            by_shard.setdefault(shard_idx, []).append((pos, d))
            shard_of[shard_idx] = (index, searcher)
        docvalue_fields = [f if isinstance(f, str) else f.get("field")
                           for f in body.get("docvalue_fields", [])]
        hits: Dict[int, Dict[str, Any]] = {}
        fetch_span = (self.span("fetch", {"shards": len(by_shard)})
                      if by_shard else None)
        try:
            self._fetch_shards(by_shard, shard_of, body, query,
                               collapse_field, profiles, docvalue_fields,
                               hits)
        finally:
            if fetch_span is not None:
                fetch_span.finish()
        return [hits[i] for i in sorted(hits)]

    def _fetch_shards(self, by_shard, shard_of, body: Dict[str, Any], query,
                      collapse_field, profiles: Optional[_ShardProfiles],
                      docvalue_fields, hits: Dict[int, Dict[str, Any]]
                      ) -> None:
        """Each shard's fetch of its hits, filed in ``hits`` by page
        position."""
        for shard_idx, entries in by_shard.items():
            index, searcher = shard_of[shard_idx]
            docs = [d for _, d in entries]
            t0 = time.monotonic_ns()
            fetched = searcher.fetch_phase(
                docs, source_filter=body.get("_source", True),
                docvalue_fields=docvalue_fields,
                highlight=body.get("highlight"), highlight_query=query,
                script_fields=body.get("script_fields"),
                fields=body.get("fields"), version=body.get("version"),
                seq_no_primary_term=body.get("seq_no_primary_term"))
            if profiles is not None:
                profiles.fetch_ns[shard_idx] = time.monotonic_ns() - t0
            for (pos, d), h in zip(entries, fetched):
                h["_index"] = index
                if collapse_field:
                    h.setdefault("fields", {})[collapse_field] = [
                        _doc_field_value(searcher, d, collapse_field)]
                hits[pos] = h

    def _aggregate(self, aggs_spec, results,
                   profiles: Optional[_ShardProfiles]) -> Dict[str, Any]:
        """The aggregations over every shard's segments and match masks,
        each segment with its own index's mapper, in one pass (the
        reference's single-node reduce)."""
        ctx = [(seg, mask, searcher.mapper)
               for _, searcher, result in results
               for seg, mask in (result.agg_masks or [])]
        first = results[0][1]
        if profiles is None:
            return compute_aggs(aggs_spec, ctx, first.mapper, first.cache)
        t0 = time.monotonic_ns()
        with _prof.profiling() as rec:
            out = compute_aggs(aggs_spec, ctx, first.mapper, first.cache)
        profiles.aggs = (rec, time.monotonic_ns() - t0)
        return out

    # ---------------------------------------------------------------- kNN
    def _pure_knn_search(self, searchers, body: Dict[str, Any],
                         profiles: Optional[_ShardProfiles]
                         ) -> Optional[Dict[str, Any]]:
        """A pure top-level kNN body (one section, no query, ids and
        scores only) through the batched cohort launch, shard by shard:
        the response without ``took``, or None, and the caller takes the
        dense executor, which serves everything."""
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
        hits = self._knn_branch_hits(searchers, spec, window, profiles)
        if hits is None:
            return None
        seg = searchers[0][1].segments[0]
        vv = seg.vectors.get(spec.get("field"))
        # the version before the mask: a delete between the two reads is
        # counted again at the next request, never kept
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

    def _knn_branch_hits(self, searchers, spec: Dict[str, Any], window: int,
                         profiles: Optional[_ShardProfiles] = None
                         ) -> Optional[List[Dict[str, Any]]]:
        """A kNN branch (a knn clause) through the KnnBatcher: concurrent
        requests share the shard's product and top-k launch. Its first
        ``window`` hit dicts (``_index``, ``_id``, ``_score``), or None
        where the reference does not batch it (several shards, a shard
        of several segments, a filter, no such vector field, a cut
        beyond the largest bucket): the dense executor serves it."""
        if spec.get("filter") is not None or len(searchers) != 1:
            return None
        index, searcher = searchers[0]
        if len(searcher.segments) != 1:
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
            # quantized slab: nominate the full num_candidates before the
            # exact re-rank, then trim to the window
            cut = max(cut, min(int(nc or 3 * (k or 1000)),
                               ctx.n_docs_padded))
        if cut > _CUT_BUCKETS[-1]:
            return None
        scope = (profiles.shard(f"[{index}][0]") if profiles is not None
                 else contextlib.nullcontext())
        with scope:
            _prof.note("collector", "KnnBatchTopDocsCollector")
            with _prof.span("launch"):
                scores, ids = self.knn_batcher.topk(ctx, field, qvec, cut)
        seg = ctx.segment
        return [{"_index": index, "_id": seg.stored.ids[int(i)],
                 "_score": float(s)}
                for s, i in zip(scores[:window], ids[:window])
                if 0 <= i < seg.n_docs and np.isfinite(s)]

    def _rrf_search(self, searchers, body: Dict[str, Any]) -> Dict[str, Any]:
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
                hits = self._knn_branch_hits(searchers, br["query"]["knn"],
                                             window)
            if hits is None:
                sub = {**passthrough, **br, "size": window}
                if bi == 0:
                    # the aggregations compute once, over the first
                    # (query) branch
                    for agg_key in ("aggs", "aggregations"):
                        if agg_key in body:
                            sub[agg_key] = body[agg_key]
                r = self._execute(searchers, sub)
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
            "_shards": {"total": len(searchers),
                        "successful": len(searchers), "skipped": 0,
                        "failed": 0},
            "hits": {"total": {"value": len(scores),
                               "relation": "gte" if truncated else "eq"},
                     "max_score": hits[0]["_score"] if hits else None,
                     "hits": hits},
        }
        if aggregations is not None:
            out["aggregations"] = aggregations
        return out


@contextlib.contextmanager
def _task_scope(task):
    """The search's cancellation poll and stage hook (search/profile.py):
    every ``profile.span`` entry (the device-launch boundaries) and
    every ``checkpoint`` (before each shard, between the phases) polls
    ``task.ensure_not_cancelled`` and publishes its stage to the task
    (``GET /_tasks?detailed=true``), so a cancelled search stops
    launching between the launches of a multi-segment scan, not only
    between shards. No task: nothing is installed."""
    if task is None:
        yield
        return
    check = getattr(task, "ensure_not_cancelled", None)
    with _prof.cancellable(check), _prof.stage_hook(task.enter_stage):
        _prof.checkpoint("parse")
        yield


def _mesh_shaped(searchers) -> bool:
    """Several shards of one index: what the mesh step looks at."""
    return len(searchers) > 1 and len({n for n, _ in searchers}) == 1


def _merge_shards(results, sort) -> List[Tuple[float, int, DocAddress,
                                               ShardSearcher, str]]:
    """Every shard's docs as (key, shard, doc, searcher, index), in the
    page's order: under a sort by the docs' real sort values
    (``_host_sort_cmp``: float64 doc values, keyword terms, missing
    last), then shard order, since a keyword's device key is a
    shard-local ordinal; else by (-score, shard, segment, docid)."""
    merged = [(d.sort_key, shard_idx, d, searcher, index)
              for shard_idx, (index, searcher, result) in enumerate(results)
              for d in result.docs]
    sort_spec = _parse_sort(sort)
    if sort_spec is not None and any(e[2].sort_values for e in merged):
        def cmp(a, b):
            c = _host_sort_cmp(a[2], b[2], sort_spec)
            return c if c else (a[1] > b[1]) - (a[1] < b[1])
        merged.sort(key=functools.cmp_to_key(cmp))
    elif len(results) > 1:
        merged.sort(key=lambda e: (-e[0], e[1], e[2].segment_idx,
                                   e[2].docid))
    return merged


def resumable_scroll_batches(search_service, expression: str,
                             body: Dict[str, Any], batch_size: int,
                             keep_alive: str = "5m", on_resume=None,
                             task=None):
    """Every hit of ``expression`` in batches of ``batch_size`` through
    a scroll that survives a lost context (the reference's): a
    ``search_context_missing_exception`` mid-drain re-opens the scroll,
    at ``search_after`` = the last hit's sort values under a ``sort``,
    else from the top skipping what was handed out (exact against an
    unchanged index). ``on_resume`` is called at each recovery; every
    page polls ``task`` (``search``)."""
    base = dict(body or {})
    base["size"] = int(batch_size)
    has_sort = bool(base.get("sort"))
    emitted = 0
    last_sort = None
    skip = 0

    def reopen():
        b = dict(base)
        if has_sort and last_sort is not None:
            b["search_after"] = list(last_sort)
        return search_service.search(expression, b, scroll=keep_alive,
                                     task=task)

    r = search_service.search(expression, dict(base), scroll=keep_alive,
                              task=task)
    scroll_id = r.get("_scroll_id")
    try:
        while True:
            raw_hits = r["hits"]["hits"]
            hits = raw_hits
            if skip:
                drop = min(skip, len(hits))
                hits = hits[drop:]
                skip -= drop
            if hits:
                emitted += len(hits)
                if hits[-1].get("sort") is not None:
                    last_sort = hits[-1]["sort"]
                yield hits
            if not raw_hits:
                return
            try:
                r = search_service.scroll(scroll_id, keep_alive, task)
                scroll_id = r.get("_scroll_id", scroll_id)
            except SearchContextMissingException:
                if on_resume is not None:
                    on_resume()
                skip = 0 if has_sort and last_sort is not None else emitted
                r = reopen()
                scroll_id = r.get("_scroll_id")
    finally:
        if scroll_id:
            search_service.clear_scroll([scroll_id])
