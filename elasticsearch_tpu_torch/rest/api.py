"""REST routes of the port (counterpart of elasticsearch_tpu/rest/api.py,
reduced to the routes ported so far):

    GET  /
    PUT  /{index}                 {"settings": {"index": {"number_of_shards": N}}}
    GET|DELETE /{index}           ({index} may be an index expression)
    GET|PUT /{index}/_mapping     GET|PUT /{index}/_settings
    GET  /{index}/_stats          docs, segments, translog, seq_no
    PUT|POST /{index}/_doc/{id}   POST /{index}/_doc (an id is made)
    PUT|POST /{index}/_create/{id}
    GET  /{index}/_doc/{id}       GET /{index}/_source/{id}
    DELETE /{index}/_doc/{id}
    POST /{index}/_update/{id}    {"doc": ...} | {"script": ...}, "upsert"
    GET|POST /_mget, /{index}/_mget
    POST|PUT /_bulk, /{index}/_bulk  index, create, update, delete items
    POST /{index}/_refresh        POST /{index}/_flush
    POST /{index}/_forcemerge     ?max_num_segments=n
    POST|GET /{index}/_search     {"query": ..., "size": k, "from": n, ...}
    POST|GET /_search             every index
    POST|GET /_search/scroll      DELETE /_search/scroll
    POST /{index}/_pit            DELETE /_pit
    GET|POST /{index}/_count      GET|POST /{index}/_explain/{id}
    POST /_msearch, /{index}/_msearch
    PUT|POST|GET|DELETE /_scripts/{id}
    POST /_aliases                GET /_alias[/{name}], /{index}/_alias[/{name}]
    PUT|POST|DELETE /{index}/_alias/{name}   (and /_aliases/{name})
    PUT|POST|GET|DELETE /_index_template[/{name}], /_component_template[/{name}]
    PUT|GET|DELETE /_data_stream[/{name}]
    POST /{index}/_rollover[/{new_index}]    ?dry_run
    PUT|POST /{index}/_shrink/{target}, _split/{target}, _clone/{target}
    POST /{index}/_close          POST /{index}/_open
    PUT  /{index}/_block/{block}  write, read, read_only, metadata
    GET|POST /_analyze, /{index}/_analyze
    GET|POST /{index}/_termvectors/{id}   GET|POST /{index}/_mtermvectors
    POST /_reindex                POST /{index}/_update_by_query
    POST /{index}/_delete_by_query        ?wait_for_completion=false
    POST /_reindex|_update_by_query|_delete_by_query/{task_id}/_rethrottle
    GET  /_tasks                  ?actions, detailed, parent_task_id, group_by
    GET  /_tasks/{id}             POST /_tasks/{id}/_cancel, /_tasks/_cancel
    GET  /_cat/tasks              GET /_nodes/hot_threads
    POST /_async_search, /{index}/_async_search
    GET|DELETE /_async_search/{id}
    GET|POST /_render/template[/{id}]
    GET|POST /_search/template, /{index}/_search/template
    POST /_msearch/template, /{index}/_msearch/template
    GET|POST /{index}/_rank_eval
    GET|POST /_field_caps, /{index}/_field_caps
    GET|POST /{index}/_validate/query     GET|POST /{index}/_terms_enum
    GET  /_resolve/index/{expression}
    GET  /_cat/indices, count, shards, aliases, templates, segments
    GET  /_stats                  every index's stats, the docs of all
    GET  /_kernels                the launch tracker's table
    GET  /_nodes/stats            indices, breakers, pressure, engine, tasks,
                                  telemetry (?history=true), recoveries
    GET  /_flight_recorder        the launch/readback ring, filtered
    GET  /_flight_recorder/waterfall/{trace_id}
    GET  /_traces                 ?size, from, exemplar_for=<histogram>
    GET  /_traces/{trace_id}
    GET  /_tenants/stats, /_workload/stats, /_cat/tenants, /_cat/workload
    GET  /_cluster/health, /_health_report[/{indicator}], /_cat/health
    GET  /_cat/thread_pool        POST /{index}/_freeze, /{index}/_unfreeze
    GET  /_migration/deprecations
    /_snapshot, /_slm/policy, /_searchable_snapshots/stats, /_cat/snapshots,
    /_cat/repositories            (rest/operations.py)

``dispatch`` takes the request's headers: ``X-Opaque-Id``,
``X-Tenant-Id`` and ``X-Workload-Class`` become ambient for the
handler (telemetry/context.py). Each `_search` is rooted in a
``rest.search`` span and answers its trace id under ``_headers``
(``trace.id``), which the front sends as a response header; a search
is counted in the node's metrics and its tenant's and class's rows
(search/service.py ``accounted``), and a `_bulk` charges the ``bulk``
class unless the request named one.

A HEAD takes the GET route of its path and answers the GET's status
with no body.

`_analyze` runs a named analyzer, the analyzer of a ``field`` of the
named index, or an ad hoc chain (``analyze_answer``); `_termvectors`
analyzes a document's ``_source`` again with each text field's analyzer
(``termvectors_of``). `_reindex` (from a local source),
`_update_by_query` and `_delete_by_query` run through reindex/worker.py
as a cancellable task and answer its ``BulkByScrollResponse``; with
``wait_for_completion=false`` the job runs on a background thread and
answers ``{"task": "<node>:<id>"}``, its result kept for
``GET /_tasks/{id}`` (across a restart: the ``.tasks`` index), and
``_rethrottle`` changes its pace. A remote source needs the client of a
later slice: a typed 400.

Tasks (transport/tasks.py): `_search`, `_count` and a scroll page run as
a cancellable ``indices:data/read/search`` task (``_search_task``: its
own trace, its stage from ``parse`` on); `_msearch` is a cancellable
``indices:data/read/msearch`` parent whose bodies run as its children,
so its ban cancels every child that starts after its cancel. A
cancelled request answers 400 ``task_cancelled_exception``. The `_tasks`
routes answer the reference's shapes: a malformed id is a 400, another
node's id or a task that is not running (and stored no result) a 404.
`_async_search` (search/async_search.py) runs `_search` on a background
thread under its submit task. The search templates render through
search/template.py (a stored script's ``source`` by ``id``), then run as
`_search`; `_rank_eval` (search/rank_eval.py) searches each rated
request as `_search`. `_field_caps`, `_validate/query`, `_terms_enum`,
`_resolve/index`, `_cat` and `_stats` are the reference's handlers over
the port's indices; a `_cat` route answers ``{"_cat": text}``.

The document routes are the reference's handlers, with its bodies,
statuses and error types: a write answers ``_index``, ``_id``,
``_version``, ``result``, ``_shards``, ``_seq_no`` and ``_primary_term``
(201 when it created the document); ``refresh``, ``op_type``,
``if_seq_no``/``if_primary_term`` (a 409 ``version_conflict_engine_
exception`` when they do not match) and ``routing`` are read as the
reference reads them, and the first write to a missing index creates
it, with the matching index template (index/metadata.py). A write to
an alias or a data stream lands in its write index (``write_target``),
as the document reads, deletes and updates do; a closed index refuses
writes with a 403 ``cluster_block_exception`` and reads with a 400
``index_closed_exception``. A GET is realtime (index/engine.py); a
search sees a write only after ``_refresh``. ``_update`` deep-merges ``doc`` (``noop`` when
nothing changes, unless ``detect_noop`` is false), indexes ``upsert``
when the document is missing, or runs ``script`` over ``ctx._source``
(reindex/worker.py; ``ctx.op`` ``none`` or ``delete``). A `_bulk` charges
its raw bytes to the node's indexing pressure before it parses
(index/pressure.py: past the limit a retryable 429
``es_rejected_execution_exception``) and releases them when the answer
is decided; its items may name other indices, and each index or create
item answers its ``_version`` and ``_seq_no``. A ``pipeline`` parameter
(ingest) is a later slice: a typed 400.

``{index}`` of `_search`, `_refresh` and `_forcemerge` is an index
expression (a comma list of names and ``*``/``?`` patterns, or
``_all``; index/service.py ``IndicesService.resolve``): an unknown
concrete name answers 404 ``index_not_found_exception``. A `_bulk` item
routes to the shard of ``abs(murmur3(routing or _id)) % N``
(index/service.py ``shard_for``), its ``routing`` taken from the action
line, else the URL's ``routing``; `_refresh` and `_forcemerge` act on
every shard and count them in ``_shards``.

`_search` takes the URL parameters ``q``, ``from``, ``size``,
``request_cache``, ``allow_partial_search_results`` (merged into the
body as the reference merges them), ``search_type``
(``query_then_fetch`` or ``dfs_query_then_fetch``, else a 400) and
``scroll`` (a keep-alive: the search opens a scroll,
search/service.py); any other is a typed 400. A search, a `_count`,
an `_explain` and each `_msearch` body on a filtered alias get its
filter as a bool ``filter`` (``_apply_alias_filter``). `_msearch` runs
its bodies concurrently on the node's ``search`` pool (common/
threadpool.py), each answering in its own slot (an error as
``{"error", "status"}``); a search that targets only frozen indices
runs on the ``search_throttled`` pool, one at a time, and never takes
the fast path (the search service drops a frozen index's device state
after each search). A device admission the ``hbm`` breaker refuses
answers 429 ``circuit_breaking_exception`` with ``bytes_wanted`` and
``bytes_limit``; a search whose failed shards the body does not allow
(``allow_partial_search_results: false``) answers 503
``search_phase_execution_exception`` with ``failed_shards``.

`_search` answers an exact top-k and an exact total (relation "eq"),
unless the body's ``track_total_hits`` is false or a threshold (the plan
path may then prune and count a lower bound, relation "gte"). The fast
path (search/fastpath.py) takes the bodies of the C++ front's grammar on
an index of one shard and one segment, when one of its lanes serves the
query
(``FastPathServer.fits``: at most 16 terms, a block need within the
largest bucket, ``size`` <= 1000):

    {"query": {"match": {FIELD: TEXT | {"query": TEXT, "operator": "or"}}}}
    {"query": {"bool": {"must": MATCH | [MATCH],
                        "filter"?: MATCH1 | [MATCH1, ...up to 8]}}}

with only ``size``, ``from`` 0, ``_source`` true or false and
``track_total_hits`` true beside the query; FIELD is a text field whose
analyzer and search analyzer are the builtin standard one, and
each MATCH1 is a match on the same field whose text is one token.
Everything else goes to the plan path (search/service.py): other bool
shapes, term, terms, constant_score, multi_match, dis_max,
``post_filter``, ``from`` > 0, ``size`` up to 10000 and indices of
several segments, and the dense executor behind it: range, exists, ids,
match_all, boosting, term(s) on numbers, booleans and dates, ``sort``,
``search_after`` and ``min_score``; ``script_score`` (its expression
scripts ride the plan launch; vector functions, statement scripts and
``min_score`` take the dense executor), ``function_score`` and
``rescore``; ``script_fields`` and the ``aggs`` tree (every
aggregation type of the reference) are computed over the matched docs.
A script that fails to compile or run answers 400 ``script_exception``;
a script given by ``{"id": ...}`` reads the node's stored scripts
(``PUT /_scripts/{id}``). Top-level ``knn`` and ``rank.rrf``
(hybrid retrieval over ``dense_vector`` fields, which ``PUT /{index}``
maps and ``_bulk`` indexes) go to the search service too: the fast
grammar and the C++ front refuse both keys. What none serves is answered
with a typed 400, never on another device.

A body with ``pit`` or ``slice``, or a request with ``scroll``, never
takes the fast path: the PIT's pinned segments and the cursor belong to
the search service.

Behind the native front (rest/native_http.py) the hot bodies of its one
registered index, with ``_source: false``, never reach this module: C++
parses them and the fast path answers them. What reaches ``_search``
from there is what the C++ grammar refuses (``_source: true``, say),
which still takes the fast path here when it can, and what the drain
bounced back (a registration gone stale since C++ parsed it, or more
blocks than the largest bucket), which goes the same way: the fast
path when it fits, else the plan path.
"""

from __future__ import annotations

import contextlib
import copy
import fnmatch
import json
import logging
import os
import time
import uuid
from typing import Any, Optional, Tuple

from elasticsearch_tpu_torch.analysis.analyzers import (
    _CHAR_FILTERS, _TOKEN_FILTERS, _TOKENIZERS, AnalysisRegistry,
    CustomAnalyzer)
from elasticsearch_tpu_torch.common.errors import (
    CircuitBreakingException, DocumentMissingException,
    EsRejectedExecutionException, IllegalArgumentException,
    IndexNotFoundException, QueryShardException,
    ResourceAlreadyExistsException, ResourceNotFoundException,
    ScriptException, SearchPhaseExecutionException, SettingsException,
    WriteException, error_type_of)
from elasticsearch_tpu_torch.index.metadata import resize_index
from elasticsearch_tpu_torch.index.mapper import (MapperParsingException,
                                                  TextFieldType)
from elasticsearch_tpu_torch.index.service import INDEX_NAME
from elasticsearch_tpu_torch.index.translog import write_batch
from elasticsearch_tpu_torch.rest.operations import (OPS_ROOTS,
                                                     OperationsRoutes)
from elasticsearch_tpu_torch.reindex.worker import (
    _Ctx, compile_update_script, delete_by_query, reindex, update_by_query)
from elasticsearch_tpu_torch.search.fastpath import (MAX_FILTERS,
                                                     SliceUnsupported)
from elasticsearch_tpu_torch.search.context import ShardStats
from elasticsearch_tpu_torch.search.queries import (ParsingException,
                                                    parse_query)
from elasticsearch_tpu_torch.search.rank_eval import rank_eval
from elasticsearch_tpu_torch.search.service import SEARCH_TYPES
from elasticsearch_tpu_torch.search.template import render_template
from elasticsearch_tpu_torch.telemetry import context as _telectx
from elasticsearch_tpu_torch.telemetry import engine as _engine
from elasticsearch_tpu_torch.telemetry import flightrecorder as _flight
from elasticsearch_tpu_torch.telemetry.flightrecorder import build_waterfall
from elasticsearch_tpu_torch.telemetry.tenants import (merge_tenant_stats,
                                                       render_cat_tenants)
from elasticsearch_tpu_torch.telemetry.workload import (
    merge_workload_stats, render_cat_workload)
from elasticsearch_tpu_torch.transport.tasks import (
    EMPTY_TASK_ID, CancellableTask, TaskId, build_tasks_response,
    hot_threads_text, node_task_slice, parse_bool_param, render_cat_tasks)

logger = logging.getLogger("elasticsearch_tpu_torch.rest")

# the `_search` URL parameters this slice serves (``_merge_search_params``)
_SEARCH_PARAMS = ("q", "from", "size", "request_cache",
                  "allow_partial_search_results", "search_type", "scroll")


def _merge_search_params(body, params: dict) -> dict:
    """The body with the URL parameters of `_search` merged in, as the
    reference's ``_merge_search_params``: ``q`` becomes a ``match``
    (``field:value``) or a ``multi_match`` over every field when the
    body has no query; URL ``from``/``size`` override the body's;
    ``request_cache`` and ``allow_partial_search_results`` must be
    ``true`` or ``false`` and then go into the body (where the body keys
    the slice serves decide); ``search_type`` and ``scroll`` are the
    caller's. Any other parameter (``timeout``, ...) is a later slice: a
    typed 400."""
    extra = sorted(set(params) - set(_SEARCH_PARAMS))
    if extra:
        raise SliceUnsupported(
            f"_search URL parameters {extra} are a later slice of the port "
            f"(this one takes {list(_SEARCH_PARAMS)})")
    body = dict(body or {})
    if "q" in params and "query" not in body:
        q = params["q"]
        if ":" in q:
            field, _, value = q.partition(":")
            body["query"] = {"match": {field: value}}
        else:
            body["query"] = {"multi_match": {"query": q, "fields": ["*"]}}
    for key in ("from", "size"):
        if key in params:
            body[key] = int(params[key])
    for key in ("request_cache", "allow_partial_search_results"):
        if key in params:
            if params[key] not in ("true", "false"):
                raise IllegalArgumentException(
                    f"Failed to parse value [{params[key]}] as only [true] "
                    f"or [false] are allowed.")
            body[key] = params[key] == "true"
    return body


def _error(status: int, etype: str, reason: str, **extra):
    err = {"type": etype, "reason": reason, **extra}
    return status, {"error": {"root_cause": [err], **err}, "status": status}


# the typed failures a `_bulk` item answers in its own entry (the
# reference's ElasticsearchTpuException family)
_ITEM_ERRORS = (WriteException, IndexNotFoundException,
                CircuitBreakingException, SliceUnsupported,
                MapperParsingException, ParsingException,
                IllegalArgumentException, QueryShardException,
                ScriptException, SettingsException)


def _xcontent(e: BaseException) -> Tuple[int, dict]:
    """(status, error object) of a typed failure, as the reference's
    ``to_xcontent``: type, reason and the failure's metadata."""
    if isinstance(e, WriteException):
        return e.status, e.to_xcontent()
    err = {"type": error_type_of(e), "reason": str(e)}
    if isinstance(e, IndexNotFoundException):
        err["index"] = e.index
    if isinstance(e, CircuitBreakingException):
        err.update(bytes_wanted=e.bytes_wanted, bytes_limit=e.bytes_limit)
    return getattr(e, "status", 400), err


# the typed failures a route answers with their own status and body
_TYPED = (CircuitBreakingException, IndexNotFoundException, WriteException,
          SearchPhaseExecutionException, SliceUnsupported,
          MapperParsingException, ParsingException, IllegalArgumentException,
          QueryShardException, ScriptException, SettingsException)
# the node-level routes of the metadata (``RestController._meta_handler``)
_META_ROUTES = ("_aliases", "_alias", "_scripts", "_index_template",
                "_component_template", "_data_stream")
# the index routes of three parts: (part 2, part 3, method) -> handler
_INDEX_SUBROUTES = {
    ("_search", "template", "POST"): "_search_template",
    ("_search", "template", "GET"): "_search_template",
    ("_msearch", "template", "POST"): "_msearch_template",
    ("_validate", "query", "GET"): "_validate_query",
    ("_validate", "query", "POST"): "_validate_query",
}
# the URL parameters of `_async_search` itself (the rest are `_search`'s)
_ASYNC_PARAMS = ("wait_for_completion_timeout", "keep_alive",
                 "keep_on_completion")
# the request headers ``dispatch`` makes ambient (lower case)
_ATTRIBUTION_HEADERS = ("x-opaque-id", "x-tenant-id", "x-workload-class")
SEARCH_ACTION = "indices:data/read/search"
MSEARCH_ACTION = "indices:data/read/msearch"


def _typed_error(e: BaseException) -> Tuple[int, dict]:
    """(status, error object) of one of the ``_TYPED`` failures."""
    if isinstance(e, SearchPhaseExecutionException):
        return e.status, {"type": e.error_type, "reason": str(e),
                          "phase": e.phase_name, "grouped": True,
                          "failed_shards": e.shard_failures}
    if isinstance(e, (CircuitBreakingException, IndexNotFoundException,
                      WriteException)):
        return _xcontent(e)
    return 400, {"type": getattr(e, "error_type",
                                 "mapper_parsing_exception"),
                 "reason": str(e)}


def _ack(_=None):
    return 200, {"acknowledged": True}


def _write_response(index: str, result, word: str) -> dict:
    return {"_index": index, "_id": result.doc_id,
            "_version": result.version, "result": word,
            "_shards": {"total": 1, "successful": 1, "failed": 0},
            "_seq_no": result.seq_no,
            "_primary_term": result.primary_term}


def _deep_merge(base: dict, update: dict) -> dict:
    out = dict(base)
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _refreshes(params: dict, wait_for: bool = True) -> bool:
    """Whether a write's ``refresh`` parameter asks for a refresh (the
    reference's values; a delete or an update does not take
    ``wait_for``)."""
    return params.get("refresh") in (("true", "wait_for", "")
                                     if wait_for else ("true", ""))


def _no_pipeline(params: dict) -> None:
    if "pipeline" in params:
        raise SliceUnsupported("ingest pipelines are a later slice of the "
                               "port")


def analyze_answer(registry: AnalysisRegistry, body: dict,
                   mapper=None) -> dict:
    """The `_analyze` answer (the reference's ``_analyze``): ``text`` (a
    string or a list) through a named ``analyzer`` (``standard`` by
    default), the index analyzer of ``field`` when the request names an
    index (``mapper``) and no analyzer, or an ad hoc chain of
    ``tokenizer``, ``filter`` and ``char_filter``, each a name (the
    index's components first) or an inline definition; ``explain``
    answers each stage's output."""
    text = body.get("text", "")
    texts = text if isinstance(text, list) else [text]
    if "tokenizer" in body or "filter" in body or "char_filter" in body:
        def build(spec, reg, named, kind):
            if isinstance(spec, str):
                built = named.get(spec)
                if built is not None:
                    return built
                name, conf = spec, {}
            else:
                conf = dict(spec)
                name = conf.get("type")
            factory = reg.get(name)
            if factory is None:
                raise IllegalArgumentException(
                    f"failed to find global {kind} under [{name}]")
            return factory(conf)

        tok = build(body.get("tokenizer", "standard"), _TOKENIZERS,
                    registry.named_tokenizers, "tokenizer")
        filters = [build(f, _TOKEN_FILTERS, registry.named_filters,
                         "token filter") for f in body.get("filter", [])]
        char_filters = [build(f, _CHAR_FILTERS, registry.named_char_filters,
                              "char filter")
                        for f in body.get("char_filter", [])]
        analyzer = CustomAnalyzer("_adhoc_", tok, filters, char_filters)
    elif "analyzer" not in body and "field" in body and mapper is not None:
        analyzer = mapper.index_analyzer(mapper.field_type(body["field"]))
    else:
        analyzer = registry.get(body.get("analyzer", "standard"))

    def rows(toks):
        return [{"token": t.term, "start_offset": t.start_offset,
                 "end_offset": t.end_offset, "position": t.position,
                 "type": "<ALPHANUM>"} for t in toks]

    if body.get("explain") in (True, "true"):
        # each stage's output: the text after each char filter, the
        # tokenizer's tokens, then the tokens after each token filter
        staged = list(texts)
        charfilters = []
        for cf in analyzer.char_filters:
            staged = [cf.apply(x) for x in staged]
            charfilters.append({"name": cf.name,
                                "filtered_text": list(staged)})
        toks = [t for x in staged for t in analyzer.tokenizer.tokenize(x)]
        detail = {"custom_analyzer": True, "charfilters": charfilters,
                  "tokenizer": {"name": analyzer.tokenizer.name,
                                "tokens": rows(toks)},
                  "tokenfilters": []}
        for f in analyzer.token_filters:
            toks = f.filter(toks)
            detail["tokenfilters"].append({"name": f.name,
                                           "tokens": rows(toks)})
        return {"detail": detail}
    return {"tokens": [row for x in texts
                       for row in rows(analyzer.analyze(x))]}


def termvectors_of(node, index: str, doc_id: Optional[str], body: dict,
                   routing: Optional[str] = None) -> dict:
    """One document's term vectors (the reference's ``_termvectors_for``):
    each text field of its ``_source`` (``fields`` selects) analyzed with
    the field's analyzer, every term's ``term_freq`` and tokens
    (position, offsets; the values of an array 100 positions apart),
    ``doc_freq`` with ``term_statistics``, and the field's ``doc_count``,
    over every shard's segments; ``index`` may be an alias or a data
    stream, and ``routing`` finds the document's shard."""
    if doc_id is None:
        return {"_index": index, "_id": None, "found": False,
                "error": {"type": "illegal_argument_exception",
                          "reason": "[_id] is required"}}
    index = node.metadata_service.write_target(index)
    svc = node.indices.require(index)
    result = svc.get_doc(doc_id, body.get("routing", routing))
    if not result.found or result.source is None:
        return {"_index": index, "_id": doc_id, "found": False}
    source = result.source
    fields = body.get("fields")
    want_term_stats = bool(body.get("term_statistics", False))
    stats = ShardStats([seg for shard in svc.shards
                        for seg in shard.segments])
    analysis = svc.mapper.analysis
    tv = {}
    for fname, ft in svc.mapper.fields.items():
        if ft.type_name != "text" or (fields and fname not in fields):
            continue
        value = source.get(fname) if isinstance(source, dict) else None
        if value is None:
            continue
        # an analyzer the index lacks falls to the builtin standard one
        # here (the reference's choice), not to the index's default
        name = getattr(ft, "analyzer_name", "standard")
        analyzer = analysis.get(name if analysis.has(name) else "standard")
        terms = {}
        pos_base = 0
        for v in (value if isinstance(value, list) else [value]):
            max_pos = -1
            for tok in analyzer.analyze(str(v)):
                entry = terms.setdefault(tok.term, {"term_freq": 0,
                                                    "tokens": []})
                entry["term_freq"] += 1
                entry["tokens"].append({
                    "position": pos_base + tok.position,
                    "start_offset": tok.start_offset,
                    "end_offset": tok.end_offset})
                max_pos = max(max_pos, pos_base + tok.position)
            pos_base = max_pos + 100
        if want_term_stats:
            for term, entry in terms.items():
                entry["doc_freq"] = stats.doc_freq(fname, term)
        if terms:
            tv[fname] = {"field_statistics": {
                "doc_count": stats.field_stats(fname)[0]}, "terms": terms}
    return {"_index": index, "_id": doc_id, "found": True,
            "term_vectors": tv}


class RestController(OperationsRoutes):
    def __init__(self, node):
        self.node = node

    def dispatch(self, method: str, path: str, params: Optional[dict] = None,
                 body: Any = None, headers: Optional[dict] = None
                 ) -> Tuple[int, Any]:
        """(status, body) of one request. A HEAD takes the GET route and
        answers its status with no body (the reference's router; the
        existence checks of Elasticsearch's clients). ``headers`` (the
        HTTP request's, any case): ``X-Opaque-Id``, ``X-Tenant-Id`` and
        ``X-Workload-Class`` become ambient for the handler
        (telemetry/context.py), so its tasks, slowlog entries, batcher
        slots, flight events and search records are attributed to
        them."""
        if method == "HEAD":
            status, _ = self.dispatch("GET", path, params, body, headers)
            return status, None
        params = params or {}
        parts = [p for p in path.split("/") if p]
        tags = {k.lower(): str(v) for k, v in (headers or {}).items()
                if k.lower() in _ATTRIBUTION_HEADERS}
        try:
            # every launch and readback under this request lands in the
            # node's flight recorder
            with contextlib.ExitStack() as stack:
                if tags.get("x-opaque-id"):
                    stack.enter_context(
                        _telectx.activate_opaque(tags["x-opaque-id"]))
                if tags.get("x-tenant-id"):
                    stack.enter_context(
                        _telectx.activate_tenant(tags["x-tenant-id"]))
                if tags.get("x-workload-class"):
                    stack.enter_context(_telectx.activate_workload_class(
                        tags["x-workload-class"]))
                stack.enter_context(_flight.activate(self.node.flight))
                return self._route(method, path, parts, params, body)
        except _TYPED as e:
            status, err = _typed_error(e)
            return status, {"error": {"root_cause": [err], **err},
                            "status": status}
        except Exception as e:  # the boundary: report, keep serving
            logger.exception("request failed: %s %s", method, path)
            return _error(500, "exception", f"{type(e).__name__}: {e}")

    def _route(self, method: str, path: str, parts, params: dict, body):
        n = len(parts)
        if not parts:
            if method == "GET":
                return 200, self.node.info()
        elif method == "GET" and parts == ["_kernels"]:
            return self._kernels()
        elif method == "GET" and parts == ["_nodes", "stats"]:
            return self._nodes_stats(params)
        elif method == "GET" and parts == ["_flight_recorder"]:
            return self._flight_recorder(params)
        elif (method == "GET" and n == 3
              and parts[:2] == ["_flight_recorder", "waterfall"]):
            return self._flight_waterfall(parts[2])
        elif method == "GET" and parts == ["_traces"]:
            return self._traces(params)
        elif method == "GET" and parts[0] == "_traces" and n == 2:
            return self._trace(parts[1])
        elif method == "GET" and parts == ["_tenants", "stats"]:
            return 200, self._tenants_stats()
        elif method == "GET" and parts == ["_workload", "stats"]:
            return 200, self._workload_stats()
        elif method == "GET" and parts == ["_nodes", "hot_threads"]:
            return self._hot_threads(params)
        elif method == "GET" and parts == ["_stats"]:
            return self._all_stats()
        elif parts[0] == "_tasks":
            handler = self._task_handler(method, parts, params)
            if handler is not None:
                return handler()
        elif parts[0] == "_cat" and n == 2 and method == "GET":
            handler = self._CAT.get(parts[1])
            if handler is not None:
                return 200, {"_cat": handler(self, params)}
        elif parts[:2] == ["_cat", "snapshots"] and n == 3 \
                and method == "GET":
            return 200, {"_cat": self._cat_snapshots(parts[2])}
        elif parts[0] in OPS_ROOTS:
            handler = self._ops_handler(method, parts, params, body)
            if handler is not None:
                return handler()
        elif parts == ["_async_search"] and method == "POST":
            return self._submit_async_search("_all", params, body)
        elif parts[0] == "_async_search" and n == 2:
            if method == "GET":
                r = self.node.async_search_service.get(parts[1], params)
                return r.pop("_http_status", 200), r
            if method == "DELETE":
                self.node.async_search_service.delete(parts[1])
                return 200, {"acknowledged": True}
        elif parts[:2] == ["_render", "template"] and n <= 3 \
                and method in ("POST", "GET"):
            return self._render_template(parts[2] if n == 3 else None, body)
        elif parts == ["_field_caps"] and method in ("POST", "GET"):
            return self._field_caps("_all", params, body)
        elif parts[:2] == ["_resolve", "index"] and n == 3 \
                and method == "GET":
            return self._resolve_index(parts[2])
        elif parts == ["_search"] and method in ("POST", "GET"):
            return self._search_route("_all", params, body)
        elif parts == ["_search", "template"] and method in ("POST", "GET"):
            return self._search_template("_all", params, body)
        elif parts == ["_search", "scroll"]:
            if method in ("POST", "GET"):
                return self._scroll(params, body)
            if method == "DELETE":
                return self._clear_scroll(params, body)
        elif parts == ["_msearch"] and method in ("POST", "GET"):
            return self._msearch(None, params, body)
        elif parts == ["_msearch", "template"] and method == "POST":
            return self._msearch_template(None, params, body)
        elif parts == ["_pit"] and method == "DELETE":
            return self._close_pit(params, body)
        elif parts == ["_bulk"] and method in ("POST", "PUT"):
            return self._bulk(None, params, body)
        elif parts == ["_mget"] and method in ("POST", "GET"):
            return self._mget(None, params, body)
        elif parts == ["_analyze"] and method in ("POST", "GET"):
            return 200, analyze_answer(AnalysisRegistry(), body or {})
        elif parts == ["_reindex"] and method == "POST":
            return self._bulk_by_scroll(
                params, "indices:data/write/reindex",
                lambda task: reindex(self.node, body, params, task))
        elif (n == 3 and parts[0] in ("_reindex", "_update_by_query",
                                      "_delete_by_query")
              and parts[2] == "_rethrottle" and method == "POST"):
            return self._rethrottle(parts[1], params)
        elif parts[0] in _META_ROUTES:
            handler = self._meta_handler(method, parts, body)
            if handler is not None:
                return handler()
        elif parts[0].startswith("_") and parts[0] != "_all":
            pass
        elif n == 3 and (parts[1], parts[2], method) in _INDEX_SUBROUTES:
            return getattr(self, _INDEX_SUBROUTES[
                (parts[1], parts[2], method)])(parts[0], params, body)
        elif n == 1:
            handler = {"PUT": self._create_index, "GET": self._get_index,
                       "DELETE": self._delete_index}.get(method)
            if handler is not None:
                return handler(parts[0], params, body)
        elif n == 2:
            index, action = parts
            handler = {
                ("_bulk", "POST"): self._bulk, ("_bulk", "PUT"): self._bulk,
                ("_refresh", "POST"): self._refresh,
                ("_refresh", "GET"): self._refresh,
                ("_flush", "POST"): self._flush,
                ("_forcemerge", "POST"): self._forcemerge,
                ("_search", "POST"): self._search_route,
                ("_search", "GET"): self._search_route,
                ("_async_search", "POST"): self._submit_async_search,
                ("_field_caps", "GET"): self._field_caps,
                ("_field_caps", "POST"): self._field_caps,
                ("_terms_enum", "GET"): self._terms_enum,
                ("_terms_enum", "POST"): self._terms_enum,
                ("_rank_eval", "GET"): self._rank_eval,
                ("_rank_eval", "POST"): self._rank_eval,
                ("_count", "POST"): self._count,
                ("_count", "GET"): self._count,
                ("_msearch", "POST"): self._msearch,
                ("_msearch", "GET"): self._msearch,
                ("_pit", "POST"): self._open_pit,
                ("_mget", "POST"): self._mget, ("_mget", "GET"): self._mget,
                ("_mapping", "GET"): self._get_mapping,
                ("_mapping", "PUT"): self._put_mapping,
                ("_settings", "GET"): self._get_settings,
                ("_settings", "PUT"): self._put_settings,
                ("_stats", "GET"): self._index_stats,
                ("_doc", "POST"): self._index_auto_id,
                ("_alias", "GET"): self._get_index_alias,
                ("_rollover", "POST"): self._rollover,
                ("_close", "POST"): self._close,
                ("_open", "POST"): self._open,
                ("_freeze", "POST"): self._freeze,
                ("_unfreeze", "POST"): self._unfreeze,
                ("_analyze", "GET"): self._analyze,
                ("_analyze", "POST"): self._analyze,
                ("_mtermvectors", "GET"): self._mtermvectors,
                ("_mtermvectors", "POST"): self._mtermvectors,
                ("_update_by_query", "POST"): self._update_by_query,
                ("_delete_by_query", "POST"): self._delete_by_query,
            }.get((action, method))
            if handler is not None:
                return handler(index, params, body)
        elif n == 3:
            index, action, doc_id = parts
            handler = {
                ("_doc", "PUT"): self._index_doc,
                ("_doc", "POST"): self._index_doc,
                ("_create", "PUT"): self._create_doc,
                ("_create", "POST"): self._create_doc,
                ("_doc", "GET"): self._get_doc,
                ("_source", "GET"): self._get_source,
                ("_doc", "DELETE"): self._delete_doc,
                ("_update", "POST"): self._update_doc,
                ("_explain", "GET"): self._explain,
                ("_explain", "POST"): self._explain,
                ("_termvectors", "GET"): self._termvectors,
                ("_termvectors", "POST"): self._termvectors,
                ("_alias", "PUT"): self._put_alias,
                ("_alias", "POST"): self._put_alias,
                ("_aliases", "PUT"): self._put_alias,
                ("_alias", "DELETE"): self._delete_alias,
                ("_aliases", "DELETE"): self._delete_alias,
                ("_alias", "GET"): self._get_index_alias,
                ("_block", "PUT"): self._add_block,
                ("_rollover", "POST"): self._rollover,
                ("_shrink", "PUT"): self._shrink,
                ("_shrink", "POST"): self._shrink,
                ("_split", "PUT"): self._split,
                ("_split", "POST"): self._split,
                ("_clone", "PUT"): self._clone,
                ("_clone", "POST"): self._clone,
            }.get((action, method))
            if handler is not None:
                return handler(index, doc_id, params, body)
        return _error(400, "unsupported_in_slice_exception",
                      f"{method} {path} is not a route of this slice of "
                      f"the port")

    def _meta_handler(self, method: str, parts, body):
        """The handler of a node-level metadata route (``_aliases``,
        ``_alias``, ``_scripts``, ``_index_template``,
        ``_component_template``, ``_data_stream``), or None."""
        md = self.node.metadata_service
        root, rest = parts[0], parts[1:]
        name = rest[0] if len(rest) == 1 else None
        if len(rest) > 1:
            return None
        if root == "_aliases" and method == "POST" and name is None:
            return lambda: self._update_aliases(body)
        if root == "_alias" and method == "GET":
            return lambda: self._alias_answer(None, name)
        if root == "_scripts" and name is not None:
            return {"PUT": lambda: self._put_script(name, body),
                    "POST": lambda: self._put_script(name, body),
                    "GET": lambda: self._get_script(name),
                    "DELETE": lambda: self._delete_script(name)}.get(method)
        if root in ("_index_template", "_component_template"):
            key = root[1:]
            store = (md.index_templates if key == "index_template"
                     else md.component_templates)
            put = (md.put_index_template if key == "index_template"
                   else md.put_component_template)
            drop = (md.delete_index_template if key == "index_template"
                    else md.delete_component_template)
            if method == "GET":
                return lambda: self._get_templates(key, store, name)
            if name is not None and method in ("PUT", "POST"):
                return lambda: _ack(put(name, body or {}))
            if name is not None and method == "DELETE":
                return lambda: _ack(drop(name))
        if root == "_data_stream":
            if method == "GET":
                return lambda: (200, {"data_streams":
                                      md.get_data_streams(name)})
            if name is not None and method == "PUT":
                return lambda: _ack(md.create_data_stream(name))
            if name is not None and method == "DELETE":
                return lambda: _ack(md.delete_data_stream(name))
        return None

    # ----------------------------------------------------- observability
    def _kernels(self):
        """GET /_kernels: the launch tracker's table (telemetry/engine.py:
        per kernel, calls, shapes seen, first calls and their ms, the
        last new key's trigger), its totals, the kernel build directory
        (``persistent_cache``), the fast path's dispatch counts when
        it runs, and the mesh's ``mesh`` section
        (parallel/mesh_executor.py ``MeshSearchBackend.stats``)."""
        out = {"kernels": _engine.TRACKER.to_dict(),
               "totals": _engine.TRACKER.totals(),
               "persistent_cache": _engine.TRACKER.persistent_stats()}
        if self.node.fastpath_running:
            out["serving"] = self.node.fastpath.serving_stats()
        # the mesh: dispatches per axis, fallback reasons, and the bytes
        # of its own copies a device
        out["mesh"] = self.node.search_service.mesh_executor.stats()
        return 200, out

    def _engine_section(self):
        cache = self.node.device_cache
        out = {"compile": _engine.TRACKER.totals(), **cache.engine_stats()}
        if self.node.fastpath_running:
            out["caches"]["theta"] = self.node.fastpath.engine_cache_stats()
        return out

    def _nodes_stats(self, params: dict):
        """GET /_nodes/stats: this node's ``indices`` (each index's
        stats), ``breakers``, ``indexing_pressure``, its ``mesh`` stats
        (as in ``GET /_kernels``), its ``engine`` section (the launch
        tracker's totals; the device bytes by slab class, with the peak,
        admissions and breaker evictions; the device caches' counters,
        and the fast path's θ cache when it runs), ``tasks``
        (transport/tasks.py ``TaskManager.stats``), ``telemetry`` (the
        metrics registry, the trace ring, the flight recorder's
        aggregates, the busiest tenants and classes, and the slow log's
        newest entries; ``?history=true`` adds the windowed history ring,
        ``history_window`` its seconds) and ``recoveries`` (each shard's
        recovery from its own store) and ``thread_pool`` (each named
        pool's threads, queue, active, completed, rejected and EWMA task
        ms: common/threadpool.py)."""
        history_window = params.get("history_window")
        telemetry = self.node.telemetry.to_dict(
            history=params.get("history") == "true",
            history_window=(float(history_window) if history_window
                            else None))
        telemetry["slowlog_recent"] = list(
            self.node.search_service.slowlog_recent)[-16:]
        return 200, {
            "cluster_name": "elasticsearch",
            "nodes": {self.node.node_id: {
                "name": self.node.node_id,
                "indices": {name: svc.stats() for name, svc
                            in list(self.node.indices.items())},
                "request_cache":
                    self.node.search_service.request_cache_stats,
                "breakers": self.node.breaker_service.stats(),
                "indexing_pressure": self.node.indexing_pressure.stats(),
                "thread_pool": self.node.threadpool.stats(),
                "engine": self._engine_section(),
                "tasks": self.node.task_manager.stats(),
                "mesh": self.node.search_service.mesh_executor.stats(),
                "telemetry": telemetry,
                "recoveries": self._recovery_entries(),
            }},
        }

    def _recovery_entries(self) -> list:
        """Each shard's recovery state, in the reference's shape: every
        shard of a single node recovered from its own store at open
        (``local_store``, stage DONE), with the bytes on disk, the ops
        in its translog and the segments resident on the device."""
        entries = []
        for name in sorted(self.node.indices):
            svc = self.node.indices[name]
            for si, engine in enumerate(svc.shards):
                # count the ops before sizing the directory
                n_ops = len(engine.translog.read_ops(1))
                nbytes = 0
                for root, _dirs, fnames in os.walk(engine.path):
                    for fname in fnames:
                        try:
                            nbytes += os.path.getsize(
                                os.path.join(root, fname))
                        except OSError:
                            continue
                resident = [self.node.device_cache.resident(seg.name)
                            for seg in engine.segments]
                resident = [d for d in resident if d is not None]
                entries.append({
                    "index": name, "shard_id": si, "allocation_id": None,
                    "type": "local_store", "protocol": 0, "stage": "DONE",
                    "source_node": self.node.node_id,
                    "target_node": self.node.node_id,
                    "index_files": {"total_bytes": nbytes,
                                    "recovered_bytes": nbytes},
                    "translog": {"ops_replayed": n_ops},
                    "device": {"hbm_uploaded_bytes":
                               sum(d.hbm_bytes() for d in resident),
                               "hbm_segments": len(resident),
                               "hbm_skipped_segments": 0},
                    "start_time": None, "stop_time": None,
                    "total_time_ms": None, "task_id": None,
                    "failure": None,
                })
        return entries

    def _traces(self, params: dict):
        """GET /_traces: newest-first summaries of the trace ring
        (``size``/``from`` page it); ``exemplar_for=<metric>`` answers
        that histogram's exemplars instead (the last trace id and value
        of each bucket), each resolved against the ring."""
        tele = self.node.telemetry
        metric = params.get("exemplar_for")
        if metric:
            exemplars = tele.metrics.exemplars_of(metric)
            for ex in exemplars:
                t = tele.tracer.trace(ex["trace_id"])
                # resolvable False: the trace aged out of the ring
                ex["resolvable"] = t is not None
                if t is not None:
                    roots = [sp for sp in t["spans"]
                             if sp["parent_id"] is None]
                    ex["root"] = roots[0]["name"] if roots else None
                    ex["spans"] = len(t["spans"])
            return 200, {"metric": metric, "exemplars": exemplars}
        return 200, {"traces": tele.tracer.recent_traces(
            int(params.get("size", 32)), int(params.get("from", 0)))}

    def _trace(self, trace_id: str):
        """GET /_traces/{trace_id}: the flat span list and the tree."""
        t = self.node.telemetry.tracer.trace(trace_id)
        if t is None:
            raise ResourceNotFoundException(f"unknown trace [{trace_id}]")
        return 200, t

    def _flight_waterfall(self, trace_id: str):
        """GET /_flight_recorder/waterfall/{trace_id}: the trace's span
        tree with the launches and readbacks recorded under each span
        and each span's self time (telemetry/flightrecorder.py
        ``build_waterfall``)."""
        tele = self.node.telemetry
        t = tele.tracer.trace(trace_id)
        events = tele.flight.events_for_trace(trace_id)
        if t is None and not events:
            raise ResourceNotFoundException(f"unknown trace [{trace_id}]")
        return 200, build_waterfall(trace_id, [{
            "node": self.node.node_id,
            "spans": (t or {}).get("spans", []),
            "events": events}])

    def _tenants_stats(self) -> dict:
        """GET /_tenants/stats: the tenant table through the merge the
        reference's cluster fan-out uses (telemetry/tenants.py)."""
        merged = merge_tenant_stats(
            {self.node.node_id: self.node.telemetry.tenants.stats()})
        merged["cluster_name"] = "elasticsearch"
        return merged

    def _workload_stats(self) -> dict:
        """GET /_workload/stats: the workload-class table
        (telemetry/workload.py), merged as ``_tenants_stats``."""
        merged = merge_workload_stats(
            {self.node.node_id: self.node.telemetry.workload.stats()})
        merged["cluster_name"] = "elasticsearch"
        return merged

    def _flight_recorder(self, params: dict):
        """GET /_flight_recorder: the node's flight ring, newest first
        (kernel launches with their shape, cohort fill, queue wait and
        dispatch nanos; readbacks with their site and bytes). Filters:
        ``kind=launch|readback``, ``kernel=``, ``site=``, ``trace_id=``,
        ``since_ns=``; ``size``/``from`` page. ``aggregates`` rides
        along."""
        fl = self.node.flight
        events = fl.events(
            kind=params.get("kind"), kernel=params.get("kernel"),
            site=params.get("site"), trace_id=params.get("trace_id"),
            since_ns=(int(params["since_ns"])
                      if params.get("since_ns") else None),
            limit=int(params.get("size", 256)),
            offset=int(params.get("from", 0)))
        return 200, {"node": self.node.node_id, "events": events,
                     "aggregates": fl.aggregates()}

    # ------------------------------------------------------------- indices
    def _create_index(self, index: str, params: dict, body):
        """``PUT /{index}``: the matching index template, then the body
        (index/metadata.py ``create_index_from_template``)."""
        if not INDEX_NAME.match(index):
            return _error(400, "invalid_index_name_exception",
                          f"Invalid index name [{index}]", index=index)
        if index in self.node.indices:
            return _error(400, "resource_already_exists_exception",
                          f"resource [index [{index}]] already exists",
                          resource=f"index [{index}]")
        self.node.create_index_from_template(index, body or {})
        return 200, {"acknowledged": True, "shards_acknowledged": True,
                     "index": index}

    def _ensure_index(self, index: str):
        """The index a write to ``index`` goes to: an alias's or data
        stream's write index, else ``index``, created on first write
        with its template as the reference's auto-create does."""
        index = self.node.metadata_service.write_target(index)
        svc = self.node.indices.get(index)
        if svc is None:
            if not index or index.startswith(("_", "-")) \
                    or index != index.lower():
                raise IllegalArgumentException(
                    f"Invalid index name [{index}], must be lowercase and "
                    f"not start with '_' or '-'")
            try:
                svc = self.node.create_index_from_template(index)
            except ResourceAlreadyExistsException:   # created meanwhile
                svc = self.node.indices.require(index)
        return svc

    def _target(self, index: str):
        """(the index a document route on ``index`` reads or changes: an
        alias's or data stream's write index; its service)."""
        index = self.node.metadata_service.write_target(index)
        return index, self.node.indices.require(index)

    def _get_index(self, expression: str, params: dict, body):
        return 200, {name: {
            "mappings": self.node.indices[name].mapper.to_mapping(),
            "settings": {"index": self.node.indices[name].nested_settings()}}
            for name in self.node.indices.resolve(expression, True)}

    def _delete_index(self, expression: str, params: dict, body):
        for name in self.node.indices.resolve(expression, True):
            self.node.delete_index(name)
        return 200, {"acknowledged": True}

    def _get_mapping(self, expression: str, params: dict, body):
        return 200, {name: {"mappings":
                            self.node.indices[name].mapper.to_mapping()}
                     for name in self.node.indices.resolve(expression, True)}

    def _put_mapping(self, expression: str, params: dict, body):
        for name in self.node.indices.resolve(expression):
            self.node.indices[name].update_mappings(body or {})
        return 200, {"acknowledged": True}

    def _get_settings(self, expression: str, params: dict, body):
        return 200, {name: {"settings": {
            "index": self.node.indices[name].nested_settings()}}
            for name in self.node.indices.resolve(expression, True)}

    def _put_settings(self, expression: str, params: dict, body):
        body = body or {}
        updates = body.get("settings", body)
        for name in self.node.indices.resolve(expression):
            self.node.indices[name].update_settings(updates)
        return 200, {"acknowledged": True}

    def _index_stats(self, expression: str, params: dict, body):
        return 200, {"indices": {
            name: self.node.indices[name].stats()
            for name in self.node.indices.resolve(expression)}}

    # ------------------------------------------------------------ documents
    def _index_doc(self, index: str, doc_id: str, params: dict, body):
        _no_pipeline(params)
        svc = self._ensure_index(index)
        kwargs = {}
        if "if_seq_no" in params:
            kwargs["if_seq_no"] = int(params["if_seq_no"])
            kwargs["if_primary_term"] = int(params.get("if_primary_term", 1))
        result = svc.index_doc(doc_id, body or {},
                               routing=params.get("routing"),
                               op_type=params.get("op_type", "index"),
                               **kwargs)
        if _refreshes(params):
            svc.refresh()
        return (201 if result.created else 200), _write_response(
            index, result, "created" if result.created else "updated")

    def _index_auto_id(self, index: str, params: dict, body):
        return self._index_doc(index, uuid.uuid4().hex[:20], params, body)

    def _create_doc(self, index: str, doc_id: str, params: dict, body):
        return self._index_doc(index, doc_id, {**params,
                                               "op_type": "create"}, body)

    def _get_doc(self, index: str, doc_id: str, params: dict, body=None):
        index, svc = self._target(index)
        result = svc.get_doc(doc_id, params.get("routing"))
        if not result.found:
            return 404, {"_index": index, "_id": doc_id, "found": False}
        return 200, {"_index": index, "_id": doc_id,
                     "_version": result.version, "_seq_no": result.seq_no,
                     "_primary_term": result.primary_term, "found": True,
                     "_source": result.source}

    def _get_source(self, index: str, doc_id: str, params: dict, body):
        index, svc = self._target(index)
        result = svc.get_doc(doc_id, params.get("routing"))
        if not result.found:
            raise DocumentMissingException(index, doc_id)
        return 200, result.source

    def _delete_doc(self, index: str, doc_id: str, params: dict, body):
        index, svc = self._target(index)
        result = svc.delete_doc(doc_id, routing=params.get("routing"))
        if _refreshes(params, wait_for=False):
            svc.refresh()
        if not result.found:
            return 404, _write_response(index, result, "not_found")
        return 200, _write_response(index, result, "deleted")

    def _update_doc(self, index: str, doc_id: str, params: dict, body):
        """The reference's get-merge-reindex: ``doc`` deep-merges,
        ``upsert`` indexes a missing document, ``script`` runs over a
        copy of ``_source`` (``ctx.op`` ``none`` or ``delete``)."""
        index, svc = self._target(index)
        body = body or {}
        routing = params.get("routing")
        current = svc.get_doc(doc_id, routing)
        if not current.found:
            if "upsert" in body:
                result = svc.index_doc(doc_id, body["upsert"],
                                       routing=routing)
                return 201, _write_response(index, result, "created")
            raise DocumentMissingException(index, doc_id)
        if "doc" in body:
            merged = _deep_merge(current.source, body["doc"])
            if merged == current.source and body.get("detect_noop", True):
                return 200, _write_response(index, current, "noop")
            result = svc.index_doc(doc_id, merged, routing=routing)
            if _refreshes(params, wait_for=False):
                svc.refresh()
            return 200, _write_response(index, result, "updated")
        if "script" in body:
            script = compile_update_script(body["script"])
            src = copy.deepcopy(current.source)
            ctx = _Ctx(src, index, doc_id, current.version)
            script.run(ctx)
            if ctx.op in ("none", "noop"):
                return 200, _write_response(index, current, "noop")
            if ctx.op == "delete":
                result = svc.delete_doc(doc_id, routing=routing)
                word = "deleted"
            else:
                result = svc.index_doc(doc_id, src, routing=routing)
                word = "updated"
            if _refreshes(params, wait_for=False):
                svc.refresh()
            return 200, _write_response(index, result, word)
        raise IllegalArgumentException(
            "update requires [doc], [script], or [upsert]")

    def _mget(self, index: Optional[str], params: dict, body):
        body = body or {}
        docs = []
        for spec in body.get("docs", []):
            target = spec["_index"] if index is None else spec.get(
                "_index", index)
            docs.append(self._get_doc(target, spec.get("_id"), params)[1])
        if index is not None:
            for doc_id in body.get("ids") or ():
                docs.append(self._get_doc(index, doc_id, params)[1])
        return 200, {"docs": docs}

    # ----------------------------------------------------------------- bulk
    def _bulk(self, index: Optional[str], params: dict, body):
        """NDJSON bulk, item by item. The raw payload's bytes charge the
        node's indexing pressure first (a retryable 429 past the limit,
        before any parsing) and are released when the answer is
        decided. Its translog ops reach the operating system together,
        before the answer (``write_batch``)."""
        nbytes = (len(body) if isinstance(body, (bytes, str))
                  else len(json.dumps(body, default=str)))
        # the bulk's bytes charge its class (``bulk`` unless the request
        # named one) and its tenant
        with _telectx.activate_workload_class(
                _telectx.current_workload_class() or "bulk"):
            release = self.node.indexing_pressure \
                .mark_coordinating_operation_started(nbytes, "_bulk")
            try:
                with write_batch():
                    return self._bulk_inner(index, params, body)
            finally:
                release()

    def _bulk_inner(self, index: Optional[str], params: dict, body):
        _no_pipeline(params)
        if isinstance(body, (bytes, str)):
            text = body.decode() if isinstance(body, bytes) else body
            try:
                if text.lstrip().startswith("["):
                    lines = json.loads(text)
                else:
                    rows = [ln for ln in text.splitlines() if ln.strip()]
                    try:        # every line in one parse
                        lines = json.loads("[" + ",".join(rows) + "]")
                    except ValueError:
                        # line by line: the failing line's own error
                        lines = [json.loads(ln) for ln in rows]
            except ValueError as e:
                raise ParsingException(f"Failed to parse bulk body: {e}")
        elif isinstance(body, list):
            lines = body
        else:
            raise IllegalArgumentException("bulk body must be NDJSON")
        if len(lines) == 1 and isinstance(lines[0], list):
            lines = lines[0]
        items = []
        errors = False
        touched = {}
        start = time.monotonic()
        i = 0
        while i < len(lines):
            (action, meta), = lines[i].items()
            meta = meta or {}
            i += 1
            target = meta.get("_index", index)
            doc_id = meta.get("_id")
            doc_id = uuid.uuid4().hex[:20] if not doc_id else str(doc_id)
            # the source line first, so a failing item never shifts the
            # action/source alternation of the next
            source = None
            if action in ("index", "create", "update"):
                if i >= len(lines):
                    raise IllegalArgumentException(
                        "Malformed bulk request: missing source for last "
                        "action")
                source = lines[i]
                i += 1
            try:
                if target is None:
                    raise IllegalArgumentException("bulk item missing _index")
                if "pipeline" in meta:
                    _no_pipeline(meta)
                # the action line's routing, else the URL's
                routing = meta.get("routing", params.get("routing"))
                routing = None if routing is None else str(routing)
                svc = self._ensure_index(target)
                touched[target] = svc
                if action in ("index", "create"):
                    result = svc.index_doc(doc_id, source, routing=routing,
                                           op_type=action)
                    items.append({action: {
                        "_index": target, "_id": result.doc_id,
                        "_version": result.version,
                        "result": ("created" if result.created
                                   else "updated"),
                        "_seq_no": result.seq_no,
                        "status": 201 if result.created else 200}})
                elif action == "delete":
                    result = svc.delete_doc(doc_id, routing=routing)
                    items.append({action: {
                        "_index": target, "_id": doc_id,
                        "result": "deleted" if result.found else "not_found",
                        "status": 200 if result.found else 404}})
                elif action == "update":
                    code, resp = self._update_doc(target, doc_id,
                                                  dict(params), source)
                    items.append({action: {**resp, "status": code}})
                else:
                    raise IllegalArgumentException(
                        f"Malformed action [{action}]")
            except _ITEM_ERRORS as e:
                errors = True
                status, err = _xcontent(e)
                items.append({action: {"_index": target, "_id": doc_id,
                                       "status": status, "error": err}})
        if _refreshes(params):
            for svc in touched.values():
                svc.refresh()
        return 200, {"took": int((time.monotonic() - start) * 1000),
                     "errors": errors, "items": items}

    # -------------------------------------------------------- index actions
    def _shards_of(self, expression: str):
        """The indices an expression selects, and the ``_shards`` of an
        action on every shard of them."""
        svcs = [self.node.indices[n]
                for n in self.node.indices.resolve(expression)]
        n = sum(svc.num_shards for svc in svcs)
        return svcs, {"_shards": {"total": n, "successful": n, "failed": 0}}

    def _refresh(self, expression: str, params: dict, body):
        svcs, out = self._shards_of(expression)
        for svc in svcs:
            svc.refresh()
        return 200, out

    def _flush(self, expression: str, params: dict, body):
        svcs, out = self._shards_of(expression)
        for svc in svcs:
            svc.flush()
        return 200, out

    def _forcemerge(self, expression: str, params: dict, body):
        n = int(params.get("max_num_segments", 1))
        svcs, out = self._shards_of(expression)
        for svc in svcs:
            svc.force_merge(n)
        return 200, out

    # -------------------------------------------------------------- search
    @staticmethod
    def _match_text(clause, field: Optional[str] = None):
        """(field, text) of a ``{"match": ...}`` clause the fast path
        takes: one field (``field`` when given), a text, operator "or"
        and no other option; else None."""
        if not isinstance(clause, dict) or list(clause) != ["match"]:
            return None
        match = clause["match"]
        if not isinstance(match, dict) or len(match) != 1:
            return None
        (f, spec), = match.items()
        if isinstance(spec, dict):
            if (set(spec) - {"query", "operator"}
                    or str(spec.get("operator", "or")).lower() != "or"):
                return None
            spec = spec.get("query")
        if not isinstance(spec, (str, int, float)) or field not in (None,
                                                                    f):
            return None
        return f, str(spec)

    @classmethod
    def _fast_body(cls, svc, body: dict):
        """(segment, field, text, filter texts) when the body is of the
        fast path's grammar (module docstring) on a text field of the
        index's one segment (an index of one shard) that indexes and
        searches with the builtin standard analyzer; else None."""
        if (svc.num_shards != 1
                or set(body) - {"query", "size", "from", "_source",
                                "track_total_hits", "tenant"}
                or body.get("from", 0) != 0
                or body.get("track_total_hits", True) is not True
                or not isinstance(body.get("_source", True), bool)):
            return None
        query = body.get("query")
        if not isinstance(query, dict) or len(query) != 1:
            return None
        filters = []
        if "bool" in query:
            bq = query["bool"]
            if (not isinstance(bq, dict) or "must" not in bq
                    or set(bq) - {"must", "filter"}):
                return None
            must = bq["must"]
            if isinstance(must, list):
                if len(must) != 1:
                    return None
                must = must[0]
            m = cls._match_text(must)
            if m is None:
                return None
            flt = bq.get("filter", [])
            flt = [flt] if isinstance(flt, dict) else flt
            if not isinstance(flt, list) or len(flt) > MAX_FILTERS:
                return None
            for clause in flt:
                fm = cls._match_text(clause, m[0])
                if fm is None:
                    return None
                filters.append(fm[1])
        else:
            m = cls._match_text(query)
            if m is None:
                return None
        field, text = m
        segments = svc.engine.segments
        ft = svc.mapper.field_type(field)
        if (not isinstance(ft, TextFieldType)
                or not svc.mapper.standard_analyzed(ft)
                or len(segments) != 1
                or field not in segments[0].postings):
            return None
        return segments[0], field, text, filters

    def _apply_alias_filter(self, expression: str, body) -> dict:
        """The body with a filtered alias's filter as a bool ``filter``
        beside its query (the reference's AliasFilter), when
        ``expression`` is one filtered alias."""
        filt = self.node.metadata_service.alias_filter(expression)
        body = dict(body or {})
        if filt is None:
            return body
        query = body.get("query")
        body["query"] = {"bool": {"must": [query] if query else [],
                                  "filter": [filt]}}
        return body

    @contextlib.contextmanager
    def _search_task(self, description: str, action: str = SEARCH_ACTION,
                     parent=None, span=None):
        """A search request's cancellable task (transport/tasks.py),
        registered under a trace (the flight recorder stamps the
        request's launches with it) and in its ``parse`` stage until the
        search publishes another. ``span`` (a live span of the node's
        tracer) is that trace, else a trace id of its own."""
        parent_id = (EMPTY_TASK_ID if parent is None
                     else TaskId(self.node.node_id, parent.id))
        ctx = (_telectx.activate_span(span) if span is not None
               else _telectx.activate(_telectx.TraceContext(
                   uuid.uuid4().hex)))
        with ctx, self.node.task_manager.task_scope(
                "transport", action, description, parent_id,
                cancellable=True) as task:
            task.enter_stage("parse")
            yield task

    def _search_route(self, expression: str, params: dict, body):
        """``_search`` as a cancellable task (the reference's
        ``search_index``): ``POST /_tasks/{id}/_cancel`` stops it at its
        next poll (search/service.py), and it answers 400
        ``task_cancelled_exception``. It is rooted in a ``rest.search``
        span (under the caller's ``trace.id`` when the request carried
        one: rest/native_http.py), whose trace id the answer echoes in
        its ``trace.id`` header."""
        span = self.node.telemetry.tracer.start_span(
            "rest.search", tags={"index": expression})
        try:
            with self._search_task(f"indices[{expression}]",
                                   span=span) as task:
                if self._targets_only_frozen(expression):
                    # frozen searches one at a time on search_throttled,
                    # with the ambient contexts carried across
                    status, response = self.node.threadpool.executor(
                        "search_throttled").submit(_telectx.bind(
                            lambda: self._search(expression, params, body,
                                                 task))).result(timeout=300)
                else:
                    status, response = self._search(expression, params,
                                                    body, task)
        finally:
            span.finish()
        response.setdefault("_headers", {})["trace.id"] = span.trace_id
        return status, response

    def _search(self, expression: str, params: dict, body, task=None):
        """The fast path when the expression names one index of one
        shard and it serves the body (``_fast_body`` and
        ``FastPathServer.fits``), else the search service over every
        shard the expression selects (search/service.py); a ``scroll``
        (or a ``pit`` or ``slice`` in the body) always the latter.
        ``task`` is polled before the search and handed to the search
        service."""
        if task is not None:
            task.ensure_not_cancelled()
        names = (self.node.indices.resolve(expression)
                 if (body or {}).get("pit") is None else [])
        body = _merge_search_params(body, params)
        scroll = params.get("scroll")
        body = self._apply_alias_filter(expression, body)
        t0 = time.time()
        search_type = params.get("search_type")
        size = int(body.get("size", 10))
        index = names[0] if len(names) == 1 else None
        svc = self.node.indices[index] if index is not None else None
        route = (self._fast_body(svc, body)
                 if svc is not None and search_type in SEARCH_TYPES
                 and scroll is None and not svc.is_frozen else None)
        if route is not None:
            seg, field, text, filter_texts = route
            pf = seg.postings[field]
            analyze = svc.mapper.search_analyzer(
                svc.mapper.field_type(field)).analyze
            term_ids = [pf.term_id(t.term) for t in analyze(text)]
            filt = []
            for ft in filter_texts:
                toks = analyze(ft)
                if len(toks) != 1:      # a filter of one token only
                    route = None
                    break
                filt.append(pf.term_id(toks[0].term))
        if route is not None:
            fp = self.node.serving_lane()
            reg = fp.register(index, seg, field, svc.k1, svc.b)
            if not fp.fits(reg, term_ids, size):
                route = None
        if route is None:
            return 200, self.node.search_service.search(
                expression, body, search_type, scroll, task)
        return 200, self.node.search_service.accounted(
            expression, body, scroll,
            lambda: self._fast_search(fp, reg, seg, index, term_ids, filt,
                                      size, body, t0, task))

    def _fast_search(self, fp, reg, seg, index: str, term_ids, filt,
                     size: int, body: dict, t0: float, task) -> dict:
        """The fast path's answer to a body ``_search`` routed to it."""
        if task is not None:
            task.enter_stage("launch")
        scores, docids, total = fp.search(reg, term_ids, size,
                                          tuple(sorted(filt)))
        want_source = body.get("_source", True)
        hits = []
        for s, d in zip(scores.tolist(), docids.tolist()):
            hit = {"_index": index, "_id": seg.stored.ids[d], "_score": s}
            src = seg.stored.source(d)
            if want_source and src:
                hit["_source"] = json.loads(src)
            hits.append(hit)
        response = {
            "took": int((time.time() - t0) * 1000),
            "timed_out": False,
            "_shards": {"total": 1, "successful": 1, "skipped": 0,
                        "failed": 0},
            "hits": {"total": {"value": int(total), "relation": "eq"},
                     "max_score": hits[0]["_score"] if hits else None,
                     "hits": hits},
        }
        self.node.search_service.record_slowlog(
            [index], response["took"], body, response, task)
        return response

    # ------------------------------------------------- search contexts
    def _count(self, expression: str, params: dict, body):
        body = self._apply_alias_filter(expression, body)
        with self._search_task(f"indices[{expression}]") as task:
            return 200, self.node.search_service.count(expression, body,
                                                       task)

    def _explain(self, index: str, doc_id: str, params: dict, body):
        body = body or {}
        if "q" in params and "query" not in body:
            body = _merge_search_params(body, {"q": params["q"]})
        body = self._apply_alias_filter(index, body)
        return 200, self.node.search_service.explain(index, doc_id, body)

    def _scroll(self, params: dict, body):
        body = body or {}
        scroll_id = body.get("scroll_id") or params.get("scroll_id")
        keep = body.get("scroll") or params.get("scroll")
        with self._search_task("scroll") as task:
            return 200, self.node.search_service.scroll(scroll_id, keep,
                                                        task)

    def _clear_scroll(self, params: dict, body):
        ids = (body or {}).get("scroll_id", ["_all"])
        if isinstance(ids, str):
            ids = [ids]
        freed = self.node.search_service.clear_scroll(ids)
        return 200, {"succeeded": True, "num_freed": freed}

    def _open_pit(self, index: str, params: dict, body):
        pit_id = self.node.search_service.open_pit(
            index, params.get("keep_alive", "1m"))
        return 200, {"id": pit_id}

    def _close_pit(self, params: dict, body):
        pit_id = (body or {}).get("id")
        if not pit_id:
            raise IllegalArgumentException("close PIT requires [id]")
        ok = self.node.search_service.close_pit(pit_id)
        return (200 if ok else 404), {"succeeded": ok,
                                      "num_freed": 1 if ok else 0}

    def _msearch(self, index: Optional[str], params: dict, body):
        """NDJSON header/body pairs; each body is a `_search` of its
        header's ``index`` (else the URL's, else ``_all``), its alias
        filter applied, run concurrently on the node's search pool (so
        concurrent bodies meet in shared cohorts). The request is a
        cancellable parent task (``indices:data/read/msearch``) and each
        body a child task registered when it starts: cancelling the
        parent cancels the running children, and its ban cancels every
        child that starts after it (a 400 ``task_cancelled_exception``
        in that slot). A typed failure answers in its own slot; a full
        search queue rejects only the bodies past it (429)."""
        searches = []
        lines = _ndjson_lines(body)
        i = 0
        while i + 1 < len(lines) or (i < len(lines) and index):
            header = lines[i]
            target = header.get("index", index) or "_all"
            searches.append((target, lines[i + 1] if i + 1 < len(lines)
                             else {}))
            i += 2
        with self._search_task(f"requests[{len(searches)}]",
                               MSEARCH_ACTION) as parent:

            def one(target, search_body):
                with _flight.activate(self.node.flight):
                    try:
                        with self._search_task(f"indices[{target}]",
                                               parent=parent) as sub:
                            return self._search(target, {}, search_body,
                                                sub)[1]
                    except _TYPED as e:
                        status, err = _typed_error(e)
                        return {"error": err, "status": status}

            if len(searches) <= 1:
                return 200, {"responses": [one(t, b) for t, b in searches]}
            pool = self.node.threadpool.executor("search")
            slots = []
            for t, b in searches:
                try:
                    # the caller's ambient contexts (trace, client id,
                    # tenant, class, recorders) go with the body
                    slots.append(pool.submit(_telectx.bind(
                        lambda t=t, b=b: one(t, b))))
                except EsRejectedExecutionException as e:
                    slots.append({"error": {"type": e.error_type,
                                            "reason": str(e)},
                                  "status": 429})
            return 200, {"responses": [f.result() if hasattr(f, "result")
                                       else f for f in slots]}

    # ------------------------------------------------------ stored scripts
    def _put_script(self, script_id: str, body):
        self.node.stored_scripts.put(script_id, (body or {}).get("script",
                                                                  {}))
        return 200, {"acknowledged": True}

    def _get_script(self, script_id: str):
        script = self.node.stored_scripts.get(script_id)
        if script is None:
            return 404, {"_id": script_id, "found": False}
        return 200, {"_id": script_id, "found": True, "script": script}

    def _delete_script(self, script_id: str):
        if not self.node.stored_scripts.delete(script_id):
            raise ResourceNotFoundException(
                f"stored script [{script_id}] does not exist")
        return 200, {"acknowledged": True}

    # ------------------------------------------ aliases, templates, streams
    def _update_aliases(self, body):
        self.node.metadata_service.update_aliases(
            (body or {}).get("actions", []))
        return 200, {"acknowledged": True}

    def _put_alias(self, index: str, name: str, params: dict, body):
        spec = {"index": index, "alias": name}
        spec.update(body or {})
        self.node.metadata_service.update_aliases([{"add": spec}])
        return 200, {"acknowledged": True}

    def _delete_alias(self, index: str, name: str, params: dict, body):
        self.node.metadata_service.update_aliases(
            [{"remove": {"index": index, "alias": name}}])
        return 200, {"acknowledged": True}

    def _get_index_alias(self, index: str, *args):
        name = args[0] if len(args) == 3 else None
        return self._alias_answer(index, name)

    def _alias_answer(self, index: Optional[str], name: Optional[str]):
        out = self.node.metadata_service.get_aliases(index, name)
        if name and not out:
            return 404, {"error": f"alias [{name}] missing", "status": 404}
        return 200, out

    def _get_templates(self, key: str, store: dict, name: Optional[str]):
        if name and name not in store:
            raise ResourceNotFoundException(
                f"{key.replace('_', ' ')} matching [{name}] not found")
        wanted = [name] if name else sorted(store)
        return 200, {f"{key}s": [{"name": n, key: store[n]}
                                 for n in wanted]}

    def _rollover(self, index: str, *args):
        new_index = args[0] if len(args) == 3 else None
        params, body = args[-2], args[-1]
        if new_index is not None:
            body = dict(body or {})
            body["new_index"] = new_index
        return 200, self.node.metadata_service.rollover(
            index, body, dry_run=params.get("dry_run") in ("true", ""))

    def _resize(self, index: str, target: str, body, mode: str):
        resize_index(self.node.indices, index, target, body, mode)
        return 200, {"acknowledged": True, "shards_acknowledged": True,
                     "index": target}

    def _shrink(self, index: str, target: str, params: dict, body):
        return self._resize(index, target, body, "shrink")

    def _split(self, index: str, target: str, params: dict, body):
        return self._resize(index, target, body, "split")

    def _clone(self, index: str, target: str, params: dict, body):
        return self._resize(index, target, body, "clone")

    # --------------------------------------------------------- index state
    def _close(self, expression: str, params: dict, body):
        for name in self.node.indices.resolve(expression, True):
            self.node.close_index(name)
        return 200, {"acknowledged": True, "shards_acknowledged": True}

    def _open(self, expression: str, params: dict, body):
        for name in self.node.indices.resolve(expression, True):
            self.node.open_index(name)
        return 200, {"acknowledged": True, "shards_acknowledged": True}

    def _add_block(self, expression: str, block: str, params: dict, body):
        """``index.blocks.{block}`` set and persisted on every index the
        expression resolves (the reference's RestAddIndexBlockAction)."""
        if block not in ("write", "read", "read_only", "metadata"):
            raise IllegalArgumentException(f"invalid block [{block}]")
        names = self.node.indices.resolve(expression)
        for name in names:
            self.node.indices[name].update_settings(
                {f"index.blocks.{block}": True})
        if self.node._http is not None:
            self.node.refresh_front()
        return 200, {"acknowledged": True, "shards_acknowledged": True,
                     "indices": [{"name": n, "blocked": True}
                                 for n in names]}

    # ------------------------------------------- analysis, term vectors
    def _analyze(self, index: str, params: dict, body):
        svc = self.node.indices.require(index)
        return 200, analyze_answer(svc.mapper.analysis, body or {},
                                   svc.mapper)

    def _termvectors(self, index: str, doc_id: str, params: dict, body):
        body = dict(body or {})
        if "fields" in params and "fields" not in body:
            body["fields"] = params["fields"].split(",")
        if params.get("term_statistics") in ("true", ""):
            body["term_statistics"] = True
        return 200, termvectors_of(self.node, index, doc_id, body,
                                   params.get("routing"))

    def _mtermvectors(self, index: str, params: dict, body):
        """Each document's term vectors in its own slot; a failure (a
        missing index, say) is that slot's ``error``."""
        body = body or {}

        def one(target, doc_id, spec):
            try:
                return termvectors_of(self.node, target, doc_id, spec)
            except _TYPED as e:
                return {"_index": target, "_id": doc_id, "found": False,
                        "error": _typed_error(e)[1]}

        docs = [one(spec.get("_index", index), spec.get("_id"), spec)
                for spec in body.get("docs", [])]
        docs += [one(index, doc_id, body) for doc_id in body.get("ids", [])]
        return 200, {"docs": docs}

    # ----------------------------------------------------- by query
    def _update_by_query(self, index: str, params: dict, body):
        return self._bulk_by_scroll(
            params, "indices:data/write/update/byquery",
            lambda task: update_by_query(self.node, index, body, params,
                                         task))

    def _delete_by_query(self, index: str, params: dict, body):
        return self._bulk_by_scroll(
            params, "indices:data/write/delete/byquery",
            lambda task: delete_by_query(self.node, index, body, params,
                                         task))

    def _bulk_by_scroll(self, params: dict, action: str, run):
        """A reindex-family job (reindex/worker.py) as a cancellable
        task: with ``wait_for_completion=false`` on a background thread
        of the node's (``Node.spawn``), answering ``{"task":
        "<node>:<id>"}`` at once; its ``BulkByScrollResponse`` (or its
        failure, as ``{"error": ...}``) is stored when it ends
        (``Node.task_results``, persisted in the ``.tasks`` index) for
        ``GET /_tasks/{id}``, before the task unregisters. Otherwise it
        runs in this request."""
        tm = self.node.task_manager
        if params.get("wait_for_completion") != "false":
            with tm.task_scope("transport", action, cancellable=True) as t:
                return 200, run(t).to_dict()
        task = tm.register("transport", action, cancellable=True)

        def runner():
            try:
                with _flight.activate(self.node.flight):
                    result = run(task).to_dict()
            except Exception as e:   # a background failure is stored
                result = {"error": error_answer(e)[1]}
            try:
                self.node.task_results.store(task.id, result)
            finally:
                tm.unregister(task)

        try:
            self.node.spawn(f"{action}[{task.id}]", runner)
        except BaseException:
            tm.unregister(task)
            raise
        return 200, {"task": f"{self.node.node_id}:{task.id}"}

    def _rethrottle(self, task_id: str, params: dict):
        """``POST /_reindex|_update_by_query|_delete_by_query/{task_id}/
        _rethrottle``: the running job's ``requests_per_second``
        (``-1`` or ``unlimited``: no pacing)."""
        task = self._local_task(task_id)
        throttle = getattr(task, "reindex_throttle", None)
        if throttle is not None and "requests_per_second" in params:
            raw = params["requests_per_second"]
            throttle.rethrottle(-1.0 if raw in ("-1", "unlimited")
                                else float(raw))
        return 200, {"nodes": {self.node.node_id: {
            "tasks": {task_id: task.to_dict(self.node.node_id)}}}}

    # --------------------------------------------------------------- tasks
    def _task_handler(self, method: str, parts, params: dict):
        """The handler of a `_tasks` route, or None."""
        n = len(parts)
        if method == "GET" and n == 1:
            return lambda: self._list_tasks(params)
        if method == "POST" and parts[1:] == ["_cancel"]:
            return lambda: self._cancel_tasks(params)
        if method == "GET" and n == 2:
            return lambda: self._get_task(parts[1], params)
        if method == "POST" and n == 3 and parts[2] == "_cancel":
            return lambda: self._cancel_task(parts[1], params)
        return None

    def _task_infos(self, actions=None, parent_task_id=None,
                    detailed=True):
        """This node's `_tasks` slice, keyed by its id."""
        return {self.node.node_id: node_task_slice(
            self.node.task_manager, self.node.node_id,
            name=self.node.node_id, actions=actions,
            parent_task_id=parent_task_id, detailed=detailed)}

    def _list_tasks(self, params: dict):
        """``GET /_tasks`` with ``actions``, ``detailed``,
        ``parent_task_id`` and ``group_by=nodes|parents|none``."""
        infos = self._task_infos(
            actions=params.get("actions"),
            parent_task_id=params.get("parent_task_id"),
            detailed=parse_bool_param(params.get("detailed"), False))
        return 200, build_tasks_response(
            infos, group_by=params.get("group_by", "nodes"))

    def _local_task(self, task_id: str):
        """The live task ``task_id`` names: a malformed id is a 400, a
        foreign node's id or a task not running a 404."""
        tid = TaskId.parse(task_id)
        if tid.node_id not in ("", self.node.node_id):
            # a task id minted by another node must not alias a local one
            raise ResourceNotFoundException(f"task [{task_id}] is not found")
        task = self.node.task_manager.get_task(tid.id)
        if task is None:
            raise ResourceNotFoundException(
                f"task [{task_id}] isn't running and hasn't stored its "
                f"results")
        return task

    def _get_task(self, task_id: str, params: dict):
        """``GET /_tasks/{id}``: a stored result (memory, then the
        ``.tasks`` index), else the running task;
        ``wait_for_completion=true`` waits for the result up to
        ``timeout_s`` (30) seconds."""
        tid = TaskId.parse(task_id)
        node_id = self.node.node_id
        local = tid.node_id in ("", node_id)
        done = {"node": node_id, "id": tid.id}
        stored = self.node.task_results.get(tid.id) if local else None
        if stored is None and local:
            stored = self.node.stored_task_result(tid.id)
        if stored is not None:
            return 200, {"completed": True, "response": stored,
                         "task": done}
        task = self._local_task(task_id)
        if params.get("wait_for_completion") == "true":
            deadline = time.monotonic() + float(params.get("timeout_s", 30))
            while time.monotonic() < deadline:
                stored = self.node.task_results.get(tid.id)
                if stored is not None:
                    return 200, {"completed": True, "response": stored,
                                 "task": done}
                if self.node.task_manager.get_task(tid.id) is None:
                    # ended without a stored result (a search task)
                    return 200, {"completed": True, "task": done}
                time.sleep(0.02)
        return 200, {"completed": False, "task": task.to_dict(node_id)}

    def _cancel_task(self, task_id: str, params: dict):
        task = self._local_task(task_id)
        if not isinstance(task, CancellableTask):
            raise IllegalArgumentException(
                f"task [{task_id}] is not cancellable")
        self.node.task_manager.cancel(task, params.get("reason",
                                                       "by user request"))
        return 200, {"nodes": {self.node.node_id: {
            "tasks": {task_id: task.to_dict(self.node.node_id)}}}}

    def _cancel_tasks(self, params: dict):
        cancelled = {}
        tm = self.node.task_manager
        for t in tm.list_tasks(actions=params.get("actions")):
            if isinstance(t, CancellableTask):
                tm.cancel(t, "by user request")
                cancelled[f"{self.node.node_id}:{t.id}"] = t.to_dict(
                    self.node.node_id)
        return 200, {"nodes": {self.node.node_id: {"tasks": cancelled}}}

    def _hot_threads(self, params: dict):
        """``GET /_nodes/hot_threads``: the top ``threads`` (3) running
        tasks with their running time and current stage."""
        return 200, {"_cat": hot_threads_text(
            self.node.task_manager, self.node.node_id, self.node.node_id,
            limit=int(params.get("threads", 3)))}

    # ------------------------------------------------------- async search
    def _submit_async_search(self, index: str, params: dict, body):
        """``POST /_async_search``, ``/{index}/_async_search``
        (search/async_search.py): the body with the `_search` URL
        parameters merged, run as `_search` on a background thread."""
        search_params = {k: v for k, v in params.items()
                         if k not in _ASYNC_PARAMS}
        body = _merge_search_params(body, search_params)
        r = self.node.async_search_service.submit(index, body, params)
        return r.pop("_http_status", 200), r

    def async_search_fn(self, index: str, body, task):
        """The async search's body (``AsyncSearchService.search_fn``):
        `_search` under the task, on the background thread with the
        node's flight recorder and a trace of its own."""
        with _flight.activate(self.node.flight), _telectx.activate(
                _telectx.TraceContext(uuid.uuid4().hex)):
            return self._search(index, {}, body, task)[1]

    # ---------------------------------------------------- search templates
    def _resolve_template(self, body) -> dict:
        """The search body a template request renders
        (search/template.py): inline ``source`` or a stored script's by
        ``id``, with ``params``."""
        body = body or {}
        source = body.get("source")
        if source is None and body.get("id"):
            stored = self.node.stored_scripts.get(body["id"])
            if stored is None:
                raise ResourceNotFoundException(
                    f"stored script [{body['id']}] does not exist")
            source = stored["source"]
        if source is None:
            raise IllegalArgumentException(
                "search template requires [source] or [id]")
        return render_template(source, body.get("params"))

    def _render_template(self, template_id: Optional[str], body):
        if template_id is not None:
            body = dict(body or {})
            body["id"] = template_id
        return 200, {"template_output": self._resolve_template(body)}

    def _search_template(self, index: str, params: dict, body):
        return self._search_route(index, {}, self._resolve_template(body))

    def _msearch_template(self, index: Optional[str], params: dict, body):
        """Header/template pairs, each rendered and searched in turn; a
        typed failure answers in its own slot."""
        lines = _ndjson_lines(body)
        responses = []
        i = 0
        while i + 1 < len(lines) or (i < len(lines) and index):
            header = lines[i]
            target = header.get("index", index) or "_all"
            spec = lines[i + 1] if i + 1 < len(lines) else {}
            i += 2
            try:
                responses.append(self._search_route(
                    target, {}, self._resolve_template(spec))[1])
            except _TYPED as e:
                status, err = _typed_error(e)
                responses.append({"error": err, "status": status})
        if i < len(lines):
            raise IllegalArgumentException(
                "msearch template body has a trailing header with no body "
                "line")
        return 200, {"responses": responses}

    # ------------------------------------------------------ search utilities
    def _rank_eval(self, index: str, params: dict, body):
        """``/{index}/_rank_eval`` (search/rank_eval.py): each rated
        request searched as `_search`, its hit ids scored by the
        metric."""
        body = body or {}

        def search_fn(request_body):
            r = self._search_route(index, {}, request_body)[1]
            return [h["_id"] for h in r["hits"]["hits"]]

        return 200, rank_eval(search_fn, body.get("requests", []),
                              body.get("metric", {"recall": {"k": 10}}))

    def _field_caps(self, index: str, params: dict, body):
        """The reference's ``field_caps``: each mapped field matching
        ``fields`` (URL or body, wildcards) per type, with the indices
        listed only where the types conflict."""
        patterns = params.get("fields", "*").split(",")
        if body and "fields" in body:
            patterns = (body["fields"] if isinstance(body["fields"], list)
                        else body["fields"].split(","))
        names = self.node.indices.resolve(index)
        out: dict = {}
        for name in names:
            mapper = self.node.indices[name].mapper
            for fname in sorted(mapper.fields):
                if not any(fnmatch.fnmatch(fname, p.strip())
                           for p in patterns):
                    continue
                ft = mapper.field_type(fname)
                t = ft.type_name
                caps = out.setdefault(fname, {}).setdefault(t, {
                    "type": t,
                    "metadata_field": fname.startswith("_"),
                    "searchable": getattr(ft, "searchable", True),
                    "aggregatable": t not in ("text",),
                    "_indices": []})
                caps["_indices"].append(name)
        fields = {}
        for fname, types in out.items():
            entry = {}
            for t, caps in types.items():
                c = dict(caps)
                listed = c.pop("_indices")
                if len(types) > 1:   # indices only where types conflict
                    c["indices"] = sorted(listed)
                entry[t] = c
            fields[fname] = entry
        return 200, {"indices": sorted(names), "fields": fields}

    def _validate_query(self, index: str, params: dict, body):
        """``/{index}/_validate/query``: whether the query parses (an
        unknown index, too, answers ``valid: false``), with the parsed
        query's ``explanation`` under ``explain``."""
        q = (body or {}).get("query", {"match_all": {}})
        try:
            parsed = parse_query(q)
            explanation = (repr(parsed) if params.get("explain")
                           in ("true", "") else None)
            exp = [{"index": n, "valid": True,
                    **({"explanation": explanation} if explanation
                       else {})}
                   for n in self.node.indices.resolve(index)]
            return 200, {"valid": True,
                         "_shards": {"total": 1, "successful": 1,
                                     "failed": 0},
                         "explanations": exp if explanation else []}
        except _TYPED as e:
            return 200, {"valid": False, "error": str(e)}

    def _terms_enum(self, index: str, params: dict, body):
        """``/{index}/_terms_enum``: the sorted terms of ``field``'s
        dictionaries (postings and keyword doc values of every segment)
        that start with ``string`` (``case_insensitive``), the first
        ``size`` (10)."""
        body = body or {}
        field = body.get("field") or params.get("field")
        if not field:
            raise IllegalArgumentException("terms_enum requires [field]")
        prefix = body.get("string", params.get("string", ""))
        size = int(body.get("size", params.get("size", 10)))
        fold = bool(body.get("case_insensitive"))
        want = prefix.lower() if fold else prefix
        found = set()
        for name in self.node.indices.resolve(index):
            for shard in self.node.indices[name].shards:
                for seg in shard.segments:
                    for src in (seg.postings.get(field),
                                seg.keywords.get(field)):
                        if src is None:
                            continue
                        found.update(t for t in src.terms
                                     if (t.lower() if fold else t)
                                     .startswith(want))
        return 200, {"terms": sorted(found)[:size], "complete": True,
                     "_shards": {"total": 1, "successful": 1, "failed": 0}}

    def _resolve_index(self, expression: str):
        """``GET /_resolve/index/{expression}``: the indices, aliases and
        data streams whose names match."""
        md = self.node.metadata_service
        index_names, alias_names, stream_names = set(), set(), set()
        for part in expression.split(","):
            if part == "_all":
                part = "*"
            index_names.update(n for n in self.node.indices
                               if fnmatch.fnmatch(n, part))
            alias_names.update(a for a in md.aliases
                               if fnmatch.fnmatch(a, part))
            stream_names.update(ds for ds in md.data_streams
                                if fnmatch.fnmatch(ds, part))
        return 200, {
            "indices": [{"name": n, "attributes": ["open"]}
                        for n in sorted(index_names)],
            "aliases": [{"name": a, "indices": sorted(md.aliases[a])}
                        for a in sorted(alias_names)],
            "data_streams": [{"name": ds,
                              "backing_indices":
                                  md.data_streams[ds].get("indices", []),
                              "timestamp_field": "@timestamp"}
                             for ds in sorted(stream_names)],
        }

    # -------------------------------------------------------- _cat, _stats
    def _all_stats(self):
        """``GET /_stats``: every index's stats and the docs of all."""
        out = {"indices": {name: svc.stats()
                           for name, svc in self.node.indices.items()}}
        total = sum(s["docs"]["count"] for s in out["indices"].values())
        out["_all"] = {"primaries": {"docs": {"count": total}}}
        return 200, out

    def _cat_indices(self, params: dict) -> str:
        lines = []
        for name in sorted(self.node.indices):
            svc = self.node.indices[name]
            s = svc.stats()
            lines.append(f"green open {name} {svc.num_shards} 0 "
                         f"{s['docs']['count']} {s['docs']['deleted']}")
        return "\n".join(lines)

    def _cat_count(self, params: dict) -> str:
        docs = sum(svc.stats()["docs"]["count"]
                   for svc in self.node.indices.values())
        return f"{int(time.time())} {docs}"

    def _cat_shards(self, params: dict) -> str:
        lines = []
        for name in sorted(self.node.indices):
            for i, shard in enumerate(self.node.indices[name].shards):
                lines.append(f"{name} {i} p STARTED "
                             f"{shard.stats()['docs']['count']} "
                             f"{self.node.node_id}")
        return "\n".join(lines)

    def _cat_aliases(self, params: dict) -> str:
        return "\n".join(
            f"{a} {idx} - - - -"
            for a, members in sorted(self.node.metadata_service
                                     .aliases.items())
            for idx in sorted(members))

    def _cat_templates(self, params: dict) -> str:
        return "\n".join(
            f"{name} [{','.join(t.get('index_patterns', []))}] "
            f"{t.get('priority', 0)}"
            for name, t in self.node.metadata_service
            .index_templates.items())

    def _cat_segments(self, params: dict) -> str:
        lines = []
        for name in sorted(self.node.indices):
            for si, shard in enumerate(self.node.indices[name].shards):
                for seg in shard.segments:
                    lines.append(f"{name} {si} p 127.0.0.1 {seg.name} "
                                 f"{seg.n_docs} {int(seg.live.sum())}")
        return "\n".join(lines)

    def _cat_tasks(self, params: dict) -> str:
        return render_cat_tasks(self._task_infos(
            actions=params.get("actions")))

    def _cat_tenants(self, params: dict) -> str:
        return render_cat_tenants(self._tenants_stats())

    def _cat_workload(self, params: dict) -> str:
        return render_cat_workload(self._workload_stats())

    # ``GET /_cat/{name}``: each a text of rows, answered as {"_cat": text}
    _CAT = {"indices": _cat_indices, "count": _cat_count,
            "shards": _cat_shards, "aliases": _cat_aliases,
            "templates": _cat_templates, "segments": _cat_segments,
            "tasks": _cat_tasks, "tenants": _cat_tenants,
            "workload": _cat_workload,
            "health": OperationsRoutes._cat_health,
            "thread_pool": OperationsRoutes._cat_thread_pool,
            "repositories": OperationsRoutes._cat_repositories}


def _ndjson_lines(body) -> list:
    """The objects of an NDJSON body (bytes or text), or the list given."""
    if isinstance(body, (bytes, str)):
        text = body.decode() if isinstance(body, bytes) else body
        return [json.loads(ln) for ln in text.splitlines() if ln.strip()]
    return body or []


def error_answer(e: BaseException) -> Tuple[int, dict]:
    """(status, error object) of any failure: a typed one's own, else a
    500 ``exception``."""
    if isinstance(e, _TYPED):
        return _typed_error(e)
    return 500, {"type": "exception", "reason": f"{type(e).__name__}: {e}"}
