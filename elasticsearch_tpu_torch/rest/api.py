"""REST routes of the `_search` BM25 slice (counterpart of
elasticsearch_tpu/rest/api.py, reduced to the slice's routes):

    GET  /
    PUT  /{index}                 {"settings": {"index": {"number_of_shards": N}}}
    POST /{index}/_bulk           items routed by ``routing`` (or ?routing=)
    POST /{index}/_refresh        ({index} may be an index expression)
    POST /{index}/_forcemerge
    POST|GET /{index}/_search     {"query": ..., "size": k, "from": n, ...}
    POST|GET /_search             every index
    GET  /_kernels                the launch tracker's table
    GET  /_nodes/stats            breakers, engine, flight recorder
    GET  /_flight_recorder        the launch/readback ring, filtered

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
body as the reference merges them; the port keeps no request cache, so
``request_cache: false`` is served and ``true`` is a typed 400) and
``search_type``
(``query_then_fetch`` or ``dfs_query_then_fetch``, else a 400); any
other is a typed 400. A device admission the ``hbm`` breaker refuses
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
``track_total_hits`` true beside the query; FIELD is a text field, and
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
a stored-script reference (``{"id": ...}``) and the ``_scripts`` routes
are a later slice (a typed 400). Top-level ``knn`` and ``rank.rrf``
(hybrid retrieval over ``dense_vector`` fields, which ``PUT /{index}``
maps and ``_bulk`` indexes) go to the search service too: the fast
grammar and the C++ front refuse both keys. What none serves is answered
with a typed 400, never on another device.

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

import json
import logging
import re
import time
from typing import Any, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import (
    CircuitBreakingException, IllegalArgumentException,
    IndexNotFoundException, QueryShardException, ScriptException,
    SearchPhaseExecutionException, SettingsException)
from elasticsearch_tpu_torch.index.mapper import (MapperParsingException,
                                                  TextFieldType)
from elasticsearch_tpu_torch.search.fastpath import (MAX_FILTERS,
                                                     SliceUnsupported)
from elasticsearch_tpu_torch.search.queries import ParsingException
from elasticsearch_tpu_torch.search.service import SEARCH_TYPES
from elasticsearch_tpu_torch.telemetry import engine as _engine
from elasticsearch_tpu_torch.telemetry import flightrecorder as _flight

logger = logging.getLogger("elasticsearch_tpu_torch.rest")

_INDEX_NAME = re.compile(r"^[a-z0-9][a-z0-9_.\-]*$")


# the `_search` URL parameters this slice serves (``_merge_search_params``)
_SEARCH_PARAMS = ("q", "from", "size", "request_cache",
                  "allow_partial_search_results", "search_type")


def _merge_search_params(body, params: dict) -> dict:
    """The body with the URL parameters of `_search` merged in, as the
    reference's ``_merge_search_params``: ``q`` becomes a ``match``
    (``field:value``) or a ``multi_match`` over every field when the
    body has no query; URL ``from``/``size`` override the body's;
    ``request_cache`` and ``allow_partial_search_results`` must be
    ``true`` or ``false`` and then go into the body (where the body keys
    the slice serves decide); ``search_type`` is the caller's. Any
    other parameter (``scroll``, ``timeout``, ...) is a later slice: a
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


class RestController:
    def __init__(self, node):
        self.node = node

    def dispatch(self, method: str, path: str, params: Optional[dict] = None,
                 body: Any = None) -> Tuple[int, Any]:
        params = params or {}
        parts = [p for p in path.split("/") if p]
        try:
            # every launch and readback under this request lands in the
            # node's flight recorder
            with _flight.activate(self.node.flight):
                return self._route(method, path, parts, params, body)
        except CircuitBreakingException as e:
            return _error(429, e.error_type, str(e),
                          bytes_wanted=e.bytes_wanted,
                          bytes_limit=e.bytes_limit)
        except IndexNotFoundException as e:
            return _error(404, e.error_type, str(e), index=e.index)
        except SearchPhaseExecutionException as e:
            return _error(e.status, e.error_type, str(e),
                          phase=e.phase_name, grouped=True,
                          failed_shards=e.shard_failures)
        except (SliceUnsupported, MapperParsingException, ParsingException,
                IllegalArgumentException, QueryShardException,
                ScriptException, SettingsException) as e:
            etype = getattr(e, "error_type", "mapper_parsing_exception")
            return _error(400, etype, str(e))
        except Exception as e:  # the boundary: report, keep serving
            logger.exception("request failed: %s %s", method, path)
            return _error(500, "exception", f"{type(e).__name__}: {e}")

    def _route(self, method: str, path: str, parts, params: dict, body):
        if not parts:
            if method in ("GET", "HEAD"):
                return 200, self.node.info()
        elif method == "GET" and parts == ["_kernels"]:
            return self._kernels()
        elif method == "GET" and parts == ["_nodes", "stats"]:
            return self._nodes_stats()
        elif method == "GET" and parts == ["_flight_recorder"]:
            return self._flight_recorder(params)
        elif parts == ["_search"] and method in ("POST", "GET"):
            return self._search("_all", params, body)
        elif len(parts) == 1 and not parts[0].startswith("_"):
            if method == "PUT":
                return self._create_index(parts[0], body)
        elif len(parts) == 2 and (not parts[0].startswith("_")
                                  or parts[0] == "_all"):
            index, action = parts
            if action == "_bulk" and method in ("POST", "PUT"):
                return self._bulk(index, params, body)
            if action == "_refresh" and method in ("POST", "GET"):
                return self._refresh(index)
            if action == "_forcemerge" and method == "POST":
                return self._forcemerge(index, params)
            if action == "_search" and method in ("POST", "GET"):
                return self._search(index, params, body)
        return _error(400, "unsupported_in_slice_exception",
                      f"{method} {path} is not a route of this slice of "
                      f"the port")

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

    def _nodes_stats(self):
        """GET /_nodes/stats: this node's ``breakers``, its ``mesh``
        stats (as in ``GET /_kernels``), its ``engine``
        section (the launch tracker's totals; the device bytes by slab
        class, with the peak, admissions and breaker evictions; the
        device caches' counters, and the fast path's θ cache when it
        runs) and ``telemetry.flight_recorder`` (the ring's aggregates).
        The reference's other sections (indices, thread_pool, tasks,
        recoveries, the metrics registry) come with the port's host-side
        services."""
        return 200, {
            "cluster_name": "elasticsearch",
            "nodes": {self.node.node_id: {
                "name": self.node.node_id,
                "breakers": self.node.breaker_service.stats(),
                "engine": self._engine_section(),
                "mesh": self.node.search_service.mesh_executor.stats(),
                "telemetry": {
                    "flight_recorder": self.node.flight.aggregates()},
            }},
        }

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
    def _index_or_404(self, index: str):
        svc = self.node.indices.get(index)
        if svc is None:
            return None, _error(404, "index_not_found_exception",
                                f"no such index [{index}]", index=index)
        return svc, None

    def _create_index(self, index: str, body):
        if not _INDEX_NAME.match(index):
            return _error(400, "invalid_index_name_exception",
                          f"Invalid index name [{index}]", index=index)
        if index in self.node.indices:
            return _error(400, "resource_already_exists_exception",
                          f"resource [index [{index}]] already exists",
                          resource=f"index [{index}]")
        body = body or {}
        self.node.create_index(index, body.get("mappings"),
                               body.get("settings"))
        return 200, {"acknowledged": True, "shards_acknowledged": True,
                     "index": index}

    def _bulk(self, index: str, params: dict, body):
        svc, err = self._index_or_404(index)
        if err:
            return err
        t0 = time.time()
        lines = [ln for ln in (body or "").splitlines() if ln.strip()]
        items = []
        errors = False
        i = 0
        while i < len(lines):
            try:
                action = json.loads(lines[i])
            except json.JSONDecodeError as e:
                return _error(400, "parsing_exception",
                              f"malformed bulk action line: {e}")
            (op, meta), = action.items()
            meta = meta or {}
            i += 1
            if meta.get("_index", index) != index:
                return _error(400, "unsupported_in_slice_exception",
                              "bulk into another index than the path's is "
                              "a later slice")
            doc_id = meta.get("_id")
            doc_id = None if doc_id is None else str(doc_id)
            routing = meta.get("routing", params.get("routing"))
            routing = None if routing is None else str(routing)
            try:
                if op in ("index", "create"):
                    source = json.loads(lines[i])
                    i += 1
                    doc_id, result = svc.index_doc(doc_id, source, routing,
                                                   op_type=op)
                    status = 201 if result == "created" else 200
                    items.append({op: {"_index": index, "_id": doc_id,
                                       "result": result, "status": status}})
                elif op == "delete":
                    found = svc.delete_doc(doc_id, routing)
                    items.append({op: {
                        "_index": index, "_id": doc_id,
                        "result": "deleted" if found else "not_found",
                        "status": 200 if found else 404}})
                else:
                    raise SliceUnsupported(
                        f"bulk action [{op}] is a later slice")
            except (ValueError, SliceUnsupported) as e:
                errors = True
                etype = ("version_conflict_engine_exception"
                         if "version conflict" in str(e) else
                         getattr(e, "error_type", "mapper_parsing_exception"))
                items.append({op: {"_index": index, "_id": doc_id,
                                   "status": 409 if etype.startswith(
                                       "version") else 400,
                                   "error": {"type": etype,
                                             "reason": str(e)}}})
        if str(params.get("refresh", "false")).lower() in ("true", "",
                                                            "wait_for"):
            svc.refresh()
        return 200, {"took": int((time.time() - t0) * 1000),
                     "errors": errors, "items": items}

    def _shards_of(self, expression: str):
        """The indices an expression selects, and the ``_shards`` of an
        action on every shard of them."""
        svcs = [self.node.indices[n]
                for n in self.node.indices.resolve(expression)]
        n = sum(svc.num_shards for svc in svcs)
        return svcs, {"_shards": {"total": n, "successful": n, "failed": 0}}

    def _refresh(self, expression: str):
        svcs, out = self._shards_of(expression)
        for svc in svcs:
            svc.refresh()
        return 200, out

    def _forcemerge(self, expression: str, params: dict):
        n = int(params.get("max_num_segments", 1))
        if n != 1:
            raise SliceUnsupported("this slice force-merges to one segment "
                                   "only (max_num_segments=1)")
        svcs, out = self._shards_of(expression)
        for svc in svcs:
            svc.force_merge(1)
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
        index's one segment (an index of one shard); else None."""
        if (svc.num_shards != 1
                or set(body) - {"query", "size", "from", "_source",
                         "track_total_hits"}
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
        if (not isinstance(svc.mapper.field_type(field), TextFieldType)
                or len(segments) != 1
                or field not in segments[0].postings):
            return None
        return segments[0], field, text, filters

    def _search(self, expression: str, params: dict, body):
        """The fast path when the expression names one index of one
        shard and it serves the body (``_fast_body`` and
        ``FastPathServer.fits``), else the search service over every
        shard the expression selects (search/service.py)."""
        names = self.node.indices.resolve(expression)
        t0 = time.time()
        body = _merge_search_params(body, params)
        search_type = params.get("search_type")
        size = int(body.get("size", 10))
        index = names[0] if len(names) == 1 else None
        svc = self.node.indices[index] if index is not None else None
        route = (self._fast_body(svc, body)
                 if svc is not None and search_type in SEARCH_TYPES
                 else None)
        if route is not None:
            seg, field, text, filter_texts = route
            pf = seg.postings[field]
            analyze = svc.mapper.analyzer.analyze
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
            return 200, self.node.search_service.search(expression, body,
                                                        search_type)
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
        return 200, {
            "took": int((time.time() - t0) * 1000),
            "timed_out": False,
            "_shards": {"total": 1, "successful": 1, "skipped": 0,
                        "failed": 0},
            "hits": {"total": {"value": int(total), "relation": "eq"},
                     "max_score": hits[0]["_score"] if hits else None,
                     "hits": hits},
        }
