"""REST routes of the `_search` BM25 slice (counterpart of
elasticsearch_tpu/rest/api.py, reduced to the slice's routes):

    GET  /
    PUT  /{index}
    POST /{index}/_bulk
    POST /{index}/_refresh
    POST /{index}/_forcemerge
    POST|GET /{index}/_search     {"query": ..., "size": k, "from": n, ...}

`_search` answers an exact top-k and an exact total (relation "eq"),
unless the body's ``track_total_hits`` is false or a threshold (the plan
path may then prune and count a lower bound, relation "gte"). The fast
path (search/fastpath.py) takes the bodies of the C++ front's grammar on
an index of one segment, when one of its lanes serves the query
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
``search_after`` and ``min_score``. Top-level ``knn`` and ``rank.rrf``
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

from elasticsearch_tpu_torch.index.mapper import (MapperParsingException,
                                                  TextFieldType)
from elasticsearch_tpu_torch.search.fastpath import (MAX_FILTERS,
                                                     SliceUnsupported)
from elasticsearch_tpu_torch.search.queries import ParsingException
from elasticsearch_tpu_torch.search.service import IllegalArgumentException

logger = logging.getLogger("elasticsearch_tpu_torch.rest")

_INDEX_NAME = re.compile(r"^[a-z0-9][a-z0-9_.\-]*$")


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
            if not parts:
                if method in ("GET", "HEAD"):
                    return 200, self.node.info()
            elif len(parts) == 1 and not parts[0].startswith("_"):
                if method == "PUT":
                    return self._create_index(parts[0], body)
            elif len(parts) == 2 and not parts[0].startswith("_"):
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
        except (SliceUnsupported, MapperParsingException, ParsingException,
                IllegalArgumentException) as e:
            etype = getattr(e, "error_type", "mapper_parsing_exception")
            return _error(400, etype, str(e))
        except Exception as e:  # the boundary: report, keep serving
            logger.exception("request failed: %s %s", method, path)
            return _error(500, "exception", f"{type(e).__name__}: {e}")

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
                          f"index [{index}] already exists", index=index)
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
            try:
                if op in ("index", "create"):
                    source = json.loads(lines[i])
                    i += 1
                    doc_id, result = svc.engine.index(doc_id, source,
                                                      op_type=op)
                    status = 201 if result == "created" else 200
                    items.append({op: {"_index": index, "_id": doc_id,
                                       "result": result, "status": status}})
                elif op == "delete":
                    found = svc.engine.delete(doc_id)
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
            svc.engine.refresh()
        return 200, {"took": int((time.time() - t0) * 1000),
                     "errors": errors, "items": items}

    def _refresh(self, index: str):
        svc, err = self._index_or_404(index)
        if err:
            return err
        svc.engine.refresh()
        return 200, {"_shards": {"total": 1, "successful": 1, "failed": 0}}

    def _forcemerge(self, index: str, params: dict):
        svc, err = self._index_or_404(index)
        if err:
            return err
        n = int(params.get("max_num_segments", 1))
        if n != 1:
            raise SliceUnsupported("this slice force-merges to one segment "
                                   "only (max_num_segments=1)")
        svc.engine.force_merge(1)
        return 200, {"_shards": {"total": 1, "successful": 1, "failed": 0}}

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
        index's one segment; else None."""
        if (set(body) - {"query", "size", "from", "_source",
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

    def _search(self, index: str, params: dict, body):
        """The fast path when it serves the body (``_fast_body`` and
        ``FastPathServer.fits``), else the plan path
        (search/service.py)."""
        svc, err = self._index_or_404(index)
        if err:
            return err
        t0 = time.time()
        body = dict(body or {})
        for key in ("size", "from"):
            if key in params and key not in body:
                body[key] = int(params[key])
        size = int(body.get("size", 10))
        route = self._fast_body(svc, body)
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
            return 200, self.node.search_service.search(index, svc, body)
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
