"""REST routes of the `_search` BM25 slice (counterpart of
elasticsearch_tpu/rest/api.py, reduced to the slice's routes):

    GET  /
    PUT  /{index}
    POST /{index}/_bulk
    POST /{index}/_refresh
    POST /{index}/_forcemerge
    POST|GET /{index}/_search     {"query": {"match": {field: text}}, "size": k}

`_search` is served by the v2m lane (search/fastpath.py): an exact top-k
and an exact total (relation "eq"). What the slice does not serve is
answered with a typed 400, never on another path.
"""

from __future__ import annotations

import json
import logging
import re
import time
from typing import Any, Optional, Tuple

from elasticsearch_tpu_torch.index.mapper import MapperParsingException
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported

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
        except (SliceUnsupported, MapperParsingException) as e:
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
    def _parse_match(body: dict) -> Tuple[str, str]:
        query = body.get("query")
        if not isinstance(query, dict) or list(query) != ["match"]:
            raise SliceUnsupported(
                "this slice serves the match query only; the plan kernel "
                "path that serves the rest of the DSL is the next slice")
        match = query["match"]
        if not isinstance(match, dict) or len(match) != 1:
            raise SliceUnsupported("[match] takes exactly one field")
        (field, spec), = match.items()
        if isinstance(spec, dict):
            extra = set(spec) - {"query", "operator"}
            if extra or str(spec.get("operator", "or")).lower() != "or":
                raise SliceUnsupported(
                    f"match options {sorted(extra) or ['operator']} are a "
                    f"later slice (only query and operator 'or')")
            text = spec.get("query")
        else:
            text = spec
        if not isinstance(text, (str, int, float)):
            raise SliceUnsupported("[match] query text must be a string")
        return field, str(text)

    def _search(self, index: str, params: dict, body):
        svc, err = self._index_or_404(index)
        if err:
            return err
        t0 = time.time()
        body = body or {}
        size = int(body.get("size", params.get("size", 10)))
        if int(body.get("from", params.get("from", 0))) != 0:
            raise SliceUnsupported("[from] > 0 is a later slice")
        want_source = body.get("_source", True) is not False
        field, text = self._parse_match(body)
        if svc.mapper.fields.get(field) != "text":
            raise SliceUnsupported(f"field [{field}] is not a mapped text "
                                   f"field of [{index}]")
        segments = svc.engine.segments
        hits, total = [], 0
        if len(segments) > 1:
            raise SliceUnsupported(
                f"[{index}] has {len(segments)} segments and the v2m lane "
                f"serves one: POST /{index}/_forcemerge first")
        if segments and field in segments[0].postings:
            seg = segments[0]
            pf = seg.postings[field]
            term_ids = [pf.term_id(t.term)
                        for t in svc.mapper.analyzer.analyze(text)]
            fp = self.node.serving_lane()
            reg = fp.register(index, seg, field, svc.k1, svc.b)
            scores, docids, total = fp.search(reg, term_ids, size)
            for s, d in zip(scores.tolist(), docids.tolist()):
                hit = {"_index": index, "_id": seg.stored.ids[d],
                       "_score": s}
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
