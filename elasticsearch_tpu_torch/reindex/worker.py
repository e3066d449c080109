"""The scroll and bulk worker behind `_reindex`, `_update_by_query` and
`_delete_by_query`, and the update-script context of ``_update`` and the
`_bulk` update item (the port's copy of
elasticsearch_tpu/reindex/worker.py).

The worker reads its source through a scroll that survives a lost
context (search/service.py ``resumable_scroll_batches``: every page a
search of the search service, so a scored ``query`` runs on the device
as any `_search` does), transforms each hit (a script, the destination's
``op_type`` and ``version_type``), writes it through the index service,
and counts created, updated, deleted, noops and version conflicts in a
``BulkByScrollResponse``; ``conflicts: proceed`` counts a conflict where
``abort`` stops at it; ``requests_per_second`` paces the batches
(``_Throttle``); ``slices``/``slice_id`` keep the hits whose id hashes
to the slice. A worker given the request's ``task`` (transport/
tasks.py) polls it before each batch (every scroll page polls it too,
search/service.py), so a cancel stops the job between batches, and
hangs its ``_Throttle`` on it (``task.reindex_throttle``): ``_rethrottle``
changes the pace of the running job and wakes a batch's pause. A remote
source needs the client (client/) of a later slice and answers a typed
400 (``SliceUnsupported``), as does an ingest ``pipeline``.

An update script mutates ``ctx._source`` and may set ``ctx.op`` to
``none``/``noop`` (nothing is written) or ``delete``.
"""

from __future__ import annotations

import ast
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException, ScriptException,
    VersionConflictEngineException)
from elasticsearch_tpu_torch.script import contexts as _plctx
from elasticsearch_tpu_torch.script.interp import PainlessError
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported

_SCROLL_KEEPALIVE = "5m"
_DEFAULT_BATCH = 1000


_ALLOWED_STMT = (ast.Module, ast.Assign, ast.AugAssign, ast.Expr, ast.If,
                 ast.Pass)
_ALLOWED_EXPR = (
    ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare, ast.Call, ast.IfExp,
    ast.Attribute, ast.Subscript, ast.Name, ast.Constant, ast.List,
    ast.Dict, ast.Tuple, ast.Load, ast.Store, ast.Add, ast.Sub, ast.Mult,
    ast.Div, ast.Mod, ast.Pow, ast.FloorDiv, ast.USub, ast.UAdd, ast.Not,
    ast.And, ast.Or, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.In, ast.NotIn, ast.Is, ast.IsNot,
)


class _SourceProxy:
    """``ctx._source``: attribute/item access onto the source dict, so the
    painless idioms ``ctx._source.counter += 1`` and
    ``ctx._source['tags'] = [...]`` both work."""

    def __init__(self, source: Dict[str, Any]):
        object.__setattr__(self, "_data", source)

    def __getattr__(self, name):
        try:
            v = self._data[name]
        except KeyError:
            return None
        return _SourceProxy(v) if isinstance(v, dict) else v

    def __setattr__(self, name, value):
        self._data[name] = value

    def __getitem__(self, name):
        return getattr(self, name)

    def __setitem__(self, name, value):
        self._data[name] = value

    def __contains__(self, name):
        return name in self._data

    def remove(self, name):
        self._data.pop(name, None)

    def containsKey(self, name):  # painless Map surface
        return name in self._data

    def get(self, name, default=None):
        return self._data.get(name, default)


class _Ctx:
    """The update-script ``ctx`` variable (Elasticsearch's UpdateHelper:
    _source, _index, _id, _version, and the mutable ``op``)."""

    def __init__(self, source, index, doc_id, version):
        self._source = _SourceProxy(source)
        self._index = index
        self._id = doc_id
        self._version = version
        self.op = "index"


_SAFE_FUNCS = {
    "abs": abs, "min": min, "max": max, "round": round, "len": len,
    "str": str, "int": int, "float": float, "bool": bool,
}


def _painless_to_python(source: str) -> str:
    """Normalize painless-isms (``;`` statement ends, ``&&``/``||``/``!``)
    to python, WITHOUT touching quoted string literals."""
    out = []
    quote = None
    i = 0
    n = len(source)
    while i < n:
        c = source[i]
        if quote is not None:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(source[i + 1])
                i += 2
                continue
            if c == quote:
                quote = None
            i += 1
            continue
        if c in "'\"":
            quote = c
            out.append(c)
            i += 1
            continue
        two = source[i:i + 2]
        if two == "&&":
            out.append(" and ")
            i += 2
        elif two == "||":
            out.append(" or ")
            i += 2
        elif two == "!=":
            out.append("!=")
            i += 2
        elif c == "!":
            out.append(" not ")
            i += 1
        elif c == ";":
            out.append("\n")  # statement end; indentation of the next
            i += 1            # physical line still governs blocks
            while i < n and source[i] == " ":
                i += 1
        else:
            out.append(c)
            i += 1
    lines = [l for l in "".join(out).split("\n") if l.strip()]
    return "\n".join(lines)


class UpdateScript:
    """A compiled update-context script: Painless through the port's
    interpreter (script/), else the legacy expression translation for
    what it cannot parse."""

    def __init__(self, source: str, params: Optional[Dict[str, Any]] = None):
        self.source = source
        self.params = params or {}
        self._painless = _plctx.try_compile(source)
        if self._painless:
            self._code = None
            return
        py = _painless_to_python(source)
        try:
            tree = ast.parse(py, mode="exec")
        except SyntaxError as e:
            raise ScriptException(f"compile error in script [{source}]: {e}")
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_STMT + _ALLOWED_EXPR):
                raise ScriptException(
                    f"illegal construct [{type(node).__name__}] in script")
            if isinstance(node, ast.Name) and node.id not in (
                    "ctx", "params") and node.id not in _SAFE_FUNCS:
                raise ScriptException(f"unknown variable [{node.id}]")
            if isinstance(node, ast.Attribute) and node.attr.startswith("__"):
                raise ScriptException("dunder access is not allowed")
        self._code = compile(tree, "<update-script>", "exec")

    def run(self, ctx: _Ctx) -> None:
        if self._painless:
            try:
                _plctx.run_update_script(self.source, ctx, self.params)
            except PainlessError as e:
                raise ScriptException(str(e))
            return
        scope = dict(_SAFE_FUNCS)
        scope["ctx"] = ctx
        scope["params"] = _ScriptParams(self.params)
        exec(self._code, {"__builtins__": {}}, scope)


class _ScriptParams(dict):
    def __init__(self, d):
        super().__init__(d)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise ScriptException(f"missing script parameter [{name}]")


def compile_update_script(spec: Any) -> Optional[UpdateScript]:
    if spec is None:
        return None
    if isinstance(spec, str):
        return UpdateScript(spec)
    return UpdateScript(spec.get("source", ""), spec.get("params"))


# ----------------------------------------------------------------- the worker


@dataclass
class BulkByScrollResponse:
    took_millis: int = 0
    total: int = 0
    created: int = 0
    updated: int = 0
    deleted: int = 0
    noops: int = 0
    batches: int = 0
    version_conflicts: int = 0
    throttled_millis: int = 0
    requests_per_second: float = -1.0
    failures: List[Dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "took": self.took_millis, "timed_out": False,
            "total": self.total, "created": self.created,
            "updated": self.updated, "deleted": self.deleted,
            "batches": self.batches, "noops": self.noops,
            "version_conflicts": self.version_conflicts,
            "retries": {"bulk": 0, "search": 0},
            "throttled_millis": self.throttled_millis,
            "requests_per_second": self.requests_per_second,
            "throttled_until_millis": 0,
            "failures": self.failures,
        }


def _scroll_batches(node, index, search_body, batch_size, task=None):
    """Lists of hits of ``index`` from a scroll snapshot, through the
    resumable drain: a context lost mid-drain re-opens at the last
    continuation point, so no batch is applied twice. A cancelled
    ``task`` stops the drain before the next batch."""
    from elasticsearch_tpu_torch.search.service import \
        resumable_scroll_batches
    for hits in resumable_scroll_batches(
            node.search_service, index, search_body, batch_size,
            keep_alive=_SCROLL_KEEPALIVE, task=task):
        if task is not None:
            task.ensure_not_cancelled()
        yield hits


def _attach(task, throttle: "_Throttle") -> None:
    """Hang the job's throttle on its task (``_rethrottle`` reaches it
    there); a cancel wakes a paused batch."""
    if task is None:
        return
    task.reindex_throttle = throttle
    listen = getattr(task, "add_cancellation_listener", None)
    if listen is not None:
        listen(throttle.wake)


def _slice_filter(slices: int, slice_id: int, hit_id: str) -> bool:
    if slices <= 1:
        return True
    from elasticsearch_tpu_torch.index.mapper import murmur3_hash
    return abs(murmur3_hash(hit_id)) % slices == slice_id


class _Throttle:
    """``requests_per_second`` pacing: after a batch of ``n_ops``, wait
    what is left of ``n_ops / rps`` (at most a second a batch). ``rps``
    is read at each batch, so ``rethrottle`` changes a running job's
    pace; it and a cancel (``wake``) end a pause early."""

    def __init__(self, rps: float):
        self.rps = rps
        self.throttled_ms = 0
        self._wake = threading.Event()

    def pause_after(self, n_ops: int, elapsed_s: float):
        if self.rps is None or self.rps <= 0:
            return
        delay = n_ops / self.rps - elapsed_s
        if delay > 0:
            t0 = time.monotonic()
            self._wake.wait(min(delay, 1.0))
            self._wake.clear()
            self.throttled_ms += int((time.monotonic() - t0) * 1000)

    def rethrottle(self, rps: float) -> None:
        self.rps = rps
        self._wake.set()

    def wake(self) -> None:
        self._wake.set()


def _parse_rps(params: Dict[str, Any]) -> float:
    raw = params.get("requests_per_second", "-1")
    if raw in ("-1", -1, "", None, "unlimited"):
        return -1.0
    return float(raw)


def reindex(node, body: Dict[str, Any], params: Dict[str, Any],
            task=None) -> BulkByScrollResponse:
    """POST /_reindex from a local source."""
    body = body or {}
    source = body.get("source") or {}
    dest = body.get("dest") or {}
    src_index = source.get("index")
    dest_index = dest.get("index")
    if not src_index or not dest_index:
        raise IllegalArgumentException(
            "_reindex requires source.index and dest.index")
    if source.get("remote"):
        raise SliceUnsupported(
            "a remote source needs the client (client/), a later slice of "
            "the port")
    if dest.get("pipeline"):
        raise SliceUnsupported("ingest pipelines are a later slice of the "
                               "port")
    if isinstance(src_index, list):
        src_index = ",".join(src_index)
    conflicts = body.get("conflicts", "abort")
    max_docs = body.get("max_docs") or body.get("size")
    op_type = dest.get("op_type", "index")
    version_type = dest.get("version_type", "internal")
    script = compile_update_script(body.get("script"))
    slices = int(params.get("slices", 1) or 1)
    slice_id = int(params.get("slice_id", 0))
    rps = _parse_rps(params)
    throttle = _Throttle(rps)
    _attach(task, throttle)

    search_body: Dict[str, Any] = {}
    if "query" in source:
        search_body["query"] = source["query"]
    if "_source" in source:
        search_body["_source"] = source["_source"]
    if version_type == "external":
        search_body["version"] = True

    resp = BulkByScrollResponse(requests_per_second=rps)
    start = time.monotonic()
    batch_size = min(int(source.get("size", _DEFAULT_BATCH)
                         or _DEFAULT_BATCH), max_docs or 10 ** 9)
    dest_idx = _ensure_dest(node, dest_index)
    done = False
    for hits in _scroll_batches(node, src_index, search_body, batch_size,
                                task):
        t_batch = time.monotonic()
        resp.batches += 1
        n_ops = 0
        for hit in hits:
            if not _slice_filter(slices, slice_id, hit["_id"]):
                continue
            if max_docs is not None and resp.total >= max_docs:
                done = True
                break
            resp.total += 1
            n_ops += 1
            doc_id = hit["_id"]
            src = dict(hit.get("_source") or {})
            op = "index"
            if script is not None:
                ctx = _Ctx(src, dest_index, doc_id, hit.get("_version", 1))
                script.run(ctx)
                op = ctx.op
                doc_id = ctx._id
                src = ctx._source._data
            if op == "noop":
                resp.noops += 1
                continue
            if op == "delete":
                r = dest_idx.delete_doc(doc_id)
                if getattr(r, "found", False):
                    resp.deleted += 1
                else:
                    resp.noops += 1
                continue
            try:
                kwargs: Dict[str, Any] = {}
                if op_type == "create":
                    kwargs["op_type"] = "create"
                if version_type == "external":
                    # write only over an older destination document
                    cur = dest_idx.get_doc(doc_id)
                    if cur.found and cur.version >= hit.get("_version", 1):
                        raise VersionConflictEngineException(
                            doc_id,
                            f"current version [{cur.version}] is higher or "
                            f"equal to the one provided "
                            f"[{hit.get('_version', 1)}]")
                r = dest_idx.index_doc(doc_id, src, **kwargs)
                if getattr(r, "created", True):
                    resp.created += 1
                else:
                    resp.updated += 1
            except VersionConflictEngineException as e:
                resp.version_conflicts += 1
                if conflicts != "proceed":
                    resp.failures.append({"index": dest_index, "id": doc_id,
                                          "cause": str(e), "status": 409})
                    done = True
                    break
        throttle.pause_after(n_ops, time.monotonic() - t_batch)
        if done:
            break
    if params.get("refresh") in ("true", True, ""):
        dest_idx.refresh()
    resp.throttled_millis = throttle.throttled_ms
    resp.took_millis = int((time.monotonic() - start) * 1000)
    return resp


def _ensure_dest(node, index: str):
    """The destination's index service: an alias's or data stream's
    write index, created from its template when it does not exist."""
    index = node.metadata_service.write_target(index)
    svc = node.indices.get(index)
    if svc is None:
        svc = node.create_index_from_template(index)
    return svc


def update_by_query(node, index: str, body: Dict[str, Any],
                    params: Dict[str, Any],
                    task=None) -> BulkByScrollResponse:
    """POST /{index}/_update_by_query: each matched document's current
    version through the script, written back under its seq_no and
    primary term (a concurrent change is a version conflict)."""
    body = body or {}
    conflicts = body.get("conflicts", "abort")
    max_docs = body.get("max_docs")
    script = compile_update_script(body.get("script"))
    rps = _parse_rps(params)
    throttle = _Throttle(rps)
    _attach(task, throttle)
    resp = BulkByScrollResponse(requests_per_second=rps)
    start = time.monotonic()
    search_body: Dict[str, Any] = {}
    if "query" in body:
        search_body["query"] = body["query"]
    idx_cache: Dict[str, Any] = {}

    def idx_for(name):
        if name not in idx_cache:
            idx_cache[name] = node.indices.require(name)
        return idx_cache[name]

    done = False
    for hits in _scroll_batches(node, index, search_body, _DEFAULT_BATCH,
                                task):
        t_batch = time.monotonic()
        resp.batches += 1
        n_ops = 0
        for hit in hits:
            if max_docs is not None and resp.total >= max_docs:
                done = True
                break
            resp.total += 1
            n_ops += 1
            target = hit.get("_index", index)
            idx = idx_for(target)
            doc_id = hit["_id"]
            current = idx.get_doc(doc_id)
            if not current.found:
                resp.version_conflicts += 1
                if conflicts != "proceed":
                    done = True
                    break
                continue
            src = dict(current.source)
            op = "index"
            if script is not None:
                ctx = _Ctx(src, target, doc_id, current.version)
                script.run(ctx)
                op = ctx.op
                src = ctx._source._data
            if op == "noop":
                resp.noops += 1
                continue
            if op == "delete":
                r = idx.delete_doc(doc_id)
                if getattr(r, "found", False):
                    resp.deleted += 1
                continue
            try:
                idx.index_doc(doc_id, src, if_seq_no=current.seq_no,
                              if_primary_term=current.primary_term)
                resp.updated += 1
            except VersionConflictEngineException as e:
                resp.version_conflicts += 1
                if conflicts != "proceed":
                    resp.failures.append({"index": target, "id": doc_id,
                                          "cause": str(e), "status": 409})
                    done = True
                    break
        throttle.pause_after(n_ops, time.monotonic() - t_batch)
        if done:
            break
    if params.get("refresh") in ("true", True, ""):
        for idx in idx_cache.values():
            idx.refresh()
    resp.throttled_millis = throttle.throttled_ms
    resp.took_millis = int((time.monotonic() - start) * 1000)
    return resp


def delete_by_query(node, index: str, body: Dict[str, Any],
                    params: Dict[str, Any],
                    task=None) -> BulkByScrollResponse:
    """POST /{index}/_delete_by_query: each matched document deleted (one
    gone meanwhile is a version conflict)."""
    body = body or {}
    if "query" not in body:
        raise IllegalArgumentException("_delete_by_query requires a query")
    conflicts = body.get("conflicts", "abort")
    max_docs = body.get("max_docs")
    rps = _parse_rps(params)
    throttle = _Throttle(rps)
    _attach(task, throttle)
    resp = BulkByScrollResponse(requests_per_second=rps)
    start = time.monotonic()
    search_body = {"query": body["query"]}
    idx_cache: Dict[str, Any] = {}
    done = False
    for hits in _scroll_batches(node, index, search_body, _DEFAULT_BATCH,
                                task):
        t_batch = time.monotonic()
        resp.batches += 1
        n_ops = 0
        for hit in hits:
            if max_docs is not None and resp.total >= max_docs:
                done = True
                break
            resp.total += 1
            n_ops += 1
            target = hit.get("_index", index)
            if target not in idx_cache:
                idx_cache[target] = node.indices.require(target)
            r = idx_cache[target].delete_doc(hit["_id"])
            if getattr(r, "found", False):
                resp.deleted += 1
            else:
                resp.version_conflicts += 1
                if conflicts != "proceed":
                    done = True
                    break
        throttle.pause_after(n_ops, time.monotonic() - t_batch)
        if done:
            break
    if params.get("refresh") in ("true", True, ""):
        for idx in idx_cache.values():
            idx.refresh()
    resp.throttled_millis = throttle.throttled_ms
    resp.took_millis = int((time.monotonic() - start) * 1000)
    return resp
