"""Percolate: reverse search (counterpart of
elasticsearch_tpu/search/percolate.py). A ``percolator`` field holds a
query in each document's ``_source``; the ``percolate`` query takes one
or more candidate documents, indexes them into an in-memory segment of
their own, and matches every stored query against it.

The candidate segment is parsed with a sandboxed copy of the index's
mapper (a field the candidates introduce never reaches the live
mapping), and it is a real DeviceSegment on the node's device: the
node's device cache admits it (the ``hbm`` breaker charges it) when the
query is rewritten on the shard, and ``release`` evicts it when the
request ends (search/service.py). Each stored query then runs on the
candidate segment's dense executor, one query phase per stored query,
in a loop on the host as the reference's (percolate reads only which
slots matched, which the dense executor answers as the plan path
would). On an index of several shards the candidate segment is built
once, at the first shard's rewrite, and every shard runs its stored
queries against it. ``resolve_percolate_refs`` replaces a document given
by ``index`` and ``id`` (and ``routing``) with its ``_source``, read
from the shard it routes to, before the query parses.
"""

from __future__ import annotations

import copy
import itertools
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   IndexNotFoundException,
                                                   QueryShardException)
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.search.queries import QueryBuilder, parse_query

_CANDIDATES = itertools.count()


def _sandbox(mapper):
    """A parse-only copy of ``mapper`` with a fields dict of its own:
    dynamic fields of the candidates stay there."""
    m = copy.copy(mapper)
    m.fields = dict(mapper.fields)
    return m


def _field_path(source: Dict[str, Any], path: str) -> Any:
    cur: Any = source
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


class PercolateQuery(QueryBuilder):
    """The stored queries of ``field`` that match any of ``documents``;
    each matching hit carries ``fields._percolator_document_slot``, the
    positions of the documents it matched (``add_hit_fields``)."""

    name = "percolate"

    def __init__(self, field: str,
                 documents: Optional[List[Dict[str, Any]]] = None):
        super().__init__()
        self.field = field
        self.documents = documents or []
        # _id of a matched stored-query doc -> the slots it matched
        self.matched_slots: Dict[str, List[int]] = {}
        self._mini = None

    def rewrite(self, searcher) -> "PercolateQuery":
        if not self.documents:
            raise IllegalArgumentException(
                "[percolate] query requires [document] or [documents]")
        if self._mini is not None or not hasattr(searcher, "cache"):
            # built once per request, on the shard (the coordinator's
            # rewrite has no device)
            return self
        from elasticsearch_tpu_torch.search.searcher import ShardSearcher
        sandbox = _sandbox(searcher.mapper)
        writer = SegmentWriter()
        for slot, doc in enumerate(self.documents):
            writer.add(sandbox.parse(f"_slot_{slot}", doc))
        seg = writer.build(f"_percolate_candidates_{next(_CANDIDATES)}")
        self._mini = ShardSearcher([seg], sandbox, searcher.cache,
                                   searcher.k1, searcher.b)
        return self

    def release(self) -> None:
        """Evict the candidate segment from the device cache (and its
        bytes from the hbm breaker)."""
        if self._mini is not None:
            self._mini.cache.evict([s.name for s in self._mini.segments])

    def do_execute(self, ctx):
        if self._mini is None:
            raise QueryShardException("[percolate] query was not rewritten")
        seg = ctx.segment
        m = np.zeros(ctx.n_docs_padded, bool)
        n_slots = len(self.documents)
        for docid in np.nonzero(seg.live[: seg.n_docs])[0]:
            spec = _field_path(json.loads(seg.stored.source(int(docid))),
                               self.field)
            if not isinstance(spec, dict):
                continue
            try:
                stored_q = parse_query(spec)
            except Exception:
                continue
            result = self._mini.query_phase(stored_q, n_slots,
                                            track_total_hits=True,
                                            allow_plan=False)
            if result.total_hits > 0:
                m[docid] = True
                self.matched_slots[seg.stored.ids[int(docid)]] = sorted(
                    d.docid for d in result.docs)
        mask = torch.from_numpy(m).to(ctx.device.device)
        return mask.to(torch.float32), mask

    def add_hit_fields(self, hit: Dict[str, Any]) -> None:
        slots = self.matched_slots.get(hit.get("_id"))
        if slots is not None:
            hit.setdefault("fields", {})["_percolator_document_slot"] = slots


def resolve_percolate_refs(query_spec: Any, indices) -> Any:
    """``query_spec`` with every ``{"percolate": {..., "index": i, "id":
    d, "routing"?: r}}`` given the document's ``_source``, read from the
    shard its id (or routing) routes to (``indices``: the node's
    IndicesService; an unknown index is a 404)."""
    if isinstance(query_spec, list):
        return [resolve_percolate_refs(x, indices) for x in query_spec]
    if not isinstance(query_spec, dict):
        return query_spec
    out = {}
    for k, v in query_spec.items():
        if (k == "percolate" and isinstance(v, dict) and "index" in v
                and "id" in v):
            svc = (indices or {}).get(v["index"])
            if svc is None:
                raise IndexNotFoundException(v["index"])
            routing = v.get("routing")
            source = svc.get_doc(str(v["id"]),
                                 None if routing is None else str(routing)
                                 ).source
            if source is None:
                raise IllegalArgumentException(
                    f"percolate document [{v['index']}/{v['id']}] not found")
            v = {key: val for key, val in v.items()
                 if key not in ("index", "id", "routing", "preference")}
            v["document"] = source
            out[k] = v
        else:
            out[k] = resolve_percolate_refs(v, indices)
    return out


def parse_percolate(spec: Dict[str, Any]) -> PercolateQuery:
    field = spec.get("field")
    if not field:
        raise IllegalArgumentException("[percolate] requires [field]")
    docs = spec.get("documents")
    if docs is None and spec.get("document") is not None:
        docs = [spec["document"]]
    return PercolateQuery(field, docs)
