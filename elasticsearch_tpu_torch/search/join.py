"""Parent/child join queries (counterpart of
elasticsearch_tpu/search/join.py): has_child, has_parent, parent_id.

The join runs within a shard (a child routes by its parent's id, so
parents and children share a shard: index/service.py ``index_doc``):
in ``rewrite`` the inner query executes over every segment of the
shard, the
matched docs of the wanted relation are read back, joined on the host
through the ``{field}#parent`` keyword doc values, and the query becomes
an id -> score lookup (``_IdScoreQuery``, ``_ParentRefScoreQuery``),
whose mask and scores are built on the host and uploaded. The loops
over the matched docs are the reference's, in Python.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import QueryShardException
from elasticsearch_tpu_torch.index.mapper import JoinFieldType
from elasticsearch_tpu_torch.ops.device import readback
from elasticsearch_tpu_torch.search import profile as _prof
from elasticsearch_tpu_torch.search.queries import (MatchNoneQuery,
                                                    QueryBuilder)


def _join_field(mapper) -> Optional[JoinFieldType]:
    for ft in mapper.fields.values():
        if isinstance(ft, JoinFieldType):
            return ft
    return None


def _relation_docs(seg, jf_name: str, relations: List[str]) -> np.ndarray:
    """bool [n_docs]: the docs whose (first) join relation is one of
    ``relations``."""
    kv = seg.keywords.get(jf_name)
    out = np.zeros(seg.n_docs, bool)
    if kv is None:
        return out
    for o in {kv.terms.index(r) for r in relations if r in kv.terms}:
        out |= kv.ords[: seg.n_docs] == o
    return out


def _upload(ctx, m: np.ndarray, s: np.ndarray):
    dev = ctx.device.device
    with _prof.span("score.upload"):
        return torch.from_numpy(s).to(dev), torch.from_numpy(m).to(dev)


def _matched(ctx, inner, rel: np.ndarray, site: str):
    """The inner query's (scores, mask) on the host, the mask cut to the
    live docs of the relation ``rel``."""
    scores, mask = inner.execute(ctx)
    n = ctx.segment.n_docs
    sc, m = readback(site, scores[:n], mask[:n])
    return sc, m & rel & ctx.segment.live[:n]


class _IdScoreQuery(QueryBuilder):
    """The docs whose _id is a key of ``scores``, each scoring its value:
    what has_child rewrites into."""

    name = "_id_scores"

    def __init__(self, scores: Dict[str, float]):
        super().__init__()
        self.scores = scores

    def do_execute(self, ctx):
        m = np.zeros(ctx.n_docs_padded, bool)
        s = np.zeros(ctx.n_docs_padded, np.float32)
        for doc_id, score in self.scores.items():
            d = ctx.segment.docid_for(doc_id)
            if d >= 0:
                m[d] = True
                s[d] = score
        return _upload(ctx, m, s)


class _ParentRefScoreQuery(QueryBuilder):
    """The docs of a relation in ``child_relations`` whose
    ``{field}#parent`` value is a key of ``scores``, each scoring that
    parent's value: what has_parent and parent_id rewrite into."""

    name = "_parent_ref_scores"

    def __init__(self, jf_name: str, child_relations: List[str],
                 scores: Dict[str, float]):
        super().__init__()
        self.jf_name = jf_name
        self.child_relations = child_relations
        self.scores = scores

    def do_execute(self, ctx):
        seg = ctx.segment
        rel_mask = _relation_docs(seg, self.jf_name, self.child_relations)
        kv = seg.keywords.get(f"{self.jf_name}#parent")
        m = np.zeros(ctx.n_docs_padded, bool)
        s = np.zeros(ctx.n_docs_padded, np.float32)
        if kv is not None:
            for d in np.nonzero(rel_mask)[0]:
                for pid in kv.get(int(d)):
                    if pid in self.scores:
                        m[d] = True
                        s[d] = self.scores[pid]
        return _upload(ctx, m, s)


def _score_reduce(values: List[float], mode: str) -> float:
    if mode == "none":
        return 1.0
    if mode == "sum":
        return float(sum(values))
    if mode == "avg":
        return float(sum(values) / len(values))
    if mode == "min":
        return float(min(values))
    return float(max(values))   # "max"


class HasChildQuery(QueryBuilder):
    """Parents with matching children: ``score_mode`` none (1.0), max,
    sum, avg or min over the children's scores; ``min_children`` and
    ``max_children`` bound the count."""

    name = "has_child"

    def __init__(self, child_type: str, query: QueryBuilder,
                 score_mode: str = "none", min_children: int = 1,
                 max_children: Optional[int] = None,
                 ignore_unmapped: bool = False):
        super().__init__()
        self.child_type = child_type
        self.query = query
        self.score_mode = score_mode
        self.min_children = max(1, int(min_children))
        self.max_children = max_children
        self.ignore_unmapped = ignore_unmapped

    def rewrite(self, searcher) -> QueryBuilder:
        if not hasattr(searcher, "_contexts"):
            return self     # the coordinator's rewrite: the join is the shard's
        jf = _join_field(searcher.mapper)
        if jf is None:
            if self.ignore_unmapped:
                return MatchNoneQuery()
            raise QueryShardException(
                "[has_child] no join field has been configured")
        if jf.parent_of(self.child_type) is None:
            if self.ignore_unmapped:
                return MatchNoneQuery()
            raise QueryShardException(
                f"[has_child] join relation [{self.child_type}] is not a "
                f"child of any parent")
        inner = self.query.rewrite(searcher)
        child_scores: Dict[str, List[float]] = {}
        for ctx in searcher._contexts():
            seg = ctx.segment
            kv = seg.keywords.get(f"{jf.name}#parent")
            if seg.n_docs == 0 or kv is None:
                continue
            sc, m = _matched(ctx, inner,
                             _relation_docs(seg, jf.name, [self.child_type]),
                             "search.join.has_child")
            with _prof.span("rewrite.join"):
                for d in np.nonzero(m)[0]:
                    for pid in kv.get(int(d)):
                        child_scores.setdefault(pid, []).append(float(sc[d]))
        out: Dict[str, float] = {}
        for pid, vals in child_scores.items():
            if len(vals) < self.min_children:
                continue
            if (self.max_children is not None
                    and len(vals) > int(self.max_children)):
                continue
            out[pid] = _score_reduce(vals, self.score_mode)
        q = _IdScoreQuery(out)
        q.boost = self.boost
        return q


class HasParentQuery(QueryBuilder):
    """Children whose parent matches; with ``score`` the parent's score
    passes to its children (else 1.0)."""

    name = "has_parent"

    def __init__(self, parent_type: str, query: QueryBuilder,
                 score: bool = False, ignore_unmapped: bool = False):
        super().__init__()
        self.parent_type = parent_type
        self.query = query
        self.score = score
        self.ignore_unmapped = ignore_unmapped

    def rewrite(self, searcher) -> QueryBuilder:
        if not hasattr(searcher, "_contexts"):
            return self
        jf = _join_field(searcher.mapper)
        if jf is None or not jf.children_of(self.parent_type):
            if self.ignore_unmapped:
                return MatchNoneQuery()
            raise QueryShardException(
                "[has_parent] no join field has been configured"
                if jf is None else
                f"[has_parent] join relation [{self.parent_type}] has no "
                f"children")
        inner = self.query.rewrite(searcher)
        parent_scores: Dict[str, float] = {}
        for ctx in searcher._contexts():
            seg = ctx.segment
            if seg.n_docs == 0:
                continue
            sc, m = _matched(ctx, inner,
                             _relation_docs(seg, jf.name, [self.parent_type]),
                             "search.join.has_parent")
            with _prof.span("rewrite.join"):
                for d in np.nonzero(m)[0]:
                    score = float(sc[d]) if self.score else 1.0
                    pid = seg.stored.ids[int(d)]
                    parent_scores[pid] = max(parent_scores.get(pid, 0.0),
                                             score)
        q = _ParentRefScoreQuery(jf.name, jf.children_of(self.parent_type),
                                 parent_scores)
        q.boost = self.boost
        return q


class ParentIdQuery(QueryBuilder):
    """The children of one parent doc."""

    name = "parent_id"

    def __init__(self, child_type: str, parent_id: str,
                 ignore_unmapped: bool = False):
        super().__init__()
        self.child_type = child_type
        self.parent_id = str(parent_id)
        self.ignore_unmapped = ignore_unmapped

    def rewrite(self, searcher) -> QueryBuilder:
        if not hasattr(searcher, "_contexts"):
            return self
        jf = _join_field(searcher.mapper)
        if jf is None:
            if self.ignore_unmapped:
                return MatchNoneQuery()
            raise QueryShardException(
                "[parent_id] no join field has been configured")
        q = _ParentRefScoreQuery(jf.name, [self.child_type],
                                 {self.parent_id: 1.0})
        q.boost = self.boost
        return q
