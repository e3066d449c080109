"""Query DSL (counterpart of elasticsearch_tpu/search/queries.py): JSON
query tree -> builders that execute per segment on the device.

Each builder's ``execute(ctx)`` returns ``(scores, mask)`` tensors on the
segment's device:

- ``scores`` float32 [ND_padded]: relevance (0 where unmatched or
  filter-only, as ES scores a filter-only bool 0.0);
- ``mask`` bool [ND_padded]: which docs matched.

This is the reference's dense executor: a bool query is mask algebra and
score addition over dense columns, operator-and and minimum_should_match
are clause counts (ops/bm25.py ``match_count``), BM25 text scoring is
ops/plan.py ``bm25_dense_scores_sorted`` (whose gather and contribution
run in the contribution kernel). The plan compiler (search/plan.py)
turns the trees it can into one fused launch instead and reads the same
builders as parse trees.

Served (the keys of ``_PARSERS``, which tests/test_torch_fulltext.py
holds equal to this list): bool, boosting, constant_score, dis_max,
distance_feature, exists, field_masking_span, function_score, fuzzy,
geo_bounding_box, geo_distance, geo_polygon, geo_shape, has_child,
has_parent, ids, intervals, knn, match, match_all, match_bool_prefix,
match_none, match_phrase, match_phrase_prefix, more_like_this,
multi_match, nested, parent_id, percolate, pinned, prefix,
query_string, range, rank_feature, regexp, script, script_score,
simple_query_string, span_containing, span_field_masking, span_first,
span_multi, span_near, span_not, span_or, span_term, span_within,
term, terms, terms_set, text_expansion, weighted_tokens, wildcard,
wrapper.

Over every field type of index/mapper.py (a multi_match of a type
other than most_fields scores as best_fields, as the reference's dense
path does).
term/terms/range/exists on numbers, booleans and dates compare the
float32 doc-value column (ops/device.py) with the bound rounded to
float32, as the reference's weakly typed jnp compare does. knn scores
the field's slab (ops/vector.py). script_score and function_score run
their script once over the segment's columns (search/script.py), with
cosineSimilarity, dotProduct and l2norm over the slab
(``_make_vector_fns``); an expression script_score over a plannable
query rides the plan launch instead (search/plan.py). function_score
takes script_score and weight functions, score_mode multiply or sum and
boost_mode multiply, sum or replace. A stored-script reference
(``{"id": ...}``) is a later slice.

The positional queries (the match_phrase family, intervals and the span
family) filter candidates on the device (ops/bm25.py
``conjunction_mask``, or ``match_mask`` over the leaf terms) and verify
positions on the host over the segment's token streams
(search/phrase.py, search/intervals.py). The multi-term queries
(prefix, wildcard, regexp, fuzzy) expand over the segment's term
dictionary on the host; fuzzy scores its expansions in one launch of
the dense scorer. more_like_this resolves its like-docs and picks its
terms in ``rewrite``, which the searcher and the service run before
execution. text_expansion sums its tokens' rank_features columns in
one weighted reduction (ops/features.py). None of these builders has
a plan, so they take the dense executor, as in the reference; the bool
of term queries a more_like_this rewrites into may take the plan path.
Under ``profile: true`` their host work is timed as children of the
``score`` stage: ``expand`` (the term dictionary scans), ``select``
(block selections built and uploaded), ``verify`` (the position
checks; their candidates in the ``verify_candidates`` counter) and
``upload`` (a host-computed score column sent to the device).

The field-type queries: term, range and exists answer on range fields
(containment, the ``relation``), ip (a CIDR block as a range),
constant_keyword (the constant), flattened and join (their terms) as
the reference's do. The geo queries (geo_distance, geo_bounding_box,
geo_polygon, geo_shape) are elementwise float32 masks over the
lat/lon or bounding-box columns (common/geo.py). nested filters on
the flattened index and verifies each candidate's ``_source`` objects
on the host (``_source_matches``); has_child, has_parent and parent_id
(search/join.py) and percolate (search/percolate.py) rewrite or run
against the shard in ``rewrite``. A distance_feature on a geo_point is
a 400 (the reference fails on it). A name the reference does not know
is a ``ParsingException``.

A script given by ``{"id": ...}`` resolves through the stored scripts
of the node serving the request (search/script.py ``StoredScripts``),
which its search service makes ambient for the request
(``stored_scripts``): two nodes in one process never read each other's
store. ``SliceQuery`` (a body's ``slice``) keeps the docs whose
``abs(murmur3(_id)) % max`` is the slice's id.
"""

from __future__ import annotations

import base64
import bisect
import contextlib
import contextvars
import fnmatch
import ipaddress
import json
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common import geo
from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   ParsingException,
                                                   QueryShardException)
from elasticsearch_tpu_torch.index.mapper import (ConstantKeywordFieldType,
                                                  IpFieldType,
                                                  KeywordFieldType,
                                                  RankFeatureFieldType,
                                                  ShingleSubFieldType,
                                                  TextFieldType,
                                                  _RangeFieldType,
                                                  murmur3_hash_array)
from elasticsearch_tpu_torch.ops import bm25 as bm25_ops
from elasticsearch_tpu_torch.ops import vector as vec_ops
from elasticsearch_tpu_torch.ops.device import readback
from elasticsearch_tpu_torch.ops.features import feature_plane_sum
from elasticsearch_tpu_torch.ops.plan import bm25_dense_scores_sorted
from elasticsearch_tpu_torch.ops.topk import stable_topk
from elasticsearch_tpu_torch.search import intervals
from elasticsearch_tpu_torch.search import profile as _prof
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.phrase import (phrase_prefix_freqs,
                                                   sloppy_phrase_freqs)
from elasticsearch_tpu_torch.search.script import (ScriptContext, _DocColumn,
                                                   as_column, compile_script)

Result = Tuple[torch.Tensor, torch.Tensor]   # (scores f32, mask bool)


def parse_minimum_should_match(value, n_clauses: int) -> int:
    """ES minimum_should_match forms: int, "2", "-1", "75%", "-25%"
    (ref: common/lucene/search/Queries.calculateMinShouldMatch)."""
    if value is None:
        return 0
    if isinstance(value, int):
        n = value
    else:
        s = str(value).strip()
        try:
            if s.endswith("%"):
                pct = float(s[:-1])
                n = int(n_clauses * pct / 100.0) if pct >= 0 else \
                    n_clauses + int(n_clauses * pct / 100.0)
            else:
                n = int(s)
        except ValueError:
            raise ParsingException(
                f"could not parse minimum_should_match [{value}]")
    if n < 0:
        n = n_clauses + n
    return max(0, min(n, n_clauses))


def _f32(v: float) -> float:
    """``v`` rounded to float32: a bound or key compared with a float32
    doc-value column, as the reference's jnp compare rounds it."""
    return float(np.float32(float(v)))


def _nothing(ctx) -> Result:
    z = torch.zeros(ctx.n_docs_padded, dtype=torch.float32,
                    device=ctx.device.device)
    return z, z.to(torch.bool)


def _constant(mask: torch.Tensor) -> Result:
    return mask.to(torch.float32), mask


class QueryBuilder:
    name = "?"

    def __init__(self):
        self.boost = 1.0

    def execute(self, ctx) -> Result:
        scores, mask = self.do_execute(ctx)
        if self.boost != 1.0:
            scores = scores * self.boost
        return scores, mask

    def do_execute(self, ctx) -> Result:
        raise NotImplementedError

    def can_match(self, ctx) -> bool:
        """False when no doc of the segment can match (the searcher
        skips the segment)."""
        return True

    def rewrite(self, searcher) -> "QueryBuilder":
        """The shard-level rewrite before execution (the reference's
        QueryBuilder.rewrite: more_like_this resolves its like-docs
        here). ``searcher`` has ``segments``, ``mapper`` and ``stats``.
        A rewrite never mutates the tree: a builder whose children all
        come back as themselves returns itself, any other a new node."""
        return self


class MatchAllQuery(QueryBuilder):
    name = "match_all"

    def do_execute(self, ctx):
        return _constant(ctx.all_true())


class MatchNoneQuery(QueryBuilder):
    name = "match_none"

    def do_execute(self, ctx):
        return _nothing(ctx)

    def can_match(self, ctx):
        return False


def _analyze_terms(ctx, field: str, text: str) -> List[str]:
    """A text field's terms through its search analyzer (a
    search_as_you_type shingle subfield's shingles of them); on any
    other field the literal value is the one term. ``ctx`` carries the
    index's ``mapper``."""
    ft = ctx.mapper.field_type(field)
    if isinstance(ft, TextFieldType):
        terms = ctx.mapper.search_analyzer(ft).terms(text)
        if isinstance(ft, ShingleSubFieldType):
            n = ft.shingle_size
            return [" ".join(terms[i:i + n])
                    for i in range(len(terms) - n + 1)]
        return terms
    return [str(text)]


def _text_fields(mapper) -> List[str]:
    return [name for name, ft in mapper.fields.items()
            if isinstance(ft, TextFieldType)]


def _bm25_terms(ctx, field: str, terms: List[str]) -> Result:
    """BM25 over the field's postings for the given terms (duplicates
    count twice), dense over the segment."""
    dp = ctx.device.postings.get(field)
    if dp is None:
        return _nothing(ctx)
    doc_count, _ = ctx.stats.field_stats(field)
    tids, weights = [], []
    for t in terms:
        df = ctx.stats.doc_freq(field, t)
        tids.append(dp.host.term_id(t))
        weights.append(bm25_ops.idf(df, doc_count) if df > 0 else 0.0)
    return _bm25_weighted(ctx, field, dp, tids, weights)


def _bm25_weighted(ctx, field: str, dp, tids: List[int],
                   weights: List[float]) -> Result:
    """BM25 of the term ids ``tids``, each with its own weight (its idf,
    or fuzzy's down-weighted idf), in one launch of the dense scorer
    (whose gather and contribution are the contribution kernel)."""
    _, avg_len = ctx.stats.field_stats(field)
    with _prof.span("score.select"):
        sel, ws = dp.select_blocks(tids, weights)
    scores = bm25_dense_scores_sorted(
        dp.block_docids, dp.block_tfs, sel, ws, dp.doc_lens, avg_len,
        ctx.k1, ctx.b, max_run=bm25_ops.scan_run_bound(len(tids)),
        mask_row=ctx.device.all_docs_row)
    return scores, scores > 0.0


def _selection(dp, ctx, term_ids) -> torch.Tensor:
    with _prof.span("score.select"):
        sel, _ = dp.select_blocks(term_ids, [1.0] * len(term_ids))
        return torch.from_numpy(sel).to(ctx.device.device)


class MatchQuery(QueryBuilder):
    """Analyzed full-text query; multi-term OR/AND with
    minimum_should_match."""

    name = "match"

    def __init__(self, field: str, query: str, operator: str = "or",
                 minimum_should_match: Optional[Any] = None):
        super().__init__()
        self.field = field
        self.query = query
        self.operator = operator.lower()
        self.minimum_should_match = minimum_should_match

    def do_execute(self, ctx):
        terms = _analyze_terms(ctx, self.field, self.query)
        if not terms:
            return _nothing(ctx)
        scores, mask = _bm25_terms(ctx, self.field, terms)
        required = None
        if self.operator == "and":
            required = len(terms)
        elif self.minimum_should_match:
            required = parse_minimum_should_match(
                self.minimum_should_match, len(terms))
        if required is not None and required > 1:
            dp = ctx.device.postings.get(self.field)
            if dp is None:
                return scores, mask
            uniq = sorted(set(terms))
            sels, cids = [], []
            for ci, t in enumerate(uniq):
                s, _ = dp.select_blocks([dp.host.term_id(t)], [1.0])
                sels.append(s)
                cids.append(np.full(len(s), ci, np.int32))
            dev = ctx.device.device
            counts = bm25_ops.match_count(
                dp.block_docids, dp.block_tfs,
                torch.from_numpy(np.concatenate(sels)).to(dev),
                torch.from_numpy(np.concatenate(cids)).to(dev),
                len(uniq), ctx.n_docs_padded)
            need = (len(uniq) if self.operator == "and"
                    else min(required, len(uniq)))
            mask = mask & (counts >= need)
            scores = torch.where(mask, scores, 0.0)
        return scores, mask


class MultiMatchQuery(QueryBuilder):
    """most_fields (sum of per-field match) and, for every other type,
    best_fields (dis-max over them), as the reference's dense path."""

    name = "multi_match"

    def __init__(self, fields: List[str], query: str,
                 type_: str = "best_fields", tie_breaker: float = 0.0):
        super().__init__()
        self.fields = fields
        self.query = query
        self.type = type_
        self.tie_breaker = tie_breaker

    def do_execute(self, ctx):
        fields = self.fields
        if not fields or fields == ["*"]:
            fields = _text_fields(ctx.mapper)
        if not fields:
            return _nothing(ctx)
        results = [MatchQuery(f, self.query).execute(ctx) for f in fields]
        any_mask = results[0][1]
        total = results[0][0]
        for s, m in results[1:]:
            any_mask = any_mask | m
            total = total + s
        if self.type == "most_fields":
            return total, any_mask
        best = torch.stack([s for s, _ in results]).amax(dim=0)
        if self.tie_breaker > 0.0:
            best = best + self.tie_breaker * (total - best)
        return best, any_mask


class TermQuery(QueryBuilder):
    """Exact term: BM25 on a text field; on a keyword field (a join's
    relation names and a flattened field's leaves too) BM25 with tf = 1
    and no norms, idf/(1+k1), a constant per match; on a number,
    boolean, date or ip a constant-score point match; on an ip a CIDR
    block matches its whole address range; on a range field the
    intervals that contain the value; on a constant_keyword every doc
    when the value is the constant."""

    name = "term"

    def __init__(self, field: str, value: Any):
        super().__init__()
        self.field = field
        self.value = value

    def do_execute(self, ctx):
        ft = ctx.mapper.field_type(self.field)
        if isinstance(ft, ConstantKeywordFieldType):
            if ft.value is not None and str(self.value) == ft.value:
                return _constant(ctx.all_true())
            return _nothing(ctx)
        if isinstance(ft, _RangeFieldType):
            # the intervals that contain the value
            v = _f32(ft.value_type(ft.name).parse(self.value))
            lo, miss = ctx.numeric_column(f"{self.field}.lo")
            hi, _ = ctx.numeric_column(f"{self.field}.hi")
            return _constant((~miss) & (lo <= v) & (hi >= v)
                             & ctx.all_true())
        if (ft is None or isinstance(ft, (TextFieldType, KeywordFieldType))
                or ft.docvalue_kind in ("flattened", "join")):
            dp = ctx.device.postings.get(self.field)
            if dp is None:
                return _nothing(ctx)
            term = str(self.value)
            if isinstance(ft, TextFieldType):
                # unanalyzed exact term, BM25-scored
                return _bm25_terms(ctx, self.field, [term])
            mask = bm25_ops.match_mask(
                dp.block_docids, dp.block_tfs,
                _selection(dp, ctx, [dp.host.term_id(term)]),
                ctx.n_docs_padded)
            doc_count, _ = ctx.stats.field_stats(self.field)
            df = ctx.stats.doc_freq(self.field, term)
            w = bm25_ops.idf(df, doc_count) if df else 0.0
            const = w * 1.0 / (1.0 + ctx.k1)   # tf=1, no norms
            return mask.to(torch.float32) * const, mask
        col, miss = ctx.numeric_column(self.field)
        if isinstance(ft, IpFieldType) and "/" in str(self.value):
            # a CIDR block: its first to its last address
            try:
                net = ipaddress.ip_network(str(self.value), strict=False)
            except ValueError:
                raise IllegalArgumentException(
                    f"'{self.value}' is not an IP string literal or CIDR "
                    f"block")
            lo = _f32(int(net.network_address))
            hi = _f32(int(net.broadcast_address))
            return _constant((~miss) & (col >= lo) & (col <= hi)
                             & ctx.all_true())
        # numeric/date/boolean/ip: point match, constant score
        mask = (~miss) & (col == _f32(ft.parse(self.value))) \
            & ctx.all_true()
        return _constant(mask)


class TermsQuery(QueryBuilder):
    """Any of the values, constant score 1.0."""

    name = "terms"

    def __init__(self, field: str, values: List[Any]):
        super().__init__()
        self.field = field
        self.values = values

    def do_execute(self, ctx):
        ft = ctx.mapper.field_type(self.field)
        if ft is None or isinstance(ft, (TextFieldType, KeywordFieldType)):
            dp = ctx.device.postings.get(self.field)
            if dp is None:
                return _nothing(ctx)
            tids = [dp.host.term_id(str(v)) for v in self.values]
            return _constant(bm25_ops.match_mask(
                dp.block_docids, dp.block_tfs, _selection(dp, ctx, tids),
                ctx.n_docs_padded))
        col, miss = ctx.numeric_column(self.field)
        mask = torch.zeros_like(miss)
        for v in self.values:
            mask = mask | (col == _f32(ft.parse(v)))
        return _constant(mask & (~miss) & ctx.all_true())


class RangeQuery(QueryBuilder):
    """Bounds on a number, boolean, date or ip column (missing docs never
    match); on a range field, the ``relation`` (intersects, within or
    contains) of each doc's interval to the query's. An unmapped field
    matches nothing."""

    name = "range"

    def __init__(self, field: str, gte=None, gt=None, lte=None, lt=None,
                 relation: str = "intersects"):
        super().__init__()
        self.field = field
        self.gte, self.gt, self.lte, self.lt = gte, gt, lte, lt
        self.relation = str(relation).lower()

    def do_execute(self, ctx):
        ft = ctx.mapper.field_type(self.field)
        if ft is None:
            return _nothing(ctx)
        if isinstance(ft, _RangeFieldType):
            return self._on_range_field(ctx, ft)
        col, miss = ctx.numeric_column(self.field)
        mask = (~miss) & ctx.all_true()
        if self.gte is not None:
            mask = mask & (col >= _f32(ft.parse(self.gte)))
        if self.gt is not None:
            mask = mask & (col > _f32(ft.parse(self.gt)))
        if self.lte is not None:
            mask = mask & (col <= _f32(ft.parse(self.lte)))
        if self.lt is not None:
            mask = mask & (col < _f32(ft.parse(self.lt)))
        return _constant(mask)

    def _on_range_field(self, ctx, ft) -> Result:
        """The query interval [q_lo, q_hi] (an open bound one float64
        ``nextafter`` inward, as the mapper stores one) against each
        doc's [lo, hi], compared in float32."""
        vt = ft.value_type(ft.name)
        q_lo, q_hi = -np.inf, np.inf
        if self.gte is not None:
            q_lo = float(vt.parse(self.gte))
        if self.gt is not None:
            q_lo = np.nextafter(float(vt.parse(self.gt)), np.inf)
        if self.lte is not None:
            q_hi = float(vt.parse(self.lte))
        if self.lt is not None:
            q_hi = np.nextafter(float(vt.parse(self.lt)), -np.inf)
        q_lo, q_hi = _f32(q_lo), _f32(q_hi)
        lo, miss = ctx.numeric_column(f"{self.field}.lo")
        hi, _ = ctx.numeric_column(f"{self.field}.hi")
        if self.relation == "within":
            mask = (lo >= q_lo) & (hi <= q_hi)
        elif self.relation == "contains":
            mask = (lo <= q_lo) & (hi >= q_hi)
        elif self.relation == "intersects":
            mask = (lo <= q_hi) & (hi >= q_lo)
        else:
            raise ParsingException(
                f"[range] unknown relation [{self.relation}]")
        return _constant(mask & (~miss) & ctx.all_true())


class ExistsQuery(QueryBuilder):
    name = "exists"

    def __init__(self, field: str):
        super().__init__()
        self.field = field

    def do_execute(self, ctx):
        dev = ctx.device
        ft = ctx.mapper.field_type(self.field)
        if isinstance(ft, ConstantKeywordFieldType):
            # every doc of the index has the constant
            mask = ctx.all_true()
        elif isinstance(ft, _RangeFieldType) or (
                ft is not None and ft.docvalue_kind == "geo"):
            sub = "lo" if isinstance(ft, _RangeFieldType) else "lat"
            _, miss = ctx.numeric_column(f"{self.field}.{sub}")
            mask = ~miss
        elif self.field in dev.postings:
            mask = dev.postings[self.field].doc_lens > 0
        elif self.field in dev.numerics:
            mask = ~dev.numeric_missing[self.field]
        elif self.field in dev.vectors:
            mask = dev.vectors[self.field].has_value
        else:
            return _nothing(ctx)
        return _constant(mask & ctx.all_true())


class IdsQuery(QueryBuilder):
    name = "ids"

    def __init__(self, values: List[str]):
        super().__init__()
        self.values = values

    def do_execute(self, ctx):
        m = np.zeros(ctx.n_docs_padded, bool)
        for doc_id in self.values:
            docid = ctx.segment.docid_for(str(doc_id))
            if docid >= 0:
                m[docid] = True
        return _constant(torch.from_numpy(m).to(ctx.device.device))


class BoolQuery(QueryBuilder):
    """must (scoring, required), filter (required, not scoring), should
    (scoring, optional unless no must/filter), must_not (excluded),
    composed as mask algebra over dense columns."""

    name = "bool"

    def __init__(self, must=None, filter=None, should=None, must_not=None,
                 minimum_should_match: Optional[Any] = None):
        super().__init__()
        self.must = must or []
        self.filter = filter or []
        self.should = should or []
        self.must_not = must_not or []
        self.minimum_should_match = minimum_should_match

    def do_execute(self, ctx):
        scores = torch.zeros(ctx.n_docs_padded, dtype=torch.float32,
                             device=ctx.device.device)
        mask = ctx.all_true()
        for q in self.must:
            s, m = q.execute(ctx)
            scores = scores + s
            mask = mask & m
        for q in self.filter:
            _, m = q.execute(ctx)
            mask = mask & m
        for q in self.must_not:
            _, m = q.execute(ctx)
            mask = mask & (~m)
        if self.should:
            should_results = [q.execute(ctx) for q in self.should]
            for s, _ in should_results:
                scores = scores + s
            if self.minimum_should_match is None:
                msm = 1 if not (self.must or self.filter) else 0
            else:
                msm = parse_minimum_should_match(
                    self.minimum_should_match, len(self.should))
            if msm > 0:
                count = torch.zeros(ctx.n_docs_padded, dtype=torch.int32,
                                    device=ctx.device.device)
                for _, m in should_results:
                    count = count + m.to(torch.int32)
                mask = mask & (count >= msm)
        # after every clause: the boost multiplies in execute()
        scores = torch.where(mask, scores, 0.0)
        return scores, mask

    def rewrite(self, searcher):
        clauses = [[q.rewrite(searcher) for q in group] for group in
                   (self.must, self.filter, self.should, self.must_not)]
        if all(a is b for new, old in zip(clauses, (
                self.must, self.filter, self.should, self.must_not))
               for a, b in zip(new, old)):
            return self
        must, filt, should, must_not = clauses
        q = BoolQuery(must=must, filter=filt, should=should,
                      must_not=must_not,
                      minimum_should_match=self.minimum_should_match)
        q.boost = self.boost
        return q


class ConstantScoreQuery(QueryBuilder):
    name = "constant_score"

    def __init__(self, filter_query: QueryBuilder):
        super().__init__()
        self.filter_query = filter_query

    def do_execute(self, ctx):
        _, mask = self.filter_query.execute(ctx)
        return _constant(mask)

    def rewrite(self, searcher):
        inner = self.filter_query.rewrite(searcher)
        if inner is self.filter_query:
            return self
        q = ConstantScoreQuery(inner)
        q.boost = self.boost
        return q


class DisMaxQuery(QueryBuilder):
    name = "dis_max"

    def __init__(self, queries: List[QueryBuilder], tie_breaker: float = 0.0):
        super().__init__()
        self.queries = queries
        self.tie_breaker = tie_breaker

    def do_execute(self, ctx):
        results = [q.execute(ctx) for q in self.queries]
        mask = results[0][1]
        total = results[0][0]
        for s, m in results[1:]:
            mask = mask | m
            total = total + s
        best = torch.stack([s for s, _ in results]).amax(dim=0)
        if self.tie_breaker > 0.0:
            best = best + self.tie_breaker * (total - best)
        return torch.where(mask, best, 0.0), mask

    def rewrite(self, searcher):
        queries = [q.rewrite(searcher) for q in self.queries]
        if all(a is b for a, b in zip(queries, self.queries)):
            return self
        q = DisMaxQuery(queries, tie_breaker=self.tie_breaker)
        q.boost = self.boost
        return q


class BoostingQuery(QueryBuilder):
    """Demote (not exclude) the positive query's docs that match the
    negative one."""

    name = "boosting"

    def __init__(self, positive: QueryBuilder, negative: QueryBuilder,
                 negative_boost: float):
        super().__init__()
        self.positive = positive
        self.negative = negative
        self.negative_boost = negative_boost

    def do_execute(self, ctx):
        s, mask = self.positive.execute(ctx)
        _, neg = self.negative.execute(ctx)
        return torch.where(neg, s * self.negative_boost, s), mask

    def rewrite(self, searcher):
        pos = self.positive.rewrite(searcher)
        neg = self.negative.rewrite(searcher)
        if pos is self.positive and neg is self.negative:
            return self
        q = BoostingQuery(pos, neg, self.negative_boost)
        q.boost = self.boost
        return q


class KnnQuery(QueryBuilder):
    """Brute-force kNN over a dense_vector field, with the modern ES
    score transforms: cosine -> (1 + cos) / 2, dot_product ->
    (1 + dot) / 2, l2_norm -> 1 / (1 + d^2). Matches the docs with a
    vector (and the ``filter``), cut per segment to the ``k`` (else
    ``num_candidates``) best, every doc tied with the cut's score kept.
    On a quantized (bfloat16) slab the device scores only nominate: the
    top ``num_candidates`` (default 3 k) are re-scored in exact float32
    from the segment's host vectors before the cut."""

    name = "knn"

    def __init__(self, field: str, query_vector: List[float],
                 num_candidates: Optional[int] = None,
                 filter_query: Optional[QueryBuilder] = None,
                 k: Optional[int] = None):
        super().__init__()
        self.field = field
        self.query_vector = np.asarray(query_vector, np.float32)
        self.num_candidates = num_candidates
        self.filter_query = filter_query
        self.k = k

    def do_execute(self, ctx):
        dv = ctx.device.vectors.get(self.field)
        if dv is None:
            return _nothing(ctx)
        if self.query_vector.shape != (dv.dims,):
            raise ParsingException(
                f"the query vector has a different number of dimensions "
                f"[{self.query_vector.size}] than the document vectors "
                f"[{dv.dims}]")
        q = torch.from_numpy(self.query_vector).to(ctx.device.device)[None]
        scores = vec_ops.similarity_scores(q, dv.vectors, dv.sq_norms,
                                           dv.similarity)[0]
        mask = dv.has_value & ctx.all_true()
        if self.filter_query is not None:
            _, fm = self.filter_query.execute(ctx)
            mask = mask & fm
        scores = torch.where(mask, scores, 0.0)
        scores = self._exact_rerank(ctx, dv, scores)
        nd = ctx.n_docs_padded
        cut = self.k or self.num_candidates
        if cut is not None and cut < nd:
            # the k nearest per segment: the kth value of the ascending
            # order with -inf for the unmatched, every tie kept
            kth = torch.kthvalue(torch.where(mask, scores, float("-inf")),
                                 nd - int(cut) + 1).values
            mask = mask & (scores >= kth)
            scores = torch.where(mask, scores, 0.0)
        return scores, mask

    def _exact_rerank(self, ctx, dv, scores):
        """On a quantized slab, the top ``num_candidates`` by device
        score (ties to the lowest docid) get their exact float32 scores
        from the segment's host vectors, scattered back."""
        if dv.vectors.dtype == torch.float32:
            return scores
        vv = ctx.segment.vectors.get(self.field)
        if vv is None:
            return scores
        nc = int(self.num_candidates or 3 * (self.k or 1000))
        nc = min(nc, ctx.n_docs_padded)
        docids = torch.arange(scores.shape[0], dtype=torch.int32,
                              device=scores.device)
        _, ids = stable_topk(scores[None], docids[None], nc)
        ids_h = readback("search.queries.knn_rerank_ids", ids[0])
        ids_h = ids_h[ids_h < vv.vectors.shape[0]]
        exact = vec_ops.exact_rerank_scores(
            vv.vectors[ids_h], self.query_vector, dv.similarity)
        dev = scores.device
        return scores.index_put(
            (torch.from_numpy(ids_h.astype(np.int64)).to(dev),),
            torch.from_numpy(exact).to(dev))

    def rewrite(self, searcher):
        if self.filter_query is None:
            return self
        inner = self.filter_query.rewrite(searcher)
        if inner is self.filter_query:
            return self
        q = KnnQuery(self.field, self.query_vector,
                     num_candidates=self.num_candidates, filter_query=inner,
                     k=self.k)
        q.boost = self.boost
        return q


def _make_vector_fns(ctx):
    """cosineSimilarity / dotProduct / l2norm for scripts (the parity
    surface of ScoreScriptUtils.java:112-170), each one product over the
    segment's slab, scored as stored (no exact re-rank): cosine on a
    cosine slab is ``cosine_scores``; dotProduct multiplies the slab's
    norms back in; l2norm rebuilds the vectors from them."""

    def _get(field):
        dv = ctx.device.vectors.get(field)
        if dv is None:
            raise ParsingException(f"unknown vector field [{field}]")
        return dv

    def _query(query_vector):
        return torch.from_numpy(np.asarray(query_vector, np.float32)).to(
            ctx.device.device)[None]

    def cosine(query_vector, field):
        dv = _get(field)
        q = _query(query_vector)
        if dv.similarity == "cosine":
            return vec_ops.cosine_scores(q, dv.vectors)[0]
        qn = torch.linalg.vector_norm(q)
        raw = vec_ops.dot_scores(q, dv.vectors)[0]
        return raw / torch.where(dv.norms > 0, dv.norms * qn, 1.0)

    def dot(query_vector, field):
        dv = _get(field)
        raw = vec_ops.dot_scores(_query(query_vector), dv.vectors)[0]
        if dv.similarity == "cosine":   # the slab is normalized: undo
            raw = raw * dv.norms
        return raw

    def l2norm(query_vector, field):
        dv = _get(field)
        vecs = dv.vectors
        if dv.similarity == "cosine":   # float32 rows, as stored x norm
            vecs = vecs.to(torch.float32) * dv.norms[:, None]
        return torch.sqrt(torch.clamp(
            -vec_ops.l2_scores(_query(query_vector), vecs, dv.sq_norms)[0],
            min=0.0))

    return {"cosineSimilarity": cosine, "dotProduct": dot, "l2norm": l2norm}


def _script_context(ctx, params, score, mask=None) -> ScriptContext:
    """A segment's score-script context: its numeric columns (all
    missing for a field it lacks) and its vector functions."""
    def doc_columns(field):
        return _DocColumn(*ctx.numeric_column(field))
    return ScriptContext(doc_columns, params, score=score,
                         vector_fns=_make_vector_fns(ctx), mask=mask)


class ScriptScoreQuery(QueryBuilder):
    """The subquery filters, the script replaces the score (ref:
    ScriptScoreQuery.java:51,91-109), run once over the segment's
    columns; ``min_score`` drops the docs the script scores below it."""

    name = "script_score"

    def __init__(self, query: QueryBuilder, source: str,
                 params: Optional[Dict[str, Any]] = None,
                 min_score: Optional[float] = None):
        super().__init__()
        self.query = query
        self.source = source
        self.params = params or {}
        self.min_score = min_score
        self._compiled = compile_script(source)

    def do_execute(self, ctx):
        base, mask = self.query.execute(ctx)
        scores = as_column(
            self._compiled(_script_context(ctx, self.params, base, mask)),
            ctx.n_docs_padded, base.device)
        scores = torch.where(mask, scores, 0.0)
        if self.min_score is not None:
            mask = mask & (scores >= float(self.min_score))
            scores = torch.where(mask, scores, 0.0)
        return scores, mask

    def rewrite(self, searcher):
        inner = self.query.rewrite(searcher)
        if inner is self.query:
            return self
        q = ScriptScoreQuery(inner, self.source, self.params,
                             min_score=self.min_score)
        q.boost = self.boost
        return q


_FUNCTION_KEYS = {"script_score", "weight"}
_SCORE_MODES = ("multiply", "sum")
_BOOST_MODES = ("multiply", "sum", "replace")


class FunctionScoreQuery(QueryBuilder):
    """function_score with script_score and weight functions: the
    functions combine by ``score_mode`` (multiply or sum), then with the
    query's score by ``boost_mode`` (multiply, sum or replace)."""

    name = "function_score"

    def __init__(self, query: QueryBuilder, functions: List[Dict[str, Any]],
                 boost_mode: str = "multiply", score_mode: str = "multiply"):
        super().__init__()
        self.query = query
        self.functions = functions
        self.boost_mode = boost_mode
        self.score_mode = score_mode

    def do_execute(self, ctx):
        base, mask = self.query.execute(ctx)
        nd = ctx.n_docs_padded
        fn_scores = []
        for fn in self.functions:
            weight = float(fn.get("weight", 1.0))
            if "script_score" in fn:
                source, params = resolve_script_source(
                    fn["script_score"]["script"])
                val = as_column(compile_script(source)(
                    _script_context(ctx, params, base)), nd, base.device)
                fn_scores.append(val * weight)
            else:
                fn_scores.append(torch.full((nd,), weight,
                                            dtype=torch.float32,
                                            device=base.device))
        scores = base
        if fn_scores:
            combined = fn_scores[0]
            for f in fn_scores[1:]:
                combined = (combined * f if self.score_mode == "multiply"
                            else combined + f)
            if self.boost_mode == "multiply":
                scores = base * combined
            elif self.boost_mode == "sum":
                scores = base + combined
            else:
                scores = combined
        return torch.where(mask, scores, 0.0), mask

    def rewrite(self, searcher):
        inner = self.query.rewrite(searcher)
        if inner is self.query:
            return self
        q = FunctionScoreQuery(inner, self.functions,
                               boost_mode=self.boost_mode,
                               score_mode=self.score_mode)
        q.boost = self.boost
        return q


# ---------------------------------------------------------------------------
# positional queries: the token streams (index/segment.py TokenStreams)
# and search/phrase.py; a device conjunction filter, then the positions
# verified on the host over the surviving candidates only
# ---------------------------------------------------------------------------

def _conjunction_mask(ctx, field: str, tids: List[int]) -> np.ndarray:
    """Host bool [n_docs] of the segment's docs that hold every term id
    of ``tids``: ``conjunction_mask`` on the device, read back once."""
    dp = ctx.device.postings.get(field)
    if dp is None:
        return np.zeros(ctx.segment.n_docs, bool)
    with _prof.span("score.select"):
        sels, cids = [], []
        for ci, tid in enumerate(tids):
            s, _ = dp.select_blocks([tid], [1.0])
            sels.append(s)
            cids.append(np.full(len(s), ci, np.int32))
        dev = ctx.device.device
        sel = torch.from_numpy(np.concatenate(sels)).to(dev)
        cid = torch.from_numpy(np.concatenate(cids)).to(dev)
    mask = bm25_ops.conjunction_mask(dp.block_docids, dp.block_tfs, sel, cid,
                                     len(tids), ctx.n_docs_padded)
    return readback("search.queries.conjunction_mask",
                    mask[: ctx.segment.n_docs])


def _phrase_scores_from_freqs(ctx, field: str, cand: np.ndarray,
                              freqs: np.ndarray,
                              idf_weight: float) -> Result:
    """BM25 with tf = the phrase frequency (Lucene's PhraseWeight: the
    member terms' idfs summed, the field's norms), computed on the host
    in float32 as the reference's numpy does, scattered into a column
    and uploaded once."""
    pf = ctx.segment.postings[field]
    keep = freqs > 0
    cand, freqs = cand[keep], freqs[keep]
    if len(cand) == 0:
        return _nothing(ctx)
    _, avg_len = ctx.stats.field_stats(field)
    dl = pf.field_lengths[cand]
    tf = freqs.astype(np.float32)
    norm = ctx.k1 * (1.0 - ctx.b + ctx.b * dl / max(avg_len, 1e-9))
    with _prof.span("score.upload"):
        scores_np = np.zeros(ctx.n_docs_padded, np.float32)
        scores_np[cand] = idf_weight * tf / (tf + norm)
        scores = torch.from_numpy(scores_np).to(ctx.device.device)
    return scores, scores > 0.0


def _candidates(ctx, field: str, tids: List[int]) -> np.ndarray:
    """Docids holding every term of ``tids`` (sorted unique ids)."""
    return np.nonzero(_conjunction_mask(ctx, field, sorted(set(tids))))[0]


def _phrase_idf(ctx, field: str, terms) -> float:
    doc_count, _ = ctx.stats.field_stats(field)
    return sum(bm25_ops.idf(ctx.stats.doc_freq(field, t), doc_count)
               for t in set(terms))


class MatchPhraseQuery(QueryBuilder):
    """The terms in order at consecutive positions, or within ``slop``
    moves (Lucene's PhraseQuery): the device's conjunction filter over
    the phrase's terms, then position verification on the host over
    only the surviving candidates' token streams (search/phrase.py). A
    one-term phrase is that term's BM25."""

    name = "match_phrase"

    def __init__(self, field: str, query: str, slop: int = 0):
        super().__init__()
        self.field = field
        self.query = query
        self.slop = slop

    def do_execute(self, ctx):
        terms = _analyze_terms(ctx, self.field, self.query)
        if not terms:
            return _nothing(ctx)
        if len(terms) == 1:
            return _bm25_terms(ctx, self.field, terms)
        seg = ctx.segment
        pf = seg.postings.get(self.field)
        ts = seg.streams.get(self.field)
        if pf is None or ts is None:
            return _nothing(ctx)
        tids = [pf.term_id(t) for t in terms]
        if any(t < 0 for t in tids):
            return _nothing(ctx)   # a missing term cannot complete it
        cand = _candidates(ctx, self.field, tids)
        if len(cand) == 0:
            return _nothing(ctx)
        _prof.add("verify_candidates", len(cand))
        with _prof.span("score.verify"):
            freqs = sloppy_phrase_freqs(ts.tokens[cand], ts.lengths[cand],
                                        tids, self.slop)
        return _phrase_scores_from_freqs(
            ctx, self.field, cand, freqs,
            _phrase_idf(ctx, self.field, terms))


class MatchPhrasePrefixQuery(QueryBuilder):
    """A phrase whose last token is a prefix, expanded over the
    segment's term dictionary (at most ``max_expansions``, default 50);
    the expansion slot's idf comes from the expansions' doc frequencies
    summed over the shard. A one-token query matches the expansions at
    constant score 1.0."""

    name = "match_phrase_prefix"

    def __init__(self, field: str, query: str, max_expansions: int = 50,
                 slop: int = 0):
        super().__init__()
        self.field = field
        self.query = query
        self.max_expansions = max_expansions
        self.slop = slop

    def do_execute(self, ctx):
        terms = _analyze_terms(ctx, self.field, self.query)
        if not terms:
            return _nothing(ctx)
        seg = ctx.segment
        pf = seg.postings.get(self.field)
        ts = seg.streams.get(self.field)
        if pf is None or ts is None:
            return _nothing(ctx)
        *fixed, last = terms
        with _prof.span("score.expand"):
            exp = _expand_prefix(pf.terms, last, self.max_expansions)
        if not exp:
            return _nothing(ctx)
        exp_ids = [pf.term_id(t) for t in exp]
        if not fixed:
            dp = ctx.device.postings[self.field]
            return _constant(bm25_ops.match_mask(
                dp.block_docids, dp.block_tfs, _selection(dp, ctx, exp_ids),
                ctx.n_docs_padded))
        tids = [pf.term_id(t) for t in fixed]
        if any(t < 0 for t in tids):
            return _nothing(ctx)
        cand = _candidates(ctx, self.field, tids)
        if len(cand) == 0:
            return _nothing(ctx)
        _prof.add("verify_candidates", len(cand))
        with _prof.span("score.verify"):
            if self.slop > 0:
                freqs = sloppy_phrase_freqs(
                    ts.tokens[cand], ts.lengths[cand], tids, self.slop,
                    last_alternatives=exp_ids)
            else:
                freqs = phrase_prefix_freqs(ts.tokens[cand], tids, exp_ids)
        doc_count, _ = ctx.stats.field_stats(self.field)
        w = _phrase_idf(ctx, self.field, fixed)
        # the expansion slot at shard-level statistics, as the fixed
        # terms' idfs (a segment's own df would skew per segment)
        df_union = min(doc_count, sum(ctx.stats.doc_freq(self.field, t)
                                      for t in exp))
        w += bm25_ops.idf(max(df_union, 1), doc_count)
        return _phrase_scores_from_freqs(ctx, self.field, cand, freqs, w)


class MatchBoolPrefixQuery(QueryBuilder):
    """A bool OR of the analyzed terms, the last one a prefix: BM25 of
    the others plus the prefix's constant 1.0."""

    name = "match_bool_prefix"

    def __init__(self, field: str, query: str, max_expansions: int = 50):
        super().__init__()
        self.field = field
        self.query = query
        self.max_expansions = max_expansions

    def do_execute(self, ctx):
        terms = _analyze_terms(ctx, self.field, self.query)
        if not terms:
            return _nothing(ctx)
        *fixed, last = terms
        scores, mask = (_bm25_terms(ctx, self.field, fixed) if fixed
                        else _nothing(ctx))
        ps, pm = PrefixQuery(self.field, last,
                             max_expansions=self.max_expansions).execute(ctx)
        return scores + ps, mask | pm


# ---------------------------------------------------------------------------
# multi-term queries: expanded over the segment's term dictionary on the
# host, matched at constant score (Lucene's CONSTANT_SCORE_REWRITE)
# ---------------------------------------------------------------------------

MAX_TERM_EXPANSIONS = 1024  # indices.query.bool.max_clause_count


def _expand_prefix(terms: List[str], prefix: str, cap: int) -> List[str]:
    lo = bisect.bisect_left(terms, prefix)
    out = []
    for i in range(lo, len(terms)):
        if not terms[i].startswith(prefix):
            break
        out.append(terms[i])
        if len(out) >= cap:
            break
    return out


def _expand_regex(terms: List[str], pattern, cap: int) -> List[str]:
    out = []
    for t in terms:
        if pattern.fullmatch(t):
            out.append(t)
            if len(out) >= cap:
                break
    return out


def _edit_distance_within(a: str, b: str, k: int) -> int:
    """The optimal string alignment distance of ``a`` and ``b`` (an
    adjacent transposition is ONE edit, Lucene fuzzy's default
    ``transpositions: true``) when it is <= k, else k + 1, stopping as
    soon as a row exceeds k."""
    la, lb = len(a), len(b)
    if abs(la - lb) > k:
        return k + 1
    prev2: Optional[List[int]] = None
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        row_min = cur[0]
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            d = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if (prev2 is not None and i > 1 and j > 1
                    and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]):
                d = min(d, prev2[j - 2] + 1)
            cur[j] = d
            row_min = min(row_min, d)
        if row_min > k:
            return k + 1
        prev2, prev = prev, cur
    return prev[lb]


def resolve_fuzziness(fuzziness, term: str) -> int:
    """The edits a fuzziness allows for ``term``: an int, "AUTO" (0
    edits below 3 characters, 1 below 6, else 2) or "AUTO:low,high"."""
    if fuzziness is None or (isinstance(fuzziness, str)
                             and fuzziness.upper().startswith("AUTO")):
        low, high = 3, 6
        if isinstance(fuzziness, str) and ":" in fuzziness:
            try:
                low, high = (int(x)
                             for x in fuzziness.split(":")[1].split(","))
            except ValueError:
                pass
        n = len(term)
        return 0 if n < low else (1 if n < high else 2)
    return int(fuzziness)


class _MultiTermQuery(QueryBuilder):
    """Expanded per segment against the term dictionary; any expansion
    matches, at constant score 1.0."""

    def __init__(self, field: str):
        super().__init__()
        self.field = field

    def expand(self, terms: List[str]) -> List[str]:
        raise NotImplementedError

    def do_execute(self, ctx):
        dp = ctx.device.postings.get(self.field)
        if dp is None:
            return _nothing(ctx)
        with _prof.span("score.expand"):
            expanded = self.expand(dp.host.terms)
        if not expanded:
            return _nothing(ctx)
        tids = [dp.host.term_id(t) for t in expanded]
        return _constant(bm25_ops.match_mask(
            dp.block_docids, dp.block_tfs, _selection(dp, ctx, tids),
            ctx.n_docs_padded))


class PrefixQuery(_MultiTermQuery):
    name = "prefix"

    def __init__(self, field: str, value: str,
                 max_expansions: int = MAX_TERM_EXPANSIONS):
        super().__init__(field)
        self.value = str(value)
        self.max_expansions = max_expansions

    def expand(self, terms):
        return _expand_prefix(terms, self.value, self.max_expansions)


class WildcardQuery(_MultiTermQuery):
    """``*`` any sequence, ``?`` any one character; the literal prefix
    before the first wildcard narrows the scan."""

    name = "wildcard"

    def __init__(self, field: str, value: str):
        super().__init__(field)
        self.value = str(value)
        self._re = re.compile("".join(
            ".*" if c == "*" else "." if c == "?" else re.escape(c)
            for c in self.value))

    def expand(self, terms):
        lit = re.split(r"[*?]", self.value, maxsplit=1)[0]
        if lit:
            cands = _expand_prefix(terms, lit, len(terms))
            return [t for t in cands
                    if self._re.fullmatch(t)][:MAX_TERM_EXPANSIONS]
        return _expand_regex(terms, self._re, MAX_TERM_EXPANSIONS)


class RegexpQuery(_MultiTermQuery):
    """A regular expression anchored at both ends of the term."""

    name = "regexp"

    def __init__(self, field: str, value: str):
        super().__init__(field)
        try:
            self._re = re.compile(str(value))
        except re.error as e:
            raise ParsingException(f"invalid regexp [{value}]: {e}")

    def expand(self, terms):
        return _expand_regex(terms, self._re, MAX_TERM_EXPANSIONS)


class FuzzyQuery(QueryBuilder):
    """The terms within the fuzziness of ``value`` (Lucene's FuzzyQuery
    with its blended rewrite): the expansions, nearest first then by
    term, at most ``max_expansions``, score as down-weighted synonyms in
    ONE launch of the dense scorer, weight = idf x (1 - distance /
    length)."""

    name = "fuzzy"

    def __init__(self, field: str, value: str, fuzziness=None,
                 prefix_length: int = 0, max_expansions: int = 50):
        super().__init__()
        self.field = field
        self.value = str(value)
        self.fuzziness = fuzziness
        self.prefix_length = prefix_length
        self.max_expansions = max_expansions

    def matching_terms(self, terms: List[str]) -> List[Tuple[str, int]]:
        k = resolve_fuzziness(self.fuzziness, self.value)
        pre = self.value[: self.prefix_length]
        cands = _expand_prefix(terms, pre, len(terms)) if pre else terms
        out = []
        for t in cands:
            d = _edit_distance_within(self.value, t, k)
            if d <= k:
                out.append((t, d))
        out.sort(key=lambda td: (td[1], td[0]))
        return out[: self.max_expansions]

    def do_execute(self, ctx):
        dp = ctx.device.postings.get(self.field)
        if dp is None:
            return _nothing(ctx)
        with _prof.span("score.expand"):
            matches = self.matching_terms(dp.host.terms)
        if not matches:
            return _nothing(ctx)
        doc_count, _ = ctx.stats.field_stats(self.field)
        tids, weights = [], []
        length = max(len(self.value), 1)
        for t, d in matches:
            df = ctx.stats.doc_freq(self.field, t)
            w = bm25_ops.idf(df, doc_count) if df > 0 else 0.0
            tids.append(dp.host.term_id(t))
            weights.append(w * (1.0 - d / length))
        return _bm25_weighted(ctx, self.field, dp, tids, weights)


# ---------------------------------------------------------------------------
# more_like_this, pinned, distance_feature
# ---------------------------------------------------------------------------

class MoreLikeThisQuery(QueryBuilder):
    """The like-texts' (and like-docs') most significant terms by tf x
    idf over the shard's statistics (Lucene's MoreLikeThis), run as an
    OR with ``minimum_should_match``. Like-docs are resolved in
    ``rewrite`` from the searcher's segments, and excluded from the
    answer unless ``include``."""

    name = "more_like_this"

    def __init__(self, fields: Optional[List[str]], like, unlike=None,
                 max_query_terms: int = 25, min_term_freq: int = 2,
                 min_doc_freq: int = 5, max_doc_freq: Optional[int] = None,
                 minimum_should_match: str = "30%", include: bool = False):
        super().__init__()
        self.fields = fields
        self.like = like if isinstance(like, list) else [like]
        self.unlike = ((unlike if isinstance(unlike, list) else [unlike])
                       if unlike else [])
        self.max_query_terms = max_query_terms
        self.min_term_freq = min_term_freq
        self.min_doc_freq = min_doc_freq
        self.max_doc_freq = max_doc_freq
        self.minimum_should_match = minimum_should_match
        self.include = include

    def rewrite(self, searcher) -> QueryBuilder:
        mapper = searcher.mapper
        fields = self.fields or _text_fields(mapper)
        like_texts: Dict[str, List[str]] = {f: [] for f in fields}
        doc_ids: List[str] = []
        for like in self.like:
            if isinstance(like, str):
                for f in fields:
                    like_texts[f].append(like)
            elif isinstance(like, dict):
                did = like.get("_id")
                doc_ids.append(did)
                for seg in searcher.segments:
                    d = seg.docid_for(did)
                    if d >= 0:
                        src = json.loads(seg.stored.source(d))
                        for f in fields:
                            v = src.get(f)
                            if isinstance(v, str):
                                like_texts[f].append(v)
                        break
        # like and unlike texts analyze with each field's index analyzer
        analyzers = {f: mapper.index_analyzer(mapper.field_type(f))
                     for f in fields}
        unlike_terms: Dict[str, set] = {f: set() for f in fields}
        for ul in self.unlike:
            if isinstance(ul, str):
                for f in fields:
                    unlike_terms[f].update(analyzers[f].terms(ul))
        scored: List[Tuple[float, str, str]] = []   # (score, field, term)
        for f in fields:
            counts: Dict[str, int] = {}
            for text in like_texts[f]:
                for t in analyzers[f].terms(text):
                    counts[t] = counts.get(t, 0) + 1
            doc_count, _ = searcher.stats.field_stats(f)
            for t, tf in counts.items():
                if tf < self.min_term_freq or t in unlike_terms[f]:
                    continue
                df = searcher.stats.doc_freq(f, t)
                if df < self.min_doc_freq:
                    continue
                if self.max_doc_freq is not None and df > self.max_doc_freq:
                    continue
                scored.append((tf * bm25_ops.idf(df, max(doc_count, 1)),
                               f, t))
        scored.sort(reverse=True)
        selected = scored[: self.max_query_terms]
        if not selected:
            return MatchNoneQuery()
        must_not: List[QueryBuilder] = []
        if doc_ids and not self.include:
            must_not.append(IdsQuery([d for d in doc_ids if d]))
        q = BoolQuery(should=[TermQuery(f, t) for _, f, t in selected],
                      must_not=must_not,
                      minimum_should_match=self.minimum_should_match)
        q.boost = self.boost
        return q

    def do_execute(self, ctx):
        raise ParsingException("more_like_this must be rewritten first")


class PinnedQuery(QueryBuilder):
    """The given ids rank above every organic hit, in list order (the
    reference's x-pack PinnedQueryBuilder): a pinned doc scores
    ``PIN_BASE - 10 x rank``."""

    name = "pinned"
    PIN_BASE = 1.0e6   # above any BM25 score; float32-exact steps of 10

    def __init__(self, ids: List[str], organic: QueryBuilder):
        super().__init__()
        self.ids = ids
        self.organic = organic

    def do_execute(self, ctx):
        scores, mask = self.organic.execute(ctx)
        pin_np = np.zeros(ctx.n_docs_padded, np.float32)
        for rank, did in enumerate(self.ids):
            d = ctx.segment.docid_for(did)
            if d >= 0:
                pin_np[d] = self.PIN_BASE - 10.0 * rank
        pins = torch.from_numpy(pin_np).to(scores.device)
        pinned = pins > 0
        return torch.where(pinned, pins, scores), mask | pinned

    def rewrite(self, searcher):
        organic = self.organic.rewrite(searcher)
        if organic is self.organic:
            return self
        q = PinnedQuery(self.ids, organic)
        q.boost = self.boost
        return q


class DistanceFeatureQuery(QueryBuilder):
    """A score that decays with the distance of a numeric or date
    column from ``origin``: pivot / (pivot + |value - origin|), in
    float32 over the doc-value column; docs without a value do not
    match. A geo_point origin, or a geo_point field, is refused with a
    400: the reference's query reads the field as one numeric column
    and fails on a geo field with a 500 (ROADMAP Queue 3)."""

    name = "distance_feature"

    def __init__(self, field: str, origin, pivot):
        super().__init__()
        if isinstance(origin, (dict, list, tuple)):
            raise IllegalArgumentException(
                f"[distance_feature] on a geo_point origin [{origin}] is "
                f"not supported (numeric and date fields are)")
        self.field = field
        self.origin = origin
        self.pivot = pivot

    def do_execute(self, ctx):
        ft = ctx.mapper.field_type(self.field)
        if ft is not None and ft.docvalue_kind == "geo":
            raise IllegalArgumentException(
                f"[distance_feature] on the geo_point field [{self.field}] "
                f"is not supported (numeric and date fields are)")
        origin = float(ft.parse(self.origin)) if ft else float(self.origin)
        pivot = _f32(_parse_duration_or_number(self.pivot, ft))
        col, miss = ctx.numeric_column(self.field)
        mask = (~miss) & ctx.all_true()
        dist = torch.abs(col - _f32(origin))
        # a true division (a Python number over a tensor would multiply
        # by the tensor's reciprocal)
        scores = torch.full_like(dist, pivot) / (pivot + dist)
        return torch.where(mask, scores, 0.0), mask


def _parse_duration_or_number(v, ft) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    units = {"ms": 1.0, "s": 1000.0, "m": 60_000.0, "h": 3_600_000.0,
             "d": 86_400_000.0, "w": 604_800_000.0}
    for suffix in sorted(units, key=len, reverse=True):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * units[suffix]
    return float(s)


# ---------------------------------------------------------------------------
# query_string / simple_query_string (the reference's lite grammars)
# ---------------------------------------------------------------------------

class _QueryStringParser:
    """Recursive descent over the Lucene classic QueryParser surface the
    reference serves: AND/OR/NOT (&&, ||, !), parentheses, field:term,
    quoted phrases, wildcard terms, +/- prefixes; adjacency binds with
    the default operator."""

    def __init__(self, text: str, default_field: Optional[str],
                 fields: Optional[List[str]], default_operator: str):
        self.toks = self._lex(text)
        self.i = 0
        self.default_field = default_field
        self.fields = fields
        self.default_operator = default_operator.lower()

    @staticmethod
    def _lex(text: str) -> List[str]:
        # field:"phrase" stays one token; then bare phrases, parens, words
        return re.findall(r'[+\-]?[^\s:"()]+:"[^"]*"|"[^"]*"|\(|\)|\S+',
                          text)

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.toks[self.i]
        self.i += 1
        return t

    def parse(self) -> QueryBuilder:
        q = self.parse_or()
        return MatchNoneQuery() if q is None else q

    def parse_or(self):
        clauses = [self.parse_and()]
        while True:
            nxt = self.peek()
            if nxt in ("OR", "||"):
                self.next()
                clauses.append(self.parse_and())
            elif (nxt is not None and nxt != ")"
                  and self.default_operator == "or"):
                clauses.append(self.parse_and())
            else:
                break
        clauses = [c for c in clauses if c]
        if len(clauses) <= 1:
            return clauses[0] if clauses else None
        return BoolQuery(should=clauses, minimum_should_match=1)

    def parse_and(self):
        musts = [self.parse_unary()]
        while True:
            nxt = self.peek()
            if nxt in ("AND", "&&"):
                self.next()
                musts.append(self.parse_unary())
            elif (nxt is not None and nxt not in ("OR", "||", ")")
                  and self.default_operator == "and"):
                musts.append(self.parse_unary())
            else:
                break
        musts = [m for m in musts if m]
        if len(musts) <= 1:
            return musts[0] if musts else None
        return BoolQuery(must=musts)

    def parse_unary(self):
        t = self.peek()
        if t is None or t in (")", "OR", "||", "AND", "&&"):
            return None
        if t == "NOT" or t.startswith("!"):
            if t == "NOT":
                self.next()
            else:
                self.toks[self.i] = t[1:]
            inner = self.parse_unary()
            return BoolQuery(must_not=[inner] if inner else [])
        return self.parse_atom()

    def parse_atom(self):
        t = self.next()
        if t == "(":
            q = self.parse_or()
            if self.peek() == ")":
                self.next()
            return q
        negate = False
        if t.startswith("-") and len(t) > 1:
            negate, t = True, t[1:]
        elif t.startswith("+") and len(t) > 1:
            t = t[1:]
        field = None
        if ":" in t and not t.startswith('"'):
            field, t = t.split(":", 1)
        q = self._term_query(field, t)
        return BoolQuery(must_not=[q]) if negate else q

    def _term_query(self, field: Optional[str], text: str) -> QueryBuilder:
        targets = ([field] if field
                   else self.fields if self.fields
                   else [self.default_field] if self.default_field
                   else None)
        if text.startswith('"') and text.endswith('"') and len(text) >= 2:
            phrase = text[1:-1]
            if targets and len(targets) == 1:
                return MatchPhraseQuery(targets[0], phrase)
            return MultiMatchPhrase(targets, phrase)
        if "*" in text or "?" in text:
            if targets and len(targets) == 1:
                return WildcardQuery(targets[0], text)
            return BoolQuery(should=[WildcardQuery(f, text)
                                     for f in (targets or [])],
                             minimum_should_match=1)
        if targets and len(targets) == 1:
            return MatchQuery(targets[0], text)
        return MultiMatchQuery(targets or ["*"], text)


class MultiMatchPhrase(QueryBuilder):
    """A phrase over several fields (all text fields when none),
    dis-max combined."""

    name = "multi_match_phrase"

    def __init__(self, fields: Optional[List[str]], phrase: str):
        super().__init__()
        self.fields = fields
        self.phrase = phrase

    def do_execute(self, ctx):
        fields = self.fields or _text_fields(ctx.mapper)
        results = [MatchPhraseQuery(f, self.phrase).execute(ctx)
                   for f in fields]
        if not results:
            return _nothing(ctx)
        scores = torch.stack([s for s, _ in results]).amax(dim=0)
        mask = results[0][1]
        for _, m in results[1:]:
            mask = mask | m
        return scores, mask


class QueryStringQuery(QueryBuilder):
    """Lucene query syntax, parsed once into the builders above and the
    match, multi_match and bool builders."""

    name = "query_string"

    def __init__(self, query: str, default_field: Optional[str] = None,
                 fields: Optional[List[str]] = None,
                 default_operator: str = "or"):
        super().__init__()
        self.parsed = _QueryStringParser(
            query, default_field, fields, default_operator).parse()

    def do_execute(self, ctx):
        return self.parsed.execute(ctx)

    def rewrite(self, searcher):
        parsed = self.parsed.rewrite(searcher)
        if parsed is self.parsed:
            return self
        q = QueryStringQuery.__new__(QueryStringQuery)
        QueryBuilder.__init__(q)
        q.boost = self.boost
        q.parsed = parsed
        return q


class SimpleQueryStringQuery(QueryBuilder):
    """The forgiving syntax (never a parse error): ``|`` separates OR
    groups, ``+`` requires, ``-`` excludes, a quoted phrase, a trailing
    ``*`` prefix; terms of a group combine by the default operator."""

    name = "simple_query_string"

    def __init__(self, query: str, fields: Optional[List[str]] = None,
                 default_operator: str = "or"):
        super().__init__()
        self.query = query
        self.fields = fields
        self.default_operator = default_operator.lower()

    def do_execute(self, ctx):
        toks = re.findall(r'"[^"]*"|\S+', self.query)
        must_not, should = [], []
        groups: List[List[str]] = [[]]
        for t in toks:
            if t == "|":
                groups.append([])
                continue
            groups[-1].append(t)

        def tok_query(tok: str) -> QueryBuilder:
            if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
                return MultiMatchPhrase(self.fields, tok[1:-1])
            if tok.endswith("*") and len(tok) > 1:
                fields = self.fields or ["*"]
                if fields == ["*"]:
                    fields = _text_fields(ctx.mapper)
                return BoolQuery(should=[PrefixQuery(f, tok[:-1])
                                         for f in fields],
                                 minimum_should_match=1)
            return MultiMatchQuery(self.fields or ["*"], tok)

        for group in groups:
            gclauses = []
            for tok in group:
                if tok.startswith("-") and len(tok) > 1:
                    must_not.append(tok_query(tok[1:]))
                    continue
                if tok.startswith("+") and len(tok) > 1:
                    tok = tok[1:]
                gclauses.append(tok_query(tok))
            if gclauses:
                should.append(
                    gclauses[0] if len(gclauses) == 1
                    else BoolQuery(must=gclauses)
                    if self.default_operator == "and"
                    else BoolQuery(should=gclauses, minimum_should_match=1))
        if not should and not must_not:
            return MatchAllQuery().execute(ctx)
        return BoolQuery(should=should, must_not=must_not,
                         minimum_should_match=1 if should else None
                         ).execute(ctx)


# ---------------------------------------------------------------------------
# intervals and the span family (search/intervals.py)
# ---------------------------------------------------------------------------

class IntervalsQuery(QueryBuilder):
    """Minimal-interval matching (the reference's IntervalQueryBuilder)
    with match / any_of / all_of / prefix / wildcard rules and filters;
    the span family parses onto the same rules (``_span_rule``). The
    device filters: the docs holding any leaf term (``match_mask`` per
    field, each leaf term against its own field), read back once; the
    interval algebra then checks each candidate on the host. Scored as a
    phrase: tf = the number of minimal intervals, the leaf terms' idfs
    summed."""

    name = "intervals"

    def __init__(self, field: str, rule: Dict[str, Any]):
        super().__init__()
        self.field = field
        self.rule = rule

    def _prepare(self, ctx, rule, field: Optional[str] = None):
        """(the rule with each leaf's ``_tids`` resolved in this
        segment, the leaf (field, term) pairs). ``field`` carries the
        evaluation field down the tree; a node marked ``_src_field``
        (a field_masking_span subtree) switches it."""
        field = field or self.field
        (kind, spec), = ((k, v) for k, v in rule.items() if k != "boost")
        if isinstance(spec, dict) and spec.get("_src_field"):
            field = str(spec["_src_field"])
        pf = ctx.segment.postings.get(field)
        if kind == "match":
            terms = _analyze_terms(ctx, field, str(spec.get("query", "")))
            out = dict(spec)
            out["_tids"] = [pf.term_id(t) if pf is not None else -1
                            for t in terms]
            if spec.get("filter"):
                out["filter"] = {fk: self._prepare(ctx, fr, field)[0]
                                 for fk, fr in spec["filter"].items()}
            return {"match": out}, [(field, t) for t in terms]
        if kind in ("prefix", "wildcard"):
            with _prof.span("score.expand"):
                if pf is None:
                    exp = []
                elif kind == "prefix":
                    exp = _expand_prefix(pf.terms,
                                         str(spec.get("prefix", "")), 128)
                else:   # the full pattern, capped as the prefix
                    pat = str(spec.get("pattern", ""))
                    exp = [t for t in pf.terms
                           if fnmatch.fnmatchcase(t, pat)][:128]
            out = {"_tids": [pf.term_id(t) for t in exp]}
            if isinstance(spec, dict) and spec.get("_src_field"):
                out["_src_field"] = spec["_src_field"]
            return {"prefix": out}, [(field, t) for t in exp]
        if kind in ("any_of", "all_of"):
            kids, leaf_terms = [], []
            for child in spec.get("intervals", []):
                prep, terms = self._prepare(ctx, child, field)
                kids.append(prep)
                leaf_terms.extend(terms)
            out = dict(spec)
            out["intervals"] = kids
            if spec.get("filter"):
                out["filter"] = {fk: self._prepare(ctx, fr, field)[0]
                                 for fk, fr in spec["filter"].items()}
            return {kind: out}, leaf_terms
        raise ParsingException(f"unknown intervals rule [{kind}]")

    def do_execute(self, ctx):
        seg = ctx.segment
        pf = seg.postings.get(self.field)
        if pf is None or seg.streams.get(self.field) is None:
            return _nothing(ctx)
        rule, leaf_terms = self._prepare(ctx, self.rule)
        leaf_terms = [(f, t) for f, t in leaf_terms if t]
        if not leaf_terms:
            return _nothing(ctx)
        present: Dict[str, List[int]] = {}
        for f, t in set(leaf_terms):
            pff = seg.postings.get(f)
            if pff is not None and pff.term_id(t) >= 0:
                present.setdefault(f, []).append(pff.term_id(t))
        if not present:
            return _nothing(ctx)
        cand = np.nonzero(self._any_leaf(ctx, present))[0]
        if len(cand) == 0:
            return _nothing(ctx)
        fields = ({f for f, _ in leaf_terms} | {self.field}
                  | _masked_fields(rule, set()))
        field_streams = {f: seg.streams.get(f) for f in fields}
        _prof.add("verify_candidates", len(cand))
        with _prof.span("score.verify"):
            freqs = np.zeros(len(cand), np.int64)
            for i, docid in enumerate(cand):
                rows = {f: (s.tokens[docid, : s.lengths[docid]]
                            if s is not None else ())
                        for f, s in field_streams.items()}
                freqs[i] = len(intervals.evaluate_rule(
                    rule, rows[self.field], pf.term_id, None, rows=rows))
        # each term's idf from its OWN field's statistics: a masked
        # field's df against this field's doc count could go negative
        w = sum(bm25_ops.idf(ctx.stats.doc_freq(f, t),
                             ctx.stats.field_stats(f)[0])
                for f, t in set(leaf_terms))
        return _phrase_scores_from_freqs(ctx, self.field, cand, freqs, w)

    @staticmethod
    def _any_leaf(ctx, present: Dict[str, List[int]]) -> np.ndarray:
        """Host bool [n_docs]: the docs holding any of the term ids of
        ``present`` (field -> ids), one ``match_mask`` per field."""
        mask = None
        for f in sorted(present):
            dp = ctx.device.postings[f]
            m = bm25_ops.match_mask(dp.block_docids, dp.block_tfs,
                                    _selection(dp, ctx, present[f]),
                                    ctx.n_docs_padded)
            mask = m if mask is None else mask | m
        return readback("search.queries.intervals_candidates",
                        mask[: ctx.segment.n_docs])


def _masked_fields(node, acc: set) -> set:
    """The ``_src_field`` names anywhere under ``node``: masked subtrees
    in filter position hold no scoring leaf but read their field's
    rows."""
    if isinstance(node, dict):
        if node.get("_src_field"):
            acc.add(str(node["_src_field"]))
        for v in node.values():
            _masked_fields(v, acc)
    elif isinstance(node, list):
        for v in node:
            _masked_fields(v, acc)
    return acc


class TermsSetQuery(QueryBuilder):
    """The docs that match at least ``minimum_should_match_field``'s
    value (or the script's count) of the terms, scored as the sum of
    the matched terms' scores. The script is a closed grammar, never
    run: a constant, ``params.num_terms`` or
    ``Math.min(params.num_terms, N)``; anything else requires every
    term."""

    name = "terms_set"

    def __init__(self, field: str, terms: List[str],
                 msm_field: Optional[str] = None,
                 msm_script: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.field = field
        self.terms = terms
        self.msm_field = msm_field
        self.msm_script = msm_script

    def do_execute(self, ctx):
        nd = ctx.n_docs_padded
        dev = ctx.device.device
        count = torch.zeros(nd, dtype=torch.int32, device=dev)
        total = torch.zeros(nd, dtype=torch.float32, device=dev)
        for term in self.terms:
            s, m = TermQuery(self.field, term).do_execute(ctx)
            count = count + m.to(torch.int32)
            total = total + s
        required = np.ones(nd, np.float64)
        if self.msm_field is not None:
            nv = ctx.segment.numerics.get(self.msm_field)
            if nv is not None:
                required[: ctx.segment.n_docs] = np.where(
                    nv.missing, 1, nv.values)
        elif self.msm_script is not None:
            required[:] = self._script_required()
        need = torch.from_numpy(np.maximum(required, 1)).to(dev)
        mask = count.to(torch.float64) >= need
        return torch.where(mask, total, 0.0), mask

    def _script_required(self) -> int:
        src = (self.msm_script.get("source", "")
               if isinstance(self.msm_script, dict)
               else str(self.msm_script)).strip()
        n_terms = len(self.terms)
        if src.isdigit():
            return int(src)
        if src == "params.num_terms":
            return n_terms
        m = re.fullmatch(
            r"Math\.min\(\s*params\.num_terms\s*,\s*(\d+)\s*\)", src)
        return min(n_terms, int(m.group(1))) if m else n_terms


class ScriptQuery(QueryBuilder):
    """A filter-context script over the doc values: the docs where it
    is not 0 match, at constant score 1.0."""

    name = "script"

    def __init__(self, script: Any):
        super().__init__()
        self.source, self.params = resolve_script_source(script)
        self._compiled = compile_script(self.source)

    def do_execute(self, ctx):
        def doc_columns(field):
            return _DocColumn(*ctx.numeric_column(field))
        result = as_column(
            self._compiled(ScriptContext(doc_columns, self.params)),
            ctx.n_docs_padded, ctx.device.device)
        return _constant((result != 0) & ctx.all_true())


# ---------------------------------------------------------------------------
# rank_feature and text_expansion: feature columns
# ---------------------------------------------------------------------------

class RankFeatureQuery(QueryBuilder):
    """A score from a rank_feature(s) column (the reference's
    RankFeatureQueryBuilder): saturation (the default; its pivot, when
    not given, the mean of the segment's present values), log, sigmoid
    or linear, over the float32 column; a negative score impact inverts
    the feature first. Docs without the feature do not match."""

    name = "rank_feature"

    def __init__(self, field: str, saturation=None, log=None, sigmoid=None,
                 linear=None):
        super().__init__()
        self.field = field
        self.saturation = saturation
        self.log = log
        self.sigmoid = sigmoid
        self.linear = linear

    def do_execute(self, ctx):
        col, miss = ctx.numeric_column(self.field)
        mask = (~miss) & ctx.all_true()
        ft = ctx.mapper.field_type(self.field)
        positive = (ft.positive_score_impact
                    if isinstance(ft, RankFeatureFieldType) else True)
        feat = torch.where(mask, col, 0.0)
        if not positive:
            feat = torch.where(mask, 1.0 / torch.clamp(feat, min=1e-9), 0.0)
        if self.log is not None:
            scaling = float(self.log.get("scaling_factor", 1.0))
            scores = torch.log(scaling + feat)
        elif self.sigmoid is not None:
            pivot = float(self.sigmoid["pivot"])
            exp = float(self.sigmoid["exponent"])
            scores = feat ** exp / (feat ** exp + pivot ** exp)
        elif self.linear is not None:
            scores = feat
        else:
            sat = self.saturation or {}
            if "pivot" in sat:
                pivot = float(sat["pivot"])
            else:
                # the mean of the segment's present values, from the
                # host's copy of the column the device holds (float32)
                nv = ctx.segment.numerics.get(self.field)
                vals = (nv.values[~nv.missing].astype(np.float32)
                        if nv is not None else np.zeros(0, np.float32))
                pivot = float(np.mean(vals)) if len(vals) else 1.0
            scores = feat / (feat + pivot)
        return torch.where(mask, scores, 0.0), mask


class SliceQuery(QueryBuilder):
    """A sliced scroll's partition (the reference's SliceBuilder): the
    inner query's docs whose ``abs(murmur3(_id)) % slice_max`` equals
    ``slice_id``. The hash column is built once a segment and
    ``slice_max`` (``murmur3_hash_array`` over the id column, cached on
    the segment, padded with -1) and the mask is one comparison on the
    device."""

    name = "_slice"

    def __init__(self, slice_id: int, slice_max: int, inner: QueryBuilder):
        super().__init__()
        if not 0 <= slice_id < slice_max:
            raise ParsingException(
                f"slice id [{slice_id}] must be in [0, {slice_max})")
        self.slice_id = slice_id
        self.slice_max = slice_max
        self.inner = inner

    def do_execute(self, ctx):
        scores, mask = self.inner.execute(ctx)
        col = torch.from_numpy(slice_column(
            ctx.segment, self.slice_max, ctx.n_docs_padded)).to(mask.device)
        mask = mask & (col == self.slice_id)
        return torch.where(mask, scores, 0.0), mask

    def rewrite(self, searcher):
        inner = self.inner.rewrite(searcher)
        if inner is self.inner:
            return self
        q = SliceQuery(self.slice_id, self.slice_max, inner)
        q.boost = self.boost
        return q


def slice_column(segment, slice_max: int, n_padded: int) -> np.ndarray:
    """``abs(murmur3(_id)) % slice_max`` of each doc of ``segment`` as
    int32 [n_padded] (-1 past its docs), cached on the segment for the
    last ``slice_max`` asked."""
    cached = getattr(segment, "_slice_column", None)
    if cached is None or cached[0] != slice_max or len(cached[1]) < n_padded:
        h = np.abs(murmur3_hash_array(segment.stored.ids).astype(np.int64))
        col = np.full(n_padded, -1, np.int32)
        col[: segment.n_docs] = h % slice_max
        cached = (slice_max, col)
        segment._slice_column = cached
    return cached[1][:n_padded]


class TextExpansionQuery(QueryBuilder):
    """Learned-sparse retrieval over a rank_features field: a doc scores
    the sum over the query's tokens of the token's weight x the doc's
    value of that feature. The present tokens' columns stack into a
    [T, ND] plane and sum in ONE weighted reduction on the device
    (ops/features.py ``feature_plane_sum``), never a loop over tokens.
    The token weights come with the query (no expansion model runs
    here)."""

    name = "text_expansion"

    def __init__(self, field: str, tokens: Dict[str, float]):
        super().__init__()
        self.field = field
        self.tokens = {str(t): float(w) for t, w in tokens.items()}

    def do_execute(self, ctx):
        cols, misses, weights = [], [], []
        for tok, w in self.tokens.items():
            name = f"{self.field}.{tok}"
            if name not in ctx.device.numerics:
                continue
            col, miss = ctx.numeric_column(name)
            cols.append(col)
            misses.append(miss)
            weights.append(w)
        if not cols:
            return _nothing(ctx)
        scores, present = feature_plane_sum(
            torch.stack(cols), torch.stack(misses),
            torch.from_numpy(np.asarray(weights, np.float32)).to(
                cols[0].device))
        mask = present & ctx.all_true()
        return torch.where(mask, scores, 0.0), mask



# ---------------------------------------------------------------------------
# geo queries: elementwise masks over the {field}.lat / .lon columns
# ---------------------------------------------------------------------------

class GeoDistanceQuery(QueryBuilder):
    """Docs within ``distance`` of ``origin``: the haversine distance in
    float32 over the lat/lon columns (common/geo.py), constant score."""

    name = "geo_distance"

    def __init__(self, field: str, origin, distance):
        super().__init__()
        self.field = field
        self.lat, self.lon = geo.parse_geo_point(origin)
        self.meters = geo.parse_distance(distance)

    def do_execute(self, ctx):
        lat, lat_miss = ctx.numeric_column(f"{self.field}.lat")
        lon, _ = ctx.numeric_column(f"{self.field}.lon")
        dist = geo.haversine_meters(lat, lon, self.lat, self.lon, xp=torch)
        return _constant((~lat_miss) & (dist <= _f32(self.meters))
                         & ctx.all_true())


class GeoBoundingBoxQuery(QueryBuilder):
    """Points inside a box; a box with left > right crosses the
    antimeridian."""

    name = "geo_bounding_box"

    def __init__(self, field: str, top: float, left: float, bottom: float,
                 right: float):
        super().__init__()
        self.field = field
        self.top, self.left, self.bottom, self.right = top, left, bottom, right

    def do_execute(self, ctx):
        lat, lat_miss = ctx.numeric_column(f"{self.field}.lat")
        lon, _ = ctx.numeric_column(f"{self.field}.lon")
        mask = geo.bbox_contains(lat, lon, _f32(self.top), _f32(self.left),
                                 _f32(self.bottom), _f32(self.right),
                                 xp=torch)
        return _constant(mask & (~lat_miss) & ctx.all_true())


class GeoPolygonQuery(QueryBuilder):
    """Points inside a polygon by the even-odd rule: a few elementwise
    passes over every point per edge."""

    name = "geo_polygon"

    def __init__(self, field: str, points):
        super().__init__()
        self.field = field
        pts = [geo.parse_geo_point(p) for p in points]
        if len(pts) < 3:
            raise ParsingException(
                "too few points defined for geo_polygon query")
        self.poly_lats = [p[0] for p in pts]
        self.poly_lons = [p[1] for p in pts]

    def do_execute(self, ctx):
        lat, lat_miss = ctx.numeric_column(f"{self.field}.lat")
        lon, _ = ctx.numeric_column(f"{self.field}.lon")
        mask = geo.points_in_polygon(lat, lon, self.poly_lats,
                                     self.poly_lons, xp=torch)
        return _constant(mask & (~lat_miss) & ctx.all_true())


class GeoShapeQuery(QueryBuilder):
    """The relation (intersects, disjoint, within, contains) of each
    doc's shape to the query shape, at bounding-box precision over the
    four box columns: exact for points and envelopes, a polygon's
    interior relation that of its box."""

    name = "geo_shape"

    def __init__(self, field: str, shape: Dict[str, Any],
                 relation: str = "intersects"):
        super().__init__()
        self.field = field
        self.relation = str(relation).lower()
        if self.relation not in ("intersects", "disjoint", "within",
                                 "contains"):
            raise ParsingException(f"invalid geo_shape relation [{relation}]")
        (self.q_minlat, self.q_minlon,
         self.q_maxlat, self.q_maxlon) = (
            _f32(v) for v in geo.shape_bbox(shape))

    def do_execute(self, ctx):
        minlat, miss = ctx.numeric_column(f"{self.field}.min_lat")
        minlon, _ = ctx.numeric_column(f"{self.field}.min_lon")
        maxlat, _ = ctx.numeric_column(f"{self.field}.max_lat")
        maxlon, _ = ctx.numeric_column(f"{self.field}.max_lon")
        overlaps = ~((maxlat < self.q_minlat) | (minlat > self.q_maxlat)
                     | (maxlon < self.q_minlon) | (minlon > self.q_maxlon))
        if self.relation == "intersects":
            mask = overlaps
        elif self.relation == "disjoint":
            mask = ~overlaps
        elif self.relation == "within":
            mask = ((minlat >= self.q_minlat) & (maxlat <= self.q_maxlat)
                    & (minlon >= self.q_minlon) & (maxlon <= self.q_maxlon))
        else:   # contains
            mask = ((minlat <= self.q_minlat) & (maxlat >= self.q_maxlat)
                    & (minlon <= self.q_minlon) & (maxlon >= self.q_maxlon))
        return _constant(mask & (~miss) & ctx.all_true())


# ---------------------------------------------------------------------------
# nested: flattened on the device, verified per object on the host
# ---------------------------------------------------------------------------

def _walk_source_path(node: Any, parts: List[str]) -> List[Any]:
    """A dotted-path walk that flat-maps lists at every step."""
    cur = [node]
    for part in parts:
        nxt: List[Any] = []
        for n in cur:
            for item in (n if isinstance(n, list) else [n]):
                if isinstance(item, dict) and part in item:
                    nxt.append(item[part])
        cur = nxt
    out: List[Any] = []
    for n in cur:
        out.extend(n if isinstance(n, list) else [n])
    return out


def _nested_objects(src: Dict[str, Any], path: str) -> List[Dict[str, Any]]:
    return [o for o in _walk_source_path(src, path.split("."))
            if isinstance(o, dict)]


def _obj_values(obj: Dict[str, Any], field: str, path: str) -> List[Any]:
    rel = field[len(path) + 1:] if field.startswith(path + ".") else field
    return [v for v in _walk_source_path(obj, rel.split("."))
            if v is not None]


def _as_clause_list(spec_val) -> List[Dict[str, Any]]:
    """A bool occurrence: one clause object or a list of them."""
    if spec_val is None:
        return []
    return spec_val if isinstance(spec_val, list) else [spec_val]


def _coerce_pair(ctx, field: str, have, want):
    """Both sides through the field type, so the verifier compares what
    the index compared (a long "7" with 5, a date string with millis)."""
    ft = ctx.mapper.fields.get(field) if ctx is not None else None
    if ft is not None:
        try:
            return ft.parse(have), ft.parse(want)
        except Exception:
            pass
    return have, want


def _source_matches(q: Dict[str, Any], obj: Dict[str, Any],
                    path: str, ctx=None) -> bool:
    """Whether ONE nested object of ``_source`` satisfies the inner query
    ``q``: bool, term, terms, range, match, match_all and exists are
    verified (values through the field type, match terms through the
    analyzer); any other inner query is True, keeping its flattened
    (device) answer."""
    (kind, spec), = ((k, v) for k, v in q.items() if k != "boost")
    if kind == "bool":
        for clause in ("must", "filter"):
            for c in _as_clause_list(spec.get(clause)):
                if not _source_matches(c, obj, path, ctx):
                    return False
        for c in _as_clause_list(spec.get("must_not")):
            if _source_matches(c, obj, path, ctx):
                return False
        should = _as_clause_list(spec.get("should"))
        if should and not (spec.get("must") or spec.get("filter")):
            return any(_source_matches(c, obj, path, ctx) for c in should)
        return True
    if kind == "match_all":
        return True
    if kind == "term":
        (field, body), = spec.items()
        want = body.get("value") if isinstance(body, dict) else body
        for h in _obj_values(obj, field, path):
            ch, cw = _coerce_pair(ctx, field, h, want)
            if ch == cw or str(h) == str(want):
                return True
        return False
    if kind == "terms":
        (field, wants), = ((k, v) for k, v in spec.items() if k != "boost")
        for h in _obj_values(obj, field, path):
            for w in wants:
                ch, cw = _coerce_pair(ctx, field, h, w)
                if ch == cw or str(h) == str(w):
                    return True
        return False
    if kind == "range":
        (field, body), = spec.items()
        haves = _obj_values(obj, field, path)
        if not haves:
            return False
        for have in haves:
            ok = True
            for op, cmp in (("gt", lambda a, b: a > b),
                            ("gte", lambda a, b: a >= b),
                            ("lt", lambda a, b: a < b),
                            ("lte", lambda a, b: a <= b)):
                if op not in body:
                    continue
                ch, cw = _coerce_pair(ctx, field, have, body[op])
                try:
                    if not cmp(ch, cw):
                        ok = False
                        break
                except TypeError:
                    ok = False
                    break
            if ok:
                return True
        return False
    if kind == "match":
        (field, body), = spec.items()
        text = body.get("query") if isinstance(body, dict) else body
        haves = _obj_values(obj, field, path)
        if not haves:
            return False
        if ctx is not None:
            want_tokens = set(_analyze_terms(ctx, field, str(text)))
            return any(want_tokens & set(_analyze_terms(ctx, field, str(h)))
                       for h in haves)
        want_tokens = set(str(text).lower().split())
        return any(want_tokens & set(str(h).lower().split()) for h in haves)
    if kind == "exists":
        return bool(_obj_values(obj, spec.get("field", ""), path))
    return True     # another inner query: its flattened answer stands


class NestedQuery(QueryBuilder):
    """A nested path's query. Nested objects index flattened, so the
    inner query's device mask is a candidate set: each candidate's
    ``_source`` objects at ``path`` are parsed on the host and one of
    them must satisfy the inner query (``_source_matches``). The score
    is the inner query's (``score_mode`` none scores 0); ``inner_hits``
    lists the matched objects with their offsets in the ``_source``
    array (``add_hit_fields``)."""

    name = "nested"

    def __init__(self, path: str, query_dict: Dict[str, Any],
                 score_mode: str = "avg", ignore_unmapped: bool = False,
                 inner_hits: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.path = path
        self.raw = query_dict
        self.inner = parse_query(query_dict)
        self.score_mode = score_mode
        self.ignore_unmapped = ignore_unmapped
        self.inner_hits = inner_hits
        # _id -> [(offset, object)] of the matched objects, for
        # inner_hits (a query parses per request)
        self._matched_objects: Dict[str, List] = {}

    def do_execute(self, ctx):
        if self.path not in ctx.mapper.nested_paths:
            if self.ignore_unmapped:
                return _nothing(ctx)
            raise QueryShardException(
                f"[nested] failed to find nested object under path "
                f"[{self.path}]")
        scores, mask = self.inner.execute(ctx)
        seg = ctx.segment
        with _prof.span("score.verify"):
            keep = readback("search.queries.nested_candidates",
                            mask[: seg.n_docs]).copy()
            cand = np.nonzero(keep)[0]
            _prof.add("verify_candidates", len(cand))
            for d in cand:
                src = json.loads(seg.stored.source(int(d)))
                matched = [(i, o) for i, o in
                           enumerate(_nested_objects(src, self.path))
                           if _source_matches(self.raw, o, self.path, ctx)]
                if not matched:
                    keep[d] = False
                elif self.inner_hits is not None:
                    self._matched_objects[seg.stored.ids[int(d)]] = matched
        with _prof.span("score.upload"):
            full = np.zeros(ctx.n_docs_padded, bool)
            full[: seg.n_docs] = keep
            keep_t = torch.from_numpy(full).to(ctx.device.device)
        if self.score_mode == "none":
            return torch.zeros_like(scores), keep_t
        return torch.where(keep_t, scores, 0.0), keep_t

    def add_hit_fields(self, hit: Dict[str, Any]) -> None:
        """``inner_hits``: the hit's matched nested objects (at most
        ``size``, default 3), each with its ``_nested`` offset."""
        if self.inner_hits is None:
            return
        matched = self._matched_objects.get(hit.get("_id"))
        if matched is None:
            return
        name = self.inner_hits.get("name", self.path)
        size = int(self.inner_hits.get("size", 3))
        inner = [{"_index": hit.get("_index"), "_id": hit.get("_id"),
                  "_nested": {"field": self.path, "offset": off},
                  "_score": None, "_source": obj}
                 for off, obj in matched[:size]]
        hit.setdefault("inner_hits", {})[name] = {"hits": {
            "total": {"value": len(matched), "relation": "eq"},
            "max_score": None, "hits": inner}}


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

def parse_query(body: Dict[str, Any]) -> QueryBuilder:
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingException(
            f"[query] malformed query, expected a single query type, got "
            f"{list(body) if isinstance(body, dict) else type(body).__name__}")
    (qtype, spec), = body.items()
    parser = _PARSERS.get(qtype)
    if parser is None:
        raise ParsingException(f"unknown query [{qtype}]")
    return parser(spec)


def _with_boost(q: QueryBuilder, spec) -> QueryBuilder:
    if isinstance(spec, dict) and "boost" in spec:
        q.boost = float(spec["boost"])
    return q


def _parse_match(spec):
    if not isinstance(spec, dict) or len(spec) != 1:
        raise ParsingException("[match] query malformed")
    (field, params), = spec.items()
    if isinstance(params, dict):
        q = MatchQuery(field, str(params.get("query", "")),
                       operator=params.get("operator", "or"),
                       minimum_should_match=params.get(
                           "minimum_should_match"))
        return _with_boost(q, params)
    return MatchQuery(field, str(params))


def _parse_multi_match(spec):
    return MultiMatchQuery(list(spec.get("fields", [])),
                           str(spec.get("query", "")),
                           type_=spec.get("type", "best_fields"),
                           tie_breaker=float(spec.get("tie_breaker", 0.0)))


def _parse_term(spec):
    if not isinstance(spec, dict) or len(spec) != 1:
        raise ParsingException("[term] query malformed")
    (field, params), = spec.items()
    if isinstance(params, dict):
        return _with_boost(TermQuery(field, params.get("value")), params)
    return TermQuery(field, params)


def _parse_terms(spec):
    fields = {k: v for k, v in spec.items() if k != "boost"}
    if len(fields) != 1:
        raise ParsingException("[terms] query requires exactly one field")
    (field, values), = fields.items()
    return _with_boost(TermsQuery(field, list(values)), spec)


def _parse_range(spec):
    if not isinstance(spec, dict) or len(spec) != 1:
        raise ParsingException("[range] query malformed")
    (field, params), = spec.items()
    # `from`/`to` legacy aliases
    gte = params.get("gte", params.get("from"))
    lte = params.get("lte", params.get("to"))
    return _with_boost(
        RangeQuery(field, gte=gte, gt=params.get("gt"),
                   lte=lte, lt=params.get("lt"),
                   relation=params.get("relation", "intersects")), params)


def _parse_bool(spec):
    def parse_clauses(key):
        v = spec.get(key, [])
        if isinstance(v, dict):
            v = [v]
        return [parse_query(c) for c in v]

    q = BoolQuery(
        must=parse_clauses("must"), filter=parse_clauses("filter"),
        should=parse_clauses("should"), must_not=parse_clauses("must_not"),
        minimum_should_match=spec.get("minimum_should_match"))
    return _with_boost(q, spec)


def _parse_knn(spec):
    if not isinstance(spec, dict) or "field" not in spec \
            or "query_vector" not in spec:
        raise ParsingException("[knn] requires [field] and [query_vector]")
    filt = spec.get("filter")
    return KnnQuery(spec["field"], spec["query_vector"],
                    num_candidates=spec.get("num_candidates"),
                    filter_query=parse_query(filt) if filt else None,
                    k=spec.get("k"))


# the stored scripts of the node serving the current request (a
# StoredScripts, or None outside a request)
_STORED_SCRIPTS: contextvars.ContextVar = contextvars.ContextVar(
    "stored_scripts", default=None)


@contextlib.contextmanager
def stored_scripts(store):
    """Make ``store`` the stored scripts ``{"id": ...}`` references
    resolve through, for the code run inside (one request)."""
    token = _STORED_SCRIPTS.set(store)
    try:
        yield
    finally:
        _STORED_SCRIPTS.reset(token)


def resolve_script_source(script):
    """(source, params) of an inline or a stored (``{"id": ...}``)
    script; a stored one is read from the request's node
    (``stored_scripts``)."""
    if not isinstance(script, dict):
        return str(script), {}
    if "id" in script and "source" not in script:
        store = _STORED_SCRIPTS.get()
        if store is None:
            raise ParsingException(
                f"unable to resolve stored script [{script['id']}]")
        stored = store.get(script["id"])
        if stored is None:
            raise ParsingException(
                f"unable to find script [{script['id']}]")
        return stored["source"], script.get("params", {})
    if "source" not in script:
        raise ParsingException(
            "script must specify either [source] or [id]")
    return script["source"], script.get("params", {})


def _parse_script_score(spec):
    if not isinstance(spec, dict) or "query" not in spec \
            or "script" not in spec:
        raise ParsingException("[script_score] requires [query] and "
                               "[script]")
    source, params = resolve_script_source(spec["script"])
    q = ScriptScoreQuery(parse_query(spec["query"]), source, params,
                         min_score=spec.get("min_score"))
    return _with_boost(q, spec)


def _parse_function_score(spec):
    served = {"query", "functions", "script_score", "boost_mode",
              "score_mode", "boost"}
    extra = sorted(set(spec) - served)
    if extra:
        raise SliceUnsupported(f"function_score options {extra} are a "
                               f"later slice of the port")
    inner = parse_query(spec.get("query", {"match_all": {}}))
    functions = spec.get("functions", [])
    if not functions and "script_score" in spec:
        functions = [{"script_score": spec["script_score"]}]
    for fn in functions:
        other = sorted(set(fn) - _FUNCTION_KEYS)
        if other:
            raise SliceUnsupported(
                f"function_score functions {other} are a later slice of "
                f"the port (this one takes script_score and weight)")
        if "script_score" in fn:
            source, _ = resolve_script_source(fn["script_score"]["script"])
            compile_script(source)
    score_mode = spec.get("score_mode", "multiply")
    boost_mode = spec.get("boost_mode", "multiply")
    if score_mode not in _SCORE_MODES or boost_mode not in _BOOST_MODES:
        raise SliceUnsupported(
            f"function_score score_mode [{score_mode}] / boost_mode "
            f"[{boost_mode}]: this slice takes score_mode "
            f"{list(_SCORE_MODES)} and boost_mode {list(_BOOST_MODES)}")
    return _with_boost(FunctionScoreQuery(inner, functions, boost_mode,
                                          score_mode), spec)


def _single_field_spec(spec, qname: str):
    """The one (field, params) of a spec like {"field": {...}, "boost":
    2}; anything else is a ParsingException (a 400)."""
    if not isinstance(spec, dict):
        raise ParsingException(f"[{qname}] query malformed")
    entries = [(k, v) for k, v in spec.items() if k != "boost"]
    if len(entries) != 1:
        raise ParsingException(
            f"[{qname}] query requires exactly one field, got "
            f"{[k for k, _ in entries]}")
    return entries[0]


def _parse_match_phrase(spec):
    field, params = _single_field_spec(spec, "match_phrase")
    if isinstance(params, dict):
        return _with_boost(MatchPhraseQuery(
            field, str(params.get("query", "")),
            slop=int(params.get("slop", 0))), params)
    return MatchPhraseQuery(field, str(params))


def _parse_match_phrase_prefix(spec):
    field, params = _single_field_spec(spec, "match_phrase_prefix")
    if isinstance(params, dict):
        return _with_boost(MatchPhrasePrefixQuery(
            field, str(params.get("query", "")),
            max_expansions=int(params.get("max_expansions", 50)),
            slop=int(params.get("slop", 0))), params)
    return MatchPhrasePrefixQuery(field, str(params))


def _parse_match_bool_prefix(spec):
    field, params = _single_field_spec(spec, "match_bool_prefix")
    if isinstance(params, dict):
        return _with_boost(MatchBoolPrefixQuery(
            field, str(params.get("query", "")),
            max_expansions=int(params.get("max_expansions", 50))), params)
    return MatchBoolPrefixQuery(field, str(params))


def _parse_prefix(spec):
    field, params = _single_field_spec(spec, "prefix")
    if isinstance(params, dict):
        return _with_boost(PrefixQuery(field, str(params.get("value", ""))),
                           params)
    return PrefixQuery(field, str(params))


def _parse_wildcard(spec):
    field, params = _single_field_spec(spec, "wildcard")
    if isinstance(params, dict):
        return _with_boost(WildcardQuery(
            field, str(params.get("value", params.get("wildcard", "")))),
            params)
    return WildcardQuery(field, str(params))


def _parse_regexp(spec):
    field, params = _single_field_spec(spec, "regexp")
    if isinstance(params, dict):
        return _with_boost(RegexpQuery(field, str(params.get("value", ""))),
                           params)
    return RegexpQuery(field, str(params))


def _parse_fuzzy(spec):
    field, params = _single_field_spec(spec, "fuzzy")
    if isinstance(params, dict):
        return _with_boost(FuzzyQuery(
            field, str(params.get("value", "")),
            fuzziness=params.get("fuzziness"),
            prefix_length=int(params.get("prefix_length", 0)),
            max_expansions=int(params.get("max_expansions", 50))), params)
    return FuzzyQuery(field, str(params))


def _parse_more_like_this(spec):
    return _with_boost(MoreLikeThisQuery(
        spec.get("fields"), spec.get("like", []), unlike=spec.get("unlike"),
        max_query_terms=int(spec.get("max_query_terms", 25)),
        min_term_freq=int(spec.get("min_term_freq", 2)),
        min_doc_freq=int(spec.get("min_doc_freq", 5)),
        max_doc_freq=spec.get("max_doc_freq"),
        minimum_should_match=spec.get("minimum_should_match", "30%"),
        include=bool(spec.get("include", False))), spec)


def _parse_pinned(spec):
    return _with_boost(PinnedQuery(
        list(spec.get("ids", [])),
        parse_query(spec.get("organic", {"match_all": {}}))), spec)


def _parse_distance_feature(spec):
    if not isinstance(spec, dict) or not {"field", "origin",
                                          "pivot"} <= set(spec):
        raise ParsingException(
            "[distance_feature] requires [field], [origin] and [pivot]")
    return _with_boost(DistanceFeatureQuery(spec["field"], spec["origin"],
                                            spec["pivot"]), spec)


def _parse_query_string(spec):
    if not isinstance(spec, dict):
        return QueryStringQuery(str(spec))
    return _with_boost(QueryStringQuery(
        str(spec["query"]), default_field=spec.get("default_field"),
        fields=spec.get("fields"),
        default_operator=spec.get("default_operator", "or")), spec)


def _parse_simple_query_string(spec):
    return _with_boost(SimpleQueryStringQuery(
        str(spec["query"]), fields=spec.get("fields"),
        default_operator=spec.get("default_operator", "or")), spec)


def _parse_rank_feature(spec):
    if not isinstance(spec, dict) or "field" not in spec:
        raise ParsingException("[rank_feature] requires [field]")
    return _with_boost(RankFeatureQuery(
        spec["field"], saturation=spec.get("saturation"),
        log=spec.get("log"), sigmoid=spec.get("sigmoid"),
        linear=spec.get("linear")), spec)


def _parse_intervals(spec):
    """{field: {rule..., boost?}}: the rule tree passes through (the
    span family builds the same trees, ``_span_rule``); the boost may
    sit beside the rule or beside the field."""
    field, rule = _single_field_spec(spec, "intervals")
    q = IntervalsQuery(field, rule)
    _with_boost(q, rule)
    return _with_boost(q, spec)


def _span_rule(node):
    """(field, intervals rule) of one span query."""
    (kind, body), = ((k, v) for k, v in node.items() if k != "boost")
    if kind == "span_term":
        (field, v), = body.items()
        term = v.get("value") if isinstance(v, dict) else v
        return field, {"match": {"query": str(term)}}
    if kind == "span_multi":
        # a prefix or wildcard: an any_of over the terms matching the
        # whole pattern, expanded per segment
        inner = body.get("match", {})
        if len(inner) != 1:
            raise ParsingException(
                "[span_multi] requires exactly one [match] query")
        (iq, ispec), = inner.items()
        if iq not in ("prefix", "wildcard"):
            raise ParsingException(
                f"[span_multi] unsupported inner query [{iq}]")
        if len(ispec) != 1:
            raise ParsingException(
                f"[span_multi] [{iq}] requires exactly one field")
        (field, v), = ispec.items()
        pat = v.get("value") if isinstance(v, dict) else v
        if iq == "prefix":
            return field, {"prefix": {"prefix": str(pat)}}
        return field, {"wildcard": {"pattern": str(pat)}}
    if kind in ("span_or", "span_near"):
        parts = [_span_rule(c) for c in body.get("clauses", [])]
        fields = {f for f, _ in parts}
        if len(fields) != 1:
            raise ParsingException(
                f"[{kind}] clauses must target one field")
        if kind == "span_or":
            return fields.pop(), {"any_of": {
                "intervals": [r for _, r in parts]}}
        return fields.pop(), {"all_of": {
            "intervals": [r for _, r in parts],
            "ordered": bool(body.get("in_order", True)),
            "max_gaps": int(body.get("slop", 0))}}
    if kind == "span_first":
        field, inner = _span_rule(body.get("match", {}))
        # end position < end, as a marker the evaluator applies
        return field, {"all_of": {"intervals": [inner],
                                  "_first_end": int(body.get("end", 3))}}
    if kind in ("span_not", "span_containing", "span_within"):
        keys, flt = {"span_not": (("include", "exclude"),
                                  "not_overlapping"),
                     "span_containing": (("big", "little"), "containing"),
                     "span_within": (("little", "big"), "contained_by")}[kind]
        field, kept = _span_rule(body.get(keys[0], {}))
        f2, other = _span_rule(body.get(keys[1], {}))
        if f2 != field:
            raise ParsingException(f"[{kind}] fields must match")
        return field, {"all_of": {"intervals": [kept],
                                  "filter": {flt: other}}}
    if kind in ("field_masking_span", "span_field_masking"):
        # the inner span reads ITS OWN field's positions but reports the
        # masked field, so an enclosing span_near combines spans across
        # fields of the same position structure
        inner = body.get("query")
        masked = body.get("field")
        if not inner or not masked:
            raise ParsingException(
                "[field_masking_span] requires [query] and [field]")
        src_field, rule = _span_rule(inner)
        (rk, rv), = ((k, v) for k, v in rule.items() if k != "boost")
        rv = dict(rv)
        rv["_src_field"] = src_field
        return str(masked), {rk: rv}
    raise ParsingException(f"unknown span query [{kind}]")


def _parse_span(kind):
    def parse(spec):
        field, rule = _span_rule({kind: spec})
        return _with_boost(IntervalsQuery(field, rule), spec)
    return parse


def _parse_terms_set(spec):
    field, body = _single_field_spec(spec, "terms_set")
    return _with_boost(TermsSetQuery(
        field, [str(t) for t in body.get("terms", [])],
        msm_field=body.get("minimum_should_match_field"),
        msm_script=body.get("minimum_should_match_script")), body)


def _parse_wrapper(spec):
    """base64 of a JSON query body."""
    try:
        decoded = json.loads(base64.b64decode(spec.get("query", "")))
    except Exception:       # noqa: BLE001 -- any undecodable body
        raise ParsingException("[wrapper] query must be base64-encoded JSON")
    return parse_query(decoded)


def _parse_text_expansion(spec):
    field, body = _single_field_spec(spec, "text_expansion")
    if not isinstance(body, dict):
        raise ParsingException(
            f"[text_expansion] [{field}] must be an object")
    tokens = body.get("tokens") or body.get("weighted_tokens")
    if isinstance(tokens, list):             # the weighted_tokens form
        try:
            tokens = {t["token"]: t["weight"] for t in tokens}
        except (TypeError, KeyError):
            raise ParsingException(
                "[text_expansion] weighted_tokens entries need [token] "
                "and [weight]")
    if not tokens or not isinstance(tokens, dict):
        raise ParsingException(
            "[text_expansion] requires precomputed [tokens]: no "
            "expansion model runs here")
    try:
        q = TextExpansionQuery(field, tokens)
    except (TypeError, ValueError):
        raise ParsingException(
            "[text_expansion] token weights must be numbers")
    _with_boost(q, body)
    return _with_boost(q, spec)


def _parse_geo_distance(spec):
    opts = {k: v for k, v in spec.items()
            if k in ("distance", "distance_type", "validation_method",
                     "ignore_unmapped", "boost", "_name")}
    fields = {k: v for k, v in spec.items() if k not in opts}
    if len(fields) != 1:
        raise ParsingException(
            "[geo_distance] requires exactly one point field")
    (field, origin), = fields.items()
    return _with_boost(GeoDistanceQuery(field, origin, spec["distance"]),
                       spec)


def _parse_geo_bounding_box(spec):
    fields = {k: v for k, v in spec.items()
              if k not in ("validation_method", "ignore_unmapped", "boost",
                           "_name", "type")}
    if len(fields) != 1:
        raise ParsingException("[geo_bounding_box] requires one point field")
    (field, box), = fields.items()
    if "top_left" in box:
        top, left = geo.parse_geo_point(box["top_left"])
        bottom, right = geo.parse_geo_point(box["bottom_right"])
    elif "wkt" in box:
        raise ParsingException("[geo_bounding_box] WKT envelope unsupported")
    else:
        top, left = float(box["top"]), float(box["left"])
        bottom, right = float(box["bottom"]), float(box["right"])
    return _with_boost(GeoBoundingBoxQuery(field, top, left, bottom, right),
                       spec)


def _parse_geo_polygon(spec):
    fields = {k: v for k, v in spec.items()
              if k not in ("validation_method", "ignore_unmapped", "boost",
                           "_name")}
    if len(fields) != 1:
        raise ParsingException("[geo_polygon] requires one point field")
    (field, body), = fields.items()
    return _with_boost(GeoPolygonQuery(field, body["points"]), spec)


def _parse_geo_shape(spec):
    fields = {k: v for k, v in spec.items()
              if k not in ("ignore_unmapped", "boost", "_name")}
    if len(fields) != 1:
        raise ParsingException("[geo_shape] requires one shape field")
    (field, body), = fields.items()
    if "indexed_shape" in body:
        raise ParsingException("[geo_shape] indexed_shape is unsupported")
    return _with_boost(
        GeoShapeQuery(field, body["shape"],
                      relation=body.get("relation", "intersects")), spec)


def _parse_nested(spec):
    return _with_boost(NestedQuery(
        spec["path"], spec.get("query", {"match_all": {}}),
        score_mode=spec.get("score_mode", "avg"),
        ignore_unmapped=bool(spec.get("ignore_unmapped", False)),
        inner_hits=spec.get("inner_hits")), spec)


def _parse_has_child(spec):
    from elasticsearch_tpu_torch.search.join import HasChildQuery
    return _with_boost(HasChildQuery(
        spec["type"], parse_query(spec["query"]),
        score_mode=spec.get("score_mode", "none"),
        min_children=spec.get("min_children", 1),
        max_children=spec.get("max_children"),
        ignore_unmapped=bool(spec.get("ignore_unmapped"))), spec)


def _parse_has_parent(spec):
    from elasticsearch_tpu_torch.search.join import HasParentQuery
    return _with_boost(HasParentQuery(
        spec["parent_type"], parse_query(spec["query"]),
        score=bool(spec.get("score")),
        ignore_unmapped=bool(spec.get("ignore_unmapped"))), spec)


def _parse_parent_id(spec):
    from elasticsearch_tpu_torch.search.join import ParentIdQuery
    return _with_boost(ParentIdQuery(
        spec["type"], spec["id"],
        ignore_unmapped=bool(spec.get("ignore_unmapped"))), spec)


def _parse_percolate(spec):
    from elasticsearch_tpu_torch.search.percolate import parse_percolate
    return parse_percolate(spec)


def _parse_dis_max(spec):
    queries = [parse_query(q) for q in spec.get("queries", [])]
    if not queries:
        raise ParsingException("[dis_max] requires 'queries' field with at "
                               "least one clause")
    return DisMaxQuery(queries,
                       tie_breaker=float(spec.get("tie_breaker", 0.0)))


_PARSERS = {
    "match_all": lambda spec: _with_boost(MatchAllQuery(), spec),
    "match_none": lambda spec: MatchNoneQuery(),
    "match": _parse_match,
    "multi_match": _parse_multi_match,
    "term": _parse_term,
    "terms": _parse_terms,
    "range": _parse_range,
    "exists": lambda spec: ExistsQuery(spec["field"]),
    "ids": lambda spec: IdsQuery(list(spec.get("values", []))),
    "bool": _parse_bool,
    "constant_score": lambda spec: _with_boost(
        ConstantScoreQuery(parse_query(spec["filter"])), spec),
    "dis_max": _parse_dis_max,
    "boosting": lambda spec: BoostingQuery(
        parse_query(spec["positive"]), parse_query(spec["negative"]),
        float(spec.get("negative_boost", 0.5))),
    "knn": _parse_knn,
    "script_score": _parse_script_score,
    "function_score": _parse_function_score,
    "match_phrase": _parse_match_phrase,
    "match_phrase_prefix": _parse_match_phrase_prefix,
    "match_bool_prefix": _parse_match_bool_prefix,
    "prefix": _parse_prefix,
    "wildcard": _parse_wildcard,
    "regexp": _parse_regexp,
    "fuzzy": _parse_fuzzy,
    "more_like_this": _parse_more_like_this,
    "pinned": _parse_pinned,
    "distance_feature": _parse_distance_feature,
    "query_string": _parse_query_string,
    "simple_query_string": _parse_simple_query_string,
    "intervals": _parse_intervals,
    **{kind: _parse_span(kind) for kind in (
        "span_term", "span_or", "span_near", "span_multi", "span_first",
        "span_not", "span_containing", "span_within", "field_masking_span",
        "span_field_masking")},
    "terms_set": _parse_terms_set,
    "script": lambda spec: _with_boost(ScriptQuery(spec.get("script", "")),
                                       spec),
    "wrapper": _parse_wrapper,
    "rank_feature": _parse_rank_feature,
    "text_expansion": _parse_text_expansion,
    "weighted_tokens": _parse_text_expansion,
    "geo_distance": _parse_geo_distance,
    "geo_bounding_box": _parse_geo_bounding_box,
    "geo_polygon": _parse_geo_polygon,
    "geo_shape": _parse_geo_shape,
    "nested": _parse_nested,
    "has_child": _parse_has_child,
    "has_parent": _parse_has_parent,
    "parent_id": _parse_parent_id,
    "percolate": _parse_percolate,
}
