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

Served: match_all, match_none, match, multi_match, term, terms, range,
exists, ids, bool, constant_score, dis_max, boosting, knn, script_score
and function_score, over text, keyword, numeric, boolean, date and
dense_vector fields (a multi_match of a type other than most_fields
scores as best_fields, as the reference's dense path does).
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
(``{"id": ...}``) is a later slice. Range-typed, geo, ``ip`` and
``constant_keyword`` fields are refused by the mapper (a later slice),
so their branches are too. Every other query type the reference knows
raises ``SliceUnsupported`` (a typed 400); a name it does not know is a
``ParsingException``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.mapper import (KeywordFieldType,
                                                  TextFieldType)
from elasticsearch_tpu_torch.ops import bm25 as bm25_ops
from elasticsearch_tpu_torch.ops import vector as vec_ops
from elasticsearch_tpu_torch.ops.device import readback
from elasticsearch_tpu_torch.ops.plan import bm25_dense_scores_sorted
from elasticsearch_tpu_torch.ops.topk import stable_topk
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.script import (ScriptContext, _DocColumn,
                                                   as_column, compile_script)

Result = Tuple[torch.Tensor, torch.Tensor]   # (scores f32, mask bool)


class ParsingException(ValueError):
    """A malformed query body (a 400, as in the reference)."""

    error_type = "parsing_exception"


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
    """A text field's analyzed terms; on any other field the literal
    value is the one term. ``ctx`` carries the index's ``mapper``."""
    if isinstance(ctx.mapper.field_type(field), TextFieldType):
        return [t.term for t in ctx.mapper.analyzer.analyze(text)]
    return [str(text)]


def _bm25_terms(ctx, field: str, terms: List[str]) -> Result:
    """BM25 over the field's postings for the given terms (duplicates
    count twice), dense over the segment."""
    dp = ctx.device.postings.get(field)
    if dp is None:
        return _nothing(ctx)
    doc_count, avg_len = ctx.stats.field_stats(field)
    tids, weights = [], []
    for t in terms:
        df = ctx.stats.doc_freq(field, t)
        tids.append(dp.host.term_id(t))
        weights.append(bm25_ops.idf(df, doc_count) if df > 0 else 0.0)
    sel, ws = dp.select_blocks(tids, weights)
    scores = bm25_dense_scores_sorted(
        dp.block_docids, dp.block_tfs, sel, ws, dp.doc_lens, avg_len,
        ctx.k1, ctx.b, max_run=bm25_ops.scan_run_bound(len(tids)),
        mask_row=ctx.device.all_docs_row)
    return scores, scores > 0.0


def _selection(dp, ctx, term_ids) -> torch.Tensor:
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
            fields = [name for name, ft in ctx.mapper.fields.items()
                      if isinstance(ft, TextFieldType)]
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
    """Exact term: BM25 on a text field; on a keyword field BM25 with
    tf = 1 and no norms, idf/(1+k1), a constant per match; on a number,
    boolean or date a constant-score point match."""

    name = "term"

    def __init__(self, field: str, value: Any):
        super().__init__()
        self.field = field
        self.value = value

    def do_execute(self, ctx):
        ft = ctx.mapper.field_type(self.field)
        if ft is None or isinstance(ft, (TextFieldType, KeywordFieldType)):
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
        # numeric/date/boolean: point match, constant score
        col, miss = ctx.numeric_column(self.field)
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
    """Bounds on a number, boolean or date column (missing docs never
    match); an unmapped field matches nothing."""

    name = "range"

    def __init__(self, field: str, gte=None, gt=None, lte=None, lt=None):
        super().__init__()
        self.field = field
        self.gte, self.gt, self.lte, self.lt = gte, gt, lte, lt

    def do_execute(self, ctx):
        ft = ctx.mapper.field_type(self.field)
        if ft is None:
            return _nothing(ctx)
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


class ExistsQuery(QueryBuilder):
    name = "exists"

    def __init__(self, field: str):
        super().__init__()
        self.field = field

    def do_execute(self, ctx):
        dev = ctx.device
        if self.field in dev.postings:
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


class ConstantScoreQuery(QueryBuilder):
    name = "constant_score"

    def __init__(self, filter_query: QueryBuilder):
        super().__init__()
        self.filter_query = filter_query

    def do_execute(self, ctx):
        _, mask = self.filter_query.execute(ctx)
        return _constant(mask)


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


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

# the reference's other query types: each a later slice of the port
_LATER_SLICE = {
    "rank_feature",
    "geo_distance", "geo_bounding_box", "geo_polygon", "geo_shape",
    "match_phrase", "match_phrase_prefix", "match_bool_prefix", "prefix",
    "wildcard", "regexp", "fuzzy", "more_like_this", "pinned",
    "distance_feature", "query_string", "simple_query_string", "nested",
    "text_expansion", "weighted_tokens", "intervals", "span_term",
    "span_or", "span_near", "span_multi", "span_first", "span_not",
    "span_containing", "span_within", "field_masking_span",
    "span_field_masking", "terms_set", "script", "wrapper", "has_child",
    "has_parent", "parent_id", "percolate"}


def parse_query(body: Dict[str, Any]) -> QueryBuilder:
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingException(
            f"[query] malformed query, expected a single query type, got "
            f"{list(body) if isinstance(body, dict) else type(body).__name__}")
    (qtype, spec), = body.items()
    parser = _PARSERS.get(qtype)
    if parser is None:
        if qtype in _LATER_SLICE:
            raise SliceUnsupported(
                f"query [{qtype}] is a later slice of the port: this slice "
                f"serves {', '.join(sorted(_PARSERS))}")
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
                   lte=lte, lt=params.get("lt")), params)


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


def resolve_script_source(script):
    """(source, params) of an inline script; a stored-script reference
    (``{"id": ...}``) is a later slice of the port."""
    if not isinstance(script, dict):
        return str(script), {}
    if "id" in script and "source" not in script:
        raise SliceUnsupported(
            f"stored script [{script['id']}]: stored scripts are a later "
            f"slice of the port (send the script's source inline)")
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
}
