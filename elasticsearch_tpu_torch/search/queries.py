"""Query DSL (counterpart of elasticsearch_tpu/search/queries.py), the
subset the plan path compiles: match, multi_match, term, terms, bool,
constant_score and dis_max over text and keyword fields.

Builders here are parse trees only. The plan compiler (search/plan.py)
turns a tree into one fused launch of ops/plan.py; the reference's dense
executor (``do_execute``, a dense [ND] score/mask pair per clause) is not
ported. Any other query name, dense clauses (range, exists, ids,
match_all) included, raises ``SliceUnsupported``: a typed 400.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported


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


class QueryBuilder:

    def __init__(self):
        self.boost = 1.0


class MatchQuery(QueryBuilder):
    """Analyzed full-text query; multi-term OR/AND with
    minimum_should_match."""


    def __init__(self, field: str, query: str, operator: str = "or",
                 minimum_should_match: Optional[Any] = None):
        super().__init__()
        self.field = field
        self.query = query
        self.operator = operator.lower()
        self.minimum_should_match = minimum_should_match


class MultiMatchQuery(QueryBuilder):
    """best_fields (dis-max over per-field match) and most_fields (sum)."""


    def __init__(self, fields: List[str], query: str,
                 type_: str = "best_fields", tie_breaker: float = 0.0):
        super().__init__()
        self.fields = fields
        self.query = query
        self.type = type_
        self.tie_breaker = tie_breaker


class TermQuery(QueryBuilder):
    """Exact term: BM25 on a text field; on a keyword field BM25 with
    tf = 1 and no norms, idf/(1+k1), a constant per match."""


    def __init__(self, field: str, value: Any):
        super().__init__()
        self.field = field
        self.value = value


class TermsQuery(QueryBuilder):
    """Any of the values, constant score 1.0."""


    def __init__(self, field: str, values: List[Any]):
        super().__init__()
        self.field = field
        self.values = values


class BoolQuery(QueryBuilder):
    """must (scoring, required), filter (required, not scoring), should
    (scoring, optional unless no must/filter), must_not (excluded)."""


    def __init__(self, must=None, filter=None, should=None, must_not=None,
                 minimum_should_match: Optional[Any] = None):
        super().__init__()
        self.must = must or []
        self.filter = filter or []
        self.should = should or []
        self.must_not = must_not or []
        self.minimum_should_match = minimum_should_match


class ConstantScoreQuery(QueryBuilder):

    def __init__(self, filter_query: QueryBuilder):
        super().__init__()
        self.filter_query = filter_query


class DisMaxQuery(QueryBuilder):

    def __init__(self, queries: List[QueryBuilder], tie_breaker: float = 0.0):
        super().__init__()
        self.queries = queries
        self.tie_breaker = tie_breaker


def _analyze_terms(ctx, field: str, text: str) -> List[str]:
    """A text field's analyzed terms; on any other field the literal
    value is the one term. ``ctx`` carries the index's ``mapper``."""
    if ctx.mapper.fields.get(field) == "text":
        return [t.term for t in ctx.mapper.analyzer.analyze(text)]
    return [str(text)]


def parse_query(body: Dict[str, Any]) -> QueryBuilder:
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingException(
            f"[query] malformed query, expected a single query type, got "
            f"{list(body) if isinstance(body, dict) else type(body).__name__}")
    (qtype, spec), = body.items()
    parser = _PARSERS.get(qtype)
    if parser is None:
        raise SliceUnsupported(
            f"query [{qtype}] is a later slice of the port: this slice "
            f"serves {', '.join(sorted(_PARSERS))}")
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


def _parse_dis_max(spec):
    queries = [parse_query(q) for q in spec.get("queries", [])]
    if not queries:
        raise ParsingException("[dis_max] requires 'queries' field with at "
                               "least one clause")
    return DisMaxQuery(queries,
                       tie_breaker=float(spec.get("tie_breaker", 0.0)))


_PARSERS = {
    "match": _parse_match,
    "multi_match": _parse_multi_match,
    "term": _parse_term,
    "terms": _parse_terms,
    "bool": _parse_bool,
    "constant_score": lambda spec: _with_boost(
        ConstantScoreQuery(parse_query(spec["filter"])), spec),
    "dis_max": _parse_dis_max,
}
