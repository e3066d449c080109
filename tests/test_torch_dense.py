"""The port's dense executor against the reference's, on the CPU.

The same seeded documents go through both packages (each its own mapper
and SegmentWriter, the same deletes) and the same bodies through both:

- the mapper: numbers, booleans and dates, multi-fields, and the
  dynamic rules (a dynamic string is text with a ``.keyword`` subfield,
  an int a long, a date-shaped string a date);
- ops: ``match_mask``, ``match_count``, ``bm25_dense_scores_sorted`` and
  ``masked_topk`` (ties at the kth key: the lowest docid wins), and the
  plan launch with a ``dense_mask`` and an ``after_score``;
- every query class of the dense executor at the ops level (the
  reference's tests/test_queries.py cases) and through both
  ``ShardSearcher``s (three segments, one with deletes), under every
  sort kind: ``_score``, ``_doc``, numeric and date fields, asc and
  desc, missing values, multi-key; ``search_after`` walks,
  ``min_score`` and ``post_filter`` against the totals;
- the plan path's dense factors (``range`` in must/filter/must_not, a
  post_filter), and ``_search`` over REST on both nodes (the reference's
  tests/test_search_service.py sort and search_after cases).

Tolerance: ids, order, totals and sort values exact; scores rtol 1e-5
(float32 on both sides). The plan path's scores keep test_torch_plan's
rtol 1e-4 and its tie-aware order (the reference's plan launch sums
through a global float32 prefix).
"""

import datetime as dt
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.index.segment import merge_segments as jax_merge
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops import bm25 as jax_bm25
from elasticsearch_tpu.ops import plan as jax_plan
from elasticsearch_tpu.ops import topk as jax_topk
from elasticsearch_tpu.ops.device import DeviceSegment as JaxDeviceSegment
from elasticsearch_tpu.search.context import \
    DeviceSegmentCache as JaxSegmentCache
from elasticsearch_tpu.search.context import SegmentContext as JaxContext
from elasticsearch_tpu.search.context import ShardStats as JaxStats
from elasticsearch_tpu.search.queries import parse_query as jax_parse
from elasticsearch_tpu.search.searcher import ShardSearcher as JaxSearcher
from elasticsearch_tpu_torch.index.mapper import (DateFieldType,
                                                  DocumentMapper,
                                                  KeywordFieldType,
                                                  LongFieldType,
                                                  MapperParsingException,
                                                  TextFieldType)
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.index.segment import \
    merge_segments as port_merge
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import bm25 as bm25_ops
from elasticsearch_tpu_torch.ops import plan as plan_ops
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.ops.device import DeviceSegment
from elasticsearch_tpu_torch.ops.topk import masked_topk
from elasticsearch_tpu_torch.search.batching import PlanBatcher
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    SegmentContext,
                                                    ShardStats)
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.plan import (bind_plan, compile_plan,
                                                 execute_bound)
from elasticsearch_tpu_torch.search.queries import (ParsingException,
                                                    parse_query)
from elasticsearch_tpu_torch.search.searcher import ShardSearcher
from test_torch_node import assert_same_hits

RTOL = 1e-5
PLAN_RTOL = 1e-4

# ---------------------------------------------------------------------------
# the reference's query-test fixture (tests/test_queries.py, without its
# dense_vector field, a later slice of the port)
# ---------------------------------------------------------------------------

Q_MAPPINGS = {"properties": {
    "title": {"type": "text"},
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "views": {"type": "long"},
    "price": {"type": "float"},
    "flag": {"type": "boolean"},
}}
Q_DOCS = [
    {"title": "quick brown fox", "body": "jumps over the lazy dog",
     "tag": "animal", "views": 10, "price": 1.5, "flag": True},
    {"title": "quick red fox", "body": "eats the quick rabbit",
     "tag": "animal", "views": 50, "price": 2.5, "flag": False},
    {"title": "slow green turtle", "body": "swims in the sea",
     "tag": "reptile", "views": 5, "price": 3.5, "flag": True},
    {"title": "lazy dog", "body": "sleeps all day",
     "tag": "animal", "views": 100, "flag": False},
]
# the bodies of the reference's test_match_all ... test_boosting and
# test_multi_match
Q_CASES = [
    {"match_all": {}},
    {"match_all": {"boost": 2.0}},
    {"match_none": {}},
    {"match": {"title": "quick fox"}},
    {"match": {"title": {"query": "quick fox dog", "operator": "and"}}},
    {"match": {"title": {"query": "quick brown", "operator": "and"}}},
    {"match": {"title": {"query": "quick brown dog",
                         "minimum_should_match": 2}}},
    {"match": {"title": "quick brown fox"}},
    {"match": {"title": {"query": "quick fox", "boost": 3.0}}},
    {"term": {"tag": "animal"}},
    {"term": {"title": "fox"}},
    {"term": {"views": 50}},
    {"term": {"flag": True}},
    {"term": {"price": {"value": 2.5, "boost": 2.0}}},
    {"terms": {"tag": ["reptile", "missing"]}},
    {"terms": {"views": [10, 5]}},
    {"range": {"views": {"gte": 10, "lt": 100}}},
    {"range": {"price": {"gt": 2.0}}},
    {"range": {"price": {"gte": 0}}},
    {"range": {"views": {"from": 5, "to": 50}}},
    {"range": {"nope": {"gte": 1}}},
    {"exists": {"field": "price"}},
    {"exists": {"field": "title"}},
    {"exists": {"field": "nope"}},
    {"ids": {"values": ["1", "3", "404"]}},
    {"bool": {"must": [{"match": {"title": "quick"}}],
              "filter": [{"term": {"tag": "animal"}}],
              "must_not": [{"term": {"views": 50}}]}},
    {"bool": {"filter": [{"term": {"tag": "animal"}}]}},
    {"bool": {"should": [{"term": {"views": 10}}, {"term": {"views": 50}},
                         {"term": {"tag": "animal"}}],
              "minimum_should_match": 2}},
    {"bool": {"must": [{"term": {"tag": "animal"}}],
              "should": [{"term": {"views": 10}}]}},
    {"bool": {"must_not": [{"term": {"tag": "reptile"}}], "boost": 2.0}},
    {"constant_score": {"filter": {"term": {"tag": "animal"}},
                        "boost": 2.5}},
    {"dis_max": {"queries": [{"match": {"title": "quick"}},
                             {"match": {"body": "quick"}}],
                 "tie_breaker": 0.5}},
    {"boosting": {"positive": {"term": {"tag": "animal"}},
                  "negative": {"term": {"views": 50}},
                  "negative_boost": 0.1}},
    {"multi_match": {"query": "quick", "fields": ["title", "body"]}},
    {"multi_match": {"query": "quick", "fields": ["title", "body"],
                     "type": "most_fields"}},
    {"multi_match": {"query": "quick lazy", "tie_breaker": 0.2}},
]


def build_both(mappings, docs, name, offset=0):
    """The reference's and the port's segment of ``docs`` (ids from
    ``offset``), each through its own mapper and writer."""
    jm, pm = MapperService(mappings=mappings), DocumentMapper(mappings)
    jw, pw = JaxWriter(), SegmentWriter()
    for i, d in enumerate(docs):
        jw.add(jm.parse(str(i + offset), d))
        pw.add(pm.parse(str(i + offset), d))
    return (jw.build(name), jm), (pw.build(name), pm)


@pytest.fixture(scope="module")
def qctx():
    (js, jm), (ps, pm) = build_both(Q_MAPPINGS, Q_DOCS, "s0")
    return (JaxContext(js, JaxDeviceSegment(js), jm, JaxStats([js])),
            SegmentContext(ps, DeviceSegment(ps, "cpu"), pm,
                           ShardStats([ps])))


def execute_both(ctxs, body):
    jctx, pctx = ctxs
    js, jmask = jax_parse(body).execute(jctx)
    ps, pmask = parse_query(body).execute(pctx)
    return ((np.asarray(ps), np.asarray(pmask)),
            (np.asarray(js), np.asarray(jmask)))


@pytest.mark.parametrize("ci", range(len(Q_CASES)))
def test_query_classes_match_reference(qctx, ci):
    (ps, pm), (js, jm) = execute_both(qctx, Q_CASES[ci])
    assert ps.dtype == np.float32 and pm.dtype == bool
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(ps, js, rtol=RTOL, atol=0)


def test_reference_query_assertions_hold_on_the_port(qctx):
    """The reference's own assertions of tests/test_queries.py, on the
    port's executor."""
    def matching(body):
        (_, m), _ = execute_both(qctx, body)
        return set(np.nonzero(m[:4])[0].tolist())

    def scores(body):
        (s, _), _ = execute_both(qctx, body)
        return s[:4]
    assert matching({"match_all": {}}) == {0, 1, 2, 3}
    assert (scores({"match_all": {}}) == 1.0).all()
    assert matching({"match_none": {}}) == set()
    assert matching({"term": {"views": 50}}) == {1}
    assert matching({"term": {"flag": True}}) == {0, 2}
    assert scores({"term": {"views": 50}})[1] == 1.0
    assert matching({"terms": {"views": [10, 5]}}) == {0, 2}
    assert matching({"range": {"views": {"gte": 10, "lt": 100}}}) == {0, 1}
    assert matching({"range": {"price": {"gte": 0}}}) == {0, 1, 2}
    assert matching({"exists": {"field": "price"}}) == {0, 1, 2}
    assert matching({"ids": {"values": ["1", "3", "404"]}}) == {1, 3}
    s = scores({"bool": {"filter": [{"term": {"tag": "animal"}}]}})
    assert (s == 0.0).all()
    s = scores({"boosting": {"positive": {"term": {"tag": "animal"}},
                             "negative": {"term": {"views": 50}},
                             "negative_boost": 0.1}})
    assert s[1] == pytest.approx(s[0] * 0.1, rel=1e-5)


def test_parse_errors():
    """As the reference's test_parse_errors; every query type of the
    reference parses (nested since the field-type slice), and a stored
    script parsed outside a node's request has no store to resolve in:
    a ParsingException, as the reference's without a node."""
    with pytest.raises(ParsingException):
        parse_query({"match": {"a": 1}, "term": {"b": 2}})
    with pytest.raises(ParsingException):
        parse_query({"made_up_query": {}})
    assert parse_query({"nested": {"path": "a", "query": {
        "match_all": {}}}}).name == "nested"
    with pytest.raises(ParsingException, match="stored script"):
        parse_query({"script_score": {"query": {"match_all": {}},
                                      "script": {"id": "stored"}}})


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------

# types whose parse takes an object or a point (the field-type slice):
# a scalar raises the reference's own exception (a geo ParsingException,
# a join's NotImplementedError: the mapper parses a join itself)
OBJECT_TYPES = {"geo_point", "geo_shape", "join", "integer_range",
                "long_range", "float_range", "double_range", "date_range",
                "ip_range", "flattened", "percolator", "rank_features",
                "completion"}


def test_numeric_field_types_parse_as_the_reference():
    from elasticsearch_tpu.index.mapper import FIELD_TYPES as JAX_TYPES
    from elasticsearch_tpu_torch.index.mapper import FIELD_TYPES
    values = [0, 1, -7, 3.75, "42", "2.5", True, False, "true", "false",
              "2026-01-01", "2026-01-01T10:20:30Z",
              "2026-01-01T10:20:30.123+02:00", "2026/03/04",
              "2026-01-01 05:06:07", "1767225600000", 1767225600123,
              "x", 2 ** 40, 300, 70000]
    for name, cls in FIELD_TYPES.items():
        jcls = JAX_TYPES[name]
        for v in values:
            try:
                want = jcls(name).parse(v)
            except Exception as e:   # noqa: BLE001 -- the type must match
                with pytest.raises(Exception) as got:
                    cls(name).parse(v)
                assert type(got.value).__name__ == type(e).__name__
                # rank_feature parses with float(), as the reference's: a
                # value that is no number raises float()'s ValueError;
                # the object-valued types of the field-type slice raise
                # what the reference's raise (the type above)
                assert type(e).__name__ == "MapperParsingException" or (
                    name == "rank_feature" and type(e) is ValueError) or \
                    name in OBJECT_TYPES, (name, v, e)
                continue
            assert cls(name).parse(v) == want, (name, v)


def dynamic_docs():
    return [
        {"title": "Quick Fox", "n": 5, "when": "2026-01-02T03:04:05Z",
         "ok": True, "f": 1.5, "tags": ["a b", "c"]},
        {"title": "quick brown fox", "n": 12, "when": "2026-01-03",
         "ok": False, "tags": "a b"},
        {"title": "Quick Fox", "n": -3, "when": "2026-01-01T23:59:59Z",
         "f": 0.25},
        {"title": "lazy dog " * 40, "n": 7, "ok": True},
    ]


DYNAMIC_BODIES = [
    {"query": {"term": {"title.keyword": "Quick Fox"}}},
    {"query": {"terms": {"tags.keyword": ["a b", "zzz"]}}},
    # above ignore_above 256: not indexed into title.keyword
    {"query": {"bool": {"should": [
        {"term": {"title.keyword": "lazy dog " * 40}},
        {"term": {"title.keyword": "quick brown fox"}}]}}},
    {"query": {"range": {"n": {"gte": 5}}}},
    {"query": {"range": {"when": {"gte": "2026-01-02", "lt": "2026-01-04"}}}},
    {"query": {"term": {"ok": True}}},
    {"query": {"exists": {"field": "f"}}},
    {"query": {"match": {"title": "quick"}},
     "sort": [{"when": "desc"}]},
    {"query": {"match_all": {}}, "sort": [{"n": "asc"}]},
]


@pytest.fixture(scope="module")
def dynamic_nodes(tmp_path_factory):
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("dyn")))
    node = Node(device="cpu")
    bulk = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                   + json.dumps(d) + "\n"
                   for i, d in enumerate(dynamic_docs()))
    for c in (jax_node.rest_controller, node.rest_controller):
        st, _ = c.dispatch("PUT", "/dyn", {}, {
            "settings": {"index": {"number_of_shards": 1}}})
        assert st == 200
        st, r = c.dispatch("POST", "/dyn/_bulk", {"refresh": "true"}, bulk)
        assert st == 200 and not r["errors"], r
    yield jax_node, node
    node.close()
    jax_node.close()


def test_dynamic_mapping_matches_reference(dynamic_nodes):
    """The dynamic rules: a dynamic string maps to text with a
    ``.keyword`` subfield (ignore_above 256), an int to long, a float to
    float, a bool to boolean, a date-shaped string to date."""
    jax_node, node = dynamic_nodes
    jm = jax_node.indices_service.get("dyn").mapper
    pm = node.indices["dyn"].mapper
    for f in ("title", "title.keyword", "n", "when", "ok", "f", "tags",
              "tags.keyword"):
        assert pm.field_type(f).type_name == \
            jm.field_type(f).type_name, f
    assert isinstance(pm.field_type("title"), TextFieldType)
    assert isinstance(pm.field_type("title.keyword"), KeywordFieldType)
    assert pm.field_type("title.keyword").ignore_above == 256
    assert isinstance(pm.field_type("n"), LongFieldType)
    assert isinstance(pm.field_type("when"), DateFieldType)


@pytest.mark.parametrize("bi", range(len(DYNAMIC_BODIES)))
def test_dynamic_fields_answer_as_the_reference(dynamic_nodes, bi):
    """After the same _bulk of dynamic documents, a term on
    ``<field>.keyword`` and a range on a dynamic long or date give the
    reference's hits. Before this slice the port mapped a dynamic
    string to text alone and dropped every other value, so these found
    nothing."""
    jax_node, node = dynamic_nodes
    body = DYNAMIC_BODIES[bi]
    st, got = node.rest_controller.dispatch("POST", "/dyn/_search", {}, body)
    st2, ref = jax_node.rest_controller.dispatch("POST", "/dyn/_search", {},
                                                 body)
    assert st == st2 == 200, got
    assert ref["hits"]["total"]["value"] > 0
    assert_same_page(got, ref)


def test_explicit_multi_fields_index_every_subfield():
    mappings = {"properties": {"msg": {"type": "text", "fields": {
        "raw": {"type": "keyword"}, "len": {"type": "keyword",
                                            "ignore_above": 3}}}}}
    docs = [{"msg": "Hello World"}, {"msg": "abc"}, {"msg": ["x", "Hello"]}]
    (js, _), (ps, pm) = build_both(mappings, docs, "m")
    assert sorted(ps.postings) == sorted(js.postings)
    for f in ps.postings:
        assert ps.postings[f].terms == list(js.postings[f].terms), f
    assert pm.field_type("msg").subfields == ["raw", "len"]


def test_later_slice_types_are_refused():
    """The types a later slice once refused map since the field-type
    slice (tests/test_torch_field_types.py); a name the reference does
    not know is still refused."""
    for ftype in ("ip", "geo_point", "date_range", "flattened",
                  "constant_keyword"):
        m = DocumentMapper({"properties": {"x": {"type": ftype}}})
        assert m.field_type("x").type_name == ftype
    m = DocumentMapper({"properties": {"x": {"type": "nested"}}})
    assert m.nested_paths == {"x"}
    with pytest.raises(MapperParsingException, match="No handler"):
        DocumentMapper({"properties": {"x": {"type": "geo_hash"}}})


# ---------------------------------------------------------------------------
# logs-shaped documents in three segments
# ---------------------------------------------------------------------------

L_MAPPINGS = {"properties": {
    "msg": {"type": "text", "fields": {"raw": {"type": "keyword"}}},
    "level": {"type": "keyword"},
    "@timestamp": {"type": "date"},
    "status": {"type": "integer"},
    "bytes": {"type": "long"},
    "ok": {"type": "boolean"},
    "ratio": {"type": "float"},
    "codes": {"type": "short"},
}}
WORDS = ["get", "post", "index", "login", "error", "timeout", "cache",
         "miss", "hit", "user", "admin", "api", "v1", "v2", "slow"]
LEVELS = ["info", "warn", "error", "debug"]
T0_MS = 1767225600000          # 2026-01-01T00:00:00Z
# ~40 s apart: several docs per float32 step of 2^17 ms, so float32 keys
# tie in groups, as at scale
STEP_MS = 40_000


def iso(ms: int) -> str:
    t = dt.datetime.fromtimestamp(ms / 1000.0, tz=dt.timezone.utc)
    return t.strftime("%Y-%m-%dT%H:%M:%S.") + f"{ms % 1000:03d}Z"


def log_docs(seed: int, n: int, first: int):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        ms = T0_MS + (first + i) * STEP_MS + int(rng.integers(0, 1000))
        doc = {"msg": " ".join(rng.choice(WORDS, int(rng.integers(1, 7)))),
               "level": str(rng.choice(LEVELS)),
               # dates as ISO strings and as epoch millis
               "@timestamp": iso(ms) if i % 3 else ms,
               "status": int(rng.choice([200, 200, 200, 304, 404, 500])),
               "ok": bool(rng.random() < 0.7)}
        if rng.random() < 0.85:
            doc["bytes"] = int(rng.lognormal(8.0, 1.0))
        if rng.random() < 0.5:
            doc["ratio"] = float(np.round(rng.random(), 3))
        if rng.random() < 0.3:
            doc["codes"] = [int(c) for c in
                            rng.integers(0, 40, int(rng.integers(1, 4)))]
        docs.append(doc)
    return docs


SEG_SIZES = (120, 90, 150)
DELETED = {0: (3, 17, 64), 2: (0, 149)}


@pytest.fixture(scope="module")
def searchers():
    ref_segs, port_segs = [], []
    first = 0
    for si, n in enumerate(SEG_SIZES):
        (js, jm), (ps, pm) = build_both(L_MAPPINGS,
                                        log_docs(40 + si, n, first),
                                        f"l{si}", offset=first)
        for d in DELETED.get(si, ()):
            js.delete(d)
            ps.delete(d)
        ref_segs.append(js)
        port_segs.append(ps)
        first += n
    return (JaxSearcher(ref_segs, jm, JaxSegmentCache()),
            ShardSearcher(port_segs, pm, DeviceSegmentCache("cpu")))


def test_numeric_doc_values_match_reference(searchers):
    ref, port = searchers
    for js, ps in zip(ref.segments, port.segments):
        assert sorted(ps.numerics) == sorted(js.numerics)
        for f, nv in ps.numerics.items():
            jv = js.numerics[f]
            for a in ("values", "missing", "offsets", "all_values"):
                np.testing.assert_array_equal(getattr(nv, a),
                                              np.asarray(getattr(jv, a)),
                                              err_msg=f"{f}.{a}")
    merged_j = jax_merge("m", ref.segments)
    merged_p = port_merge("m", port.segments)
    for f, nv in merged_p.numerics.items():
        jv = merged_j.numerics[f]
        for a in ("values", "missing", "offsets", "all_values"):
            np.testing.assert_array_equal(getattr(nv, a),
                                          np.asarray(getattr(jv, a)),
                                          err_msg=f"merged {f}.{a}")
    # the device columns: float32, NaN -> 0, padding missing
    dev = DeviceSegment(port.segments[0], "cpu")
    jdev = JaxDeviceSegment(ref.segments[0])
    for f in dev.numerics:
        np.testing.assert_array_equal(dev.numerics[f].numpy(),
                                      np.asarray(jdev.numerics[f]))
        np.testing.assert_array_equal(dev.numeric_missing[f].numpy(),
                                      np.asarray(jdev.numeric_missing[f]))


def ts(i: int) -> str:
    return iso(T0_MS + i * STEP_MS)


DENSE_BODIES = [
    {"match_all": {}},
    {"range": {"@timestamp": {"gte": ts(40), "lt": ts(200)}}},
    {"range": {"@timestamp": {"gt": T0_MS + 100 * STEP_MS}}},
    {"range": {"status": {"gte": 400}}},
    {"term": {"status": 500}},
    {"terms": {"status": [304, 404]}},
    {"term": {"ok": "false"}},
    {"exists": {"field": "bytes"}},
    {"exists": {"field": "msg"}},
    {"ids": {"values": ["5", "130", "250", "3", "nope"]}},
    {"bool": {"must_not": [{"term": {"level": "error"}}]}},
    {"bool": {"must": [{"bool": {"should": [
        {"match": {"msg": "error timeout"}}, {"match": {"msg": "slow"}}]}}],
        "filter": [{"range": {"bytes": {"gte": 1000}}}]}},
    {"boosting": {"positive": {"match": {"msg": "api user"}},
                  "negative": {"range": {"status": {"gte": 500}}},
                  "negative_boost": 0.25}},
    {"dis_max": {"queries": [{"match": {"msg": "cache miss"}},
                             {"range": {"bytes": {"gte": 8000}}}],
                 "tie_breaker": 0.3}},
    {"constant_score": {"filter": {"range": {"ratio": {
        "gt": 0.25, "lte": 0.75}}}, "boost": 1.5}},
    {"match": {"msg.raw": "error"}},
    {"terms": {"codes": [3, 7, 11]}},
    {"multi_match": {"query": "error slow", "fields": ["msg", "msg.raw"],
                     "type": "cross_fields"}},
    {"match": {"msg": {"query": "get api user", "operator": "and"}}},
    {"match": {"msg": {"query": "get api user admin",
                       "minimum_should_match": "50%"}}},
    {"bool": {"should": [{"range": {"status": {"gte": 500}}},
                         {"match": {"msg": "timeout"}}]}},
    {"match": {"msg": {"query": "login", "boost": -1.0}}},
    {"bool": {"must": [{"match": {"msg": "error"}},
                       {"term": {"status": 500}}],
              "filter": [{"range": {"@timestamp": {"lt": ts(300)}}}],
              "must_not": [{"term": {"ok": True}}], "boost": 1.5}},
]
SORTS = [
    None,
    [{"@timestamp": "desc"}],
    [{"@timestamp": {"order": "asc"}}],
    ["_doc"],
    [{"_doc": "desc"}],
    [{"_score": "asc"}],
    ["_score"],
    [{"bytes": "asc"}],
    [{"bytes": {"order": "desc"}}],
    [{"status": "desc"}, {"@timestamp": "asc"}],
    [{"ratio": "asc"}, "_doc"],
]


def assert_same_result(p, r, searchers_pair):
    """Exact ids, order, totals and sort values; scores rtol 1e-5."""
    ref, port = searchers_pair
    assert p.total_hits == r.total_hits
    got = [(d.segment_idx, d.docid) for d in p.docs]
    want = [(d.segment_idx, d.docid) for d in r.docs]
    assert got == want
    np.testing.assert_allclose([d.score for d in p.docs],
                               [d.score for d in r.docs], rtol=RTOL, atol=0)
    for a, b in zip(p.docs, r.docs):
        assert len(a.sort_values) == len(b.sort_values)
        for x, y in zip(a.sort_values, b.sort_values):
            if isinstance(y, float) and isinstance(x, float) and x != y:
                # a _score sort value: float32 on both sides
                assert x == pytest.approx(y, rel=RTOL)
            else:
                assert x == y
    if r.max_score is None:
        assert p.max_score is None
    else:
        assert p.max_score == pytest.approx(r.max_score, rel=RTOL)


def dense_both(searchers_pair, body, size, **kw):
    ref, port = searchers_pair
    pf = kw.pop("post_filter", None)
    r = ref.query_phase(jax_parse(body), size, allow_plan=False,
                        post_filter=None if pf is None else jax_parse(pf),
                        **kw)
    p = port.query_phase(parse_query(body), size, allow_plan=False,
                         post_filter=None if pf is None else parse_query(pf),
                         **kw)
    return p, r


@pytest.mark.parametrize("size", [7, 400])
@pytest.mark.parametrize("bi", range(len(DENSE_BODIES)))
def test_dense_bodies_under_every_sort(searchers, bi, size):
    body = DENSE_BODIES[bi]
    for sort in SORTS:
        p, r = dense_both(searchers, body, size, sort=sort)
        assert_same_result(p, r, searchers)


@pytest.mark.parametrize("sort", [
    [{"@timestamp": "desc"}, "_doc"], [{"@timestamp": "asc"}],
    [{"bytes": "asc"}, {"_doc": "asc"}], [{"status": "asc"}], None,
    [{"_score": "desc"}, "_doc"]])
def test_search_after_walks_match_reference(searchers, sort):
    """Page by page, each side continuing from its own last hit's sort
    values (a single non-unique key excludes the cursor's ties, on both
    sides)."""
    body = {"bool": {"should": [{"match": {"msg": "error api"}},
                                {"range": {"status": {"gte": 404}}}]}}
    ref, port = searchers
    after_p = after_r = None
    for _ in range(6):
        p, r = dense_both(searchers, body, 25, sort=sort,
                          search_after=after_p)
        assert after_p == after_r
        assert_same_result(p, r, searchers)
        if not p.docs:
            break
        after_p = list(p.docs[-1].sort_values) or [p.docs[-1].score]
        after_r = list(r.docs[-1].sort_values) or [r.docs[-1].score]


@pytest.mark.parametrize("sort", [None, [{"@timestamp": "desc"}]])
def test_min_score_and_post_filter_against_totals(searchers, sort):
    body = {"bool": {"should": [{"match": {"msg": "error timeout slow"}},
                                {"term": {"level": "warn"}}]}}
    base, _ = dense_both(searchers, body, 500, sort=sort)
    for kw in ({"min_score": 1.0},
               {"post_filter": {"range": {"status": {"gte": 400}}}},
               {"min_score": 0.5,
                "post_filter": {"term": {"ok": True}}}):
        p, r = dense_both(searchers, body, 500, sort=sort, **kw)
        assert_same_result(p, r, searchers)
        assert 0 < p.total_hits < base.total_hits
        assert len(p.docs) == p.total_hits


def test_segment_filtered_out_by_can_match(searchers):
    p, r = dense_both(searchers, {"match_none": {}}, 10)
    assert p.total_hits == r.total_hits == 0 and p.docs == []


# ---------------------------------------------------------------------------
# the plan path's dense factors
# ---------------------------------------------------------------------------

PLAN_DENSE = [
    {"bool": {"must": [{"match": {"msg": "error api"}}],
              "filter": [{"range": {"@timestamp": {"gte": ts(50),
                                                   "lt": ts(250)}}}]}},
    {"bool": {"must": [{"match": {"msg": "get user"}},
                       {"range": {"bytes": {"gte": 2000}}}]}},
    {"bool": {"must": [{"match": {"msg": "timeout"}}],
              "must_not": [{"term": {"status": 200}},
                           {"exists": {"field": "ratio"}}]}},
    {"bool": {"should": [{"match": {"msg": "cache"}},
                         {"match": {"msg": "miss"}}],
              "filter": [{"terms": {"status": [404, 500]}},
                         {"term": {"ok": True}}],
              "minimum_should_match": 1}},
    {"bool": {"must": [{"term": {"level": "error"}},
                       {"match_all": {"boost": 0.5}}],
              "filter": [{"ids": {"values": [str(i) for i in
                                             range(0, 360, 3)]}}],
              "boost": 2.0}},
]


@pytest.mark.parametrize("after", [False, True])
@pytest.mark.parametrize("bi", range(len(PLAN_DENSE)))
def test_plan_dense_factors_match_reference(searchers, bi, after):
    """The plan compiles the factors (dense_mask, bonus) on both sides;
    ids, order (up to float32 near-ties) and totals equal, and equal to
    the port's own dense executor; with ``after`` a ``_score``
    search_after cursor rides the launch."""
    ref, port = searchers
    body = PLAN_DENSE[bi]
    plan = compile_plan(parse_query(body), port)
    assert plan is not None and plan.dense
    kw = {}
    if after:
        # a cursor between two scores that differ by more than the plan
        # path's float32 drift, so both packages cut at the same place
        sc = [x.score for x in port.query_phase(parse_query(body), 50).docs]
        gaps = [i for i in range(2, len(sc) - 1)
                if sc[i] - sc[i + 1] > 1e-3 * sc[i]]
        kw["search_after"] = [(sc[gaps[0]] + sc[gaps[0] + 1]) / 2 if gaps
                              else sc[0] * 1.01]
    r = ref.query_phase(jax_parse(body), 301, **kw)
    p = port.query_phase(parse_query(body), 300, **kw)
    d = port.query_phase(parse_query(body), 301, allow_plan=False, **kw)
    assert p.total_hits == r.total_hits > 0

    def hits(res, total):
        return {"hits": {"total": {"value": total, "relation": "eq"},
                         "hits": [{"_id": f"{x.segment_idx}:{x.docid}",
                                   "_score": x.score} for x in res.docs]}}
    assert_same_hits(hits(p, p.total_hits), hits(r, r.total_hits), 300,
                     rtol=PLAN_RTOL)
    # the dense executor: the same hits; its total counts before the
    # cursor (the plan launch's after it), in both packages
    if not after:
        assert d.total_hits == p.total_hits
    assert_same_hits(hits(p, 0), hits(d, 0), 300, rtol=PLAN_RTOL)


def test_plan_post_filter_dense_factor(searchers):
    ref, port = searchers
    body = {"match": {"msg": "error get"}}
    pf = {"range": {"status": {"gte": 404}}}
    plan = compile_plan(parse_query(body), port, parse_query(pf))
    assert plan.dense == [(plan.dense[0][0], False)]
    r = ref.query_phase(jax_parse(body), 101, post_filter=jax_parse(pf))
    p = port.query_phase(parse_query(body), 100, post_filter=parse_query(pf))
    assert p.total_hits == r.total_hits > 0
    assert_same_hits(
        {"hits": {"total": {"value": p.total_hits, "relation": "eq"},
                  "hits": [{"_id": f"{x.segment_idx}:{x.docid}",
                            "_score": x.score} for x in p.docs]}},
        {"hits": {"total": {"value": r.total_hits, "relation": "eq"},
                  "hits": [{"_id": f"{x.segment_idx}:{x.docid}",
                            "_score": x.score} for x in r.docs]}},
        100, rtol=PLAN_RTOL)


def test_dense_plans_launch_alone(searchers):
    """A plan with a dense mask, or with a _score cursor, does not join
    a cohort: the batcher runs it through execute_bound."""
    _, port = searchers
    ctx = port._contexts()[1]
    batcher = PlanBatcher()
    bp = bind_plan(compile_plan(parse_query(PLAN_DENSE[0]), port), ctx, 20)
    assert bp.dense_mask is not None
    assert not batcher._eligible(bp, None)
    got = batcher.execute(bp, ctx, 20, port.k1, port.b)
    want = execute_bound(bp, ctx, 20, port.k1, port.b)
    assert batcher.launches == 0
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    plain = bind_plan(compile_plan(parse_query(
        {"match": {"msg": "error"}}), port), ctx, 20)
    assert batcher._eligible(plain, None)
    assert not batcher._eligible(plain, 3.5)
    # a signature keys the converted-filter composition, never an id
    sig = batcher._signature(bp, ctx, 20, 1.2, 0.75)
    assert id(bp.dense_mask) not in sig and bp.shared_mask in sig


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

ND, TB = 900, 30


def blocks(seed):
    """Seeded docid-ascending postings blocks (tf 1..4, padded with tf 0
    at docid 0), the zero block last, and doc lengths."""
    rng = np.random.default_rng(seed)
    bd = np.zeros((TB + 1, 128), np.int32)
    bt = np.zeros((TB + 1, 128), np.float32)
    for i in range(TB):
        n = int(rng.integers(10, 128))
        bd[i, :n] = np.sort(rng.choice(ND, n, replace=False))
        bt[i, :n] = rng.integers(1, 5, n)
    lens = rng.integers(3, 50, ND).astype(np.float32)
    return bd, bt, lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_mask_and_match_count(seed):
    bd, bt, _ = blocks(seed)
    rng = np.random.default_rng(seed)
    sel = np.concatenate([rng.choice(TB, 9, replace=False),
                          np.full(7, TB)]).astype(np.int32)
    cid = rng.integers(0, 4, len(sel)).astype(np.int32)
    got = bm25_ops.match_mask(torch.from_numpy(bd), torch.from_numpy(bt),
                              torch.from_numpy(sel), ND)
    want = jax_bm25.match_mask(jnp.asarray(bd), jnp.asarray(bt),
                               jnp.asarray(sel), ND)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = bm25_ops.match_count(torch.from_numpy(bd), torch.from_numpy(bt),
                               torch.from_numpy(sel), torch.from_numpy(cid),
                               4, ND)
    want = jax_bm25.match_count(jnp.asarray(bd), jnp.asarray(bt),
                                jnp.asarray(sel), jnp.asarray(cid), 4, ND)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_dup", [0, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_bm25_dense_scores_sorted_matches_reference(seed, n_dup):
    """Dense BM25 from the contribution kernel's twin, the stable sort,
    the doubling scan and the run-last scatter; duplicated selections
    (a repeated query term) make runs longer than one entry per term."""
    bd, bt, lens = blocks(seed)
    rng = np.random.default_rng(10 + seed)
    sel = rng.choice(TB, 12, replace=False).astype(np.int32)
    sel = np.concatenate([sel, sel[:n_dup], np.full(16 - n_dup, TB)])
    w = np.concatenate([rng.uniform(0.3, 3.0, 12 + n_dup),
                        np.zeros(16 - n_dup)]).astype(np.float32)
    avg = float(lens.mean())
    before = gather_bm25_contrib.launches
    got = plan_ops.bm25_dense_scores_sorted(
        torch.from_numpy(bd), torch.from_numpy(bt), sel, w,
        torch.from_numpy(lens), avg, 1.2, 0.75, max_run=32)
    assert gather_bm25_contrib.launches == before   # the CPU twin ran
    want = jax_plan.bm25_dense_scores_sorted(
        jnp.asarray(bd), jnp.asarray(bt), jnp.asarray(sel), jnp.asarray(w),
        jnp.asarray(lens), jnp.float32(avg), 1.2, 0.75, max_run=32)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == (ND,)
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("k", [1, 7, 40, 300, 900])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_topk_ties_keep_the_lowest_docids(seed, k):
    """Scores from a few values, so the kth key ties across many docs:
    the same values and docids as lax.top_k (lowest index first)."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 5, ND).astype(np.float32) * 0.5
    mask = rng.random(ND) < 0.6
    vals, ids = masked_topk(torch.from_numpy(scores), torch.from_numpy(mask),
                            k)
    wv, wi = jax_topk.masked_topk(jnp.asarray(scores), jnp.asarray(mask), k)
    wv, wi = np.asarray(wv), np.asarray(wi)
    np.testing.assert_array_equal(vals.numpy(), wv)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(ids.numpy()[fin], wi[fin])
    assert (ids.numpy()[~fin] == bm25_ops._SENTINEL).all()


def test_plan_topk_dense_mask_and_after_score_match_reference():
    bd, bt, lens = blocks(5)
    rng = np.random.default_rng(5)
    live = rng.random(ND) > 0.05
    dense = rng.random(ND) < 0.5
    nb = 16
    sel = np.full(nb, TB, np.int32)
    sel[:10] = rng.choice(TB, 10, replace=False)
    grp = np.where(np.arange(nb) < 10, rng.integers(0, 2, nb), 2)
    grp = grp.astype(np.int32)
    sub = np.zeros(nb, np.int32)
    w = np.where(np.arange(nb) < 10, rng.uniform(0.5, 2, nb), 0)
    w = w.astype(np.float32)
    c = np.zeros(nb, bool)
    gk = np.array([plan_ops.SHOULD, plan_ops.SHOULD, plan_ops.FILTER,
                   plan_ops.FILTER], np.int32)
    gr = np.array([1, 1, 1 << 30, 1 << 30], np.int32)
    gc = np.full(4, np.nan, np.float32)
    avg = float(lens.mean())
    for after in (None, 1.5):
        js = jax_plan.FieldStream(jnp.asarray(bd), jnp.asarray(bt),
                                  jnp.asarray(lens), jnp.float32(avg),
                                  sel, grp, sub, w, c)
        rv, ri, rt = jax_plan.plan_topk(
            [js], gk, gr, gc, jnp.asarray(live), jnp.asarray(dense), 0, 0,
            1, bonus=0.25, k=51, after_score=after)
        ts_ = plan_ops.FieldStream(torch.from_numpy(bd), torch.from_numpy(bt),
                                   torch.from_numpy(lens), avg, sel, grp,
                                   sub, w, c)
        pv, pi, pt = plan_ops.plan_topk(
            [ts_], gk, gr, gc, torch.from_numpy(live), 0, 0, 1, bonus=0.25,
            k=50, dense_mask=torch.from_numpy(dense), after_score=after)
        assert int(pt) == int(rt) > 0

        def rows(v, i, t):
            keep = np.isfinite(v)
            return {"hits": {"total": {"value": t, "relation": "eq"},
                             "hits": [{"_id": str(a), "_score": float(b)}
                                      for b, a in zip(v[keep], i[keep])]}}
        assert_same_hits(rows(pv.numpy(), pi.numpy(), int(pt)),
                         rows(np.asarray(rv), np.asarray(ri), int(rt)), 50,
                         rtol=PLAN_RTOL)
        got_ids = pi.numpy()[np.isfinite(pv.numpy())]
        assert dense[got_ids].all() and live[got_ids].all()
        if after is not None:
            assert (pv.numpy()[np.isfinite(pv.numpy())] < after).all()


# ---------------------------------------------------------------------------
# _search over REST on both nodes
# ---------------------------------------------------------------------------

def fill_docs(n=20):
    """tests/test_search_service.py ``fill``'s documents."""
    return [{"title": f"doc number {i} " + ("quick fox " * (i % 3)),
             "tag": "even" if i % 2 == 0 else "odd", "views": i}
            for i in range(n)]


S_MAPPINGS = {"properties": {"title": {"type": "text"},
                             "tag": {"type": "keyword"},
                             "views": {"type": "long"}}}


@pytest.fixture(scope="module")
def rest_nodes(tmp_path_factory):
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("svc")))
    node = Node(device="cpu")
    logs = log_docs(77, 160, 0)
    for name, mappings, docs in (("test", S_MAPPINGS, fill_docs()),
                                 ("logs", L_MAPPINGS, logs)):
        for c in (jax_node.rest_controller, node.rest_controller):
            st, _ = c.dispatch("PUT", f"/{name}", {}, {
                "mappings": mappings,
                "settings": {"index": {"number_of_shards": 1}}})
            assert st == 200
            # two refreshes: two segments
            for lo, hi in ((0, len(docs) // 2), (len(docs) // 2, len(docs))):
                bulk = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                               + json.dumps(docs[i]) + "\n"
                               for i in range(lo, hi))
                st, r = c.dispatch("POST", f"/{name}/_bulk",
                                   {"refresh": "true"}, bulk)
                assert st == 200 and not r["errors"], r
    yield jax_node, node
    node.close()
    jax_node.close()


def assert_same_page(got, ref):
    """Equal totals and max_score, and equal hits: ids, sort values and
    order exactly, scores rtol 1e-5."""
    assert got["hits"]["total"] == ref["hits"]["total"]
    gm, rm = got["hits"]["max_score"], ref["hits"]["max_score"]
    assert (gm is None) == (rm is None)
    if rm is not None:
        assert gm == pytest.approx(rm, rel=RTOL)
    gh, rh = got["hits"]["hits"], ref["hits"]["hits"]
    assert [h["_id"] for h in gh] == [h["_id"] for h in rh]
    assert [h.get("sort") for h in gh] == [h.get("sort") for h in rh]
    for a, b in zip(gh, rh):
        if b["_score"] is None:
            assert a["_score"] is None
        else:
            assert a["_score"] == pytest.approx(b["_score"], rel=RTOL)
        assert a.get("_source") == b.get("_source")


REST_CASES = [
    ("test", {"sort": [{"views": "asc"}], "size": 5, "from": 10}),
    ("test", {"sort": [{"views": {"order": "desc"}}], "size": 3}),
    ("test", {"sort": [{"views": "asc"}], "size": 5,
              "search_after": [4.0]}),
    ("test", {"query": {"match": {"title": "quick"}},
              "post_filter": {"term": {"tag": "even"}}}),
    ("test", {"query": {"match": {"title": "quick"}}, "min_score": 1.0}),
    ("test", {}),
    ("test", {"query": {"range": {"views": {"gte": 3, "lt": 9}}},
              "sort": ["_doc"]}),
    ("logs", {"query": {"range": {"@timestamp": {"gte": ts(20),
                                                 "lt": ts(110)}}},
              "size": 10}),
    ("logs", {"query": {"bool": {"filter": [{"range": {"@timestamp": {
        "gte": ts(10), "lte": ts(150)}}}]}},
        "sort": [{"@timestamp": "desc"}], "size": 50}),
    ("logs", {"query": {"match_all": {}}, "sort": [{"@timestamp": "asc"}],
              "size": 30}),
    ("logs", {"query": {"match_all": {}}, "sort": [{"bytes": "asc"}],
              "size": 200}),
    ("logs", {"query": {"bool": {"must": [{"match": {"msg": "error"}}],
                                 "filter": [{"term": {"status": 500}}]}}}),
    ("logs", {"query": {"exists": {"field": "bytes"}}, "size": 0}),
    ("logs", {"query": {"match": {"msg": "api"}},
              "sort": [{"status": "desc"}, {"@timestamp": "desc"}],
              "size": 40, "from": 5}),
]


# bodies the plan path serves (score-sorted, no min_score)
REST_PLAN = {3, 11}


@pytest.mark.parametrize("ci", range(len(REST_CASES)))
def test_rest_search_matches_reference(rest_nodes, ci):
    """Dense-executor bodies exactly; plan-path bodies with the
    tie-aware order of test_torch_plan (the reference asked one hit
    more)."""
    jax_node, node = rest_nodes
    index, body = REST_CASES[ci]
    st, got = node.rest_controller.dispatch("POST", f"/{index}/_search", {},
                                            body)
    size = body.get("size", 10)
    st2, ref = jax_node.rest_controller.dispatch(
        "POST", f"/{index}/_search", {},
        dict(body, size=size + 1) if ci in REST_PLAN else body)
    assert st == st2 == 200, got
    if ci in REST_PLAN:
        assert_same_hits(got, ref, size, rtol=PLAN_RTOL)
    else:
        assert_same_page(got, ref)


def test_rest_sort_paging_as_the_reference_service(rest_nodes):
    """tests/test_search_service.py:93-120 on the port: from/size paging
    by views, sort values as floats, no max_score under a field sort,
    search_after continuing a page."""
    _, node = rest_nodes
    c = node.rest_controller
    seen = []
    for frm in range(0, 20, 5):
        st, r = c.dispatch("POST", "/test/_search", {}, {
            "query": {"match_all": {}}, "sort": [{"views": "asc"}],
            "from": frm, "size": 5})
        seen.extend(h["_source"]["views"] for h in r["hits"]["hits"])
    assert seen == list(range(20))
    st, r = c.dispatch("POST", "/test/_search", {}, {
        "sort": [{"views": {"order": "desc"}}], "size": 3})
    assert [h["_source"]["views"] for h in r["hits"]["hits"]] == [19, 18, 17]
    assert r["hits"]["hits"][0]["sort"] == [19.0]
    assert r["hits"]["max_score"] is None
    body = {"sort": [{"views": "asc"}], "size": 5}
    st, r = c.dispatch("POST", "/test/_search", {}, body)
    last = r["hits"]["hits"][-1]["sort"]
    st, r2 = c.dispatch("POST", "/test/_search", {},
                        dict(body, search_after=last))
    assert [h["_source"]["views"] for h in r2["hits"]["hits"]] == \
        [5, 6, 7, 8, 9]
    st, r = c.dispatch("POST", "/test/_search", {}, {
        "query": {"match_all": {}}, "from": 9990, "size": 20})
    assert st == 400 and r["error"]["type"] == "illegal_argument_exception"
    # a keyword sort is served (it was a later slice before the fetch
    # and sort slice), as the reference's
    body = {"query": {"match_all": {}}, "sort": [{"level": "asc"}]}
    st, r = c.dispatch("POST", "/logs/_search", {}, body)
    jst, jr = rest_nodes[0].rest_controller.dispatch(
        "POST", "/logs/_search", {}, body)
    assert st == jst == 200, r
    assert_same_page(r, jr)


def test_dense_path_needs_a_device(monkeypatch):
    """Without CUDA and without ``device="cpu"`` the dense path's state
    cannot be built: it raises, never runs quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSegmentCache()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSegment(build_both(Q_MAPPINGS, Q_DOCS, "x")[1][0])
