"""The port's nested query against the reference's, on the CPU.

- The reference's six nested cases of tests/test_intervals_spans.py
  (per-object correlation, a simple term, an unmapped path with and
  without ``ignore_unmapped``, the mapping's round trip, the verifier's
  edges: nested under nested, a one-clause bool, match through the
  analyzer, range through the field type, and ``inner_hits``), over
  REST on both nodes.
- A seeded question/answer corpus after Rally's ``nested`` track (0-5
  answers a question, each with a Zipf-drawn user, a date and a score),
  in two segments with deletes: bools of a term and a range,
  ``score_mode`` over an inner match, ``inner_hits`` with ``size`` and
  ``name``, nested inside a bool beside a match, and a sort; each body
  through both nodes.

Tolerance: ids, order, totals, sort values, ``inner_hits`` exact;
scores rtol 1e-5 (the inner match is the dense BM25 scorer on both
sides).
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search.queries import (_nested_objects,
                                                    _source_matches)
from test_torch_dense import assert_same_page

ORDERS_MAPPINGS = {"properties": {
    "order": {"type": "keyword"},
    "items": {"type": "nested", "properties": {
        "product": {"type": "keyword"}, "qty": {"type": "long"}}}}}
ORDERS = [("1", {"order": "a", "items": [{"product": "widget", "qty": 10},
                                         {"product": "gadget", "qty": 1}]}),
          ("2", {"order": "b", "items": [{"product": "widget", "qty": 1},
                                         {"product": "gadget", "qty": 10}]})]
N2_MAPPINGS = {"properties": {
    "a": {"type": "nested", "properties": {"b": {"type": "nested",
                                                 "properties": {
                                                     "v": {"type": "keyword"}}}}},
    "items": {"type": "nested", "properties": {
        "note": {"type": "text"}, "qty": {"type": "long"}}}}}
N2 = [("1", {"a": [{"b": [{"v": "x"}]}],
             "items": [{"note": "Fast delivery!", "qty": "7"}]})]

QA_MAPPINGS = {"properties": {
    "title": {"type": "text"}, "tag": {"type": "keyword"},
    "answers": {"type": "nested", "properties": {
        "user": {"type": "keyword"}, "date": {"type": "date"},
        "score": {"type": "integer"}, "text": {"type": "text"}}}}}
WORDS = ["python", "java", "list", "dict", "sort", "error", "thread",
         "memory", "string", "regex", "file", "json"]


def qa_docs(n=400, seed=41):
    rng = np.random.default_rng(seed)
    users = [f"u{i}" for i in range(40)]
    zipf = 1.0 / np.arange(1, 41) ** 1.1
    zipf /= zipf.sum()
    docs = []
    for i in range(n):
        answers = []
        for _ in range(int(rng.integers(0, 6))):
            answers.append({
                "user": str(rng.choice(users, p=zipf)),
                "date": f"2024-0{int(rng.integers(1, 10))}-"
                        f"{int(rng.integers(10, 29))}",
                "score": int(rng.integers(-3, 20)),
                "text": " ".join(rng.choice(WORDS, int(rng.integers(2, 7))))})
        doc = {"title": " ".join(rng.choice(WORDS, int(rng.integers(2, 8)))),
               "tag": WORDS[i % 5]}
        if answers:
            doc["answers"] = answers
        docs.append((str(i), doc))
    return docs


def _install(c, name, mappings, parts, deletes=()):
    assert c.dispatch("PUT", f"/{name}", {}, {
        "mappings": mappings,
        "settings": {"index": {"number_of_shards": 1}}})[0] == 200
    for part in parts:
        bulk = "".join(json.dumps({"index": {"_id": i}}) + "\n"
                       + json.dumps(d) + "\n" for i, d in part)
        st, r = c.dispatch("POST", f"/{name}/_bulk", {"refresh": "true"},
                           bulk)
        assert st == 200 and not r["errors"], r
    if deletes:
        st, r = c.dispatch("POST", f"/{name}/_bulk", {"refresh": "true"},
                           "".join(json.dumps({"delete": {"_id": i}}) + "\n"
                                   for i in deletes))
        assert st == 200 and not r["errors"], r


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("nested")))
    node = Node(device="cpu")
    qa = qa_docs()
    for c in (jax_node.rest_controller, node.rest_controller):
        _install(c, "orders", ORDERS_MAPPINGS, [ORDERS])
        _install(c, "n2", N2_MAPPINGS, [N2])
        _install(c, "qa", QA_MAPPINGS, [qa[:250], qa[250:]],
                 deletes=("3", "260", "399"))
    yield jax_node, node
    node.close()
    jax_node.close()


def both(nodes, index, body, expect=200):
    jax_node, node = nodes
    st, got = node.rest_controller.dispatch("POST", f"/{index}/_search", {},
                                            body)
    st2, ref = jax_node.rest_controller.dispatch(
        "POST", f"/{index}/_search", {}, body)
    assert st == st2 == expect, (got, ref)
    if expect == 200:
        assert_same_page(got, ref)
        for a, b in zip(got["hits"]["hits"], ref["hits"]["hits"]):
            assert a.get("inner_hits") == b.get("inner_hits")
    else:
        assert got["error"]["type"] == ref["error"]["type"]
    return got


def ids(r):
    return sorted(h["_id"] for h in r["hits"]["hits"])


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_intervals_spans.py)
# ---------------------------------------------------------------------------

def test_nested_query_per_object_correlation(nodes):
    r = both(nodes, "orders", {"query": {"nested": {
        "path": "items",
        "query": {"bool": {"must": [
            {"term": {"items.product": {"value": "widget"}}},
            {"range": {"items.qty": {"gte": 5}}}]}}}}})
    assert ids(r) == ["1"]


def test_nested_query_simple_term(nodes):
    r = both(nodes, "orders", {"query": {"nested": {
        "path": "items",
        "query": {"term": {"items.product": {"value": "gadget"}}}}}})
    assert ids(r) == ["1", "2"]


def test_nested_unmapped_path(nodes):
    r = both(nodes, "orders", {"query": {"nested": {
        "path": "nope", "query": {"match_all": {}}}}}, expect=400)
    assert r["error"]["type"] == "query_shard_exception"
    r = both(nodes, "orders", {"query": {"nested": {
        "path": "nope", "query": {"match_all": {}},
        "ignore_unmapped": True}}})
    assert r["hits"]["total"]["value"] == 0


def test_nested_mapping_roundtrip(nodes):
    jax_node, node = nodes
    m = node.indices["orders"].mapper.to_mapping()
    assert m["properties"]["items"]["type"] == "nested"
    assert m == jax_node.indices_service.get("orders").mapper.to_mapping()


@pytest.mark.parametrize("body", [
    {"query": {"nested": {"path": "a.b", "query": {
        "term": {"a.b.v": {"value": "x"}}}}}},
    {"query": {"nested": {"path": "a.b", "query": {"bool": {
        "must": {"term": {"a.b.v": {"value": "x"}}}}}}}},
    {"query": {"nested": {"path": "items", "query": {
        "match": {"items.note": {"query": "delivery"}}}}}},
    {"query": {"nested": {"path": "items", "query": {
        "range": {"items.qty": {"gte": 5}}}}}}])
def test_nested_verifier_edge_cases(nodes, body):
    assert ids(both(nodes, "n2", body)) == ["1"]


def test_nested_inner_hits(nodes):
    r = both(nodes, "orders", {"query": {"nested": {
        "path": "items",
        "query": {"term": {"items.product": {"value": "gadget"}}},
        "inner_hits": {}}}})
    hit = next(h for h in r["hits"]["hits"] if h["_id"] == "1")
    ih = hit["inner_hits"]["items"]["hits"]
    assert ih["total"]["value"] == 1
    assert ih["hits"][0]["_source"]["product"] == "gadget"
    assert ih["hits"][0]["_nested"] == {"field": "items", "offset": 1}


# ---------------------------------------------------------------------------
# the verifier against the reference's, object by object
# ---------------------------------------------------------------------------

VERIFIER_QUERIES = [
    {"term": {"answers.user": "u0"}},
    {"terms": {"answers.user": ["u1", "u2"]}},
    {"range": {"answers.score": {"gt": 5, "lte": 12}}},
    {"range": {"answers.date": {"gte": "2024-03-01"}}},
    {"match": {"answers.text": "python error"}},
    {"exists": {"field": "answers.score"}},
    {"bool": {"must": [{"term": {"answers.user": "u0"}}],
              "must_not": [{"range": {"answers.score": {"lt": 0}}}]}},
    {"bool": {"should": [{"term": {"answers.user": "u3"}},
                         {"match": {"answers.text": "json"}}]}},
    {"match_phrase": {"answers.text": "list dict"}},
]


@pytest.mark.parametrize("qi", range(len(VERIFIER_QUERIES)))
def test_source_matches_agrees_with_the_reference(qi):
    from elasticsearch_tpu.index.mapper import MapperService
    from elasticsearch_tpu.search import queries as jq

    class _Ctx:
        pass
    jctx, pctx = _Ctx(), _Ctx()
    jctx.mapper = MapperService(mappings=QA_MAPPINGS)
    pctx.mapper = DocumentMapper(QA_MAPPINGS)
    q = VERIFIER_QUERIES[qi]
    n = 0
    for _id, doc in qa_docs(120, seed=42):
        objs = _nested_objects(doc, "answers")
        assert objs == jq._nested_objects(doc, "answers")
        for o in objs:
            got = _source_matches(q, o, "answers", pctx)
            assert got == jq._source_matches(q, o, "answers", jctx)
            n += got
    assert n > 0


# ---------------------------------------------------------------------------
# the seeded question/answer corpus over REST
# ---------------------------------------------------------------------------

QA_BODIES = [
    {"query": {"nested": {"path": "answers", "query": {"bool": {"must": [
        {"term": {"answers.user": "u0"}},
        {"range": {"answers.date": {"gte": "2024-05-01",
                                    "lt": "2024-08-01"}}}]}}}},
     "size": 50},
    {"query": {"nested": {"path": "answers", "score_mode": "avg",
                          "query": {"match": {"answers.text":
                                              "python thread"}}}},
     "size": 40},
    {"query": {"nested": {"path": "answers", "score_mode": "none",
                          "query": {"match": {"answers.text": "regex"}}}},
     "size": 40},
    {"query": {"nested": {"path": "answers", "score_mode": "max",
                          "query": {"bool": {
                              "must": [{"match": {"answers.text": "json"}}],
                              "filter": [{"range": {"answers.score": {
                                  "gte": 10}}}]}}}},
     "size": 40},
    {"query": {"nested": {"path": "answers", "query": {
        "term": {"answers.user": "u1"}},
        "inner_hits": {"size": 2, "name": "by_u1"}}}, "size": 30},
    {"query": {"nested": {"path": "answers", "query": {
        "range": {"answers.score": {"gte": 15}}}, "inner_hits": {}}},
     "size": 30, "sort": [{"tag": "asc"}, "_doc"]},
    {"query": {"bool": {"must": [{"match": {"title": "memory"}}],
                        "filter": [{"nested": {
                            "path": "answers", "query": {"term": {
                                "answers.user": "u2"}}}}]}}, "size": 30},
    {"query": {"bool": {"must_not": [{"nested": {
        "path": "answers", "query": {"exists": {"field": "answers.user"}}}}]}},
     "size": 20},
    {"query": {"nested": {"path": "answers", "query": {
        "match_phrase": {"answers.text": "list dict"}}}}, "size": 20},
]


@pytest.mark.parametrize("bi", range(len(QA_BODIES)))
def test_qa_bodies_match_the_reference(nodes, bi):
    r = both(nodes, "qa", QA_BODIES[bi])
    assert r["hits"]["total"]["value"] > 0


def test_qa_inner_hits_offsets_index_the_source(nodes):
    """Each inner hit's offset names its object in the hit's own
    ``_source`` array, and the object is the one shown."""
    r = both(nodes, "qa", QA_BODIES[4])
    for h in r["hits"]["hits"]:
        for ih in h["inner_hits"]["by_u1"]["hits"]["hits"]:
            off = ih["_nested"]["offset"]
            assert h["_source"]["answers"][off] == ih["_source"]
            assert ih["_source"]["user"] == "u1"


def test_source_filter_does_not_change_the_verifier(nodes):
    """``_source`` filtering shapes the hit, not what the verifier
    reads: the same ids and inner hits with ``_source: false``."""
    body = dict(QA_BODIES[4], _source=False)
    got = both(nodes, "qa", body)
    full = both(nodes, "qa", QA_BODIES[4])
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in full["hits"]["hits"]]
    assert [h["inner_hits"] for h in got["hits"]["hits"]] == \
        [h["inner_hits"] for h in full["hits"]["hits"]]
