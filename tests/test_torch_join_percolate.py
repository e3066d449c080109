"""The port's parent-join queries and percolate against the reference's,
on the CPU.

- The reference's tests/test_join_percolate.py, its 15
  non-aggregation cases (has_child with min_children and score_mode,
  has_parent, parent_id, join inside a bool, the mapping's validation,
  an unmapped join, the percolator's single and multiple documents with
  their slots, a child's routing, an invalid stored query, a percolation
  that leaves the mapping alone, a document given by index and id), over
  REST on both nodes. The port has no single-document PUT and no GET
  mapping route: documents go through ``_bulk``, the mapping through the
  index's mapper.
- A seeded question/answer join (questions as parents, their answers as
  children, in two segments with deletes): has_child under each
  score_mode with min/max_children, has_parent with score, parent_id,
  each through both nodes.
- A seeded percolator index of stored queries (match, bools with
  filters, ranges): one document, ten documents, a document by
  index/id; the slots equal, and the candidate segment's device bytes
  are charged to the hbm breaker and released by the end of the request.

Tolerance: ids, order, totals, slots exact; scores rtol 1e-5.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node
from test_torch_dense import assert_same_page

QA_MAPPINGS = {"properties": {
    "text": {"type": "text"},
    "join": {"type": "join", "relations": {"question": "answer"}}}}
QA_DOCS = [
    ("q1", {"text": "how do I use jax", "join": "question"}),
    ("q2", {"text": "what is a tpu", "join": "question"}),
    ("a1", {"text": "with grad and jit",
            "join": {"name": "answer", "parent": "q1"}}),
    ("a2", {"text": "jax uses xla",
            "join": {"name": "answer", "parent": "q1"}}),
    ("a3", {"text": "a matrix accelerator",
            "join": {"name": "answer", "parent": "q2"}}),
]
ALERT_MAPPINGS = {"properties": {"query": {"type": "percolator"},
                                 "message": {"type": "text"},
                                 "level": {"type": "keyword"}}}
RULES = [
    ("r-error", {"query": {"match": {"message": "error"}}}),
    ("r-crit", {"query": {"bool": {"must": [
        {"match": {"message": "disk"}}, {"term": {"level": "critical"}}]}}}),
    ("r-all", {"query": {"match_all": {}}}),
]


def _bulk(c, index, docs, routing=None):
    meta = {} if routing is None else {"routing": routing}
    bulk = "".join(json.dumps({"index": {"_id": i, **meta}}) + "\n"
                   + json.dumps(d) + "\n" for i, d in docs)
    return c.dispatch("POST", f"/{index}/_bulk", {"refresh": "true"}, bulk)


def _put(c, index, mappings=None):
    body = {"settings": {"index": {"number_of_shards": 1}}}
    if mappings:
        body["mappings"] = mappings
    assert c.dispatch("PUT", f"/{index}", {}, body)[0] == 200


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """Both nodes with "qa" (the reference's join docs, routed), "alerts"
    (its rules), "messages", "plain", and the seeded "qj" and
    "rules"."""
    jax_node = JaxNode(Settings.EMPTY,
                       data_path=str(tmp_path_factory.mktemp("jp")))
    node = Node(device="cpu")
    qj_parents, qj_children = qa_join_docs()
    for c in (jax_node.rest_controller, node.rest_controller):
        _put(c, "qa", QA_MAPPINGS)
        st, r = _bulk(c, "qa", QA_DOCS, routing="r")
        assert st == 200 and not r["errors"], r
        _put(c, "alerts", ALERT_MAPPINGS)
        st, r = _bulk(c, "alerts", RULES)
        assert st == 200 and not r["errors"], r
        _put(c, "messages")
        st, r = _bulk(c, "messages", [("m1", {"message":
                                              "fatal error in system"})])
        assert st == 200 and not r["errors"], r
        _put(c, "plain")
        assert _bulk(c, "plain", [("1", {"x": 1})])[0] == 200
        _put(c, "qj", QJ_MAPPINGS)
        for part in (qj_parents + qj_children[:300], qj_children[300:]):
            st, r = _bulk(c, "qj", part)
            assert st == 200 and not r["errors"], r
        st, r = c.dispatch("POST", "/qj/_bulk", {"refresh": "true"},
                           "".join(json.dumps({"delete": {"_id": i}}) + "\n"
                                   for i in ("q7", "a7_0", "a33_1")))
        assert st == 200 and not r["errors"], r
        _put(c, "rules", RULE_MAPPINGS)
        for part in (stored_rules()[:60], stored_rules()[60:]):
            st, r = _bulk(c, "rules", part)
            assert st == 200 and not r["errors"], r
        _put(c, "inbox", RULE_MAPPINGS)
        assert _bulk(c, "inbox", [("d1", percolate_docs(1, 9)[0])])[0] == 200
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
            assert a.get("fields") == b.get("fields")
    return got


def ids(resp):
    return sorted(h["_id"] for h in resp["hits"]["hits"])


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_join_percolate.py)
# ---------------------------------------------------------------------------

def test_has_child(nodes):
    assert ids(both(nodes, "qa", {"query": {"has_child": {
        "type": "answer", "query": {"match": {"text": "jax"}}}}})) == ["q1"]
    assert ids(both(nodes, "qa", {"query": {"has_child": {
        "type": "answer", "query": {"match_all": {}}}}})) == ["q1", "q2"]


def test_has_child_min_children(nodes):
    assert ids(both(nodes, "qa", {"query": {"has_child": {
        "type": "answer", "query": {"match_all": {}},
        "min_children": 2}}})) == ["q1"]


def test_has_child_score_mode(nodes):
    r = both(nodes, "qa", {"query": {"has_child": {
        "type": "answer", "query": {"match_all": {}},
        "score_mode": "sum"}}})
    by_id = {h["_id"]: h["_score"] for h in r["hits"]["hits"]}
    assert by_id["q1"] == 2.0 and by_id["q2"] == 1.0


def test_has_parent(nodes):
    assert ids(both(nodes, "qa", {"query": {"has_parent": {
        "parent_type": "question",
        "query": {"match": {"text": "tpu"}}}}})) == ["a3"]


def test_parent_id(nodes):
    assert ids(both(nodes, "qa", {"query": {"parent_id": {
        "type": "answer", "id": "q1"}}})) == ["a1", "a2"]


def test_join_in_bool(nodes):
    assert ids(both(nodes, "qa", {"query": {"bool": {"must": [
        {"has_child": {"type": "answer",
                       "query": {"match": {"text": "xla"}}}}]}}})) == ["q1"]


@pytest.mark.parametrize("doc", [{"join": "nonsense"},
                                 {"join": {"name": "answer"}}])
def test_join_mapping_validation(nodes, doc):
    for c in (n.rest_controller for n in nodes):
        st, r = _bulk(c, "qa", [("bad", doc)])
        assert st == 200 and r["errors"], r
        item = r["items"][0]["index"]
        assert item["status"] == 400
        assert item["error"]["type"] == "mapper_parsing_exception"


def test_join_unmapped(nodes):
    r = both(nodes, "plain", {"query": {"has_child": {
        "type": "answer", "query": {"match_all": {}},
        "ignore_unmapped": True}}})
    assert r["hits"]["total"]["value"] == 0
    for q in ({"has_child": {"type": "answer", "query": {"match_all": {}}}},
              {"has_parent": {"parent_type": "q",
                              "query": {"match_all": {}}}},
              {"parent_id": {"type": "a", "id": "1"}}):
        r = both(nodes, "plain", {"query": q}, expect=400)
        assert r["error"]["type"] == "query_shard_exception"


def test_percolate_single_doc(nodes):
    assert ids(both(nodes, "alerts", {"query": {"percolate": {
        "field": "query",
        "document": {"message": "an error occurred", "level": "warn"}}}})) \
        == ["r-all", "r-error"]


def test_percolate_bool_rule(nodes):
    assert ids(both(nodes, "alerts", {"query": {"percolate": {
        "field": "query",
        "document": {"message": "disk full", "level": "critical"}}}})) \
        == ["r-all", "r-crit"]


def test_percolate_multiple_docs_slots(nodes):
    r = both(nodes, "alerts", {"query": {"percolate": {
        "field": "query",
        "documents": [{"message": "all is fine"}, {"message": "error one"},
                      {"message": "another error"}]}}})
    by_id = {h["_id"]: h for h in r["hits"]["hits"]}
    assert by_id["r-error"]["fields"]["_percolator_document_slot"] == [1, 2]
    assert by_id["r-all"]["fields"]["_percolator_document_slot"] == [0, 1, 2]


def test_join_child_routes_to_parent_shard(nodes):
    """An unrouted child derives its parent's id as its routing key (the
    index's one shard holds both): the port's mapper derives what the
    reference's does, and the child indexes without routing."""
    jax_node, node = nodes
    child = {"text": "x", "join": {"name": "answer", "parent": "q1"}}
    assert node.indices["qa"].mapper.join_parent_routing(child) == "q1"
    assert jax_node.indices_service.get("qa").mapper.mapper \
        .join_parent_routing(child) == "q1"
    st, r = _bulk(node.rest_controller, "qa", [("a9", child)])
    assert st == 200 and not r["errors"], r
    st, r = node.rest_controller.dispatch("POST", "/qa/_bulk",
                                          {"refresh": "true"},
                                          json.dumps({"delete": {
                                              "_id": "a9"}}) + "\n")
    assert st == 200 and not r["errors"], r


def test_percolator_rejects_invalid_query(nodes):
    for c in (n.rest_controller for n in nodes):
        st, r = _bulk(c, "alerts", [("bad", {"query": {"no_such_query": {}}})])
        assert r["errors"] and r["items"][0]["index"]["status"] == 400


def test_percolate_does_not_mutate_mappings(nodes):
    _, node = nodes
    mapper = node.indices["alerts"].mapper
    before = mapper.to_mapping()
    both(nodes, "alerts", {"query": {"percolate": {
        "field": "query",
        "document": {"message": "error", "brand_new_field": "x"}}}})
    assert mapper.to_mapping() == before
    assert "brand_new_field" not in str(before)


def test_percolate_existing_doc_ref(nodes):
    r = both(nodes, "alerts", {"query": {"percolate": {
        "field": "query", "index": "messages", "id": "m1"}}})
    assert "r-error" in ids(r)
    r = both(nodes, "alerts", {"query": {"percolate": {
        "field": "query", "index": "messages", "id": "nope"}}}, expect=400)
    assert r["error"]["type"] == "illegal_argument_exception"


# ---------------------------------------------------------------------------
# a seeded question/answer join
# ---------------------------------------------------------------------------

QJ_MAPPINGS = {"properties": {
    "body": {"type": "text"}, "votes": {"type": "integer"},
    "qa": {"type": "join", "relations": {"question": "answer"}}}}
WORDS = ["python", "java", "list", "dict", "sort", "error", "thread",
         "memory", "string", "regex", "file", "json"]


def qa_join_docs(n_questions=120, seed=43):
    rng = np.random.default_rng(seed)
    parents, children = [], []
    for q in range(n_questions):
        parents.append((f"q{q}", {
            "body": " ".join(rng.choice(WORDS, int(rng.integers(2, 8)))),
            "votes": int(rng.integers(0, 50)), "qa": "question"}))
        for a in range(int(rng.integers(0, 6))):
            children.append((f"a{q}_{a}", {
                "body": " ".join(rng.choice(WORDS, int(rng.integers(2, 9)))),
                "votes": int(rng.integers(-3, 30)),
                "qa": {"name": "answer", "parent": f"q{q}"}}))
    return parents, children


QJ_BODIES = [
    {"query": {"has_child": {"type": "answer", "query": {
        "match": {"body": "python error"}}, "score_mode": mode}},
     "size": 40}
    for mode in ("none", "max", "sum", "avg", "min")] + [
    {"query": {"has_child": {"type": "answer", "query": {"match_all": {}},
                             "min_children": 3, "max_children": 4}},
     "size": 60},
    {"query": {"has_child": {"type": "answer", "query": {
        "range": {"votes": {"gte": 20}}}, "min_children": 2}}, "size": 60},
    {"query": {"has_parent": {"parent_type": "question", "query": {
        "match": {"body": "thread memory"}}, "score": True}}, "size": 60},
    {"query": {"has_parent": {"parent_type": "question", "query": {
        "range": {"votes": {"lt": 10}}}}}, "size": 60},
    {"query": {"parent_id": {"type": "answer", "id": "q12"}}},
    {"query": {"bool": {"must": [{"match": {"body": "json"}}],
                        "filter": [{"has_child": {
                            "type": "answer", "query": {"range": {
                                "votes": {"gte": 5}}}}}]}}, "size": 40},
    {"query": {"has_child": {"type": "answer", "query": {
        "match": {"body": "regex"}}, "score_mode": "max"}},
     "sort": [{"votes": "desc"}, "_doc"], "size": 20},
]


@pytest.mark.parametrize("bi", range(len(QJ_BODIES)))
def test_qa_join_bodies_match_the_reference(nodes, bi):
    r = both(nodes, "qj", QJ_BODIES[bi])
    assert r["hits"]["total"]["value"] > 0


# ---------------------------------------------------------------------------
# a seeded percolator index
# ---------------------------------------------------------------------------

RULE_MAPPINGS = {"properties": {
    "query": {"type": "percolator"}, "message": {"type": "text"},
    "level": {"type": "keyword"}, "bytes": {"type": "long"}}}
LEVELS = ["info", "warn", "error", "critical"]


def stored_rules(n=120, seed=44):
    """match, bool with filters, and range stored queries drawn from the
    word list."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = list(rng.choice(WORDS, 2, replace=False))
        kind = i % 4
        if kind == 0:
            q = {"match": {"message": w[0]}}
        elif kind == 1:
            q = {"bool": {"must": [{"match": {"message": " ".join(w)}}],
                          "filter": [{"term": {
                              "level": LEVELS[int(rng.integers(0, 4))]}}]}}
        elif kind == 2:
            q = {"range": {"bytes": {"gte": int(rng.integers(0, 5000))}}}
        else:
            q = {"bool": {"must": [{"match": {"message": w[0]}}],
                          "must_not": [{"match": {"message": w[1]}}]}}
        out.append((f"rule{i}", {"query": q}))
    return out


def percolate_docs(n, seed):
    rng = np.random.default_rng(seed)
    return [{"message": " ".join(rng.choice(WORDS, int(rng.integers(2, 8)))),
             "level": LEVELS[int(rng.integers(0, 4))],
             "bytes": int(rng.integers(0, 8000))} for _ in range(n)]


@pytest.mark.parametrize("case", ["one", "ten", "ref"])
def test_percolate_seeded_rules_match_the_reference(nodes, case):
    if case == "ref":
        spec = {"field": "query", "index": "inbox", "id": "d1"}
    else:
        docs = percolate_docs(1 if case == "one" else 10,
                              10 if case == "one" else 11)
        spec = {"field": "query", "documents": docs}
    r = both(nodes, "rules", {"query": {"percolate": spec}, "size": 200})
    assert r["hits"]["total"]["value"] > 0
    assert all("_percolator_document_slot" in h["fields"]
               for h in r["hits"]["hits"])


def test_percolate_candidate_segment_is_charged_and_released(nodes):
    """The candidate segment is admitted to the node's device cache (the
    hbm breaker charged with its bytes) while the request runs, and
    released when it ends: the breaker is back where it was."""
    _, node = nodes
    breaker = node.device_cache.breaker
    both(nodes, "rules", {"query": {"match_all": {}}, "size": 1})
    before = breaker.used
    seen = []
    orig = node.device_cache.get

    def spy(segment):
        dev = orig(segment)
        if segment.name.startswith("_percolate_candidates"):
            seen.append((segment.name, dev.hbm_bytes(), breaker.used))
        return dev
    node.device_cache.get = spy
    try:
        both(nodes, "rules", {"query": {"percolate": {
            "field": "query", "documents": percolate_docs(3, 12)}}})
    finally:
        del node.device_cache.get
    assert seen and all(used >= before + nbytes
                        for _n, nbytes, used in seen)
    assert breaker.used == before
    assert node.device_cache.resident(seen[0][0]) is None
