"""Search templates, `_rank_eval`, `_field_caps`, `_validate/query`,
`_terms_enum` and `_resolve/index` against the reference, on the CPU.

The reference's tests/test_search_utils.py cases (templates, field
caps, validate, terms_enum, resolve) run on both packages' nodes over
the same documents, each request sent to both: statuses and answers
equal. Masked: ``_validate/query``'s ``explanation`` (each package prints
the ``repr`` of its own query class). `_search` answers compare as
test_torch_node.py's ``assert_same_hits``: scores rtol 1e-4 and ids up
to the order inside a float32 tie.
Rendered templates are byte-equal (``json.dumps`` with sorted keys)
over the mustache forms of search/template.py. `_rank_eval` runs every
metric of ``parse_metric`` over a seeded corpus: each metric equal to
the reference's at rtol 1e-12 where the hit ids agree; the port's hits
are the plan path's, whose float32 ties the reference may order apart
(ROADMAP Queue 3), and a case whose ids differ only inside such a tie
is recomputed over the reference's ids and said so. Every test runs
under the leak guard of test_torch_tasks.py.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.search.rank_eval import parse_metric as jax_metric
from elasticsearch_tpu.search.template import \
    render_template as jax_render
from elasticsearch_tpu_torch.search.rank_eval import parse_metric
from elasticsearch_tpu_torch.search.template import render_template
from elasticsearch_tpu_torch.transport import tasks as port_tasks
from test_torch_node import assert_same_hits
from test_torch_tasks import Pair, background_threads


@pytest.fixture(autouse=True)
def _leak_guard():
    """Fail a test that leaves a port task registered or a node's
    background thread running."""
    tasks0 = port_tasks.open_task_keys()
    threads0 = background_threads()
    yield
    leaked = port_tasks.open_task_keys() - tasks0
    assert not leaked, f"tasks left registered: {sorted(leaked)}"
    running = background_threads() - threads0
    assert not running, f"background threads left running: {running}"


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def seed(pair):
    for i in range(10):
        pair.do("PUT", f"/logs/_doc/{i}", None,
                {"msg": f"error in module {i}",
                 "level": "warn" if i % 2 else "info", "code": i},
                expect=201)
    pair.do("POST", "/logs/_refresh")


def same(pair, method, path, params=None, body=None, expect=200):
    j, p = pair.do(method, path, params, body, expect=expect)
    assert p == j, (p, j)
    return p


def same_hits(p, j):
    """Two `_search` answers of at most 10 hits: totals equal, scores
    rtol 1e-4, ids equal up to the order inside a float32 tie (the
    reference scores the plan path in float32: test_torch_node.py
    ``assert_same_hits``)."""
    assert_same_hits(p, j, 10)


# ------------------------------------------------------------- field caps


def test_field_caps(pair):
    seed(pair)
    pair.do("PUT", "/other", body={"mappings": {"properties": {
        "code": {"type": "keyword"}}}})
    r = same(pair, "GET", "/logs/_field_caps", {"fields": "code,msg"})
    assert r["fields"]["code"]["long"]["aggregatable"] is True
    assert "text" in r["fields"]["msg"]
    r2 = same(pair, "GET", "/_field_caps", {"fields": "code"})
    assert set(r2["fields"]["code"]) == {"long", "keyword"}
    assert r2["fields"]["code"]["long"]["indices"] == ["logs"]


def test_field_caps_wildcard(pair):
    seed(pair)
    r = same(pair, "POST", "/logs/_field_caps", body={"fields": ["c*"]})
    assert "code" in r["fields"]
    same(pair, "POST", "/_field_caps", body={"fields": "*"})


# -------------------------------------------------------------- validate


def test_validate_query(pair):
    seed(pair)
    r = same(pair, "GET", "/logs/_validate/query",
             body={"query": {"match": {"msg": "error"}}})
    assert r["valid"] is True
    j, p = pair.do("GET", "/logs/_validate/query",
                   body={"query": {"no_such_query": {}}})
    assert p["valid"] is j["valid"] is False
    assert set(p) == set(j) == {"valid", "error"}
    j, p = pair.do("GET", "/logs/_validate/query", {"explain": "true"},
                   {"query": {"term": {"level": "info"}}})
    assert p["explanations"][0]["valid"] is True
    for r in (j, p):
        (e,) = r["explanations"]
        assert e["index"] == "logs" and e["explanation"]
    # an unknown index is not an error of the route: valid false
    j, p = pair.do("GET", "/nope/_validate/query",
                   body={"query": {"match_all": {}}})
    assert p["valid"] is j["valid"] is False


# ------------------------------------------------------------ terms enum


def test_terms_enum(pair):
    seed(pair)
    r = same(pair, "POST", "/logs/_terms_enum",
             body={"field": "level", "string": "wa"})
    assert r["terms"] == ["warn"]
    r2 = same(pair, "POST", "/logs/_terms_enum",
              body={"field": "msg", "string": "err"})
    assert "error" in r2["terms"]
    r3 = same(pair, "POST", "/logs/_terms_enum",
              body={"field": "level", "string": "WA",
                    "case_insensitive": True})
    assert r3["terms"] == ["warn"]
    same(pair, "POST", "/logs/_terms_enum",
         body={"field": "msg", "string": "", "size": 4})
    same(pair, "GET", "/logs/_terms_enum", {"field": "level.keyword",
                                            "string": "i"})
    (jst, j), (st, p) = pair.both("POST", "/logs/_terms_enum", None, {})
    assert st == jst == 400
    assert p["error"]["type"] == j["error"]["type"]


# --------------------------------------------------------------- resolve


def test_resolve_index(pair):
    seed(pair)
    pair.do("POST", "/_aliases", body={"actions": [
        {"add": {"index": "logs", "alias": "logs-alias"}}]})
    r = same(pair, "GET", "/_resolve/index/l*")
    assert any(i["name"] == "logs" for i in r["indices"])
    assert any(a["name"] == "logs-alias" for a in r["aliases"])
    same(pair, "GET", "/_resolve/index/_all")
    same(pair, "GET", "/_resolve/index/nothing*")


# -------------------------------------------------------------- templates


RENDER_CASES = [
    ({"query": {"match": {"msg": "{{q}}"}}, "size": "{{size}}"},
     {"q": "hello", "size": 5}),
    ('{"query": {"terms": {"tag": {{#toJson}}tags{{/toJson}} }},'
     '"size": {{size}}{{^size}}10{{/size}} }', {"tags": ["a", "b"]}),
    ('{"query": {"terms": {"tag": {{#toJson}}tags{{/toJson}} }},'
     '"size": {{size}}{{^size}}10{{/size}} }', {"tags": [], "size": 3}),
    ('{"q": "{{text}}"}', {"text": 'say "hi"\n'}),
    ('{"filters": [ {{#clauses}}{"term": {"f": "{{.}}"}},{{/clauses}} '
     '{"match_all": {}} ]}', {"clauses": ["x", "y"]}),
    ('{"q": "{{#join}}ids{{/join}}", "r": {{{raw}}}, "n": {{n}} '
     '{{! a comment }} }', {"ids": [1, 2, 3], "raw": {"a": [1]}, "n": 0}),
    ('{"user": "{{user.name}}", "ok": {{flag}} }',
     {"user": {"name": "ann"}, "flag": True}),
    ('{"size": {{size}}{{^size}}7{{/size}} }', {"size": 0}),
]


@pytest.mark.parametrize("source,params", RENDER_CASES)
def test_rendered_templates_are_byte_equal(source, params):
    got = render_template(source, params)
    want = jax_render(source, params)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


@pytest.mark.parametrize("source", ["{{#open}} never closed",
                                    "{{/close}} never opened",
                                    '{"a": {{x}}'])
def test_bad_templates_fail_alike(source):
    from elasticsearch_tpu.common.errors import ParsingException as JaxPE
    from elasticsearch_tpu_torch.common.errors import ParsingException
    with pytest.raises(JaxPE) as want:
        jax_render(source, {})
    with pytest.raises(ParsingException) as got:
        render_template(source, {})
    assert str(got.value) == str(want.value)


def test_search_template_endpoint(pair):
    seed(pair)
    j, p = pair.do("POST", "/logs/_search/template", body={
        "source": {"query": {"match": {"level": "{{lvl}}"}}},
        "params": {"lvl": "info"}})
    assert p["hits"]["total"]["value"] == 5
    same_hits(p, j)
    pair.do("PUT", "/_scripts/lvl-tpl", body={"script": {
        "lang": "mustache",
        "source": {"query": {"match": {"level": "{{lvl}}"}}}}})
    j, p = pair.do("POST", "/logs/_search/template",
                   body={"id": "lvl-tpl", "params": {"lvl": "warn"}})
    assert p["hits"]["total"]["value"] == 5
    same_hits(p, j)
    r3 = same(pair, "POST", "/_render/template",
              body={"id": "lvl-tpl", "params": {"lvl": "warn"}})
    assert r3["template_output"]["query"]["match"]["level"] == "warn"
    same(pair, "POST", "/_render/template/lvl-tpl",
         body={"params": {"lvl": "info"}})
    j, p = pair.do("GET", "/_search/template", body={
        "source": {"query": {"match": {"msg": "{{w}}"}}},
        "params": {"w": "module"}})
    same_hits(p, j)
    for body, status in (({"id": "missing"}, 404), ({}, 400)):
        (jst, jr), (st, pr) = pair.both("POST", "/logs/_search/template",
                                        None, body)
        assert st == jst == status
        assert pr["error"]["type"] == jr["error"]["type"]


def test_msearch_template(pair):
    seed(pair)
    body = [
        {"index": "logs"},
        {"source": {"query": {"match": {"level": "{{l}}"}}},
         "params": {"l": "info"}},
        {"index": "logs"},
        {"source": {"query": {"match_all": {}}}},
        {"index": "nope"},
        {"source": {"query": {"match_all": {}}}},
        {"index": "logs"},
        {"id": "missing"},
    ]
    j, p = pair.do("POST", "/_msearch/template", body=body)
    assert p["responses"][0]["hits"]["total"]["value"] == 5
    assert p["responses"][1]["hits"]["total"]["value"] == 10
    for a, b in zip(p["responses"][:2], j["responses"][:2]):
        same_hits(a, b)
    for a, b in zip(p["responses"][2:], j["responses"][2:]):
        assert a["status"] == b["status"]
        assert a["error"]["type"] == b["error"]["type"]
    (jst, jr), (st, pr) = pair.both("POST", "/_msearch/template", None,
                                    body[:3])
    assert st == jst == 400


# ------------------------------------------------------------- rank eval


METRICS = [
    {"precision": {"k": 5}},
    {"precision": {"k": 10, "relevant_rating_threshold": 2,
                   "ignore_unlabeled": True}},
    {"recall": {"k": 5}},
    {"recall": {"k": 20, "relevant_rating_threshold": 2}},
    {"mean_reciprocal_rank": {"k": 10}},
    {"mean_reciprocal_rank": {"relevant_rating_threshold": 3}},
    {"dcg": {"k": 10}},
    {"dcg": {"k": 10, "normalize": True}},
    {"expected_reciprocal_rank": {"maximum_relevance": 3, "k": 10}},
]


def rank_corpus(pair, n=120, seed_=11):
    """``n`` docs of seeded words; rated requests whose ratings come from
    each doc's count of the query's words (0-3)."""
    rng = np.random.default_rng(seed_)
    words = [f"t{i}" for i in range(25)]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(4, 14))))
             for _ in range(n)]
    lines = []
    for i, t in enumerate(texts):
        lines += [{"index": {"_index": "re", "_id": str(i)}}, {"body": t}]
    j, p = pair.do("POST", "/_bulk", {"refresh": "true"}, lines)
    assert not p["errors"] and not j["errors"]
    requests = []
    for q in range(6):
        qw = list(rng.choice(words, size=2, replace=False))
        ratings = []
        for i, t in enumerate(texts):
            c = sum(t.split().count(w) for w in qw)
            if c and rng.random() < 0.7:
                ratings.append({"_index": "re", "_id": str(i),
                                "rating": int(min(3, c))})
        # a bool should: the plan path (a bare match on this one-segment
        # index would take the fast path, minutes of CPU for the suite)
        requests.append({"id": f"q{q}", "request": {
            "query": {"bool": {"should": [
                {"match": {"body": " ".join(qw)}}]}}, "size": 20},
            "ratings": ratings})
    return requests


@pytest.mark.parametrize("metric", METRICS,
                         ids=[json.dumps(m, sort_keys=True) for m in METRICS])
def test_rank_eval_every_metric(pair, metric):
    requests = rank_corpus(pair)
    j, p = pair.do("POST", "/re/_rank_eval",
                   body={"requests": requests, "metric": metric})
    assert set(p) == set(j) == {"metric_score", "details"}
    assert set(p["details"]) == set(j["details"])
    scores = []
    for rid, pd in p["details"].items():
        jd = j["details"][rid]
        p_ids = [h["hit"]["_id"] for h in pd["hits"]]
        j_ids = [h["hit"]["_id"] for h in jd["hits"]]
        if p_ids == j_ids:
            assert pd == jd or np.isclose(pd["metric_score"],
                                          jd["metric_score"],
                                          rtol=1e-12, atol=0)
            assert pd["unrated_docs"] == jd["unrated_docs"]
            assert pd["hits"] == jd["hits"]
        else:
            # the ids differ only by a float32 tie (Queue 3): the pages'
            # searches agree by the tie rule, and the port's metric over
            # the reference's ids equals the reference's
            req = next(r for r in requests if r["id"] == rid)
            size = req["request"]["size"]
            st, got = pair.port.rest_controller.dispatch(
                "POST", "/re/_search", {}, dict(req["request"]))
            st, ref = pair.jax.rest_controller.dispatch(
                "POST", "/re/_search", {}, dict(req["request"],
                                                size=size + 1))
            assert_same_hits(got, ref, size)
            ratings = {str(r["_id"]): int(r["rating"])
                       for r in req["ratings"]}
            assert np.isclose(parse_metric(metric).evaluate(j_ids, ratings),
                              jd["metric_score"], rtol=1e-12, atol=0)
        # the metric over the port's own ids, by the reference's code
        req = next(r for r in requests if r["id"] == rid)
        ratings = {str(r["_id"]): int(r["rating"]) for r in req["ratings"]}
        assert np.isclose(pd["metric_score"],
                          jax_metric(metric).evaluate(p_ids, ratings),
                          rtol=1e-12, atol=0)
        scores.append(pd["metric_score"])
    assert np.isclose(p["metric_score"], np.mean(scores), rtol=1e-12)
    if all([h["hit"]["_id"] for h in p["details"][r]["hits"]]
           == [h["hit"]["_id"] for h in j["details"][r]["hits"]]
           for r in p["details"]):
        assert np.isclose(p["metric_score"], j["metric_score"],
                          rtol=1e-12, atol=0)


def test_rank_eval_default_metric_and_errors(pair):
    """The default metric (recall@10) over two requests, the first a bare
    match (the fast path on the port), and the typed 400s."""
    requests = rank_corpus(pair)[:2]
    requests[0] = dict(requests[0], request={
        "query": requests[0]["request"]["query"]["bool"]["should"][0],
        "size": 20})
    j, p = pair.do("GET", "/re/_rank_eval", body={"requests": requests})
    assert np.isclose(p["metric_score"], j["metric_score"], rtol=1e-12)
    for metric in ({"nope": {}}, {"precision": {}, "recall": {}}):
        (jst, jr), (st, pr) = pair.both("POST", "/re/_rank_eval", None, {
            "requests": requests[:1], "metric": metric})
        assert st == jst == 400
        assert pr["error"]["type"] == jr["error"]["type"]
        assert pr["error"]["reason"] == jr["error"]["reason"]
