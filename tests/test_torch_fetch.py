"""The fetch and sort features of the port's ``_search`` against the
reference's, on the CPU, over REST on both nodes.

- Keyword sorts and keyword ``search_after`` over three segments with
  deletes: a term in one segment only, docs without a value (last in
  either order), multi-key sorts, cursors on a term absent everywhere
  and on a missing value, and a walk of pages against one page of the
  same total size.
- ``_source`` filtering in all its forms (the reference's
  tests/test_search_service.py:127 cases and wildcard and nested
  includes/excludes), ``docvalue_fields`` and ``fields``.
- ``script_fields``: expressions (float32 column semantics) and a
  statement script, which has no scored context in either package and
  answers 400 ``script_exception``.
- ``collapse``, including the shortfall of the 5 x (from + size)
  over-collection, and ``terminate_after`` with ``terminated_early``.
- The keyword sort column is charged to the hbm breaker; every body
  above misses the fast path's grammar; the keys still left for later
  answer typed 400s.

Ids, order, totals, sort values, ``_source``, ``fields`` are equal;
scores rtol 1e-5 (the dense executor), or the tie-aware compare of
tests/test_torch_plan.py where the plan path serves the body.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.api import RestController
from test_torch_dense import assert_same_page
from test_torch_node import assert_same_hits

RTOL = 1e-5

# the reference's tests/test_search_features.py corpus
DOCS = [
    {"title": "the quick brown fox", "body": "jumps over the lazy dog",
     "group": "a", "rank": 3},
    {"title": "quick brown rabbits", "body": "rabbits hop quickly away",
     "group": "a", "rank": 1},
    {"title": "brown quick fox", "body": "a fox of a different color",
     "group": "b", "rank": 2},
    {"title": "slow green turtle", "body": "the turtle walks slowly home",
     "group": "b", "rank": 5},
    {"title": "quick silver surfer", "body": "surfing the quick waves",
     "group": "c", "rank": 4},
]

# tests/test_search_service.py's fill(), with an object field
T_MAPPINGS = {"properties": {"title": {"type": "text"},
                             "tag": {"type": "keyword"},
                             "views": {"type": "long"}}}


def t_docs(n=20):
    return [{"title": f"doc number {i} " + ("quick fox " * (i % 3)),
             "tag": "even" if i % 2 == 0 else "odd", "views": i,
             "meta": {"a": i % 4, "b": {"c": f"c{i}", "d": [i, i + 1]}},
             "note": f"n{i}"} for i in range(n)]


# three segments with deletes; "zeta" lives in the last segment only,
# about a tenth of the docs have no tag and some have two
K_MAPPINGS = {"properties": {"title": {"type": "text"},
                             "tag": {"type": "keyword"},
                             "name": {"type": "keyword"},
                             "views": {"type": "long"},
                             "price": {"type": "double"}}}
K_TAGS = ["blue", "red", "green", "amber", "teal", "violet"]
K_WORDS = ["alpha", "beta", "gamma", "delta", "wolf", "fox", "dog", "cat"]
K_SPLITS = [(0, 120), (120, 230), (230, 300)]
K_DELETED = [3, 150, 231, 299]


def k_docs():
    rng = np.random.default_rng(13)
    p = 1.0 / np.arange(1, len(K_TAGS) + 1)
    p /= p.sum()
    docs = []
    for i in range(300):
        d = {"title": " ".join(rng.choice(K_WORDS, int(rng.integers(1, 6)))),
             "name": f"n{int(rng.integers(0, 10 ** 6)):06d}-{i}",
             "views": int(rng.integers(0, 50)),
             "price": round(float(rng.uniform(0, 100)), 2)}
        r = rng.random()
        if r < 0.1:
            pass                              # no tag
        elif r < 0.2:
            d["tag"] = [str(rng.choice(K_TAGS, p=p)), "red"]
        else:
            d["tag"] = str(rng.choice(K_TAGS, p=p))
        if i >= 230 and i % 7 == 0:
            d["tag"] = "zeta"                 # the last segment only
        docs.append(d)
    return docs


def _bulk(docs, lo, hi):
    return "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                   + json.dumps(docs[i]) + "\n" for i in range(lo, hi))


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """Both nodes with "idx" (DOCS), "test" (t_docs, one segment) and
    "kw" (k_docs, three segments with deletes)."""
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("fetch")))
    node = Node(device="cpu")
    kdocs = k_docs()
    for c in (jax_node.rest_controller, node.rest_controller):
        for name, mappings in (("idx", None), ("test", T_MAPPINGS),
                               ("kw", K_MAPPINGS)):
            body = {"settings": {"index": {"number_of_shards": 1}}}
            if mappings:
                body["mappings"] = mappings
            assert c.dispatch("PUT", f"/{name}", {}, body)[0] == 200
        for index, docs, parts in (("idx", DOCS, [(0, 5)]),
                                   ("test", t_docs(), [(0, 20)]),
                                   ("kw", kdocs, K_SPLITS)):
            for lo, hi in parts:
                st, r = c.dispatch("POST", f"/{index}/_bulk",
                                   {"refresh": "true"},
                                   _bulk(docs, lo, hi))
                assert st == 200 and not r["errors"], r
        deletes = "".join(json.dumps({"delete": {"_id": str(i)}}) + "\n"
                          for i in K_DELETED)
        st, r = c.dispatch("POST", "/kw/_bulk", {"refresh": "true"},
                           deletes)
        assert st == 200 and not r["errors"], r
    assert len(node.indices["kw"].engine.segments) == 3
    yield jax_node, node
    node.close()
    jax_node.close()


def both(nodes, index, body, plan=False):
    """(port answer, reference answer) with their statuses checked; a
    plan-path body asks the reference one hit more (the tie-aware
    compare)."""
    jax_node, node = nodes
    st, got = node.rest_controller.dispatch(
        "POST", f"/{index}/_search", {}, body)
    ref_body = dict(body, size=body.get("size", 10) + 1) if plan else body
    st2, ref = jax_node.rest_controller.dispatch(
        "POST", f"/{index}/_search", {}, ref_body)
    assert st == st2 == 200, (got, ref)
    return got, ref


def assert_same(got, ref, plan=False, size=10):
    """The page equal (assert_same_page, or the tie-aware compare of the
    plan path), and each hit's fields and highlight equal."""
    if plan:
        assert_same_hits(got, ref, size, rtol=RTOL)
        ref = dict(ref, hits=dict(ref["hits"],
                                  hits=ref["hits"]["hits"][:size]))
    else:
        assert_same_page(got, ref)
    for a, b in zip(got["hits"]["hits"], ref["hits"]["hits"]):
        if a["_id"] != b["_id"]:
            continue
        assert a.get("fields") == b.get("fields"), (a, b)
        assert a.get("highlight") == b.get("highlight"), (a, b)
        assert a.get("_source") == b.get("_source"), (a, b)
    assert got.get("terminated_early") == ref.get("terminated_early")


def ids(r):
    return [h["_id"] for h in r["hits"]["hits"]]


def _sorted_tags(docs, deleted):
    """The numpy oracle of a keyword sort: each live doc's first term
    (the smallest of its values), None last."""
    out = []
    for i, d in enumerate(docs):
        if i in deleted:
            continue
        t = d.get("tag")
        t = min(t) if isinstance(t, list) else t
        out.append((t, i))
    return out


# ---------------------------------------------------------------------------
# keyword sorts
# ---------------------------------------------------------------------------

KW_SORTS = [
    {"sort": [{"tag": "asc"}], "size": 300},
    {"sort": [{"tag": "desc"}], "size": 300},
    {"sort": [{"tag": {"order": "desc"}}], "size": 7, "from": 40},
    {"sort": ["tag"], "size": 25},
    {"sort": [{"tag": "asc"}, {"views": "desc"}], "size": 60},
    {"sort": [{"tag": "desc"}, {"price": "asc"}], "size": 300},
    {"sort": [{"tag": "asc"}, "_doc"], "size": 40},
    {"sort": [{"views": "asc"}, {"tag": "desc"}], "size": 80},
    {"sort": [{"name": "asc"}], "size": 30},
    {"sort": [{"name": "desc"}], "size": 30},
    {"query": {"match": {"title": "fox"}}, "sort": [{"tag": "asc"}],
     "size": 50},
    {"query": {"match": {"title": "wolf dog"}},
     "sort": [{"tag": "desc"}, "_score"], "size": 50},
    {"query": {"bool": {"must": [{"match": {"title": "alpha"}}],
                        "filter": [{"range": {"views": {"gte": 10}}}]}},
     "sort": [{"tag": "asc"}, {"name": "asc"}], "size": 20},
    {"query": {"term": {"tag": "zeta"}}, "sort": [{"tag": "desc"}],
     "size": 50},
    {"post_filter": {"term": {"tag": "red"}}, "sort": [{"tag": "asc"}],
     "size": 40},
]


@pytest.mark.parametrize("body", KW_SORTS)
def test_keyword_sort_as_the_reference(nodes, body):
    got, ref = both(nodes, "kw", body)
    assert_same(got, ref)
    assert got["hits"]["max_score"] is None


@pytest.mark.parametrize("order", ["asc", "desc"])
def test_keyword_sort_against_numpy(nodes, order):
    """Lexicographic term order, missing last in either order, ties by
    (segment, docid): the merged segments' docs in insertion order."""
    _, node = nodes
    st, r = node.rest_controller.dispatch(
        "POST", "/kw/_search", {},
        {"sort": [{"tag": order}], "size": 400, "_source": False})
    assert st == 200
    rows = _sorted_tags(k_docs(), set(K_DELETED))
    present = sorted((t, i) for t, i in rows if t is not None)
    if order == "desc":
        # ties by (segment, docid) ascending: docs ascend within a term
        present.sort(key=lambda e: e[1])
        present.sort(key=lambda e: e[0], reverse=True)
    missing = [(t, i) for t, i in rows if t is None]
    want = present + missing
    assert ids(r) == [str(i) for _, i in want]
    assert [h["sort"] for h in r["hits"]["hits"]] == [[t] for t, _ in want]
    assert r["hits"]["total"]["value"] == len(want)


CURSORS = [["zeta"], ["red"], ["m"], ["aaa"], ["zzz"], [None],
           ["blue"], ["violet"]]


@pytest.mark.parametrize("order", ["asc", "desc"])
@pytest.mark.parametrize("after", CURSORS)
def test_keyword_search_after(nodes, after, order):
    """A cursor on a term of one segment only, on terms absent from every
    segment (before, between and after the terms), and on a missing
    value: each segment re-ranks the term in its own dictionary."""
    got, ref = both(nodes, "kw", {"sort": [{"tag": order}], "size": 300,
                                  "search_after": after})
    assert_same(got, ref)


@pytest.mark.parametrize("after", [["red", 40], ["zeta", 0], [None, 10],
                                   ["green", 1000]])
def test_keyword_search_after_with_doc_tiebreak(nodes, after):
    got, ref = both(nodes, "kw", {"sort": [{"tag": "asc"}, "_doc"],
                                  "size": 100, "search_after": after})
    assert_same(got, ref)


@pytest.mark.parametrize("sort", [[{"name": "asc"}], [{"name": "desc"}]])
def test_keyword_search_after_walk(nodes, sort):
    """A walk of pages of 13 on a unique keyword equals one page of the
    whole size, on both nodes."""
    jax_node, node = nodes
    for c in (node.rest_controller, jax_node.rest_controller):
        st, whole = c.dispatch("POST", "/kw/_search", {},
                               {"sort": sort, "size": 400})
        walked, after = [], None
        while True:
            body = {"sort": sort, "size": 13}
            if after is not None:
                body["search_after"] = after
            st, r = c.dispatch("POST", "/kw/_search", {}, body)
            assert st == 200
            if not r["hits"]["hits"]:
                break
            walked += r["hits"]["hits"]
            after = r["hits"]["hits"][-1]["sort"]
        assert [h["_id"] for h in walked] == ids(whole)
        assert len(walked) == 300 - len(K_DELETED)


def test_keyword_sort_dynamic_keyword_subfield(nodes):
    """A dynamic text field sorts on its .keyword subfield."""
    for body in ({"sort": [{"group.keyword": "desc"}, {"rank": "asc"}]},
                 {"sort": [{"group.keyword": "asc"}], "size": 3,
                  "search_after": ["a"]}):
        got, ref = both(nodes, "idx", body)
        assert_same(got, ref)


def test_keyword_sort_column_is_charged(nodes):
    """The column is built once per segment, charged under "ordinals",
    and the breaker equals the engine's device bytes after it."""
    _, node = nodes
    st, _ = node.rest_controller.dispatch(
        "POST", "/kw/_search", {}, {"sort": [{"name": "asc"}], "size": 5})
    assert st == 200
    cache = node.device_cache
    for seg in node.indices["kw"].engine.segments:
        dev = cache.get(seg)
        col, miss = dev.keyword_ord_column("name")
        assert dev.keyword_ord_column("name")[0] is col
        assert col.dtype.is_floating_point and miss.dtype == np.bool_ or \
            str(miss.dtype) == "torch.bool"
        assert dev.hbm_bytes_by_class()["ordinals"] >= \
            int(col.nbytes + miss.nbytes)
        assert dev.keyword_ord_column("no_such_field") is None
    assert cache.breaker.used == cache.hbm_stats()["total_bytes"]


# ---------------------------------------------------------------------------
# _source filtering, docvalue_fields, fields
# ---------------------------------------------------------------------------

SOURCE_FILTERS = [
    ["views"], False, True, "title", "ti*", ["views", "tag"],
    {"includes": ["meta.*"]}, {"includes": "meta.b"},
    {"excludes": ["meta.b"]}, {"excludes": "meta.b.c"},
    {"includes": ["meta"], "excludes": ["meta.b.c"]},
    {"include": ["tag", "note"]}, {"exclude": ["title", "meta"]},
    {"includes": ["nothing_here"]}, ["meta.b.d"], "*",
]


@pytest.mark.parametrize("source", SOURCE_FILTERS)
def test_source_filtering(nodes, source):
    got, ref = both(nodes, "test", {"_source": source, "size": 5,
                                    "sort": [{"views": "asc"}]})
    assert_same(got, ref)


def test_source_filtering_reference_cases(nodes):
    """tests/test_search_service.py:127 on the port."""
    _, node = nodes
    c = node.rest_controller
    st, r = c.dispatch("POST", "/test/_search", {},
                       {"_source": ["views"], "size": 1})
    assert set(r["hits"]["hits"][0]["_source"]) == {"views"}
    st, r = c.dispatch("POST", "/test/_search", {},
                       {"_source": False, "size": 1})
    assert "_source" not in r["hits"]["hits"][0]


FIELDS_BODIES = [
    ("test", {"docvalue_fields": ["views", "tag"], "size": 3,
              "sort": [{"views": "asc"}]}),
    ("test", {"docvalue_fields": [{"field": "views"}, "nope"],
              "size": 3, "sort": [{"views": "desc"}]}),
    ("test", {"fields": ["tag", "views", "title", "meta.a", "meta.b.d",
                         "missing"], "size": 4, "sort": ["views"]}),
    ("test", {"fields": [{"field": "note"}], "docvalue_fields": ["tag"],
              "_source": False, "size": 4, "sort": ["views"]}),
    ("idx", {"query": {"match_all": {}}, "fields": ["group", "rank"]}),
    ("kw", {"docvalue_fields": ["tag", "price"], "size": 30,
            "sort": [{"tag": "asc"}]}),
]


@pytest.mark.parametrize("index,body", FIELDS_BODIES)
def test_fields_and_docvalue_fields(nodes, index, body):
    got, ref = both(nodes, index, body)
    assert_same(got, ref)


def test_fields_reference_cases(nodes):
    """tests/test_search_service.py:135 and test_search_features.py:331
    on the port."""
    _, node = nodes
    c = node.rest_controller
    st, r = c.dispatch("POST", "/test/_search", {},
                       {"docvalue_fields": ["views", "tag"], "size": 1,
                        "sort": [{"views": "asc"}]})
    assert r["hits"]["hits"][0]["fields"] == {"views": [0.0],
                                              "tag": ["even"]}
    st, r = c.dispatch("POST", "/idx/_search", {},
                       {"query": {"match_all": {}},
                        "fields": ["group", "rank"]})
    by_id = {h["_id"]: h for h in r["hits"]["hits"]}
    assert by_id["1"]["fields"]["group"] == ["a"]
    assert by_id["1"]["fields"]["rank"] == [1.0]


# ---------------------------------------------------------------------------
# script_fields
# ---------------------------------------------------------------------------

SCRIPT_FIELDS = [
    {"double_rank": {"script": "doc['rank'].value * 2"}},
    {"r": {"script": {"source": "doc['rank'].value + params.x",
                      "params": {"x": 0.25}}},
     "l": {"script": {"source": "Math.log(doc['rank'].value) / 3"}}},
    {"c": {"script": "10"}},
    {"m": {"script": "doc['nope'].value + doc['nope'].size()"}},
]


@pytest.mark.parametrize("sf", SCRIPT_FIELDS)
def test_script_fields(nodes, sf):
    got, ref = both(nodes, "idx", {"query": {"match_all": {}},
                                   "script_fields": sf})
    assert_same(got, ref)


@pytest.mark.parametrize("body", [
    {"script_fields": {"p": {"script": "doc['price'].value * 1.1 + "
                                       "doc['views'].value"}},
     "sort": [{"tag": "desc"}], "size": 60},
    {"query": {"match": {"title": "fox"}}, "size": 25,
     "script_fields": {"v": {"script": "doc['views'].value / 7"}},
     "_source": False},
])
def test_script_fields_over_segments(nodes, body):
    got, ref = both(nodes, "kw", body,
                    plan="sort" not in body)
    assert_same(got, ref, plan="sort" not in body, size=body["size"])


def test_script_fields_reference_case(nodes):
    """test_search_features.py:321 on the port, and the values against
    a float64 oracle under float32 column semantics."""
    _, node = nodes
    st, r = node.rest_controller.dispatch(
        "POST", "/idx/_search", {},
        {"query": {"match_all": {}}, "script_fields": {
            "double_rank": {"script": "doc['rank'].value * 2"},
            "third": {"script": "doc['rank'].value / 3"}}})
    by_id = {h["_id"]: h for h in r["hits"]["hits"]}
    assert by_id["0"]["fields"]["double_rank"] == [6.0]
    for i, d in enumerate(DOCS):
        want = np.float64(np.float32(d["rank"]) / np.float32(3))
        np.testing.assert_allclose(by_id[str(i)]["fields"]["third"][0],
                                   want, rtol=1e-6)


def test_statement_script_field_answers_400(nodes):
    """A statement script has no scored context in script_fields: both
    packages answer 400 script_exception (ROADMAP Queue 3)."""
    jax_node, node = nodes
    body = {"query": {"match_all": {}}, "script_fields": {"s": {
        "script": "double t = 0; for (int i = 0; i < 3; ++i) "
                  "{ t += doc['rank'].value; } return t;"}}}
    for c in (node.rest_controller, jax_node.rest_controller):
        st, r = c.dispatch("POST", "/idx/_search", {}, body)
        assert st == 400, r
        assert r["error"]["type"] == "script_exception"


# ---------------------------------------------------------------------------
# collapse and terminate_after
# ---------------------------------------------------------------------------

# a scored body sorts on a field: the plan path's float32 ties (equal
# titles score apart in the last bit in the reference) would otherwise
# pick other representatives of a group (test_collapse_on_the_plan_path)
COLLAPSE = [
    ("idx", {"query": {"match_all": {}}, "collapse": {"field": "group"}}),
    ("idx", {"query": {"match": {"title": "quick"}},
             "sort": [{"rank": "desc"}],
             "collapse": {"field": "group"}, "size": 2}),
    ("kw", {"collapse": {"field": "tag"}, "sort": [{"views": "asc"}],
            "size": 10}),
    ("kw", {"collapse": {"field": "views"}, "sort": [{"price": "desc"}],
            "size": 15, "from": 5}),
    ("kw", {"query": {"match": {"title": "alpha"}},
            "sort": [{"price": "desc"}],
            "collapse": {"field": "tag"}, "size": 10}),
]


@pytest.mark.parametrize("index,body", COLLAPSE)
def test_collapse(nodes, index, body):
    got, ref = both(nodes, index, body)
    assert_same(got, ref)
    keys = [h["fields"][body["collapse"]["field"]][0]
            for h in got["hits"]["hits"]]
    assert len(keys) == len(set(keys))
    assert got["hits"]["total"]["value"] >= len(keys)


def test_collapse_on_the_plan_path(nodes):
    """A plan-path body collapses the launch's hits: one per key, in
    score order, the total before the collapse (against the reference:
    the same totals and groups' scores within the tie-aware rtol)."""
    got, ref = both(nodes, "kw", {"query": {"match": {"title": "alpha"}},
                                  "collapse": {"field": "tag"}})
    assert got["hits"]["total"] == ref["hits"]["total"]
    keys = [h["fields"]["tag"][0] for h in got["hits"]["hits"]]
    assert len(keys) == len(set(keys)) == len(ref["hits"]["hits"])
    np.testing.assert_allclose([h["_score"] for h in got["hits"]["hits"]],
                               [h["_score"] for h in ref["hits"]["hits"]],
                               rtol=1e-4)


def test_collapse_reference_case(nodes):
    """test_search_features.py:248 on the port: one hit per group, the
    total counts before the collapse."""
    _, node = nodes
    st, r = node.rest_controller.dispatch(
        "POST", "/idx/_search", {},
        {"query": {"match_all": {}}, "collapse": {"field": "group"}})
    assert sorted(h["fields"]["group"][0] for h in r["hits"]["hits"]) == \
        ["a", "b", "c"]
    assert r["hits"]["total"]["value"] == 5


def test_collapse_shortfall(nodes):
    """The query phase collects 5 x (from + size) docs before the
    collapse: sorted by tag, the first 15 docs hold fewer than 3 tags,
    so a size-3 page comes back short, as the reference's."""
    got, ref = both(nodes, "kw", {"collapse": {"field": "tag"},
                                  "sort": [{"tag": "asc"}], "size": 3})
    assert_same(got, ref)
    assert 0 < len(got["hits"]["hits"]) < 3
    # the index holds all six tags and more
    _, node = nodes
    st, r = node.rest_controller.dispatch(
        "POST", "/kw/_search", {}, {"collapse": {"field": "tag"},
                                    "sort": [{"tag": "asc"}], "size": 60})
    assert len(r["hits"]["hits"]) >= 6


TERMINATE = [
    ("idx", {"query": {"match_all": {}}, "terminate_after": 2}),
    ("idx", {"query": {"match_all": {}}, "terminate_after": 50}),
    ("kw", {"terminate_after": 7, "size": 20, "sort": [{"tag": "asc"}]}),
    ("kw", {"terminate_after": 40, "size": 10,
            "query": {"match": {"title": "fox"}},
            "sort": [{"name": "desc"}]}),
    ("kw", {"terminate_after": 5, "track_total_hits": False}),
    ("kw", {"terminate_after": 5, "track_total_hits": 3}),
    ("kw", {"terminate_after": 3, "collapse": {"field": "tag"},
            "size": 5}),
]


@pytest.mark.parametrize("index,body", TERMINATE)
def test_terminate_after(nodes, index, body):
    got, ref = both(nodes, index, body)
    if body.get("track_total_hits") is False:
        assert "total" not in got["hits"] and "total" not in ref["hits"]
        assert ids(got) == ids(ref)
        assert got["terminated_early"] == ref["terminated_early"]
        return
    assert_same(got, ref)
    assert "terminated_early" in got
    assert len(got["hits"]["hits"]) <= body["terminate_after"]


def test_terminate_after_reference_case(nodes):
    """test_search_features.py:340 on the port."""
    _, node = nodes
    st, r = node.rest_controller.dispatch(
        "POST", "/idx/_search", {},
        {"query": {"match_all": {}}, "terminate_after": 2})
    assert r["terminated_early"] is True
    assert r["hits"]["total"] == {"value": 2, "relation": "gte"}
    st, r = node.rest_controller.dispatch(
        "POST", "/idx/_search", {},
        {"query": {"match_all": {}}, "terminate_after": 9})
    assert r["terminated_early"] is False
    assert r["hits"]["total"] == {"value": 5, "relation": "eq"}


# ---------------------------------------------------------------------------
# routing and the keys still left
# ---------------------------------------------------------------------------

FETCH_BODIES = [
    {"query": {"match": {"title": "quick"}}, "highlight": {
        "fields": {"title": {}}}},
    {"query": {"match": {"title": "quick"}}, "docvalue_fields": ["rank"]},
    {"query": {"match": {"title": "quick"}}, "fields": ["rank"]},
    {"query": {"match": {"title": "quick"}}, "script_fields": {
        "x": {"script": "doc['rank'].value"}}},
    {"query": {"match": {"title": "quick"}}, "collapse": {"field": "group"}},
    {"query": {"match": {"title": "quick"}}, "terminate_after": 2,
     "sort": [{"rank": "asc"}]},
    {"query": {"match": {"title": "quick"}}, "suggest": {
        "s": {"text": "quikc", "term": {"field": "title"}}}},
    {"query": {"match": {"title": "quick"}}, "_source": ["title"]},
    {"query": {"match": {"title": "quick"}}, "sort": [{"group.keyword":
                                                       "asc"}]},
]


@pytest.mark.parametrize("body", FETCH_BODIES)
def test_fetch_bodies_miss_the_fast_grammar(nodes, body):
    """None of these fits the fast path: each reaches the service, and
    answers as the reference."""
    _, node = nodes
    svc = node.indices["idx"]
    assert RestController._fast_body(svc, body) is None
    assert RestController._fast_body(
        svc, {"query": body["query"], "_source": False}) is not None
    plan = "sort" not in body
    got, ref = both(nodes, "idx", body, plan=plan)
    assert_same(got, ref, plan=plan)
    assert got.get("suggest") == ref.get("suggest")


@pytest.mark.parametrize("key,value", [
    ("indices_boost", [{"idx": 2.0}]), ("stats", ["group"]),
    ("stored_fields", ["title"]), ("explain", True),
    ("runtime_mappings", {"r": {"type": "long"}}), ("ext", {"x": {}}),
    ("timeout", "1s")])
def test_later_keys_stay_typed_400(nodes, key, value):
    _, node = nodes
    st, r = node.rest_controller.dispatch(
        "POST", "/idx/_search", {}, {key: value})
    assert st == 400, r
    assert key in r["error"]["reason"]
