"""Indices of several shards on one node: the port against the
reference, through both nodes' ``rest_controller.dispatch`` on the same
documents made from a numpy seed, at 2, 3 and 5 shards.

The reference runs with ``ESTPU_MESH_SERVING=0``: it takes the mesh
only with as many devices as shards (``fallback.not_enough_devices``),
and one H100 is one device, so on the port's card the reference itself
serves every multi-shard body through the per-shard loop; the tests'
eight virtual CPU devices would otherwise send it the mesh's way.

Cases: routing (``shard_for`` of 2,000 ids, a join child by its parent,
a bulk item's ``routing``), the shard-count setting's forms and its
400s, the query family (match, bool, term, range with a sort), keyword
sorts and their ``search_after`` walk, collapse, aggs, suggest,
highlight, profile entries, terminate_after, the track_total_hits
threshold, size 0, kNN and rank.rrf, has_child/has_parent, percolate of
a stored document by index, id and routing, more_like_this across
shards, ``dfs_query_then_fetch`` (each search type against a fresh
reference node: the reference's plan memo keys no statistics, Queue 3
of ROADMAP.md; and the port's answers whatever the order of the two
types), the per-shard failure barrier with
``allow_partial_search_results`` true and false, multi-index
expressions, and a multi-shard index that the C++ front never
registers and ``_fast_body`` never takes.

Ids, order and totals are exact. Scores agree within 1e-5 on the dense
executor; plan-path bodies (a score-sorted match or bool) keep
test_torch_node's tie-aware compare (rtol 1e-4), because the
reference's float32 plan path can split a true tie.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.index.service import IndexService as JaxIndexService
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.search import searcher as jax_searcher
from elasticsearch_tpu_torch.index.service import IndexService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.api import RestController
from elasticsearch_tpu_torch.search import searcher as port_searcher


SHARDS = (2, 3, 5)
RTOL = 1e-5
VOCAB = [f"w{i}" for i in range(30)]
KEYWORDS = [f"k{i:02d}" for i in range(12)]
MAPPINGS = {"properties": {
    "t": {"type": "text"}, "k": {"type": "keyword"},
    "u": {"type": "keyword"}, "n": {"type": "long"},
    "v": {"type": "dense_vector", "dims": 4, "similarity": "cosine"}}}
N_DOCS = 240
DELETED = ("3", "17", "101")


def make_docs(seed=0, n=N_DOCS):
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.07
    zipf /= zipf.sum()
    # n is unique, so a sort on it breaks every tie of a search_after walk
    ns = rng.choice(1000, n, replace=False)
    docs = []
    for i in range(n):
        d = {"t": " ".join(rng.choice(VOCAB, int(rng.integers(2, 14)),
                                      p=zipf)),
             "n": int(ns[i]), "u": f"u{int(ns[i]):04d}",
             "v": rng.standard_normal(4).round(4).tolist()}
        if i % 9:
            d["k"] = str(rng.choice(KEYWORDS))
        docs.append(d)
    return docs


def bulk_lines(docs, ids=None):
    ids = ids or [str(i) for i in range(len(docs))]
    return "".join(json.dumps({"index": {"_id": i}}) + "\n"
                   + json.dumps(d) + "\n" for i, d in zip(ids, docs))


def put_index(c, name, shards, mappings=MAPPINGS):
    st, r = c.dispatch("PUT", f"/{name}", {}, {
        "settings": {"index": {"number_of_shards": shards}},
        "mappings": mappings})
    assert st == 200, r


def fill(c, name, docs, deleted=DELETED):
    st, r = c.dispatch("POST", f"/{name}/_bulk", {}, bulk_lines(docs))
    assert st == 200 and not r["errors"], r
    st, r = c.dispatch("POST", f"/{name}/_refresh", {}, None)
    assert st == 200
    dels = "".join(json.dumps({"delete": {"_id": i}}) + "\n"
                   for i in deleted)
    st, r = c.dispatch("POST", f"/{name}/_bulk", {"refresh": "true"}, dels)
    assert st == 200 and not r["errors"], r


@pytest.fixture(scope="module", autouse=True)
def one_device():
    """The reference's per-shard loop, as on one device (module
    docstring)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ESTPU_MESH_SERVING", "0")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("shards")))
    node = Node(device="cpu")
    docs = make_docs()
    for c in (jax_node.rest_controller, node.rest_controller):
        for n in SHARDS:
            put_index(c, f"s{n}", n)
            fill(c, f"s{n}", docs)
    yield jax_node, node
    node.close()
    jax_node.close()


def fresh_nodes(tmp_path, shards, docs=None):
    """A new reference node and a new port node holding ``s{shards}``."""
    jax_node = JaxNode(data_path=str(tmp_path))
    node = Node(device="cpu")
    for c in (jax_node.rest_controller, node.rest_controller):
        put_index(c, f"s{shards}", shards)
        fill(c, f"s{shards}", docs or make_docs())
    return jax_node, node


def ask(node, path, body, params=None):
    body = dict(body) if body is not None else None
    if isinstance(node, JaxNode) and body is not None \
            and body.get("size") == 0:
        # the reference caches size-0 responses; the port refuses the key
        body["request_cache"] = False
    return node.rest_controller.dispatch("POST", path, dict(params or {}),
                                         body)


def hits_of(r):
    return [(h["_index"], h["_id"]) for h in r["hits"]["hits"]]


def assert_same_hits(got, ref, size, rtol=1e-4):
    """test_torch_node's tie-aware compare, whatever the relation: equal
    totals, scores within ``rtol``, equal ids in equal order up to the
    order inside a group of scores that agree within ``rtol``; ``ref``
    answers ``size + 1`` hits, and its extra hit says whether the page
    cuts its last group."""
    assert got["hits"].get("total") == ref["hits"].get("total")
    gh, rh = got["hits"]["hits"], ref["hits"]["hits"]
    assert len(gh) == min(size, len(rh))
    past = [h["_score"] for h in rh[size:]]
    rh = rh[:size]
    gs = np.array([h["_score"] for h in gh])
    rs = np.array([h["_score"] for h in rh])
    np.testing.assert_allclose(gs, rs, rtol=rtol, atol=0)
    i = 0
    while i < len(rh):
        j = i + 1
        while j < len(rh) and abs(rs[j] - rs[i]) <= rtol * abs(rs[i]):
            j += 1
        cut = (j == len(rh) and past
               and abs(past[0] - rs[i]) <= rtol * abs(rs[i]))
        if not cut:
            assert {(h["_index"], h["_id"]) for h in gh[i:j]} == \
                {(h["_index"], h["_id"]) for h in rh[i:j]}, (i, j)
        i = j


def assert_same(ref, got, plan=False, size=None, shards=True):
    """Equal ``_shards`` (unless ``shards`` is false), totals, ids in
    order, sort values and the other sections; scores within RTOL (plan:
    the tie-aware compare, the reference asked one hit more)."""
    if shards:
        assert got["_shards"] == ref["_shards"]
    if plan:
        assert_same_hits(got, ref, size)
        return
    assert got["hits"].get("total") == ref["hits"].get("total")
    assert hits_of(got) == hits_of(ref)
    gs = [h["_score"] for h in got["hits"]["hits"]]
    rs = [h["_score"] for h in ref["hits"]["hits"]]
    assert [s is None for s in gs] == [s is None for s in rs]
    np.testing.assert_allclose([s for s in gs if s is not None],
                               [s for s in rs if s is not None],
                               rtol=RTOL, atol=0)
    for gh, rh in zip(got["hits"]["hits"], ref["hits"]["hits"]):
        for key in ("sort", "highlight", "fields", "_source"):
            assert gh.get(key) == rh.get(key), (key, gh, rh)
    for key in ("aggregations", "suggest", "terminated_early"):
        assert got.get(key) == ref.get(key), key


# ---------------------------------------------------------------------------
# routing and the setting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", (1,) + SHARDS + (7, 1024))
def test_shard_for_equals_the_reference(shards, tmp_path):
    rng = np.random.default_rng(shards)
    ids = [str(i) for i in range(1500)] + [
        f"doc-{i}-é" for i in range(250)] + [
        rng.bytes(int(rng.integers(1, 9))).hex() for _ in range(250)]
    ref = JaxIndexService("r", str(tmp_path), Settings.from_dict(
        {"index.number_of_shards": shards}))
    port = IndexService("p", str(tmp_path / "p"),
                        {"index.number_of_shards": shards})
    assert [port.shard_for(i) for i in ids] == [ref.shard_for(i) for i in ids]
    assert [port.shard_for("x", r) for r in ids[:200]] == \
        [ref.shard_for("x", r) for r in ids[:200]]


@pytest.mark.parametrize("settings", [
    {"index.number_of_shards": 4}, {"index": {"number_of_shards": "5"}},
    {"number_of_shards": 3}, {"index.number_of_shards": 2.5},
    {"index": {"number_of_shards": 0}}, {"index.number_of_shards": -1},
    {"index": {"number_of_shards": 1025}},
    {"index": {"number_of_shards": "x"}},
    {"index": {"number_of_shards": 1024}}])
def test_shard_setting_forms_and_400s(settings, tmp_path):
    jax_node = JaxNode(data_path=str(tmp_path))
    node = Node(device="cpu")
    try:
        (jst, ref), (st, got) = (
            c.dispatch("PUT", "/s", {}, {"settings": settings})
            for c in (jax_node.rest_controller, node.rest_controller))
        assert st == jst, (ref, got)
        if st == 200:
            assert node.indices["s"].num_shards == len(
                jax_node.indices_service.get("s").shards)
        else:
            assert got["error"]["type"] == ref["error"]["type"] \
                == "settings_exception"
            assert got["error"]["reason"] == ref["error"]["reason"]
            assert "s" not in node.indices
    finally:
        node.close()
        jax_node.close()


JOIN_MAPPINGS = {"properties": {
    "t": {"type": "text"},
    "rel": {"type": "join", "relations": {"q": "a"}}}}


def join_docs(n_q=12, n_a=40, seed=3):
    rng = np.random.default_rng(seed)
    items = [(f"q{i}", {"t": " ".join(rng.choice(VOCAB[:10], 3)),
                        "rel": "q"}) for i in range(n_q)]
    for j in range(n_a):
        parent = f"q{int(rng.integers(0, n_q))}"
        items.append((f"a{j}", {"t": " ".join(rng.choice(VOCAB[:10], 4)),
                                "rel": {"name": "a", "parent": parent}}))
    return items


@pytest.fixture(scope="module")
def join_nodes(tmp_path_factory):
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("join")))
    node = Node(device="cpu")
    items = join_docs()
    lines = "".join(json.dumps({"index": {"_id": i}}) + "\n"
                    + json.dumps(d) + "\n" for i, d in items)
    for c in (jax_node.rest_controller, node.rest_controller):
        put_index(c, "fam", 3, JOIN_MAPPINGS)
        st, r = c.dispatch("POST", "/fam/_bulk", {"refresh": "true"}, lines)
        assert st == 200 and not r["errors"], r
    yield jax_node, node
    node.close()
    jax_node.close()


def test_a_child_lands_on_its_parents_shard(join_nodes):
    jax_node, node = join_nodes
    svc = node.indices["fam"]
    jsvc = jax_node.indices_service.get("fam")
    for doc_id, d in join_docs():
        rel = d["rel"]
        want = svc.shard_for(rel["parent"] if isinstance(rel, dict)
                             else doc_id)
        held = [i for i, e in enumerate(svc.shards)
                if any(s.docid_for(doc_id) >= 0 for s in e.segments)]
        jheld = [i for i, e in enumerate(jsvc.shards)
                 if any(s.docid_for(doc_id) >= 0 for s in e.segments)]
        assert held == jheld == [want], doc_id


def test_bulk_routing_from_the_action_line_and_the_url(tmp_path):
    """The action line's ``routing`` as the reference's; the URL's
    ``routing`` is the items' default in the port (the reference's bulk
    ignores it, Queue 3 of ROADMAP.md), so only the port is asked."""
    node = Node(device="cpu")
    jax_node = JaxNode(data_path=str(tmp_path))
    try:
        lines = "".join(
            json.dumps({"index": {"_id": str(i), "routing": f"r{i % 4}"}})
            + "\n" + json.dumps({"t": f"w{i}"}) + "\n" for i in range(40))
        for c in (jax_node.rest_controller, node.rest_controller):
            put_index(c, "rt", 5)
            st, r = c.dispatch("POST", "/rt/_bulk", {"refresh": "true"},
                               lines)
            assert st == 200 and not r["errors"]
        svc = node.indices["rt"]
        jsvc = jax_node.indices_service.get("rt")
        for i in range(40):
            sh = svc.shard_for(str(i), f"r{i % 4}")
            assert svc.shards[sh].get(str(i)).source == {"t": f"w{i}"}
            assert jsvc.shards[sh].get(str(i)).found
        st, _ = node.rest_controller.dispatch(
            "POST", "/rt/_bulk", {"refresh": "true", "routing": "zz"},
            json.dumps({"index": {"_id": "u"}}) + "\n{\"t\": \"w1\"}\n")
        assert st == 200
        assert svc.get_doc("u", "zz").source == {"t": "w1"}
        assert svc.shards[svc.shard_for("u", "zz")].get("u").found
    finally:
        node.close()
        jax_node.close()


# ---------------------------------------------------------------------------
# the query loop and the merge
# ---------------------------------------------------------------------------

QV = [0.3, -0.2, 0.9, 0.1]
# (body, plan path): a plan-path body is compared tie-aware
BODIES = {
    "match": ({"query": {"match": {"t": "w1 w3"}}, "size": 10}, True),
    "bool": ({"query": {"bool": {
        "must": [{"match": {"t": "w2"}}],
        "filter": [{"terms": {"k": ["k01", "k03", "k05", "k07"]}}],
        "should": [{"match": {"t": "w5"}}]}}, "size": 20}, True),
    "term": ({"query": {"term": {"k": "k04"}}, "size": 15,
              "sort": [{"n": "asc"}]}, False),
    "range_sort": ({"query": {"range": {"n": {"gte": 100, "lt": 700}}},
                    "sort": [{"n": "desc"}], "size": 30}, False),
    "match_sort": ({"query": {"match": {"t": "w0 w7"}},
                    "sort": [{"k": "desc"}, {"n": "asc"}], "size": 25},
                   False),
    "keyword_sort": ({"sort": [{"k": "asc"}, {"n": "asc"}], "size": 40},
                     False),
    "collapse": ({"query": {"match": {"t": "w1"}}, "collapse": {"field": "k"},
                  "sort": [{"n": "asc"}], "size": 6}, False),
    "aggs": ({"query": {"match": {"t": "w2"}}, "size": 0,
              "aggs": {"byk": {"terms": {"field": "k"}},
                       "avg": {"avg": {"field": "n"}},
                       "h": {"histogram": {"field": "n",
                                           "interval": 250}}}}, False),
    "suggest": ({"size": 0, "suggest": {
        "s": {"text": "w1x w22", "term": {"field": "t"}}}}, False),
    "highlight": ({"query": {"match": {"t": "w3"}}, "size": 8,
                   "sort": [{"n": "desc"}],
                   "highlight": {"fields": {"t": {}}}}, False),
    "terminate_after": ({"query": {"match_all": {}}, "terminate_after": 20,
                         "size": 100, "sort": [{"n": "asc"}]}, False),
    "threshold": ({"query": {"match": {"t": "w0"}}, "size": 5,
                   "track_total_hits": 10}, True),
    "size0": ({"query": {"match": {"t": "w4 w6"}}, "size": 0}, False),
    "from": ({"query": {"range": {"n": {"gte": 300}}}, "from": 7, "size": 9,
              "sort": [{"n": "asc"}], "_source": ["n"]}, False),
    "post_filter": ({"query": {"match": {"t": "w1"}}, "sort": [{"n": "asc"}],
                     "post_filter": {"term": {"k": "k02"}}, "size": 10},
                    False),
    "knn": ({"knn": {"field": "v", "query_vector": QV, "k": 6,
                     "num_candidates": 30}, "_source": False, "size": 6},
            False),
    "knn_dense": ({"knn": {"field": "v", "query_vector": QV, "k": 6,
                           "num_candidates": 30}, "size": 6}, False),
    "rrf": ({"query": {"term": {"k": "k05"}},
             "knn": {"field": "v", "query_vector": QV, "k": 5,
                     "num_candidates": 20},
             "rank": {"rrf": {"window_size": 10}}, "_source": False,
             "size": 8}, False),
    "mlt": ({"query": {"bool": {"must": [{"more_like_this": {
        "fields": ["t"], "like": [{"_index": "s3", "_id": "5"}],
        "min_term_freq": 1, "min_doc_freq": 1}}]}},
        "sort": [{"n": "asc"}], "size": 10}, False),
}


def check_rrf(jax_node, node, index, body, got, ref):
    """A fused answer of several shards, branch by branch: the kNN
    branch equal to the reference's (the dense executor serves a
    multi-shard branch in both packages: the port's cohort launch takes
    none); the BM25 branch tie-aware; the port's answer the fusion of
    its own branches; and where the BM25 branches agree in order, the
    fused answers equal."""
    rrf = body["rank"]["rrf"]
    window = rrf["window_size"]
    sub = {"size": window, "_source": False}
    _, rq = ask(jax_node, f"/{index}/_search",
                dict(sub, query=body["query"], size=window + 1))
    _, pq = ask(node, f"/{index}/_search", dict(sub, query=body["query"]))
    assert_same_hits(pq, rq, window)
    _, rk = ask(jax_node, f"/{index}/_search",
                dict(sub, query={"knn": body["knn"]}))
    psvc = node.search_service
    assert psvc._knn_branch_hits(
        [(index, s) for s in psvc._shard_searchers(node.indices[index])],
        body["knn"], window) is None
    _, pk = ask(node, f"/{index}/_search",
                dict(sub, query={"knn": body["knn"]}))
    pk = pk["hits"]["hits"]
    assert [h["_id"] for h in pk] == [h["_id"] for h in rk["hits"]["hits"]]
    np.testing.assert_allclose([h["_score"] for h in pk],
                               [h["_score"] for h in rk["hits"]["hits"]],
                               rtol=1e-6, atol=0)
    fused = {}
    for hits in (pq["hits"]["hits"], pk):
        for rank, h in enumerate(hits):
            fused[h["_id"]] = fused.get(h["_id"], 0.0) + 1.0 / (61 + rank)
    order = sorted(fused, key=lambda i: (-fused[i], (index, i)))
    page = order[:body["size"]]
    assert [h["_id"] for h in got["hits"]["hits"]] == page
    assert [h["_score"] for h in got["hits"]["hits"]] == [fused[i]
                                                          for i in page]
    assert got["hits"]["total"]["value"] == len(fused)
    if [h["_id"] for h in pq["hits"]["hits"]] == \
            [h["_id"] for h in rq["hits"]["hits"][:window]]:
        assert hits_of(got) == hits_of(ref)


@pytest.mark.parametrize("kind", sorted(BODIES))
@pytest.mark.parametrize("shards", SHARDS)
def test_bodies_answer_as_the_reference(nodes, shards, kind):
    jax_node, node = nodes
    body, plan = BODIES[kind]
    path = f"/s{shards}/_search"
    size = body.get("size", 10)
    if kind == "rrf":
        (jst, ref), (st, got) = ask(jax_node, path, body), ask(node, path,
                                                                body)
        assert jst == st == 200
        assert got["_shards"] == ref["_shards"]
        check_rrf(jax_node, node, f"s{shards}", body, got, ref)
        return
    jst, ref = ask(jax_node, path, dict(body, size=size + 1) if plan
                   else body)
    st, got = ask(node, path, body)
    assert jst == st == 200, (ref, got)
    assert got["_shards"] == {"total": shards, "successful": shards,
                              "skipped": 0, "failed": 0}
    assert_same(ref, got, plan, size)


@pytest.mark.parametrize("order", ["asc", "desc"])
@pytest.mark.parametrize("shards", SHARDS)
def test_keyword_search_after_walk(nodes, shards, order):
    """Pages of a keyword sort walked by ``search_after`` (a term of
    each doc's own, so no cursor ties) on both nodes, equal page by page
    and together equal to one big page: the cursor is the term, which
    each shard re-ranks in its own term list."""
    jax_node, node = nodes
    path = f"/s{shards}/_search"
    body = {"query": {"match": {"t": "w0 w1 w2"}}, "sort": [{"u": order}],
            "size": 17, "_source": False}
    after = None
    walked = []
    for _ in range(8):
        b = dict(body) if after is None else dict(body, search_after=after)
        (_, ref), (_, got) = ask(jax_node, path, b), ask(node, path, b)
        assert_same(ref, got)
        if not got["hits"]["hits"]:
            break
        walked += hits_of(got)
        after = got["hits"]["hits"][-1]["sort"]
    _, whole = ask(node, path, dict(body, size=17 * 8))
    assert walked == hits_of(whole)[:len(walked)]
    assert len(walked) > 17


def test_keyword_search_after_as_the_reference_test(tmp_path):
    """tests/test_search_features.py::test_keyword_search_after on both
    nodes (two shards)."""
    jax_node = JaxNode(data_path=str(tmp_path))
    node = Node(device="cpu")
    names = ["delta", "alpha", "echo", "bravo", "charlie"]
    lines = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                    + json.dumps({"name": nm, "n": i}) + "\n"
                    for i, nm in enumerate(names))
    try:
        for c in (jax_node.rest_controller, node.rest_controller):
            put_index(c, "k", 2, {"properties": {
                "name": {"type": "keyword"}, "n": {"type": "long"}}})
            c.dispatch("POST", "/k/_bulk", {"refresh": "true"}, lines)
        for body, want in (
                ({"sort": [{"name": "asc"}], "size": 2}, ["alpha", "bravo"]),
                ({"sort": [{"name": "asc"}], "size": 10,
                  "search_after": ["bravo"]}, ["charlie", "delta", "echo"])):
            (_, ref), (_, got) = (ask(jax_node, "/k/_search", body),
                                  ask(node, "/k/_search", body))
            assert [h["_source"]["name"] for h in got["hits"]["hits"]] == want
            assert_same(ref, got)
    finally:
        node.close()
        jax_node.close()


@pytest.mark.parametrize("shards", SHARDS)
def test_profile_has_one_entry_a_shard(nodes, shards):
    jax_node, node = nodes
    path = f"/s{shards}/_search"
    body = {"query": {"match": {"t": "w1"}}, "sort": [{"n": "asc"}],
            "size": 5, "profile": True}
    (_, ref), (_, got) = ask(jax_node, path, body), ask(node, path, body)
    ids = [e["id"] for e in got["profile"]["shards"]]
    assert ids == [e["id"] for e in ref["profile"]["shards"]] == [
        f"[s{shards}][{i}]" for i in range(shards)]
    coord = got["profile"]["coordinator"]["phases"]
    assert coord["query_ns"] == sum(
        e["searches"][0]["query"][0]["time_in_nanos"]
        for e in got["profile"]["shards"])
    plain = dict(body)
    del plain["profile"]
    _, unprofiled = ask(node, path, plain)
    got.pop("profile")
    got.pop("took")
    unprofiled.pop("took")
    assert got == unprofiled


# the reference node's monitoring creates ".monitoring-es" within a
# minute of its start (none of these bodies' documents), and its ``_all``
# counts that index's shards
ALL_SHARDS = sum(SHARDS)


@pytest.mark.parametrize("expr", ["s2,s3", "s*", "_all", "s5,s2,s5", "s?",
                                  "nope*,s3"])
def test_multi_index_expressions(nodes, expr):
    jax_node, node = nodes
    path = f"/{expr}/_search"
    for body in ({"query": {"term": {"k": "k03"}}, "sort": [{"n": "asc"}],
                  "size": 50},
                 {"query": {"match": {"t": "w2"}}, "size": 0,
                  "aggs": {"byk": {"terms": {"field": "k"}}}}):
        (jst, ref), (st, got) = ask(jax_node, path, body), ask(node, path,
                                                                body)
        assert jst == st == 200
        assert_same(ref, got, shards=expr != "_all")
        if expr == "_all":
            assert got["_shards"]["total"] == ALL_SHARDS
            assert ref["_shards"]["total"] >= ALL_SHARDS


def test_search_all_and_unknown_indices(nodes):
    jax_node, node = nodes
    body = {"query": {"range": {"n": {"lt": 50}}}, "sort": [{"n": "asc"}],
            "size": 30}
    ref = jax_node.rest_controller.dispatch("GET", "/_search", {}, body)
    got = node.rest_controller.dispatch("GET", "/_search", {}, body)
    assert ref[0] == got[0] == 200
    assert_same(ref[1], got[1], shards=False)
    assert got[1]["_shards"]["total"] == ALL_SHARDS
    for path in ("/nope/_search", "/s2,nope/_search"):
        (jst, ref), (st, got) = ask(jax_node, path, {}), ask(node, path, {})
        assert jst == st == 404
        assert got["error"]["type"] == ref["error"]["type"]
        assert got["error"]["index"] == ref["error"]["index"] == "nope"
    (jst, ref), (st, got) = (ask(jax_node, "/nope*/_search", {}),
                             ask(node, "/nope*/_search", {}))
    assert jst == st == 200
    assert got["_shards"] == ref["_shards"]
    assert got["hits"] == ref["hits"]


def test_refresh_and_forcemerge_count_every_shard(tmp_path):
    node = Node(device="cpu")
    try:
        c = node.rest_controller
        put_index(c, "fm", 3)
        fill(c, "fm", make_docs(n=60), deleted=())
        st, r = c.dispatch("POST", "/fm/_bulk", {"refresh": "true"},
                           bulk_lines(make_docs(seed=5, n=30),
                                      [f"x{i}" for i in range(30)]))
        st, r = c.dispatch("POST", "/fm/_forcemerge", {}, None)
        assert st == 200 and r["_shards"]["total"] == 3
        assert all(len(e.segments) == 1 for e in node.indices["fm"].shards)
        st, r = c.dispatch("POST", "/fm/_refresh", {}, None)
        assert r["_shards"] == {"total": 3, "successful": 3, "failed": 0}
        names = [s.name for e in node.indices["fm"].shards
                 for s in e.segments]
        assert len(set(names)) == len(names) == 3
    finally:
        node.close()


# ---------------------------------------------------------------------------
# dfs_query_then_fetch
# ---------------------------------------------------------------------------

DFS_BODIES = [
    {"query": {"match": {"t": "w1 w4"}}, "size": 12},
    {"query": {"bool": {"should": [{"match": {"t": "w2"}},
                                   {"match": {"t": "w9"}}]}}, "size": 12},
    {"query": {"match": {"t": "w3"}}, "sort": [{"n": "asc"}], "size": 12},
]


@pytest.mark.parametrize("bi", range(len(DFS_BODIES)))
@pytest.mark.parametrize("search_type", ["query_then_fetch",
                                         "dfs_query_then_fetch"])
def test_dfs_against_a_fresh_reference(tmp_path, search_type, bi):
    """Each search type against a reference node that has answered
    nothing before (its plan memo would serve the other type's plan)."""
    jax_node, node = fresh_nodes(tmp_path, 3)
    try:
        body = DFS_BODIES[bi]
        plan = "sort" not in body
        params = {"search_type": search_type}
        jst, ref = ask(jax_node, "/s3/_search",
                       dict(body, size=13) if plan else body, params)
        st, got = ask(node, "/s3/_search", body, params)
        assert jst == st == 200
        assert_same(ref, got, plan, 12)
    finally:
        node.close()
        jax_node.close()


def test_dfs_scores_identical_docs_alike(tmp_path):
    """The reference's test_dfs_query_then_fetch_consistent_idf, on both
    nodes: identical docs on different shards score alike under dfs."""
    jax_node = JaxNode(data_path=str(tmp_path))
    node = Node(device="cpu")
    docs = {"a": "quake alpha", "b": "quake alpha", "k0": "quake beta",
            "k1": "quake beta", "k2": "quake gamma"}
    lines = "".join(json.dumps({"index": {"_id": i}}) + "\n"
                    + json.dumps({"t": t}) + "\n" for i, t in docs.items())
    try:
        for c in (jax_node.rest_controller, node.rest_controller):
            put_index(c, "d", 2, {"properties": {"t": {"type": "text"}}})
            c.dispatch("POST", "/d/_bulk", {"refresh": "true"}, lines)
        body = {"query": {"match": {"t": {"query": "quake"}}}, "size": 10}
        params = {"search_type": "dfs_query_then_fetch"}
        (_, ref), (_, got) = (ask(jax_node, "/d/_search", body, params),
                              ask(node, "/d/_search", body, params))
        scores = {h["_id"]: h["_score"] for h in got["hits"]["hits"]}
        assert scores["a"] == scores["b"]
        ref_scores = {h["_id"]: h["_score"] for h in ref["hits"]["hits"]}
        assert set(scores) == set(ref_scores)
        np.testing.assert_allclose([scores[i] for i in sorted(scores)],
                                   [ref_scores[i] for i in sorted(scores)],
                                   rtol=1e-4)
    finally:
        node.close()
        jax_node.close()


@pytest.mark.parametrize("order", [("query_then_fetch",
                                    "dfs_query_then_fetch"),
                                   ("dfs_query_then_fetch",
                                    "query_then_fetch")])
def test_search_types_are_order_independent(tmp_path, order):
    """The same body sent as both search types, in either order and
    twice, answers each type's own scores: the port's bound plans are
    keyed on the statistics in force (the reference's memo is not:
    ROADMAP.md Queue 3). Each answer equals a fresh reference's."""
    body = {"query": {"match": {"t": "w1 w4"}}, "size": 12}
    want = {}
    for st_name in order:
        jax_node, node = fresh_nodes(tmp_path / st_name, 3)
        try:
            _, want[st_name] = ask(jax_node, "/s3/_search",
                                   dict(body, size=13),
                                   {"search_type": st_name})
        finally:
            node.close()
            jax_node.close()
    node = Node(device="cpu")
    try:
        put_index(node.rest_controller, "s3", 3)
        fill(node.rest_controller, "s3", make_docs())
        answers = {}
        for st_name in order + order:
            _, got = ask(node, "/s3/_search", body,
                         {"search_type": st_name})
            assert_same_hits(got, want[st_name], 12)
            answers.setdefault(st_name, []).append(got["hits"])
        for st_name, seen in answers.items():
            assert seen[0] == seen[1]
        assert answers[order[0]][0] != answers[order[1]][0]
    finally:
        node.close()


def test_unknown_search_type_is_a_400(nodes):
    _, node = nodes
    st, r = ask(node, "/s2/_search", {}, {"search_type": "scan"})
    assert st == 400
    assert r["error"]["type"] == "illegal_argument_exception"
    assert r["error"]["reason"] == "No search type for [scan]"


# ---------------------------------------------------------------------------
# the per-shard failure barrier
# ---------------------------------------------------------------------------

def _fail_the_shard_of(doc_id, module, monkeypatch):
    orig = module.ShardSearcher.query_phase

    def query_phase(self, *a, **k):
        if any(s.docid_for(doc_id) >= 0 for s in self.segments):
            raise RuntimeError("shard down")
        return orig(self, *a, **k)
    monkeypatch.setattr(module.ShardSearcher, "query_phase", query_phase)


@pytest.mark.parametrize("allow", [None, True, False])
def test_shard_failures_and_partial_results(nodes, monkeypatch, allow):
    jax_node, node = nodes
    _fail_the_shard_of("7", jax_searcher, monkeypatch)
    _fail_the_shard_of("7", port_searcher, monkeypatch)
    body = {"query": {"match": {"t": "w1"}}, "sort": [{"n": "asc"}],
            "size": 10}
    if allow is not None:
        body["allow_partial_search_results"] = allow
    (jst, ref), (st, got) = (ask(jax_node, "/s3/_search", body),
                             ask(node, "/s3/_search", body))
    assert jst == st
    if allow is False:
        assert st == 503
        assert got["error"]["type"] == ref["error"]["type"] \
            == "search_phase_execution_exception"
        assert got["error"]["failed_shards"] == ref["error"]["failed_shards"]
        return
    assert st == 200
    assert got["_shards"]["failed"] == 1 and got["_shards"]["successful"] == 2
    assert got["_shards"]["failures"] == ref["_shards"]["failures"]
    assert_same(ref, got)


def test_every_shard_failing_raises_its_error(nodes, monkeypatch):
    jax_node, node = nodes

    def query_phase(self, *a, **k):
        raise RuntimeError("every shard down")
    for module in (jax_searcher, port_searcher):
        monkeypatch.setattr(module.ShardSearcher, "query_phase", query_phase)
    (jst, ref), (st, got) = (ask(jax_node, "/s2/_search", {}),
                             ask(node, "/s2/_search", {}))
    assert jst == st == 500
    assert "every shard down" in got["error"]["reason"]


# ---------------------------------------------------------------------------
# joins and percolate
# ---------------------------------------------------------------------------

JOIN_BODIES = [
    {"query": {"has_child": {"type": "a", "query": {"match": {"t": "w1"}},
                             "score_mode": "max"}}, "size": 20},
    {"query": {"has_child": {"type": "a", "query": {"match": {"t": "w2"}},
                             "score_mode": "sum", "min_children": 2}},
     "size": 20},
    {"query": {"has_parent": {"parent_type": "q",
                              "query": {"match": {"t": "w3"}},
                              "score": True}}, "size": 40},
    {"query": {"parent_id": {"type": "a", "id": "q2"}}, "size": 20},
]


@pytest.mark.parametrize("bi", range(len(JOIN_BODIES)))
def test_joins_within_a_shard(join_nodes, bi):
    jax_node, node = join_nodes
    body = JOIN_BODIES[bi]
    (jst, ref), (st, got) = (ask(jax_node, "/fam/_search", body),
                             ask(node, "/fam/_search", body))
    assert jst == st == 200, (ref, got)
    assert got["hits"]["total"]["value"] > 0
    assert_same(ref, got)


def test_percolate_by_index_id_and_routing(tmp_path):
    jax_node = JaxNode(data_path=str(tmp_path))
    node = Node(device="cpu")
    queries = [{"match": {"t": "w1"}}, {"match": {"t": "w2 w3"}},
               {"term": {"k": "k01"}}, {"range": {"n": {"gte": 500}}},
               {"bool": {"must": [{"match": {"t": "w1"}}],
                         "filter": [{"term": {"k": "k02"}}]}}]
    qlines = "".join(json.dumps({"index": {"_id": f"p{i}"}}) + "\n"
                     + json.dumps({"query": q}) + "\n"
                     for i, q in enumerate(queries))
    dlines = "".join(
        json.dumps({"index": {"_id": f"d{i}", "routing": f"r{i}"}}) + "\n"
        + json.dumps(d) + "\n" for i, d in enumerate(make_docs(n=8)))
    try:
        for c in (jax_node.rest_controller, node.rest_controller):
            put_index(c, "pq", 3, {"properties": {
                "query": {"type": "percolator"}, "t": {"type": "text"},
                "k": {"type": "keyword"}, "n": {"type": "long"}}})
            c.dispatch("POST", "/pq/_bulk", {"refresh": "true"}, qlines)
            put_index(c, "docs", 5)
            c.dispatch("POST", "/docs/_bulk", {"refresh": "true"}, dlines)
        for i in range(8):
            body = {"query": {"percolate": {
                "field": "query", "index": "docs", "id": f"d{i}",
                "routing": f"r{i}"}}, "size": 10}
            (jst, ref), (st, got) = (ask(jax_node, "/pq/_search", body),
                                     ask(node, "/pq/_search", body))
            assert jst == st == 200, (ref, got)
            assert sorted(h["_id"] for h in got["hits"]["hits"]) == sorted(
                h["_id"] for h in ref["hits"]["hits"])
            assert got["hits"]["total"] == ref["hits"]["total"]
            assert got["_shards"] == ref["_shards"]
        # without its routing the document is looked for on its id's
        # shard, as in the reference
        for i in range(8):
            body = {"query": {"percolate": {"field": "query",
                                            "index": "docs",
                                            "id": f"d{i}"}}}
            (jst, ref), (st, got) = (ask(jax_node, "/pq/_search", body),
                                     ask(node, "/pq/_search", body))
            assert jst == st
            if st != 200:
                assert got["error"]["type"] == ref["error"]["type"]
        body = {"query": {"percolate": {"field": "query", "index": "nope",
                                        "id": "d0"}}}
        (jst, _), (st, got) = (ask(jax_node, "/pq/_search", body),
                               ask(node, "/pq/_search", body))
        assert jst == st == 404
    finally:
        node.close()
        jax_node.close()


# ---------------------------------------------------------------------------
# the serving front
# ---------------------------------------------------------------------------

def test_a_multi_shard_index_never_takes_the_fast_path(tmp_path):
    node = Node(device="cpu")
    try:
        c = node.rest_controller
        put_index(c, "big", 3, {"properties": {"t": {"type": "text"}}})
        c.dispatch("POST", "/big/_bulk", {"refresh": "true"},
                   bulk_lines([{"t": d["t"]} for d in make_docs()]))
        c.dispatch("POST", "/big/_forcemerge", {}, None)
        svc = node.indices["big"]
        body = {"query": {"match": {"t": "w1"}}, "_source": False}
        assert RestController._fast_body(svc, body) is None
        port = node.start(0)
        node.refresh_front()
        assert node.fastpath.front_registration() is None
        # a one-shard index beside it is registered, though smaller
        put_index(c, "one", 1, {"properties": {"t": {"type": "text"}}})
        c.dispatch("POST", "/one/_bulk", {"refresh": "true"},
                   bulk_lines([{"t": "w1 w2"}, {"t": "w3"}]))
        node.refresh_front()
        assert node.fastpath.front_registration()["index"] == "one"
        assert RestController._fast_body(node.indices["one"], body)
        from elasticsearch_tpu_torch.rest.native_http import loadgen
        before = node.http_stats()
        for path in ("/big/_search", "/big,one/_search", "/b*/_search"):
            out = loadgen(port, path, [body], 2, 8)
            assert out["done"] == 8 and out["non2xx"] == 0
        after = node.http_stats()
        assert after["fast"] == before["fast"]
        assert after["fallback"] - before["fallback"] == 24
    finally:
        node.close()
