"""The port's node over HTTP (``Node(device="cpu")``: PUT index, _bulk,
_refresh, _forcemerge, _search) against the reference node's REST
dispatch on the same documents: hits, their order and the totals are
equal, scores agree within the reference's float32 error. Match queries
the v2m lane serves also equal a float64 oracle exactly; bool+filter
bodies of the fast path's grammar are served by a fast lane (v2m, and
v1 with the router pointed at it); the rest (other bool shapes, term, multi_match,
post_filter, from, size above 1000, an index of two segments) go to the
plan path. A reference segment carried across with
``segment_from_numpy`` serves the same answers."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.index.segment import segment_from_numpy
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search.fastpath import NB_BUCKETS

MAPPINGS = {"properties": {"body": {"type": "text"},
                           "title": {"type": "text"},
                           "tag": {"type": "keyword"}}}
VOCAB = [f"w{i}" for i in range(120)]
TAGS = ["red", "green", "blue", "yellow"]


def make_docs(seed=0, n=400):
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.1
    zipf /= zipf.sum()
    docs = [{"body": " ".join(rng.choice(VOCAB, int(rng.integers(2, 40)),
                                         p=zipf))} for _ in range(n)]
    # title and tag from a stream of their own: the bodies stay as they were
    extra = np.random.default_rng(seed + 100)
    for d in docs:
        d["title"] = " ".join(extra.choice(VOCAB[:30],
                                           int(extra.integers(1, 6))))
        d["tag"] = str(extra.choice(TAGS))
    return docs


def make_queries(seed=1, n=10):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        terms = rng.choice(VOCAB[:80], int(rng.integers(1, 5)),
                           replace=False)
        out.append((" ".join(terms), int(rng.choice([5, 20, 100]))))
    out.append(("nosuchterm", 10))
    out.append(("W3 w3 NOSUCH", 10))          # case, repeats, unknowns
    return out


def http(port, method, path, body=None, ndjson=False):
    data = None
    if body is not None:
        data = body.encode() if ndjson else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data,
                                 {"Content-Type": "application/x-ndjson"
                                  if ndjson else "application/json"},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def bulk_body(docs, lo, hi):
    lines = []
    for i in range(lo, hi):
        lines.append(json.dumps({"index": {"_id": str(i)}}))
        lines.append(json.dumps(docs[i]))
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    docs = make_docs()
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("jax")))
    c = jax_node.rest_controller
    c.dispatch("PUT", "/idx", {}, {"mappings": MAPPINGS})
    c.dispatch("POST", "/idx/_bulk", {"refresh": "true"},
               bulk_body(docs, 0, len(docs)))

    node = Node(device="cpu")
    port = node.start(0)
    assert http(port, "PUT", "/idx", {"mappings": MAPPINGS})[0] == 200
    # two refreshes make two segments; the force-merge folds them
    for lo, hi in ((0, 250), (250, len(docs))):
        st, r = http(port, "POST", "/idx/_bulk", bulk_body(docs, lo, hi),
                     ndjson=True)
        assert st == 200 and not r["errors"]
        assert http(port, "POST", "/idx/_refresh")[0] == 200
    # two segments: the plan path answers, as the reference node does
    for body in ({"query": {"match": {"body": "w1"}}, "size": 20},
                 {"query": {"term": {"tag": "red"}}, "size": 50}):
        st, r = http(port, "POST", "/idx/_search", body)
        assert st == 200, r
        assert_same_hits(r, jax_dispatch(jax_node, body), page_size(body))
    assert http(port, "POST", "/idx/_forcemerge?max_num_segments=1")[0] \
        == 200
    yield docs, jax_node, node, port
    node.close()
    jax_node.close()


def jax_dispatch(jax_node, body):
    """The reference node's answer to ``body`` asked for one hit more
    than its page, as ``assert_same_hits`` takes it."""
    st, r = jax_node.rest_controller.dispatch(
        "POST", "/idx/_search", {},
        dict(body, track_total_hits=True, size=page_size(body) + 1))
    assert st == 200, r
    return r


def page_size(body):
    return body.get("size", 10)


def jax_search(jax_node, text, size):
    return jax_dispatch(jax_node, {"query": {"match": {"body": text}},
                                   "size": size})


def assert_same_hits(got, ref, size, rtol=1e-4):
    """Equal totals, scores equal within ``rtol``, and equal ids in equal
    order, up to the order inside a group of scores that agree within
    ``rtol``. The reference node scores in float32 (its plan path lands
    up to ~4e-5 relative off the float64 oracle on these docs), so a true
    tie can come out of it apart, and two close scores swapped; the port
    ranks in float64 and is held to the oracle exactly below.

    ``got`` is a page of ``size`` hits; ``ref`` answers the same request
    with ``size + 1``. Its extra hit, the first past the page, says
    whether the page cuts its last group: only when that hit ties the
    group may the page hold other members of the tie than the
    reference's."""
    assert got["hits"]["total"] == ref["hits"]["total"]
    assert got["hits"]["total"]["relation"] == "eq"
    gh, rh = got["hits"]["hits"], ref["hits"]["hits"]
    assert len(rh) <= size + 1
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
            assert {h["_id"] for h in gh[i:j]} == \
                {h["_id"] for h in rh[i:j]}, (i, j)
        i = j


def oracle_hits(docs, text, size, k1=1.2, b=0.75):
    """The float64 oracle on the documents themselves: (ids by (score
    desc, docid asc) re-ordered by (float32 score desc, docid asc), total)."""
    from elasticsearch_tpu_torch.analysis.analyzers import StandardAnalyzer
    from elasticsearch_tpu_torch.ops.bm25 import bm25_reference_scores
    an = StandardAnalyzer()
    toks = [[t.term for t in an.analyze(d["body"])] for d in docs]
    lens = np.array([len(t) for t in toks], np.float64)
    avg = lens.sum() / (lens > 0).sum()
    n = len(docs)
    pl, idfs = [], []
    for term in (t.term for t in an.analyze(text)):   # a repeat counts twice
        hits = [(i, t.count(term)) for i, t in enumerate(toks) if term in t]
        if not hits:
            continue
        pl.append((np.array([h[0] for h in hits]),
                   np.array([h[1] for h in hits], np.float64)))
        idfs.append(np.log(1 + (n - len(hits) + 0.5) / (len(hits) + 0.5)))
    scores = bm25_reference_scores(pl, idfs, lens, avg, k1, b)
    matched = np.nonzero(scores > 0)[0]
    top = matched[np.lexsort((matched, -scores[matched]))][:size]
    top = top[np.lexsort((top, -scores[top].astype(np.float32)))]
    return [str(d) for d in top], scores[top], len(matched)


@pytest.mark.parametrize("qi", range(12))
def test_search_matches_reference_node(nodes, qi):
    docs, jax_node, node, port = nodes
    text, size = make_queries()[qi]
    st, got = http(port, "POST", "/idx/_search",
                   {"query": {"match": {"body": text}}, "size": size})
    assert st == 200, got
    assert_same_hits(got, jax_search(jax_node, text, size), size)
    ids, scores, total = oracle_hits(docs, text, size)
    assert [h["_id"] for h in got["hits"]["hits"]] == ids
    assert got["hits"]["total"]["value"] == total
    np.testing.assert_allclose([h["_score"] for h in got["hits"]["hits"]],
                               scores, rtol=1e-7, atol=0)
    for h in got["hits"]["hits"]:
        assert h["_source"] == docs[int(h["_id"])]


PLAN_BODIES = [
    {"query": {"term": {"body": "w1"}}},
    {"query": {"match": {"body": "w1"}}, "size": 5000},
    {"query": {"term": {"tag": "blue"}}, "size": 100},
    {"query": {"terms": {"tag": ["red", "yellow"]}}, "size": 20},
    {"query": {"bool": {"must": [{"match": {"body": "w3 w7"}}],
                        "filter": [{"term": {"tag": "green"}}],
                        "must_not": [{"match": {"title": "w2"}}]}},
     "size": 30},
    {"query": {"bool": {"should": [{"match": {"title": "w4 w5"}},
                                   {"term": {"tag": "red"}}],
                        "minimum_should_match": 1}}, "size": 25},
    {"query": {"multi_match": {"query": "w2 w9",
                               "fields": ["body", "title"]}}, "size": 40},
    {"query": {"multi_match": {"query": "w2 w9", "type": "most_fields",
                               "fields": ["body", "title"]}}, "size": 40},
    {"query": {"match": {"body": {"query": "w3 w4",
                                  "operator": "and"}}}, "from": 5,
     "size": 10},
    {"query": {"match": {"body": "w6 w8"}},
     "post_filter": {"term": {"tag": "yellow"}}, "size": 50},
]


@pytest.mark.parametrize("bi", range(len(PLAN_BODIES)))
def test_plan_path_matches_reference_node(nodes, bi):
    docs, jax_node, node, port = nodes
    body = PLAN_BODIES[bi]
    st, got = http(port, "POST", "/idx/_search", body)
    assert st == 200, got
    assert got["hits"]["total"]["value"] > 0
    assert_same_hits(got, jax_dispatch(jax_node, body), page_size(body))
    for h in got["hits"]["hits"]:
        assert h["_source"] == docs[int(h["_id"])]


def test_slice_boundaries_are_typed(nodes):
    _, jax_node, node, port = nodes
    # range clauses are served since the dense executor is ported (on
    # the unmapped `views` they match nothing, as in the reference)
    for body in ({"query": {"range": {"views": {"gte": 3}}}},
                 {"query": {"bool": {"must": [{"match": {"body": "w1"}}],
                                     "filter": [{"range": {
                                         "views": {"gte": 3}}}]}}}):
        st, r = http(port, "POST", "/idx/_search", body)
        assert st == 200, (body, r)
        assert_same_hits(r, jax_dispatch(jax_node, body), page_size(body))
    # nested queries and _geo_distance sorts are served since the
    # field-type slice: a path not mapped nested is the reference's
    # query_shard_exception, an unmapped point field sorts every doc as
    # missing (keyword sorts are served since the fetch and sort slice)
    body = {"query": {"nested": {"path": "items",
                                 "query": {"match_all": {}}}}}
    st, r = http(port, "POST", "/idx/_search", body)
    assert st == 400 and r["error"]["type"] == "query_shard_exception", r
    body = {"query": {"match": {"body": "w1"}},
            "sort": [{"_geo_distance": {"loc": [0, 0]}}]}
    st, r = http(port, "POST", "/idx/_search", body)
    ref = jax_dispatch(jax_node, body)["hits"]["hits"][:page_size(body)]
    assert st == 200, r
    assert [(h["_id"], h["sort"]) for h in r["hits"]["hits"]] == \
        [(h["_id"], h["sort"]) for h in ref]
    body = {"query": {"match": {"body": "w1"}}, "sort": [{"tag": "asc"}]}
    st, r = http(port, "POST", "/idx/_search", body)
    ref = jax_dispatch(jax_node, body)["hits"]["hits"][:page_size(body)]
    assert st == 200, r
    assert [(h["_id"], h["sort"]) for h in r["hits"]["hits"]] == \
        [(h["_id"], h["sort"]) for h in ref]
    # track_total_hits is served since block-max pruning is ported:
    # false omits the total, a value of another type is refused
    st, r = http(port, "POST", "/idx/_search",
                 {"query": {"match": {"body": "w1"}},
                  "track_total_hits": False})
    assert st == 200 and "total" not in r["hits"], r
    st, r = http(port, "POST", "/idx/_search",
                 {"query": {"match": {"body": "w1"}},
                  "track_total_hits": "all"})
    assert st == 400 and r["error"]["type"] == \
        "illegal_argument_exception", r
    assert http(port, "POST", "/nope/_search",
                {"query": {"match": {"body": "w1"}}})[0] == 404
    st, info = http(port, "GET", "/")
    assert st == 200 and info["version"]["device"] == "cpu"


def test_segment_from_numpy_round_trips_reference_segment(nodes):
    docs, jax_node, _, _ = nodes
    jm = MapperService(mappings=MAPPINGS)
    jw = JaxWriter()
    for i, d in enumerate(docs):
        jw.add(jm.parse(str(i), d))
    jseg = jw.build("_j")
    jf = jseg.postings["body"]
    arrays = {a: np.asarray(getattr(jf, a)) for a in (
        "doc_freq", "total_term_freq", "term_block_start",
        "term_block_count", "block_docids", "block_tfs", "field_lengths")}
    arrays.update(terms=list(jf.terms), ids=list(jseg.stored.ids),
                  sources=[jseg.stored.source(d) for d in range(jseg.n_docs)])
    seg = segment_from_numpy(arrays, name="_j", field="body")
    pf = seg.postings["body"]
    for a in arrays:
        if a in ("terms", "ids", "sources"):
            continue
        np.testing.assert_array_equal(getattr(pf, a),
                                      np.asarray(getattr(jf, a)), err_msg=a)
    assert pf.terms == list(jf.terms)
    assert pf.sum_total_term_freq == jf.sum_total_term_freq
    assert pf.doc_count == jf.doc_count

    # served from the carried-over segment, the answers are the reference's
    other = Node(device="cpu")
    try:
        other.create_index("idx", MAPPINGS)
        other.indices["idx"].engine.install_segments([seg])
        for text, size in make_queries()[:6]:
            st, got = other.rest_controller.dispatch(
                "POST", "/idx/_search", {},
                {"query": {"match": {"body": text}}, "size": size})
            assert st == 200, got
            assert_same_hits(got, jax_search(jax_node, text, size), size)
    finally:
        other.close()


FILTER_BODIES = [
    # the fast path's grammar: one filter, eight, an unknown filter
    # term, a filter object without an array, a must object
    ({"bool": {"must": [{"match": {"body": "w3 w7"}}],
               "filter": [{"match": {"body": "w1"}}]}}, "fast"),
    ({"bool": {"must": [{"match": {"body": "w9 w11 w2"}}],
               "filter": [{"match": {"body": f"w{i}"}}
                          for i in range(8)]}}, "fast"),
    ({"bool": {"must": [{"match": {"body": "w3"}}],
               "filter": [{"match": {"body": "w0"}},
                          {"match": {"body": "nosuchterm"}}]}}, "fast"),
    ({"bool": {"must": [{"match": {"body": "w5 w6"}}],
               "filter": {"match": {"body": "w2"}}}}, "fast"),
    ({"bool": {"must": {"match": {"body": {"query": "w4 w8"}}},
               "filter": [{"match": {"body": {"query": "W0"}}},
                          {"match": {"body": "w1"}}]}}, "fast"),
    # just outside it: a should clause, a filter of two terms
    ({"bool": {"must": [{"match": {"body": "w3 w7"}}],
               "should": [{"match": {"body": "w2"}}],
               "filter": [{"match": {"body": "w1"}}]}}, "plan"),
    ({"bool": {"must": [{"match": {"body": "w3 w7"}}],
               "filter": [{"match": {"body": "w1 w2"}}]}}, "plan"),
]


@pytest.fixture(scope="module")
def lane_nodes(nodes):
    """A CPU port node per fast lane, serving the fixture's one segment:
    every query of this small index fits v2m, so the v1 node's router
    sends what fits to v1 at its bucket instead."""
    _, _, node, _ = nodes
    seg, = node.indices["idx"].engine.segments
    out = {}
    for lane in ("v1", "v2m"):
        n = Node(device="cpu")
        n.create_index("idx", MAPPINGS)
        n.indices["idx"].engine.install_segments([seg])
        out[lane] = n
    route = out["v1"].fastpath.route

    def to_v1(reg, term_ids):
        r = route(reg, term_ids)
        return ("v1", NB_BUCKETS[-1]) if r and r[0] == "v2m" else r

    out["v1"].fastpath.route = to_v1
    yield out
    for n in out.values():
        n.close()


@pytest.mark.parametrize("lane", ["v1", "v2m"])
@pytest.mark.parametrize("bi", range(len(FILTER_BODIES)))
def test_filter_bodies_match_reference_node(nodes, lane_nodes, lane, bi):
    docs, jax_node, _, _ = nodes
    node = lane_nodes[lane]
    query, path = FILTER_BODIES[bi]
    body = {"query": query, "size": 30}
    d0 = node.fastpath.serving_stats()["dispatch"]
    fast0 = sum(d0.values())
    plan0 = node.search_service.plan_batcher.launches
    st, got = node.rest_controller.dispatch("POST", "/idx/_search", {},
                                            body)
    assert st == 200, got
    assert_same_hits(got, jax_dispatch(jax_node, body), page_size(body))
    fast = sum(node.fastpath.serving_stats()["dispatch"].values()) - fast0
    plan = node.search_service.plan_batcher.launches - plan0
    if path == "fast":
        assert (fast, plan) == (1, 0)
        assert all(k.startswith(f"{lane}:") for k, v in
                   node.fastpath.serving_stats()["dispatch"].items()
                   if v > d0.get(k, 0))
    else:
        assert fast == 0 and plan >= 1
    if bi == 2:         # an unknown filter term: nothing matches
        assert got["hits"]["total"] == {"value": 0, "relation": "eq"}
    else:
        assert got["hits"]["total"]["value"] > 0
    for h in got["hits"]["hits"]:
        assert h["_source"] == docs[int(h["_id"])]
