"""The port's node over HTTP (``Node(device="cpu")``: PUT index, _bulk,
_refresh, _forcemerge, match _search) against the reference node's REST
dispatch on the same documents: hits, their order and the totals are
equal, scores agree within the reference's float32 error; the port's hits
also equal a float64 oracle exactly. A reference segment carried
across with ``segment_from_numpy`` serves the same answers."""

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

MAPPINGS = {"properties": {"body": {"type": "text"}}}
VOCAB = [f"w{i}" for i in range(120)]


def make_docs(seed=0, n=400):
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.1
    zipf /= zipf.sum()
    return [{"body": " ".join(rng.choice(VOCAB, int(rng.integers(2, 40)),
                                         p=zipf))} for _ in range(n)]


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
    st, r = http(port, "POST", "/idx/_search",
                 {"query": {"match": {"body": "w1"}}})
    assert st == 400 and r["error"]["type"] == \
        "unsupported_in_slice_exception"       # two segments: not served
    assert http(port, "POST", "/idx/_forcemerge?max_num_segments=1")[0] \
        == 200
    yield docs, jax_node, node, port
    node.close()
    jax_node.close()


def jax_search(jax_node, text, size):
    st, r = jax_node.rest_controller.dispatch(
        "POST", "/idx/_search", {},
        {"query": {"match": {"body": text}}, "size": size,
         "track_total_hits": True})
    assert st == 200, r
    return r


def assert_same_hits(got, ref, rtol=1e-4):
    """Equal totals, scores equal within ``rtol``, and equal ids in equal
    order, up to the order inside a group of scores that agree within
    ``rtol``. The reference node scores in float32 (its plan path lands
    up to ~4e-5 relative off the float64 oracle on these docs), so a true
    tie can come out of it apart, and two close scores swapped; the port
    ranks in float64 and is held to the oracle exactly below. A group cut
    by ``size`` may hold different members of the tie."""
    assert got["hits"]["total"] == ref["hits"]["total"]
    assert got["hits"]["total"]["relation"] == "eq"
    gh, rh = got["hits"]["hits"], ref["hits"]["hits"]
    assert len(gh) == len(rh)
    gs = np.array([h["_score"] for h in gh])
    rs = np.array([h["_score"] for h in rh])
    np.testing.assert_allclose(gs, rs, rtol=rtol, atol=0)
    i = 0
    while i < len(rh):
        j = i + 1
        while j < len(rh) and abs(rs[j] - rs[i]) <= rtol * rs[i]:
            j += 1
        cut = j == len(rh) and ref["hits"]["total"]["value"] > len(rh)
        if j - i == 1 or not cut:
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
    assert_same_hits(got, jax_search(jax_node, text, size))
    ids, scores, total = oracle_hits(docs, text, size)
    assert [h["_id"] for h in got["hits"]["hits"]] == ids
    assert got["hits"]["total"]["value"] == total
    np.testing.assert_allclose([h["_score"] for h in got["hits"]["hits"]],
                               scores, rtol=1e-7, atol=0)
    for h in got["hits"]["hits"]:
        assert h["_source"] == docs[int(h["_id"])]


def test_slice_boundaries_are_typed(nodes):
    _, _, node, port = nodes
    st, r = http(port, "POST", "/idx/_search",
                 {"query": {"term": {"body": "w1"}}})
    assert st == 400 and r["error"]["type"] == \
        "unsupported_in_slice_exception"
    st, r = http(port, "POST", "/idx/_search",
                 {"query": {"match": {"body": "w1"}}, "size": 5000})
    assert st == 400 and r["error"]["type"] == \
        "unsupported_in_slice_exception"
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
            assert_same_hits(got, jax_search(jax_node, text, size))
    finally:
        other.close()
