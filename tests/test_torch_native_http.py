"""The port's C++ serving front (elasticsearch_tpu_torch/rest/native_http.py,
native/src/estpu_http.cpp) and the fast path behind it, on the CPU: the
front is built here with ``g++`` from the port's own sources.

- Parity with the reference's front: a reference Node with its native
  front (buckets 64,128, as tests/test_native_http.py runs it) and a port
  Node with its native front (``NB_BUCKETS`` cut to 8/16/32, as
  test_torch_fastpath_theta.py cuts it) index the same seeded 300-doc
  ``books`` corpus. The reference test's fast bodies (match, bool+filter,
  unknown and mixed terms) give the same ids, order and totals, and
  scores within rtol 1e-5, which covers the front's ``%.6g`` print. Ids
  may swap only between docs whose scores agree within that tolerance:
  the reference sums float32 contributions, the port ranks in float64.
  Its fallback bodies take no fast path on the port's front, and each
  answer equals ``RestController.dispatch`` of the body on the same
  node; so does the C++ tokenizer's answer to mixed-case, punctuated
  ASCII text.
- Generation: a force merge replaces the segment; a request the front
  parsed under the old registration is bounced, and REST dispatch
  answers it on the new segment as the plan path does.
- Retire: after a force merge no registration (Python or C++) and no
  device copy refers to a retired segment; the next fast request
  registers afresh.
- The C++ load generator completes every request, and each is served
  on the fast path.
- No quiet fallback: with the compiler missing, ``start`` raises; a
  taken port raises too.
- ``close()`` leaves no live thread.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest import native_http
from elasticsearch_tpu_torch.search import fastpath as srv

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "fox",
         "dog", "cat", "bird", "fish", "lion"]
MAPPINGS = {"properties": {"title": {"type": "text"}}}
RTOL = 1e-5

FAST_BODIES = [
    {"query": {"match": {"title": "fox gamma"}}, "size": 20,
     "_source": False},
    {"query": {"match": {"title": "alpha"}}, "size": 5, "_source": False},
    {"query": {"match": {"title": "fox dog cat bird"}}, "size": 100,
     "_source": False},
    {"query": {"match": {"title": "zeta zeta"}}, "size": 10,
     "_source": False},
    {"query": {"match": {"title": {"query": "lion fish"}}},
     "_source": False},
    {"query": {"bool": {"must": [{"match": {"title": "fox gamma"}}],
                        "filter": [{"match": {"title": "dog"}},
                                   {"match": {"title": "cat"}}]}},
     "size": 50, "_source": False},
    {"query": {"bool": {"must": {"match": {"title": "beta delta"}},
                        "filter": {"match": {"title": "lion"}}}},
     "size": 30, "_source": False},
    # unknown terms: an empty answer; mixed: the known one scores
    {"query": {"match": {"title": "qqqqq zzzzz"}}, "size": 10,
     "_source": False},
    {"query": {"match": {"title": "qqqqq fox"}}, "size": 10,
     "_source": False},
    # an unknown filter term matches nothing
    {"query": {"bool": {"must": [{"match": {"title": "fox"}}],
                        "filter": [{"match": {"title": "qqqqq"}}]}},
     "size": 10, "_source": False},
]

FALLBACK_BODIES = [
    {"query": {"match": {"title": "fox"}}, "size": 10},   # _source on
    {"query": {"match": {"other_field": "fox"}}, "_source": False},
    {"query": {"match": {"title": "fox"}}, "from": 3, "size": 5,
     "_source": False},
    {"query": {"match": {"title": {"query": "fox cat",
                                   "operator": "or"}}},
     "_source": False},
    {"query": {"term": {"title": "fox"}}, "_source": False},
    # non-ASCII query text: the C++ tokenizer must not see it
    {"query": {"match": {"title": "fox été"}}, "_source": False},
]


def corpus_lines(n=300, seed=42):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        doc = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 12))))
        lines.append(json.dumps({"index": {"_index": "books",
                                           "_id": str(i)}}))
        lines.append(json.dumps({"title": doc}))
    return "\n".join(lines) + "\n"


def req(port, method, path, body=None, ndjson=False):
    data = None if body is None else (
        body.encode() if isinstance(body, str) else json.dumps(body).encode())
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/x-ndjson" if ndjson
                 else "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def ok(port, method, path, body=None, ndjson=False):
    st, r = req(port, method, path, body, ndjson)
    assert st == 200, r
    return r


def load_port_node():
    node = Node(device="cpu")
    port = node.start(0)
    ok(port, "PUT", "/books", {"mappings": MAPPINGS})
    r = ok(port, "POST", "/books/_bulk", corpus_lines(), ndjson=True)
    assert not r["errors"]
    ok(port, "POST", "/books/_refresh")
    return node, port


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(srv, "NB_BUCKETS", (8, 16, 32))
    ref = JaxNode(settings=Settings.from_dict({
        "http": {"native": {"fast_nb_buckets": "64,128",
                            "fast_max_k": 200}}}),
        data_path=str(tmp_path_factory.mktemp("ref")))
    ref_port = ref.start(0)
    ok(ref_port, "POST", "/_bulk", corpus_lines(), ndjson=True)
    ok(ref_port, "POST", "/books/_refresh")
    ref._http.fastpath.refresh_registration()
    assert ref._http.fastpath._reg is not None
    node, port = load_port_node()
    node.refresh_front()
    assert node.fastpath.front_registration()["index"] == "books"
    yield (ref, ref_port), (node, port)
    node.close()
    ref.close()
    mp.undo()


def hits_of(r):
    return [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]


def assert_parity(got, want):
    """Equal totals, scores equal within RTOL position by position, and
    equal ids in equal order, except that two docs whose scores agree
    within RTOL may swap (and, at the cut, a doc tying the kth score may
    stand in for another)."""
    assert got["hits"]["total"] == want["hits"]["total"]
    g, w = hits_of(got), hits_of(want)
    assert len(g) == len(w)
    np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                               rtol=RTOL)
    if g:
        assert got["hits"]["max_score"] == pytest.approx(
            want["hits"]["max_score"], rel=RTOL)
    else:
        assert got["hits"]["max_score"] is None
    gscore = dict(g)
    for (gi, gs), (wi, ws) in zip(g, w):
        if gi == wi:
            continue
        other = gscore.get(wi, g[-1][1])
        assert abs(other - gs) <= RTOL * abs(gs), (gi, gs, wi, ws)


def fast_count(node):
    return node.http_stats()["fast"]


@pytest.mark.parametrize("bi", range(len(FAST_BODIES)))
def test_fast_bodies_match_reference_front(nodes, bi):
    (ref, ref_port), (node, port) = nodes
    body = FAST_BODIES[bi]
    before = fast_count(node)
    ref_before = ref._http.stats()["fast"]
    got = ok(port, "POST", "/books/_search", body)
    want = ok(ref_port, "POST", "/books/_search", body)
    assert fast_count(node) == before + 1, "not served by the C++ front"
    assert ref._http.stats()["fast"] == ref_before + 1
    assert_parity(got, want)


@pytest.mark.parametrize("bi", range(len(FALLBACK_BODIES)))
def test_fallback_bodies_take_no_fast_path(nodes, bi):
    _, (node, port) = nodes
    body = FALLBACK_BODIES[bi]
    before = fast_count(node)
    st, got = req(port, "POST", "/books/_search", body)
    assert fast_count(node) == before, f"wrongly fast: {body}"
    st_want, want = node.rest_controller.dispatch(
        "POST", "/books/_search", {}, json.loads(json.dumps(body)))
    assert st == st_want
    got.pop("took", None)
    want.pop("took", None)
    assert got == want


def test_cpp_tokenizer_agrees_with_the_analyzer(nodes):
    """Mixed case, punctuation, digits and underscores: the C++ front's
    term ids give the answer the Python analyzer's ids give."""
    _, (node, port) = nodes
    body = {"query": {"match": {"title": "FoX,gamma!! dog_cat 42 (Lion)"}},
            "size": 40, "_source": False}
    before = fast_count(node)
    got = ok(port, "POST", "/books/_search", body)
    assert fast_count(node) == before + 1
    st, want = node.rest_controller.dispatch("POST", "/books/_search", {},
                                             dict(body))
    assert st == 200
    assert_parity(got, want)


def test_loadgen_completes_every_request(nodes):
    """Every request done with 2xx and served on a fast lane: the four
    bodies the C++ front parses through its arrays, the one it refuses
    (``_source: true``) through the fallback and the Python queue. Each
    connection steps through the bodies round-robin from its own start,
    so how often each body goes out depends on the timing."""
    _, (node, port) = nodes
    bodies = [{"query": {"match": {"title": w}}, "size": 10,
               "_source": False} for w in WORDS[:4]]
    bodies.append(dict(bodies[0], _source=True))
    before = node.http_stats()
    d0 = node.fastpath.serving_stats()["dispatch"]
    res = native_http.loadgen(port, "/books/_search", bodies, n_conns=8,
                              total=80, timeout_s=60)
    assert res["done"] == 80 and res["non2xx"] == 0
    assert res["wall_s"] > 0 and (res["lat_s"] > 0).all()
    after = node.http_stats()
    fast = after["fast"] - before["fast"]
    fallback = after["fallback"] - before["fallback"]
    assert fast + fallback == 80 and fast > 0 and fallback > 0
    assert after["bounced"] == before["bounced"]
    d1 = node.fastpath.serving_stats()["dispatch"]
    assert sum(d1.values()) - sum(d0.values()) == 80


def books_node():
    node, port = load_port_node()
    node.refresh_front()
    return node, port


def registered_segments(node):
    fp = node.fastpath
    names = {r["segment"].name for r in fp._regs.values()}
    front = fp.front_registration()
    if front is not None:
        names.add(front["segment"].name)
    return names


def test_force_merge_retires_every_registration(monkeypatch):
    monkeypatch.setattr(srv, "NB_BUCKETS", (8, 16, 32))
    node, port = books_node()
    try:
        body = {"query": {"match": {"title": "fox"}}, "size": 5,
                "_source": False}
        ok(port, "POST", "/books/_search", body)               # C++
        ok(port, "POST", "/books/_search", dict(body, _source=True))
        old_seg = node.indices["books"].engine.segments[0]
        old = old_seg.name
        assert registered_segments(node) == {old}
        ok(port, "POST", "/books/_bulk", json.dumps(
            {"index": {"_id": "n1"}}) + "\n" + json.dumps(
            {"title": "fox fox fox"}) + "\n", ndjson=True)
        ok(port, "POST", "/books/_refresh")
        ok(port, "POST", "/books/_forcemerge?max_num_segments=1")
        segs = node.indices["books"].engine.segments
        assert len(segs) == 1 and segs[0].name != old
        live = {segs[0].name}
        assert registered_segments(node) <= live
        assert set(node.device_cache._cache) <= live
        # a registration that picked the segment before its retire is
        # refused after it
        assert old_seg.retired
        node.fastpath.register_front("books", old_seg, "title", 1.2, 0.75)
        assert registered_segments(node) <= live
        # the next fast request registers the merged segment afresh
        r = ok(port, "POST", "/books/_search", dict(body, _source=True))
        assert r["hits"]["hits"][0]["_id"] == "n1"
        assert node.fastpath._regs["books"]["segment"] is segs[0]
        node.refresh_front()
        assert node.fastpath.front_registration()["segment"] is segs[0]
        assert registered_segments(node) == live
    finally:
        node.close()


def test_stale_generation_is_bounced_to_the_plan_path(monkeypatch):
    """The drain is held before its poll; a body is parsed under the
    registration of the old segment; a force merge replaces the segment
    and the front registers the new one; the drain then takes the
    request and bounces it, and REST dispatch answers it on the new
    segment (through the fast path's Python queue, as its body fits)
    with the plan path's answer."""
    monkeypatch.setattr(srv, "NB_BUCKETS", (8, 16, 32))
    node, port = books_node()
    fp = node.fastpath
    front = node._http
    gen0 = fp.front_registration()["gen"]
    real_poll = front.poll
    entered, go = threading.Event(), threading.Event()

    def held_poll(bufs, timeout_ms):
        entered.set()
        go.wait(60)
        return real_poll(bufs, timeout_ms)

    try:
        monkeypatch.setattr(front, "poll", held_poll)
        assert entered.wait(10)
        body = {"query": {"match": {"title": "fox"}}, "size": 5,
                "_source": False}
        out = {}
        t = threading.Thread(target=lambda: out.update(
            r=req(port, "POST", "/books/_search", body)))
        before = fast_count(node)
        t.start()
        for _ in range(500):
            if front.lib.es_fast_pending(front.h) == 1:
                break
            threading.Event().wait(0.01)
        assert front.lib.es_fast_pending(front.h) == 1
        assert fast_count(node) == before + 1
        ok(port, "POST", "/books/_bulk", json.dumps(
            {"index": {"_id": "n1"}}) + "\n" + json.dumps(
            {"title": "fox fox fox fox"}) + "\n", ndjson=True)
        ok(port, "POST", "/books/_refresh")
        ok(port, "POST", "/books/_forcemerge?max_num_segments=1")
        node.refresh_front()
        assert fp.front_registration()["gen"] > gen0
        bounced = fp.stats["bounced"]
        go.set()
        t.join(60)
        assert not t.is_alive()
        st, r = out["r"]
        assert st == 200
        assert fp.stats["bounced"] == bounced + 1
        assert r["hits"]["hits"][0]["_id"] == "n1"
        want = node.search_service.search("books", dict(body))
        assert r["hits"]["total"] == want["hits"]["total"]
        assert [h["_id"] for h in r["hits"]["hits"]] == \
            [h["_id"] for h in want["hits"]["hits"]]
    finally:
        go.set()
        node.close()


def test_oversize_query_is_bounced_to_the_plan_path(monkeypatch):
    # every word of the corpus: about 24 blocks, beyond a largest bucket
    # of 16
    monkeypatch.setattr(srv, "NB_BUCKETS", (8, 16))
    node, port = books_node()
    try:
        fp = node.fastpath
        reg = fp.front_registration()
        text = " ".join(WORDS)
        assert fp.route(reg, [reg["dp"].host.term_id(w)
                              for w in WORDS]) is None
        body = {"query": {"match": {"title": text}}, "size": 10,
                "_source": False}
        b0, plan0 = fp.stats["bounced"], \
            node.search_service.plan_batcher.stats()["batched_queries"]
        r = ok(port, "POST", "/books/_search", body)
        assert fp.stats["bounced"] == b0 + 1
        assert node.search_service.plan_batcher.stats()[
            "batched_queries"] == plan0 + 1
        want = node.search_service.search("books", dict(body))
        assert r["hits"]["total"] == want["hits"]["total"]
        assert [h["_id"] for h in r["hits"]["hits"]] == \
            [h["_id"] for h in want["hits"]["hits"]]
    finally:
        node.close()


def test_no_quiet_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(native_http, "CXX", "no-such-compiler-g++")
    monkeypatch.setattr(native_http, "BUILD_ROOT", tmp_path / "build")
    node = Node(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="build failed"):
            node.start(0)
        assert node._http is None
    finally:
        node.close()


def test_taken_port_raises():
    node = Node(device="cpu")
    port = node.start(0)
    other = Node(device="cpu")
    try:
        with pytest.raises(OSError, match="failed to bind"):
            other.start(port)
    finally:
        other.close()
        node.close()


def test_close_leaves_no_thread(monkeypatch):
    monkeypatch.setattr(srv, "NB_BUCKETS", (8, 16, 32))
    before = set(threading.enumerate())
    node, port = books_node()
    ok(port, "POST", "/books/_search", {
        "query": {"match": {"title": "fox"}}, "_source": False})
    assert {t.name for t in set(threading.enumerate()) - before} >= {
        "fastpath-drain", "http-fallback-0", "http-fallback-1"}
    node.close()
    assert [t for t in threading.enumerate()
            if t not in before and t.is_alive()] == []
    assert node._http is None
