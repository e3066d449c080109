"""Device accounting and launch attribution on the card: the bytes a
DeviceSegment's build and a lazy build request from the caching
allocator equal the bytes its slab classes count, and
``memory_allocated()`` grows by them within the allocator's rounding (512
B a tensor, plus at most 1 MiB for a large tensor handed an unsplit
cached block); an admission past the ``hbm`` limit evicts the least
recently used segment and the card gets its memory back; a node whose
limit is below one segment answers 429 over HTTP and still serves an
index that fits; the `_search` URL parameters over HTTP through the C++
front's fallback; and ``GET /_kernels`` counts each hand-written
kernel's calls as its ``.launches`` counts them."""

import gc
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.corpus import (build_corpus, bench_cat,
                                            segment_from_corpus, term_name)
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.ops.device import DeviceSegment
from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots

pytestmark = pytest.mark.cuda

ROUND = 512
LARGE = 1 << 20


def settled():
    """(memory_allocated(), requested bytes) once everything settled."""
    gc.collect()
    torch.cuda.synchronize()
    return (torch.cuda.memory_allocated(),
            torch.cuda.memory_stats()["requested_bytes.all.current"])


def slack(sizes):
    return sum(ROUND + (LARGE if n > LARGE else 0) for n in sizes)


def sizes_of(dev):
    return ([int(t.nbytes) for _c, t in dev._fixed_tensors()]
            + [int(m.nbytes) for m, _h in dev._filter_masks.values()]
            + [int(e[0].nbytes) for e in dev._kw_ord_major.values()
               if e is not None])


def assert_bytes(a, r, want, sizes):
    assert r == want
    assert 0 <= a - want <= slack(sizes)


def http(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data,
                                 {"Content-Type": "application/json"},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


@pytest.fixture(scope="module")
def corpus():
    return build_corpus(np.random.default_rng(21), n_docs=60000,
                        vocab=3000)


def _segment(corpus, name):
    n = len(corpus["lens"])
    return segment_from_corpus(corpus, name=name, keywords={
        "cat": dict(zip(("ords", "terms"), bench_cat(n)))})


def test_build_and_lazy_builds_allocate_what_the_classes_count(
        cuda_device, corpus):
    seg = _segment(corpus, "acct0")
    a0, r0 = settled()
    dev = DeviceSegment(seg, cuda_device)
    a1, r1 = settled()
    assert_bytes(a1 - a0, r1 - r0, dev.hbm_bytes(), sizes_of(dev))
    for build in (lambda: dev.filter_mask("title", (term_name(3),)),
                  lambda: dev.keyword_ord_major("cat")):
        h0, n0 = dev.hbm_bytes(), len(sizes_of(dev))
        b0, q0 = settled()
        build()
        b1, q1 = settled()
        assert dev.hbm_bytes() > h0
        assert_bytes(b1 - b0, q1 - q0, dev.hbm_bytes() - h0,
                     sizes_of(dev)[n0:])
    del dev
    assert settled()[1] == r0


def test_eviction_returns_the_segments_memory(cuda_device, corpus):
    segs = [_segment(corpus, f"ev{i}") for i in range(3)]
    one = DeviceSegment(segs[0], cuda_device).hbm_bytes()
    gc.collect()
    node = Node(device=cuda_device,
                settings={"indices.breaker.hbm.limit": int(2.5 * one)})
    try:
        for i, seg in enumerate(segs):
            node.create_index(f"ev{i}", {"properties": {
                "title": {"type": "text"}}})
            node.indices[f"ev{i}"].engine.install_segments([seg])
        body = {"query": {"match": {"title": {
            "query": term_name(5), "boost": 1.0}}}, "size": 10}
        for i in (0, 1):
            st, _ = node.rest_controller.dispatch(
                "POST", f"/ev{i}/_search", {}, body)
            assert st == 200
        r0 = settled()[1]
        st, _ = node.rest_controller.dispatch("POST", "/ev2/_search", {},
                                              body)
        assert st == 200
        r1 = settled()[1]
        cache = node.device_cache
        assert cache.hbm_breaker_evictions == 1
        assert sorted(cache._devices()) == ["ev1", "ev2"]
        # ev2 came, ev0 went: the card holds what it held
        assert abs(r1 - r0) <= ROUND * 64
        br = node.breaker_service.get_breaker("hbm")
        assert br.used == cache.hbm_stats()["total_bytes"] == 2 * one
    finally:
        node.close()


def test_429_over_http_and_an_index_that_fits_serves(cuda_device, corpus):
    seg = _segment(corpus, "big0")
    one = DeviceSegment(seg, cuda_device).hbm_bytes()
    gc.collect()
    node = Node(device=cuda_device,
                settings={"indices.breaker.hbm.limit": one // 2})
    try:
        node.create_index("big", {"properties": {"title": {"type": "text"}}})
        node.indices["big"].engine.install_segments([seg])
        port = node.start(0)
        st, _ = http(port, "PUT", "/small")
        assert st == 200
        lines = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                        + json.dumps({"title": "small doc"}) + "\n"
                        for i in range(20))
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/small/_bulk?refresh=true",
            lines.encode(), {"Content-Type": "application/x-ndjson"},
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
        st, r = http(port, "POST", "/big/_search",
                     {"query": {"match": {"title": term_name(5)}}})
        assert st == 429
        err = r["error"]
        assert err["type"] == "circuit_breaking_exception"
        assert err["bytes_wanted"] == one
        assert err["bytes_limit"] == one // 2
        st, r = http(port, "POST", "/small/_search",
                     {"query": {"match": {"title": "small"}}})
        assert st == 200 and r["hits"]["total"]["value"] == 20
    finally:
        node.close()


def test_url_parameters_over_http(cuda_device, corpus):
    node = Node(device=cuda_device)
    try:
        node.create_index("idx", {"properties": {"title": {"type": "text"}}})
        node.indices["idx"].engine.install_segments(
            [_segment(corpus, "idx0")])
        port = node.start(0)
        t = term_name(7)
        st, a = http(port, "POST", f"/idx/_search?q=title:{t}&size=3",
                     {"_source": False})
        st2, b = http(port, "POST", "/idx/_search",
                      {"query": {"match": {"title": t}}, "size": 3,
                       "_source": False})
        assert st == st2 == 200
        # the C++ front writes the scores with fewer digits
        assert a["hits"]["total"] == b["hits"]["total"]
        assert [h["_id"] for h in a["hits"]["hits"]] == \
            [h["_id"] for h in b["hits"]["hits"]]
        assert len(a["hits"]["hits"]) == 3
        np.testing.assert_allclose([h["_score"] for h in a["hits"]["hits"]],
                                   [h["_score"] for h in b["hits"]["hits"]],
                                   rtol=1e-6)
        st, r = http(port, "POST", "/idx/_search?scroll=1m", {})
        assert st == 200 and "_scroll_id" in r
        st, r = http(port, "POST", "/idx/_search?timeout=1s", {})
        assert st == 400
        assert r["error"]["type"] == "unsupported_in_slice_exception"
        st, r = http(port, "POST", "/idx/_search?request_cache=maybe", {})
        assert st == 400
        assert r["error"]["type"] == "illegal_argument_exception"
    finally:
        node.close()


def test_kernels_counts_equal_the_launch_counters(cuda_device, corpus):
    node = Node(device=cuda_device)
    try:
        node.create_index("idx", {"properties": {"title": {"type": "text"}}})
        node.indices["idx"].engine.install_segments(
            [_segment(corpus, "kc0")])
        port = node.start(0)
        _, k0 = http(port, "GET", "/_kernels")
        l0 = (gather_bm25_contrib.launches, merge_sorted_slots.launches)
        for t in range(10, 16):
            st, _ = http(port, "POST", "/idx/_search",
                         {"query": {"match": {"title": f"{term_name(t)} "
                                                       f"{term_name(t + 9)}"}},
                          "size": 10, "_source": False})
            assert st == 200
        _, k1 = http(port, "GET", "/_kernels")
        got = tuple(k1["kernels"][n]["calls"]
                    - k0["kernels"].get(n, {}).get("calls", 0)
                    for n in ("gather_bm25_contrib", "merge_sorted_slots"))
        want = (gather_bm25_contrib.launches - l0[0],
                merge_sorted_slots.launches - l0[1])
        assert got == want and got[0] > 0 and got[1] > 0
        assert k1["persistent_cache"]["loads"] >= 2
        assert "serving" in k1
    finally:
        node.close()
