"""The operational layer on the card: a frozen index's eviction and a
restore's fresh device state.

A ``Node(device="cuda")`` with a three-shard index ("cold", frozen) and
a one-segment index ("hot"). Every search of the frozen index, a scroll
page and a dense body that launches the contribution kernel included,
answers what it answered unfrozen (ids, order, float32 scores, totals),
and leaves none of its segments on the card: the ``hbm`` breaker holds
the resident bytes ("hot"'s) after each. A snapshot of "hot" restored
beside it as "hot_r" has segments of other names and device copies of
its own, answers "hot"'s answers, and keeps a document "hot" deletes.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib

pytestmark = pytest.mark.cuda

DENSE = {"query": {"match": {"t": "w1 w2 w3"}}, "min_score": 0.01,
         "size": 20}
PLAN = {"query": {"match": {"t": {"query": "w4 w7", "boost": 1.0}}},
        "size": 20}


@pytest.fixture(scope="module")
def node(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/ run only on "
                    "the card")
    n = Node(device="cuda", data_path=str(tmp_path_factory.mktemp("ops")))
    rng = np.random.default_rng(24)
    words = [f"w{i}" for i in range(60)]
    for index, shards in (("cold", 3), ("hot", 1)):
        st, _ = n.rest_controller.dispatch("PUT", f"/{index}", {}, {
            "settings": {"index": {"number_of_shards": shards}},
            "mappings": {"properties": {"t": {"type": "text"}}}})
        assert st == 200
        lines = []
        for i in range(6000):
            lines += [{"index": {"_index": index, "_id": str(i)}},
                      {"t": " ".join(rng.choice(words, size=12))}]
        st, r = n.rest_controller.dispatch("POST", "/_bulk",
                                           {"refresh": "true"}, lines)
        assert st == 200 and not r["errors"]
    n.rest_controller.dispatch("POST", "/hot/_forcemerge",
                               {"max_num_segments": "1"}, None)
    yield n
    n.close()


def _search(node, path, body, params=None):
    st, r = node.rest_controller.dispatch("POST", path, params or {},
                                          dict(body))
    assert st == 200, r
    return r


def _hits(r):
    return ([h["_id"] for h in r["hits"]["hits"]],
            np.asarray([h["_score"] for h in r["hits"]["hits"]],
                       np.float32), r["hits"]["total"])


def _same(a, b):
    ia, sa, ta = _hits(a)
    ib, sb, tb = _hits(b)
    assert ia == ib and ta == tb
    np.testing.assert_array_equal(sa, sb)


def _resident(node, index):
    return [n for n in node.indices[index].segment_names()
            if node.device_cache.resident(n) is not None]


def _breaker_is_resident(node):
    torch.cuda.synchronize()
    assert node.breaker_service.get_breaker("hbm").used == \
        node.device_cache.hbm_stats()["total_bytes"]


def test_frozen_searches_leave_nothing_on_the_card(node):
    _search(node, "/hot/_search", DENSE)
    warm = [_search(node, "/cold/_search", b) for b in (DENSE, PLAN)]
    walk = [_search(node, "/cold/_search", DENSE, {"scroll": "1m"})]
    st, _ = node.rest_controller.dispatch("POST", "/cold/_freeze", {}, None)
    assert st == 200
    assert _resident(node, "cold") == []
    _breaker_is_resident(node)
    try:
        for body, want in zip((DENSE, PLAN), warm):
            torch.cuda.synchronize()
            l0 = gather_bm25_contrib.launches
            got = _search(node, "/cold/_search", body)
            torch.cuda.synchronize()
            if body is DENSE:
                assert gather_bm25_contrib.launches - l0 >= 3
            _same(got, want)
            assert _resident(node, "cold") == []
            assert _resident(node, "hot") != []
            _breaker_is_resident(node)
        # the scroll opened before the freeze goes on from its cursor,
        # uploading its segments again and dropping them after the page
        st, page = node.rest_controller.dispatch(
            "POST", "/_search/scroll", {},
            {"scroll_id": walk[0]["_scroll_id"]})
        assert st == 200 and page["hits"]["hits"]
        assert not ({h["_id"] for h in page["hits"]["hits"]}
                    & {h["_id"] for h in walk[0]["hits"]["hits"]})
        assert _resident(node, "cold") == []
        _breaker_is_resident(node)
    finally:
        node.rest_controller.dispatch("DELETE", "/_search/scroll", {},
                                      {"scroll_id": "_all"})
        node.rest_controller.dispatch("POST", "/cold/_unfreeze", {}, None)


def test_restore_beside_the_source_has_its_own_device_state(node,
                                                            tmp_path):
    c = node.rest_controller
    st, _ = c.dispatch("PUT", "/_snapshot/card", {}, {
        "type": "fs", "settings": {"location": str(tmp_path / "repo")}})
    assert st == 200
    st, r = c.dispatch("PUT", "/_snapshot/card/s", {}, {"indices": "hot"})
    assert st == 200 and r["snapshot"]["state"] == "SUCCESS"
    st, _ = c.dispatch("POST", "/_snapshot/card/s/_restore", {}, {
        "rename_pattern": "hot", "rename_replacement": "hot_r"})
    assert st == 200
    try:
        src = set(node.indices["hot"].segment_names())
        dst = set(node.indices["hot_r"].segment_names())
        assert src and dst and not (src & dst)
        for body in (DENSE, PLAN):
            _same(_search(node, "/hot_r/_search", body),
                  _search(node, "/hot/_search", body))
        devs = [node.device_cache.resident(n) for n in src | dst]
        assert all(d is not None for d in devs)
        assert len({id(d) for d in devs}) == len(devs)
        _breaker_is_resident(node)
        want = _search(node, "/hot_r/_search", DENSE)
        victim = want["hits"]["hits"][0]["_id"]
        c.dispatch("DELETE", f"/hot/_doc/{victim}", {}, None)
        c.dispatch("POST", "/hot/_refresh", {}, None)
        _same(_search(node, "/hot_r/_search", DENSE), want)
        r = _search(node, "/hot/_search", DENSE)
        assert r["hits"]["total"]["value"] == \
            want["hits"]["total"]["value"] - 1
    finally:
        c.dispatch("DELETE", "/hot_r", {}, None)
        c.dispatch("DELETE", "/_snapshot/card", {}, None)
    _breaker_is_resident(node)
