"""Frozen indices against the reference, on the CPU.

The reference's tests/test_operational.py cases ``test_freeze_unfreeze``,
``test_frozen_eviction_after_scroll`` and
``test_frozen_search_uses_throttled_pool`` run on both packages' nodes,
each request sent to both, answers compared (ids, order, totals); and a
point in time on a frozen index. On the port, after every search of a
frozen index (a scroll page and a PIT search included) none of its
segments is in the device cache and the ``hbm`` breaker holds only the
other indices' resident bytes; a live scroll cursor and a PIT go on
answering what they answered, uploading their segments again.
"""

import pytest

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node

MAPPINGS = {"mappings": {"properties": {"v": {"type": "long"},
                                        "t": {"type": "text"}}}}


class Pair:
    def __init__(self, tmp_path):
        self.jax = JaxNode(Settings.EMPTY, data_path=str(tmp_path / "ref"))
        self.port = Node(device="cpu", data_path=str(tmp_path / "port"))

    def close(self):
        self.port.close()
        self.jax.close()

    def both(self, method, path, params=None, body=None):
        return (self.jax.rest_controller.dispatch(method, path,
                                                  dict(params or {}), body),
                self.port.rest_controller.dispatch(method, path,
                                                   dict(params or {}), body))

    def do(self, method, path, params=None, body=None, expect=200):
        (jst, j), (st, p) = self.both(method, path, params, body)
        assert jst == expect, f"{method} {path} -> {jst}: {j}"
        assert st == expect, f"{method} {path} -> {st}: {p}"
        return j, p

    def search(self, path, body, params=None):
        """Both answers, equal in ids, order and totals."""
        j, p = self.do("POST", path, params, body)
        assert hits(j) == hits(p), (j, p)
        return j, p

    def seed(self, name, n):
        self.do("PUT", f"/{name}", body=MAPPINGS)
        for i in range(n):
            self.do("PUT", f"/{name}/_doc/{i}", body={
                "v": i, "t": f"ice w{i % 3}"}, expect=201)
        self.do("POST", f"/{name}/_refresh")


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def hits(r):
    return ([h["_id"] for h in r["hits"]["hits"]], r["hits"]["total"])


def port_resident(pair, index):
    """The port's resident segments of ``index``."""
    node = pair.port
    return [n for n in node.indices[index].segment_names()
            if node.device_cache.resident(n) is not None]


def port_breaker_is_resident_bytes(pair):
    node = pair.port
    assert node.breaker_service.get_breaker("hbm").used == \
        node.device_cache.hbm_stats()["total_bytes"]


def ref_resident(pair, index):
    idx = pair.jax.indices_service.get(index)
    return [n for n in idx._known_seg_names if n in idx.device_cache._cache]


def test_freeze_unfreeze(pair):
    pair.seed("idx", 3)
    pair.seed("hot", 4)
    pair.search("/hot/_search", {"size": 10})    # "hot" stays resident
    pair.do("POST", "/idx/_freeze")
    # frozen is searchable but write-blocked
    j, _ = pair.search("/idx/_search", {"size": 10, "sort": ["v"]})
    assert j["hits"]["total"]["value"] == 3
    (jst, _), (st, p) = pair.both("PUT", "/idx/_doc/9", body={"v": 9})
    assert jst == st == 403
    assert p["error"]["type"] == "cluster_block_exception"
    # no device-resident segments linger after a frozen search
    assert ref_resident(pair, "idx") == []
    assert port_resident(pair, "idx") == []
    assert port_resident(pair, "hot") != []
    port_breaker_is_resident_bytes(pair)
    j, p = pair.do("GET", "/_migration/deprecations")
    assert j == p and "idx" in p["index_settings"]
    pair.do("POST", "/idx/_unfreeze")
    pair.do("PUT", "/idx/_doc/9", body={"v": 9}, expect=201)
    j, p = pair.do("GET", "/_migration/deprecations")
    assert j == p and p["index_settings"] == {}
    # unfrozen, a search keeps its segments on the device again
    pair.do("POST", "/idx/_refresh")
    pair.search("/idx/_search", {"size": 10, "sort": ["v"]})
    assert port_resident(pair, "idx") != []


def test_frozen_eviction_after_scroll(pair):
    pair.seed("fz", 5)
    pair.do("POST", "/fz/_freeze")
    body = {"size": 2, "sort": ["v"]}
    j, p = pair.search("/fz/_search", body, {"scroll": "1m"})
    assert ref_resident(pair, "fz") == [] and port_resident(pair, "fz") == []
    pages = [(hits(j), hits(p))]
    jid, pid = j["_scroll_id"], p["_scroll_id"]
    for _ in range(3):
        j = pair.jax.search_service.scroll(jid)
        st, p = pair.port.rest_controller.dispatch(
            "POST", "/_search/scroll", {}, {"scroll_id": pid})
        assert st == 200
        pages.append((hits(j), hits(p)))
        # the cursor lives on; its segments leave the device each page
        assert ref_resident(pair, "fz") == []
        assert port_resident(pair, "fz") == []
        port_breaker_is_resident_bytes(pair)
    assert all(a == b for a, b in pages)
    assert [ids for (ids, _), _ in pages] == [["0", "1"], ["2", "3"],
                                              ["4"], []]


def test_frozen_search_uses_throttled_pool(pair):
    pair.do("PUT", "/coldidx", body={"mappings": {"properties": {
        "t": {"type": "text"}}}})
    pair.do("PUT", "/coldidx/_doc/1", body={"t": "ice"}, expect=201)
    pair.do("POST", "/coldidx/_refresh")
    pair.do("POST", "/coldidx/_freeze")
    throttled = {}
    for name, node in (("jax", pair.jax), ("port", pair.port)):
        throttled[name] = node.threadpool.executor(
            "search_throttled").stats()["completed"]
    j, p = pair.search("/coldidx/_search", {"query": {"match": {"t": "ice"}}})
    assert p["hits"]["total"]["value"] == 1
    for name, node in (("jax", pair.jax), ("port", pair.port)):
        after = node.threadpool.executor("search_throttled") \
            .stats()["completed"]
        assert after == throttled[name] + 1, name
        throttled[name] = after
    # hot indices stay off the throttled pool
    pair.do("PUT", "/hotidx")
    pair.do("PUT", "/hotidx/_doc/1", body={"x": 1}, expect=201)
    pair.do("POST", "/hotidx/_refresh")
    pair.search("/hotidx/_search", {"query": {"match_all": {}}})
    # a search of a frozen and a hot index is not throttled either
    pair.search("/coldidx,hotidx/_search", {"query": {"match_all": {}}})
    for name, node in (("jax", pair.jax), ("port", pair.port)):
        assert node.threadpool.executor("search_throttled") \
            .stats()["completed"] == throttled[name], name
    assert port_resident(pair, "coldidx") == []
    assert port_resident(pair, "hotidx") != []


def test_frozen_search_keeps_its_trace_and_task(pair):
    """On the port a throttled search still answers its trace id and
    runs under its task: the contexts cross to the pool's thread."""
    pair.seed("fz", 3)
    pair.do("POST", "/fz/_freeze")
    node = pair.port
    st, r = node.rest_controller.dispatch(
        "POST", "/fz/_search", {}, {"query": {"match": {"t": "ice"}}},
        headers={"X-Opaque-Id": "frozen-op"})
    assert st == 200 and r["hits"]["total"]["value"] == 3
    trace_id = r["_headers"]["trace.id"]
    st, tr = node.rest_controller.dispatch("GET", f"/_traces/{trace_id}",
                                           {}, None)
    assert st == 200
    assert node.task_manager.list_tasks() == []


def test_pit_on_a_frozen_index(pair):
    pair.seed("fz", 6)
    pair.do("POST", "/fz/_freeze")
    j, p = pair.do("POST", "/fz/_pit", {"keep_alive": "1m"})
    body = {"size": 4, "sort": ["v"], "query": {"match": {"t": "w1"}}}
    for _ in range(2):
        jr = pair.jax.rest_controller.dispatch(
            "POST", "/_search", {}, dict(body, pit={"id": j["id"]}))[1]
        st, pr = pair.port.rest_controller.dispatch(
            "POST", "/_search", {}, dict(body, pit={"id": p["id"]}))
        assert st == 200 and hits(jr) == hits(pr)
        assert [h["_id"] for h in pr["hits"]["hits"]] == ["1", "4"]
        assert ref_resident(pair, "fz") == []
        assert port_resident(pair, "fz") == []
        port_breaker_is_resident_bytes(pair)
    st, _ = pair.port.rest_controller.dispatch("DELETE", "/_pit", {},
                                               {"id": p["id"]})
    assert st == 200
    port_breaker_is_resident_bytes(pair)


def test_the_front_keeps_a_frozen_one_segment_index(tmp_path):
    """As the reference's ``_eligible`` (search/fastpath.py), which leaves
    out only closed indices and indices of several shards, the port's
    ``refresh_front`` registers a frozen index of one segment when it is
    the largest: the front's fast bodies then read its resident copy,
    while every search through the REST layer drops it again."""
    node = Node(device="cpu", data_path=str(tmp_path / "front"))
    try:
        c = node.rest_controller
        c.dispatch("PUT", "/fz", {}, {"mappings": {"properties": {
            "t": {"type": "text"}}}})
        lines = []
        for i in range(40):
            lines += [{"index": {"_index": "fz", "_id": str(i)}},
                      {"t": f"ice w{i % 4}"}]
        st, r = c.dispatch("POST", "/_bulk", {"refresh": "true"}, lines)
        assert st == 200 and not r["errors"]
        node.start(0)
        c.dispatch("POST", "/fz/_freeze", {}, None)
        node.refresh_front()
        assert node.fastpath.front_registration()["index"] == "fz"
        st, r = c.dispatch("POST", "/fz/_search", {}, {
            "query": {"match": {"t": "w1"}}, "_source": False})
        assert st == 200 and r["hits"]["total"]["value"] == 10
        assert [n for n in node.indices["fz"].segment_names()
                if node.device_cache.resident(n) is not None] == []
    finally:
        node.close()
