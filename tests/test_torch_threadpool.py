"""The named thread pools against the reference, on the CPU.

The reference's pool cases (tests/test_action_client_threadpool.py:
execution and the EWMA, rejection when full, the registry's names and
sizes) run on both packages' ``common/threadpool.py``. On both nodes:
`_msearch` runs its bodies on the ``search`` pool (a single body
inline), and a full queue rejects only the bodies past it, each with
its own 429 ``es_rejected_execution_exception``; the ``thread_pool``
section of `_nodes/stats` and `_cat/thread_pool` have the reference's
pools and columns (node names masked).

No test waits on the wall clock: a pool's worker is held by a
``threading.Event`` and a test waits for a state by polling it
(``wait_until``).
"""

import threading
import time

import pytest

from elasticsearch_tpu.common import threadpool as jax_threadpool
from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.common import threadpool as port_threadpool
from elasticsearch_tpu_torch.node import Node

POOLS = {"jax": jax_threadpool, "port": port_threadpool}
POOL_NAMES = {"search", "search_throttled", "write", "get", "management",
              "snapshot"}
STAT_KEYS = {"threads", "queue", "active", "completed", "rejected",
             "ewma_task_ms"}


def wait_until(cond, what, timeout=30.0):
    ev = threading.Event()
    for _ in range(int(timeout / 0.001)):
        if cond():
            return
        ev.wait(0.001)
    raise AssertionError(f"timed out waiting for {what}")


# ------------------------ tests/test_action_client_threadpool.py:20-64


@pytest.mark.parametrize("pkg", sorted(POOLS))
def test_pool_executes_and_tracks_ewma(pkg):
    pool = POOLS[pkg].TaskTrackingPool("t", 2, 10)
    try:
        f = pool.submit(lambda: sum(range(1000)))
        assert f.result(5) == 499500
        for _ in range(5):
            pool.submit(time.sleep, 0.01).result(5)
        st = pool.stats()
        assert st["completed"] >= 6
        assert st["ewma_task_ms"] > 0
        assert set(st) == STAT_KEYS
    finally:
        pool.shutdown()


@pytest.mark.parametrize("pkg", sorted(POOLS))
def test_pool_rejects_when_full(pkg):
    mod = POOLS[pkg]
    pool = mod.TaskTrackingPool("tiny", 1, 1)
    gate = threading.Event()
    try:
        pool.execute(gate.wait)          # occupies the worker
        wait_until(lambda: pool.stats()["active"] == 1, "the worker")
        pool.execute(lambda: None)       # fills the queue
        with pytest.raises(mod.EsRejectedExecutionException) as e:
            pool.execute(lambda: None)
        assert e.value.status == 429
        gate.set()
        assert pool.stats()["rejected"] == 1
    finally:
        gate.set()
        pool.shutdown()


@pytest.mark.parametrize("pkg", sorted(POOLS))
def test_threadpool_registry_names(pkg):
    tp = POOLS[pkg].ThreadPool(processors=4)
    try:
        assert set(tp.stats()) == POOL_NAMES
        assert tp.executor("search").size == 7   # 3*p/2+1
        sizes = {n: (p.size, p.queue_size) for n, p in tp.pools.items()}
        assert sizes == {"search": (7, 1000), "search_throttled": (1, 100),
                         "write": (4, 10000), "get": (4, 1000),
                         "management": (2, 100), "snapshot": (2, 1000)}
    finally:
        tp.shutdown()


def test_port_shutdown_joins_the_workers():
    tp = port_threadpool.ThreadPool(processors=2)
    threads = [t for p in tp.pools.values() for t in p._threads]
    tp.shutdown(timeout=10)
    assert not any(t.is_alive() for t in threads)
    with pytest.raises(port_threadpool.EsRejectedExecutionException):
        tp.executor("search").execute(lambda: None)


# ------------------------------------------------- both nodes' routes


class Pair:
    def __init__(self, tmp_path):
        self.jax = JaxNode(Settings.EMPTY, data_path=str(tmp_path / "ref"))
        self.port = Node(device="cpu", data_path=str(tmp_path / "port"))

    def nodes(self):
        return (("jax", self.jax), ("port", self.port))

    def close(self):
        self.port.close()
        self.jax.close()

    def do(self, method, path, params=None, body=None, expect=200):
        out = []
        for _, node in self.nodes():
            st, r = node.rest_controller.dispatch(method, path,
                                                  dict(params or {}), body)
            assert st == expect, f"{method} {path} -> {st}: {r}"
            out.append(r)
        return out


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    for i in range(6):
        p.do("PUT", f"/idx/_doc/{i}", {"refresh": "true"},
             {"t": f"w{i % 3} common", "n": i}, expect=201)
    yield p
    p.close()


def hits(r):
    return ([h["_id"] for h in r["hits"]["hits"]], r["hits"]["total"])


BODIES = [{"query": {"match": {"t": "w0"}}, "size": 3},
          {"query": {"match": {"t": "common"}}, "size": 4},
          {"query": {"term": {"n": 2}}},
          {"query": {"range": {"n": {"gte": 3}}}, "sort": [{"n": "asc"}]}]


def msearch_lines(bodies):
    lines = []
    for b in bodies:
        lines += [{"index": "idx"}, b]
    return lines


def test_msearch_bodies_run_on_the_search_pool(pair):
    for pkg, node in pair.nodes():
        before = node.threadpool.stats()["search"]["completed"]
        st, r = node.rest_controller.dispatch(
            "POST", "/_msearch", {}, msearch_lines(BODIES))
        assert st == 200
        alone = [node.rest_controller.dispatch("POST", "/idx/_search", {},
                                               b)[1] for b in BODIES]
        assert [hits(x) for x in r["responses"]] == [hits(a)
                                                     for a in alone], pkg
        wait_until(lambda: node.threadpool.stats()["search"]["completed"]
                   == before + len(BODIES), f"{pkg}: completed")
        # a single body runs inline, off the pool
        st, r = node.rest_controller.dispatch(
            "POST", "/_msearch", {}, msearch_lines(BODIES[:1]))
        assert st == 200 and hits(r["responses"][0]) == hits(alone[0])
        assert node.threadpool.stats()["search"]["completed"] \
            == before + len(BODIES), pkg
    j, p = pair.do("POST", "/_msearch", body=msearch_lines(BODIES))
    assert [hits(x) for x in j["responses"]] == \
        [hits(x) for x in p["responses"]]


def test_msearch_full_queue_rejects_each_body_past_it(pair):
    """A search pool of one thread and a queue of one, its worker held:
    the first body takes the queue's slot and the two after it answer
    their own 429 on both nodes; the first answers as it does alone."""
    answers = {}
    for pkg, node in pair.nodes():
        mod = POOLS[pkg]
        node.threadpool.pools["search"].shutdown()
        pool = node.threadpool.pools["search"] = mod.TaskTrackingPool(
            "search", 1, 1)
        gate = threading.Event()
        pool.execute(gate.wait)
        wait_until(lambda: pool.stats()["active"] == 1, f"{pkg}: worker")
        box = {}
        th = threading.Thread(target=lambda: box.setdefault(
            "r", node.rest_controller.dispatch(
                "POST", "/_msearch", {}, msearch_lines(BODIES[:3]))))
        th.start()
        try:
            wait_until(lambda: pool.stats()["rejected"] == 2,
                       f"{pkg}: two rejections")
        finally:
            gate.set()
            th.join(30)
        st, r = box["r"]
        assert st == 200
        answers[pkg] = r["responses"]
        alone = node.rest_controller.dispatch("POST", "/idx/_search", {},
                                              BODIES[0])[1]
        assert hits(r["responses"][0]) == hits(alone)
        assert pool.stats()["rejected"] == 2
    for pkg, slots in answers.items():
        assert [s.get("status") for s in slots[1:]] == [429, 429], pkg
        assert {s["error"]["type"] for s in slots[1:]} == {
            "es_rejected_execution_exception"}, pkg
    assert [hits(s) for s in answers["jax"][:1]] == \
        [hits(s) for s in answers["port"][:1]]


def test_nodes_stats_thread_pool_and_cat(pair):
    pair.do("POST", "/_msearch", body=msearch_lines(BODIES))
    sections = {}
    for pkg, node in pair.nodes():
        st, r = node.rest_controller.dispatch("GET", "/_nodes/stats", {},
                                              None)
        assert st == 200
        nid = (node.node_id if pkg == "port"
               else next(iter(r["nodes"])))
        tp = r["nodes"][nid]["thread_pool"]
        assert set(tp) == POOL_NAMES
        assert all(set(row) == STAT_KEYS for row in tp.values())
        sections[pkg] = {n: (row["threads"], set(row)) for n, row
                         in tp.items()}
        st, cat = node.rest_controller.dispatch("GET", "/_cat/thread_pool",
                                                {}, None)
        assert st == 200
        rows = [ln.split() for ln in cat["_cat"].splitlines()]
        # node pool active queue rejected, a row a pool, by name
        assert [row[1] for row in rows] == sorted(POOL_NAMES)
        stats = node.threadpool.stats()
        assert [[int(x) for x in row[2:]] for row in rows] == [
            [stats[n]["active"], stats[n]["queue"], stats[n]["rejected"]]
            for n in sorted(POOL_NAMES)], pkg
    assert sections["jax"] == sections["port"]
