"""Cancellable searches on the card.

A ``Node(device="cuda")`` with an index of three segments: a dense
body (``min_score``: the dense executor, one contribution-kernel launch
a segment) run whole launches L kernels; the same body under a task
cancelled after its first scoring answers TaskCancelledException with
fewer than L launches, leaves the ``hbm`` breaker at the resident
segments' bytes, and asked again answers what the whole search answered
(ids, order, float32 scores, totals). A plan body cancelled while it
waits in a PlanBatcher cohort answers the cancellation, and the cohort
answers its other members as they answer alone. Over REST, a `_search`
cancelled through ``POST /_tasks/{id}/_cancel`` answers 400.
"""

import threading

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.common.errors import TaskCancelledException
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.search import batching
from elasticsearch_tpu_torch.search import queries as port_queries

pytestmark = pytest.mark.cuda

DENSE = {"query": {"match": {"t": "w1 w2 w3"}}, "min_score": 0.01,
         "size": 50}


@pytest.fixture(scope="module")
def node(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/ run only on "
                    "the card")
    n = Node(device="cuda", data_path=str(tmp_path_factory.mktemp("t")))
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(60)]
    for part in range(3):
        lines = []
        for i in range(part * 3000, (part + 1) * 3000):
            lines += [{"index": {"_index": "scan", "_id": str(i)}},
                      {"t": " ".join(rng.choice(words, size=16))}]
        st, r = n.rest_controller.dispatch("POST", "/_bulk",
                                           {"refresh": "true"}, lines)
        assert st == 200 and not r["errors"]
    assert len(n.indices["scan"].engine.segments) == 3
    yield n
    n.close()


def wait_until(cond, what, timeout=60.0):
    ev = threading.Event()
    for _ in range(int(timeout / 0.001)):
        if cond():
            return
        ev.wait(0.001)
    raise AssertionError(f"timed out waiting for {what}")


def test_cancel_mid_scan_on_the_card(node, monkeypatch):
    svc = node.search_service
    cancel = [None]
    orig = port_queries.bm25_dense_scores_sorted

    def scoring(*args, **kwargs):
        out = orig(*args, **kwargs)
        if cancel[0] is not None:
            cancel[0]()
            cancel[0] = None
        return out

    monkeypatch.setattr(port_queries, "bm25_dense_scores_sorted", scoring)
    l0 = gather_bm25_contrib.launches
    whole = svc.search("scan", DENSE)
    torch.cuda.synchronize()
    big_l = gather_bm25_contrib.launches - l0
    assert big_l == 3
    tm = node.task_manager
    with tm.task_scope("transport", "indices:data/read/search",
                       cancellable=True) as task:
        cancel[0] = lambda: tm.cancel(task, "mid scan")
        l0 = gather_bm25_contrib.launches
        with pytest.raises(TaskCancelledException):
            svc.search("scan", DENSE, task=task)
        torch.cuda.synchronize()
        launched = gather_bm25_contrib.launches - l0
    assert 1 <= launched < big_l
    br = node.breaker_service.get_breaker("hbm")
    assert br.used == node.device_cache.hbm_stats()["total_bytes"]
    l0 = gather_bm25_contrib.launches
    again = svc.search("scan", DENSE)
    assert gather_bm25_contrib.launches - l0 == big_l
    assert again["hits"] == whole["hits"]
    # over REST: the route's own task, cancelled after one scoring
    cancel[0] = lambda: [tm.cancel(t, "mid scan") for t in
                         tm.list_tasks("indices:data/read/search")]
    st, r = node.rest_controller.dispatch("POST", "/scan/_search", {},
                                          dict(DENSE))
    assert st == 400 and r["error"]["type"] == "task_cancelled_exception"
    assert tm.list_tasks() == []


def test_cancel_inside_a_plan_cohort_on_the_card(node):
    svc = node.search_service
    batcher = svc.plan_batcher
    bodies = [{"query": {"match": {"t": f"w{i}"}}, "size": 100}
              for i in range(6)]
    solo = [svc.search("scan", b) for b in bodies]
    tm = node.task_manager
    tasks = [tm.register("transport", "indices:data/read/search",
                         cancellable=True) for _ in bodies]
    out = [None] * len(bodies)
    launches0, queued0 = batcher.launches, batcher.cancelled_queued

    def run(i):
        try:
            out[i] = svc.search("scan", bodies[i], task=tasks[i])
        except TaskCancelledException as e:
            out[i] = e

    def queued():
        with batcher._lock:
            return sum(len(q) for q in batcher._pending.values())

    held = [batcher._launch_slots.acquire()
            for _ in range(batching.MAX_CONCURRENT)]
    threads = []
    try:
        # one segment at a time: each body's first segment queues
        for i in range(len(bodies)):
            threads.append(threading.Thread(target=run, args=(i,)))
            threads[-1].start()
            wait_until(lambda: queued() == i + 1, "the member queued")
        tm.cancel(tasks[3], "in the cohort")
        wait_until(lambda: queued() == len(bodies) - 1,
                   "the cancelled member left")
    finally:
        for _ in held:
            batcher._launch_slots.release()
        for th in threads:
            th.join(120)
        for t in tasks:
            tm.unregister(t)
    assert isinstance(out[3], TaskCancelledException)
    for i, r in enumerate(out):
        if i != 3:
            assert r["hits"] == solo[i]["hits"], i
    assert batcher.cancelled_queued - queued0 == 1
    assert batcher.launches > launches0
    br = node.breaker_service.get_breaker("hbm")
    assert br.used == node.device_cache.hbm_stats()["total_bytes"]
