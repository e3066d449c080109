"""The task manager, `_tasks` and cancellable searches against the
reference, on the CPU.

The reference's tests/test_async_search.py task cases run on both
packages' nodes, each request sent to both: statuses, error types and
the `_tasks` shapes equal, with the fields that differ between the two
by construction masked (``MASKED``: node ids, task ids, times, the
trace id). Beyond them, on the port: group_by, detailed, `_cat/tasks`,
hot threads and the ``tasks`` section of `_nodes/stats`; a search
cancelled mid-scan over a three-segment index (fewer launches than the
whole search, a 400 ``task_cancelled_exception``, the next answer equal
to the whole one); a body cancelled inside a PlanBatcher cohort, as a
follower and as the leader (it answers 400, the cohort answers the
others as they answer alone, and the hbm breaker holds the resident
bytes only); and `_msearch`'s parent cancel, whose ban kills the
children that had not started.

No test waits on the wall clock: slow searches are held by
``threading.Event``s, and a test waits for a thread to reach a point
by polling a condition (``wait_until``). Every test runs under a guard
that fails it when it leaves a task registered or a background thread
of a node running (``_leak_guard``).
"""

import threading

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import \
    TaskCancelledException as JaxTaskCancelled
from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.transport.tasks import TaskId as JaxTaskId
from elasticsearch_tpu_torch.common.errors import TaskCancelledException
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search import batching
from elasticsearch_tpu_torch.search import queries as port_queries
from elasticsearch_tpu_torch.transport import tasks as port_tasks
from elasticsearch_tpu_torch.transport.tasks import TaskId

# the fields of a task that differ between the packages by construction
MASKED = ("node", "id", "start_time_in_millis", "running_time_in_nanos",
          "trace.id", "parent_task_id")
# the names of the background threads a node starts (Node.spawn)
BACKGROUND = ("async_search-", "indices:")


def background_threads():
    return {t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(BACKGROUND)}


@pytest.fixture(autouse=True)
def _leak_guard():
    """Fail a test that leaves a port task registered or a node's
    background thread running (the reference's guard lives in
    tests/conftest.py)."""
    tasks0 = port_tasks.open_task_keys()
    threads0 = background_threads()
    yield
    leaked = port_tasks.open_task_keys() - tasks0
    assert not leaked, f"tasks left registered: {sorted(leaked)}"
    running = background_threads() - threads0
    assert not running, f"background threads left running: {running}"


def wait_until(cond, what, timeout=30.0):
    """Poll ``cond`` until it holds (a thread reached a point); fail
    after ``timeout`` seconds."""
    ev = threading.Event()
    for _ in range(int(timeout / 0.001)):
        if cond():
            return
        ev.wait(0.001)
    raise AssertionError(f"timed out waiting for {what}")


def masked(task: dict) -> dict:
    return {k: v for k, v in task.items() if k not in MASKED}


class Pair:
    """Both packages' nodes, each request sent to both."""

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

    def tasks(self, which, params=None):
        """Each node's listed tasks (group_by nodes), masked."""
        node = self.jax if which == "jax" else self.port
        st, r = node.rest_controller.dispatch("GET", "/_tasks",
                                              dict(params or {}), None)
        assert st == 200
        return sorted((masked(t) for t in
                       r["nodes"][node.node_id]["tasks"].values()),
                      key=lambda t: t["action"])


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def seed(pair, n=5):
    for i in range(n):
        pair.do("PUT", f"/idx/_doc/{i}", {"refresh": "true"}, {"n": i},
                expect=201)


# -------------------------------------- tests/test_async_search.py, tasks


def test_tasks_list_shape(pair):
    seed(pair)
    with pair.jax.task_manager.task_scope(
            "transport", "indices:data/read/search", cancellable=True), \
            pair.port.task_manager.task_scope(
                "transport", "indices:data/read/search", cancellable=True):
        want, got = pair.tasks("jax"), pair.tasks("port")
        assert got == want
        assert any(t["action"] == "indices:data/read/search"
                   and t["cancellable"] for t in got)
    assert pair.tasks("jax") == pair.tasks("port") == []


def test_tasks_actions_filter(pair):
    for node in (pair.jax, pair.port):
        with node.task_manager.task_scope("transport",
                                          "indices:data/read/search"), \
                node.task_manager.task_scope("transport",
                                             "cluster:monitor/stats"):
            st, r = node.rest_controller.dispatch(
                "GET", "/_tasks", {"actions": "indices:data/read/*"}, None)
            assert st == 200
            assert len(r["nodes"][node.node_id]["tasks"]) == 1


def test_get_and_cancel_task(pair):
    for node in (pair.jax, pair.port):
        d = node.rest_controller.dispatch
        task = node.task_manager.register(
            "transport", "indices:data/read/search", cancellable=True)
        tid = f"{node.node_id}:{task.id}"
        st, r = d("GET", f"/_tasks/{tid}", {}, None)
        assert st == 200 and r["completed"] is False
        assert r["task"]["action"] == "indices:data/read/search"
        st, r = d("POST", f"/_tasks/{tid}/_cancel", {}, None)
        assert st == 200 and task.is_cancelled()
        assert r["nodes"][node.node_id]["tasks"][tid]["cancelled"] is True
        node.task_manager.unregister(task)
        st, r = d("GET", f"/_tasks/{tid}", {}, None)
        assert st == 404
        assert r["error"]["type"] == "resource_not_found_exception"


def test_cancelled_search_returns_400(pair):
    seed(pair)
    jt = pair.jax.task_manager.register("transport", "test",
                                        cancellable=True)
    pt = pair.port.task_manager.register("transport", "test",
                                         cancellable=True)
    pair.jax.task_manager.cancel(jt, "test cancel")
    pair.port.task_manager.cancel(pt, "test cancel")
    with pytest.raises(JaxTaskCancelled) as want:
        pair.jax.search_service.search("idx", {}, task=jt)
    with pytest.raises(TaskCancelledException) as got:
        pair.port.search_service.search("idx", {}, task=pt)
    assert str(got.value) == str(want.value) \
        == "task cancelled [test cancel]"
    assert got.value.status == want.value.status == 400
    assert got.value.error_type == want.value.error_type() \
        == "task_cancelled_exception"
    pair.jax.task_manager.unregister(jt)
    pair.port.task_manager.unregister(pt)


def test_ban_propagates_to_children(pair):
    for node, tid_cls in ((pair.jax, JaxTaskId), (pair.port, TaskId)):
        tm = node.task_manager
        parent = tm.register("transport", "parent", cancellable=True)
        tm.cancel(parent, "stop")
        child = tm.register("transport", "child",
                            parent_task_id=tid_cls(node.node_id, parent.id),
                            cancellable=True)
        assert child.is_cancelled()
        assert child.cancellation_reason() == "parent banned [stop]"
        assert tm.ban_count() == 1
        tm.unregister(child)
        tm.unregister(parent)
        assert tm.ban_count() == 0


def test_malformed_task_id_is_400(pair):
    for method, path in (("GET", "/_tasks/foo"),
                         ("POST", "/_tasks/foo/_cancel")):
        (jst, j), (st, p) = pair.both(method, path)
        assert st == jst == 400
        assert p["error"]["type"] == j["error"]["type"] \
            == "illegal_argument_exception"
        assert p["error"]["reason"] == j["error"]["reason"] \
            == "malformed task id foo"


def test_foreign_node_task_id_404(pair):
    for node in (pair.jax, pair.port):
        task = node.task_manager.register("transport", "x",
                                          cancellable=True)
        st, r = node.rest_controller.dispatch(
            "POST", f"/_tasks/othernode:{task.id}/_cancel", {}, None)
        assert st == 404
        assert r["error"]["type"] == "resource_not_found_exception"
        assert not task.is_cancelled()
        node.task_manager.unregister(task)


def test_actions_filter_comma_and_exact(pair):
    for node in (pair.jax, pair.port):
        tm = node.task_manager
        with tm.task_scope("transport", "indices:data/read/search"), \
                tm.task_scope("transport", "cluster:monitor/stats"):
            assert len(tm.list_tasks(
                actions="indices:data/read/*,cluster:monitor/*")) == 2
            tasks = tm.list_tasks(actions="indices:data/read/search")
            assert [t.action for t in tasks] == ["indices:data/read/search"]


def test_node_scoped_ids_equal_the_reference():
    from elasticsearch_tpu.common.errors import \
        ResourceNotFoundException as JaxNotFound
    from elasticsearch_tpu.transport.tasks import (
        decode_node_scoped_id as jax_decode,
        encode_node_scoped_id as jax_encode)
    from elasticsearch_tpu_torch.common.errors import \
        ResourceNotFoundException
    for node_id, seq in (("node-0", 1), ("a:b", 12345), ("x" * 40, 0)):
        enc = port_tasks.encode_node_scoped_id(node_id, seq)
        assert enc == jax_encode(node_id, seq)
        got, want = port_tasks.decode_node_scoped_id(enc), jax_decode(enc)
        assert (got.node_id, got.id) == (want.node_id, want.id) \
            == (node_id, seq)
    for bad in ("", "!!", port_tasks.encode_node_scoped_id("", 3)):
        with pytest.raises(JaxNotFound):
            jax_decode(bad)
        with pytest.raises(ResourceNotFoundException):
            port_tasks.decode_node_scoped_id(bad)


# ----------------------------------------------------------- beyond them


def test_task_manager_under_contention():
    """64 threads (more than the cores) register, cancel and unregister
    tasks with a short switch interval: no task is lost or left, every
    count adds up and the bans go with their tasks."""
    import sys
    tm = port_tasks.TaskManager("stress")
    n_threads, per = 64, 50
    errors = []

    def worker(k):
        try:
            for i in range(per):
                with tm.task_scope("transport", f"a{k % 4}",
                                   cancellable=True) as t:
                    if i % 3 == 0:
                        tm.cancel(t, "stress")
                    assert tm.get_task(t.id) is t
        except BaseException as e:   # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    stats = tm.stats()
    assert stats["current"] == 0 and stats["bans"] == 0
    assert stats["started"] == stats["completed"] == n_threads * per
    assert stats["cancelled"] == n_threads * len(range(0, per, 3))
    assert 1 <= stats["peak_concurrent"] <= n_threads
    ids = {t.id for t in tm.list_tasks()}
    assert not ids and tm._seq == n_threads * per



@pytest.mark.parametrize("group_by", ["nodes", "parents", "none", "bogus"])
def test_group_by_and_detailed(pair, group_by):
    """A parent with two children, listed under each ``group_by``,
    detailed or not: the same shape on both nodes (ids masked)."""
    out = {}
    for name, node, tid_cls in (("jax", pair.jax, JaxTaskId),
                                ("port", pair.port, TaskId)):
        tm = node.task_manager
        parent = tm.register("transport", "indices:data/read/msearch",
                             description="requests[2]", cancellable=True)
        kids = [tm.register("transport", "indices:data/read/search",
                            description=f"indices[i{j}]",
                            parent_task_id=tid_cls(node.node_id, parent.id),
                            cancellable=True) for j in range(2)]
        answers = []
        for detailed in ("true", "false"):
            answers.append(node.rest_controller.dispatch(
                "GET", "/_tasks", {"group_by": group_by,
                                   "detailed": detailed}, None))
        for t in kids + [parent]:
            tm.unregister(t)
        out[name] = answers

    def shape(answer):
        st, r = answer
        if st != 200:
            return st, r["error"]["type"], r["error"]["reason"]
        if "nodes" in r:
            (info,) = r["nodes"].values()
            tasks = list(info["tasks"].values())
        else:
            tasks = list(r["tasks"].values())

        def walk(t):
            return {**masked(t), "children": [walk(c) for c in
                                              t.get("children", [])]}
        return st, sorted((walk(t) for t in tasks),
                          key=lambda t: (t["action"], t["description"]
                                         if "description" in t else ""))
    for got, want in zip(out["port"], out["jax"]):
        assert shape(got) == shape(want)
    if group_by == "parents":
        st, r = out["port"][0]
        (root,) = r["tasks"].values()
        assert len(root["children"]) == 2


def test_cat_tasks_hot_threads_and_node_stats(pair):
    tm = pair.port.task_manager
    with tm.task_scope("transport", "indices:data/read/search",
                       description="indices[idx]", cancellable=True) as t:
        t.enter_stage("launch")
        st, cat = pair.port.rest_controller.dispatch("GET", "/_cat/tasks",
                                                     {}, None)
        assert st == 200
        (row,) = cat["_cat"].splitlines()
        action, tid, parent, type_, start, name = row.split()
        assert (action, tid, parent, type_, name) == (
            "indices:data/read/search", f"node-0:{t.id}", "-", "transport",
            "node-0")
        st, hot = pair.port.rest_controller.dispatch(
            "GET", "/_nodes/hot_threads", {}, None)
        assert "occupancy by task 'indices:data/read/search'" in hot["_cat"]
        assert "stage launch" in hot["_cat"]
        st, stats = pair.port.rest_controller.dispatch(
            "GET", "/_nodes/stats", {}, None)
        assert stats["nodes"]["node-0"]["tasks"]["current"] == 1
    st, hot = pair.port.rest_controller.dispatch(
        "GET", "/_nodes/hot_threads", {}, None)
    assert "no running tasks" in hot["_cat"]
    (_, j), (_, p) = pair.both("GET", "/_nodes/hot_threads")
    assert "no running tasks" in j["_cat"]
    st, stats = pair.port.rest_controller.dispatch("GET", "/_nodes/stats",
                                                   {}, None)
    section = stats["nodes"]["node-0"]["tasks"]
    assert section["current"] == 0 and section["bans"] == 0
    assert section["started"] == section["completed"] >= 1


def test_search_route_registers_and_unregisters_its_task(pair):
    """A REST `_search` runs as an ``indices:data/read/search`` task with
    a stage and a trace while it runs, and none is left after it."""
    seed(pair)
    seen = []
    orig = pair.port.search_service.search

    def spy(*args, **kwargs):
        st, r = pair.port.rest_controller.dispatch(
            "GET", "/_tasks", {"detailed": "true"}, None)
        seen.extend(r["nodes"]["node-0"]["tasks"].values())
        return orig(*args, **kwargs)

    pair.port.search_service.search = spy
    try:
        st, r = pair.port.rest_controller.dispatch(
            "POST", "/idx/_search", {}, {"query": {"range": {"n": {
                "gte": 1}}}})
    finally:
        pair.port.search_service.search = orig
    assert st == 200 and r["hits"]["total"]["value"] == 4
    (task,) = seen
    assert task["action"] == "indices:data/read/search"
    assert task["description"] == "indices[idx]"
    assert task["cancellable"] is True and task["cancelled"] is False
    assert task["profile_stage"] == "parse" and task["trace.id"]
    assert pair.tasks("port") == []


# ------------------------------------------------ cancellation mid-scan


def three_segment_index(node, name="scan", n=300, seed_=7):
    """``name``: three segments of seeded text (a refresh after each
    third), one shard."""
    rng = np.random.default_rng(seed_)
    words = [f"w{i}" for i in range(40)]
    for part in range(3):
        lines = []
        for i in range(part * n // 3, (part + 1) * n // 3):
            text = " ".join(rng.choice(words, size=12))
            lines.append({"index": {"_index": name, "_id": str(i)}})
            lines.append({"t": text, "n": i})
        st, r = node.rest_controller.dispatch("POST", "/_bulk",
                                              {"refresh": "true"}, lines)
        assert st == 200 and not r["errors"]
    assert len(node.indices[name].engine.segments) == 3


# a dense body (min_score takes the dense executor): one BM25 scoring
# launch a segment
DENSE = {"query": {"match": {"t": "w1 w2 w3"}}, "min_score": 0.01,
         "size": 20}


def test_search_cancelled_mid_scan_launches_less_and_answers_400(
        tmp_path, monkeypatch):
    """A dense body over three segments launches one BM25 scoring a
    segment (L = 3). Cancelled after its first launch it raises
    TaskCancelledException before the next (fewer than L launches), the
    breaker holds only the resident bytes, and asked again it answers
    what the whole search answered; over REST the same cancel answers
    400."""
    node = Node(device="cpu", data_path=str(tmp_path / "d"))
    try:
        three_segment_index(node)
        calls = []
        cancel = [None]
        orig = port_queries.bm25_dense_scores_sorted

        def counting(*args, **kwargs):
            calls.append(1)
            out = orig(*args, **kwargs)
            if cancel[0] is not None and len(calls) == 1:
                cancel[0]()
            return out

        monkeypatch.setattr(port_queries, "bm25_dense_scores_sorted",
                            counting)
        whole = node.search_service.search("scan", DENSE)
        launches_whole = len(calls)
        assert launches_whole == 3
        tm = node.task_manager
        calls.clear()
        with tm.task_scope("transport", "indices:data/read/search",
                           cancellable=True) as task:
            cancel[0] = lambda: tm.cancel(task, "mid scan")
            with pytest.raises(TaskCancelledException) as err:
                node.search_service.search("scan", DENSE, task=task)
        assert str(err.value) == "task cancelled [mid scan]"
        assert 1 <= len(calls) < launches_whole
        br = node.breaker_service.get_breaker("hbm")
        assert br.used == node.device_cache.hbm_stats()["total_bytes"]
        cancel[0] = None
        calls.clear()
        again = node.search_service.search("scan", DENSE)
        assert len(calls) == launches_whole
        assert again["hits"] == whole["hits"]
        # over REST: the route's own task, cancelled after one launch
        cancel[0] = lambda: [tm.cancel(t, "mid scan") for t in
                             tm.list_tasks("indices:data/read/search")]
        calls.clear()
        st, r = node.rest_controller.dispatch("POST", "/scan/_search", {},
                                              dict(DENSE))
        assert st == 400, r
        assert r["error"]["type"] == "task_cancelled_exception"
        assert 1 <= len(calls) < launches_whole
        assert tm.list_tasks() == []
    finally:
        node.close()


def test_a_cancelled_search_over_rest_answers_400(tmp_path):
    """``POST /_tasks/{id}/_cancel`` while a `_search` runs: its answer is
    the 400 ``task_cancelled_exception``, and no task is left."""
    node = Node(device="cpu", data_path=str(tmp_path / "d"))
    try:
        three_segment_index(node)
        entered, release = threading.Event(), threading.Event()
        orig = port_queries.bm25_dense_scores_sorted

        def held(*args, **kwargs):
            entered.set()
            release.wait(30)
            return orig(*args, **kwargs)

        port_queries.bm25_dense_scores_sorted = held
        answer = {}

        def client():
            answer["r"] = node.rest_controller.dispatch(
                "POST", "/scan/_search", {}, dict(DENSE))

        th = threading.Thread(target=client)
        th.start()
        try:
            assert entered.wait(30)
            st, tasks = node.rest_controller.dispatch(
                "GET", "/_tasks", {"actions": "indices:data/read/search",
                                   "detailed": "true"}, None)
            (tid, t), = tasks["nodes"]["node-0"]["tasks"].items()
            assert t["profile_stage"].startswith("score")
            st, r = node.rest_controller.dispatch(
                "POST", f"/_tasks/{tid}/_cancel", {}, None)
            assert st == 200
        finally:
            release.set()
            th.join(30)
            port_queries.bm25_dense_scores_sorted = orig
        assert not th.is_alive()
        st, r = answer["r"]
        assert st == 400
        assert r["error"]["type"] == "task_cancelled_exception"
        assert node.task_manager.list_tasks() == []
        assert node.task_manager.stats()["cancelled"] == 1
    finally:
        node.close()


def test_a_cancel_inside_the_mesh_is_the_answer_not_a_fallback(
        tmp_path, monkeypatch):
    """A body of 2 shards on a grid of 2 devices runs on the mesh; its
    task cancelled inside the mesh's launch answers the cancellation:
    no ``fallback.error`` and no run of the per-shard loop."""
    monkeypatch.setenv("ESTPU_MESH_SERVING", "1")
    node = Node(device="cpu", devices=["cpu"] * 2,
                data_path=str(tmp_path / "mesh"))
    try:
        st, _ = node.rest_controller.dispatch("PUT", "/m", {}, {
            "settings": {"index": {"number_of_shards": 2}},
            "mappings": {"properties": {"t": {"type": "text"}}}})
        assert st == 200
        rng = np.random.default_rng(9)
        lines = []
        for i in range(200):
            lines += [{"index": {"_index": "m", "_id": str(i)}},
                      {"t": " ".join(rng.choice(["a", "b", "c", "d"],
                                                size=6))}]
        node.rest_controller.dispatch("POST", "/_bulk",
                                      {"refresh": "true"}, lines)
        svc = node.search_service
        body = {"query": {"match": {"t": "a b"}}, "size": 5}
        d0 = svc.mesh_executor.stats()["counters"]
        svc.search("m", body)
        d1 = svc.mesh_executor.stats()["counters"]
        assert d1.get("dispatch.shard", 0) > d0.get("dispatch.shard", 0), \
            (d0, d1)
        tm = node.task_manager
        orig = svc.mesh_executor.execute
        with tm.task_scope("transport", "indices:data/read/search",
                           cancellable=True) as task:
            def cancelling(*args, **kwargs):
                tm.cancel(task, "in the mesh")
                return orig(*args, **kwargs)
            svc.mesh_executor.execute = cancelling
            loop = []
            monkeypatch.setattr(svc, "_query_shards",
                                lambda *a, **k: loop.append(1))
            with pytest.raises(TaskCancelledException):
                svc.search("m", body, task=task)
        d2 = svc.mesh_executor.stats()["counters"]
        assert d2.get("fallback.error", 0) == d1.get("fallback.error", 0)
        assert loop == []
    finally:
        node.close()


# ------------------------------------------- a cancel inside a cohort


def cohort_node(tmp_path):
    """A node with one one-segment index of seeded text, and single-term
    bodies that share one plan cohort signature."""
    node = Node(device="cpu", data_path=str(tmp_path / "c"))
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(30)]
    lines = []
    for i in range(400):
        lines.append({"index": {"_index": "co", "_id": str(i)}})
        lines.append({"t": " ".join(rng.choice(words, size=10))})
    st, r = node.rest_controller.dispatch("POST", "/_bulk",
                                          {"refresh": "true"}, lines)
    assert st == 200 and not r["errors"]
    bodies = [{"query": {"match": {"t": f"w{i}"}}, "size": 10}
              for i in range(5)]
    return node, bodies


@pytest.mark.parametrize("victim", ["follower", "leader"])
def test_a_body_cancelled_inside_a_plan_cohort(tmp_path, victim):
    """Five plan bodies queue for one cohort (the batcher's launch slots
    held); one of them is cancelled while it waits. It answers
    TaskCancelledException; the cohort launches once for the other four,
    each answering as it answers alone; the batcher counts the member
    that left; the breaker holds only the resident bytes."""
    node, bodies = cohort_node(tmp_path)
    try:
        svc = node.search_service
        solo = [svc.search("co", b) for b in bodies]
        batcher = svc.plan_batcher
        launches0 = batcher.launches
        held = []
        for _ in range(batching.MAX_CONCURRENT):
            batcher._launch_slots.acquire()
            held.append(1)
        tm = node.task_manager
        tasks = [tm.register("transport", "indices:data/read/search",
                             cancellable=True) for _ in bodies]
        out = [None] * len(bodies)

        def run(i):
            try:
                out[i] = svc.search("co", bodies[i], task=tasks[i])
            except TaskCancelledException as e:
                out[i] = e

        def queued():
            with batcher._lock:
                return sum(len(q) for q in batcher._pending.values())

        threads = [threading.Thread(target=run, args=(0,))]
        threads[0].start()
        wait_until(lambda: queued() == 1, "the leader's entry")
        for i in range(1, len(bodies)):
            threads.append(threading.Thread(target=run, args=(i,)))
            threads[-1].start()
        wait_until(lambda: queued() == len(bodies), "every member queued")
        victim_i = 0 if victim == "leader" else 2
        tm.cancel(tasks[victim_i], "in the cohort")
        if victim == "follower":
            wait_until(lambda: queued() == len(bodies) - 1,
                       "the cancelled follower left the queue")
        for _ in held:
            batcher._launch_slots.release()
        for th in threads:
            th.join(30)
            assert not th.is_alive()
        for t in tasks:
            tm.unregister(t)
        assert isinstance(out[victim_i], TaskCancelledException)
        for i, r in enumerate(out):
            if i != victim_i:
                assert r["hits"] == solo[i]["hits"], i
        assert batcher.launches - launches0 == 1
        assert batcher.cancelled_queued == 1
        assert batcher.stats()["cancelled_queued"] == 1
        br = node.breaker_service.get_breaker("hbm")
        assert br.used == node.device_cache.hbm_stats()["total_bytes"]
    finally:
        node.close()


def test_a_member_cancelled_while_its_cohort_launches_is_dropped(tmp_path):
    """A follower cancelled after its cohort popped it: the launch runs,
    its row is not unpacked (``abandoned``), and it answers 400."""
    node, bodies = cohort_node(tmp_path)
    try:
        svc = node.search_service
        batcher = svc.plan_batcher
        in_launch, go = threading.Event(), threading.Event()
        orig_run = batching.PlanBatcher._run

        def slow_run(self, batch, *args):
            in_launch.set()
            go.wait(30)
            return orig_run(self, batch, *args)

        tm = node.task_manager
        tasks = [tm.register("transport", "s", cancellable=True)
                 for _ in bodies[:2]]
        out = [None, None]
        held = [batcher._launch_slots.acquire()
                for _ in range(batching.MAX_CONCURRENT)]

        def run(i):
            try:
                out[i] = svc.search("co", bodies[i], task=tasks[i])
            except TaskCancelledException as e:
                out[i] = e

        def queued():
            with batcher._lock:
                return sum(len(q) for q in batcher._pending.values())

        batching.PlanBatcher._run = slow_run
        try:
            t0 = threading.Thread(target=run, args=(0,))
            t0.start()
            wait_until(lambda: queued() == 1, "the leader")
            t1 = threading.Thread(target=run, args=(1,))
            t1.start()
            wait_until(lambda: queued() == 2, "the follower")
            for _ in held:
                batcher._launch_slots.release()
            assert in_launch.wait(30)
            tm.cancel(tasks[1], "late")
            wait_until(lambda: batcher.cancelled_in_flight == 1,
                       "the follower abandoned its row")
            go.set()
            t0.join(30)
            t1.join(30)
            assert not t0.is_alive() and not t1.is_alive()
        finally:
            batching.PlanBatcher._run = orig_run
            go.set()
        for t in tasks:
            tm.unregister(t)
        assert isinstance(out[1], TaskCancelledException)
        assert out[0]["hits"] == svc.search("co", bodies[0])["hits"]
    finally:
        node.close()


# ----------------------------------------------- _msearch's parent cancel


def test_msearch_parent_cancel_kills_queued_children(tmp_path):
    """An `_msearch` of 6 on a one-thread search pool: the second child
    is held; the parent is cancelled through `_tasks`. The first child
    answered as its body alone; the held one (running) and the four not
    started (banned on arrival) answer 400 ``task_cancelled_exception``;
    the ban dies with the parent."""
    from elasticsearch_tpu_torch.common.threadpool import TaskTrackingPool
    node = Node(device="cpu", data_path=str(tmp_path / "m"))
    node.threadpool.pools["search"].shutdown()
    node.threadpool.pools["search"] = TaskTrackingPool("search", 1)
    try:
        three_segment_index(node)
        bodies = [{"query": {"term": {"t": f"w{i}"}}, "size": 5,
                  "_source": False} for i in range(6)]
        alone = [node.search_service.search("scan", b) for b in bodies]
        entered, release = threading.Event(), threading.Event()
        orig = node.search_service.search
        calls = []

        def held(*args, **kwargs):
            calls.append(1)
            if len(calls) == 2:
                entered.set()
                release.wait(30)
            return orig(*args, **kwargs)

        node.search_service.search = held
        lines = []
        for b in bodies:
            lines += [{"index": "scan"}, b]
        answer = {}
        th = threading.Thread(target=lambda: answer.setdefault(
            "r", node.rest_controller.dispatch("POST", "/_msearch", {},
                                               lines)))
        th.start()
        try:
            assert entered.wait(30)
            st, r = node.rest_controller.dispatch(
                "GET", "/_tasks", {"actions": "indices:data/read/msearch",
                                   "detailed": "true"}, None)
            (pid, parent), = r["nodes"]["node-0"]["tasks"].items()
            assert parent["description"] == "requests[6]"
            st, r = node.rest_controller.dispatch(
                "GET", "/_tasks", {"parent_task_id": pid}, None)
            assert len(r["nodes"]["node-0"]["tasks"]) == 1
            st, _ = node.rest_controller.dispatch(
                "POST", f"/_tasks/{pid}/_cancel", {}, None)
            assert st == 200
        finally:
            release.set()
            th.join(30)
            node.search_service.search = orig
        assert not th.is_alive()
        st, r = answer["r"]
        assert st == 200
        slots = r["responses"]
        assert slots[0]["hits"] == alone[0]["hits"]
        for s in slots[1:]:
            assert s["status"] == 400
            assert s["error"]["type"] == "task_cancelled_exception"
        killed_by_ban = sum("parent banned" in s["error"]["reason"]
                            for s in slots[1:])
        assert killed_by_ban == 4
        assert len(calls) == 2          # the banned never searched
        assert node.task_manager.list_tasks() == []
        assert node.task_manager.ban_count() == 0
    finally:
        node.close()


def test_node_close_cancels_and_joins_background_work(tmp_path):
    """A background reindex held in its scroll and an async search held
    in its search: ``close`` cancels both tasks and joins both threads."""
    node = Node(device="cpu", data_path=str(tmp_path / "n"))
    three_segment_index(node)
    entered, release = threading.Event(), threading.Event()
    orig = node.search_service.search

    def held(*args, **kwargs):
        entered.set()
        release.wait(30)
        return orig(*args, **kwargs)

    node.search_service.search = held
    st, r = node.rest_controller.dispatch(
        "POST", "/_reindex", {"wait_for_completion": "false"},
        {"source": {"index": "scan"}, "dest": {"index": "copy"}})
    assert st == 200 and "task" in r
    assert entered.wait(30)
    st, a = node.rest_controller.dispatch(
        "POST", "/scan/_async_search", {"wait_for_completion_timeout": "0ms"},
        {"query": {"match_all": {}}})
    assert st == 200 and a["is_running"] is True
    assert node.background_threads() == 2
    closer = threading.Thread(target=node.close)
    closer.start()
    wait_until(lambda: all(t.is_cancelled()
                           for t in node.task_manager.list_tasks()),
               "every task cancelled")
    release.set()
    closer.join(60)
    assert not closer.is_alive()
    assert node.background_threads() == 0
    assert node.task_manager.list_tasks() == []
