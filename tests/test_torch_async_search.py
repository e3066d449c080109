"""`_async_search` against the reference, on the CPU.

The reference's tests/test_async_search.py async cases run on both
packages' nodes over the same seeded documents: statuses, ``is_running``
and ``is_partial``, the error types and the answers' hits equal, with
the fields that differ by construction masked: the search ``id``, the
epochs (``start_time_in_millis``, ``expiration_time_in_millis``,
``completion_time_in_millis``) and ``took``; and the reference's
``search.class`` stamp (the port's workload telemetry is a later
slice). A running search is held by a ``threading.Event`` in the node's
search service (both packages' `_search` reach it for these bodies),
and keep-alive expiry is driven by each service's injected clock, so no
test waits on the wall clock.
Beyond the reference's cases: the 0 wait of the chip's phase 19, an
async plan-path body equal to its `_search`, the ``keep_alive`` renewal
and the submit task's listing. Every test runs under the leak guard of
test_torch_tasks.py (tasks and background threads).
"""

import threading

import numpy as np
import pytest

from elasticsearch_tpu_torch.transport import tasks as port_tasks
from test_torch_tasks import Pair, background_threads

# the answer fields that differ between the packages by construction
MASKED = ("id", "start_time_in_millis", "expiration_time_in_millis",
          "completion_time_in_millis",
          # the reference's workload stamp, which waits for the port's
          # telemetry of it
          "search.class")


@pytest.fixture(autouse=True)
def _leak_guard():
    """Fail a test that leaves a port task registered or a node's
    background thread running."""
    tasks0 = port_tasks.open_task_keys()
    threads0 = background_threads()
    yield
    leaked = port_tasks.open_task_keys() - tasks0
    assert not leaked, f"tasks left registered: {sorted(leaked)}"
    running = background_threads() - threads0
    assert not running, f"background threads left running: {running}"


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def seed(pair, n=5):
    for i in range(n):
        pair.do("PUT", f"/idx/_doc/{i}", {"refresh": "true"},
                {"n": i, "t": f"doc number {i} of {n}"}, expect=201)


def masked(r: dict) -> dict:
    out = {k: v for k, v in r.items() if k not in MASKED}
    if isinstance(out.get("response"), dict):
        out["response"] = {k: v for k, v in out["response"].items()
                           if k != "took"}
    return out


class Held:
    """Hold each node's search service at its next searches until
    ``release``: the async search stays running, deterministically."""

    def __init__(self, pair):
        self.pair = pair
        self.release = threading.Event()
        self.started = {"jax": threading.Event(),
                        "port": threading.Event()}
        self.orig = {}
        for name, node in (("jax", pair.jax), ("port", pair.port)):
            orig = node.search_service.search
            self.orig[name] = orig

            def slow(*args, _orig=orig, _name=name, **kwargs):
                self.started[_name].set()
                self.release.wait(30)
                task = kwargs.get("task")
                if task is not None:
                    task.ensure_not_cancelled()
                return _orig(*args, **kwargs)
            node.search_service.search = slow

    def restore(self):
        self.release.set()
        self.pair.jax.search_service.search = self.orig["jax"]
        self.pair.port.search_service.search = self.orig["port"]


class FakeClock:
    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


def done_search(node, sid):
    """The async entry of ``sid`` (both services keep ``_searches``)."""
    return node.async_search_service._searches[sid]


# ------------------------------------ tests/test_async_search.py, async


def test_async_search_fast_completes_inline(pair):
    seed(pair)
    j, p = pair.do("POST", "/idx/_async_search",
                   {"wait_for_completion_timeout": "5s"},
                   {"query": {"match_all": {}}})
    assert p["is_running"] is False and p["is_partial"] is False
    assert p["response"]["hits"]["total"]["value"] == 5
    assert masked(p) == masked(j)


def test_async_search_poll_and_delete(pair):
    seed(pair)
    held = Held(pair)
    try:
        j, p = pair.do("POST", "/idx/_async_search",
                       {"wait_for_completion_timeout": "0ms"}, {})
        for r in (j, p):
            assert r["is_running"] is True and r["is_partial"] is True
        assert masked(p) == masked(j)
        ids = {"jax": j["id"], "port": p["id"]}
        for name, node in (("jax", pair.jax), ("port", pair.port)):
            st, r = node.rest_controller.dispatch(
                "GET", f"/_async_search/{ids[name]}", {}, None)
            assert st == 200 and r["is_running"] is True
        held.release.set()
        out = {}
        for name, node in (("jax", pair.jax), ("port", pair.port)):
            st, r = node.rest_controller.dispatch(
                "GET", f"/_async_search/{ids[name]}",
                {"wait_for_completion_timeout": "30s"}, None)
            assert st == 200 and r["is_running"] is False
            assert r["response"]["hits"]["total"]["value"] == 5
            out[name] = r
            st, _ = node.rest_controller.dispatch(
                "DELETE", f"/_async_search/{ids[name]}", {}, None)
            assert st == 200
            st, r = node.rest_controller.dispatch(
                "GET", f"/_async_search/{ids[name]}", {}, None)
            assert st == 404
            assert r["error"]["type"] == "resource_not_found_exception"
        assert masked(out["port"]) == masked(out["jax"])
    finally:
        held.restore()


def test_async_search_delete_cancels_running(pair):
    seed(pair)
    held = Held(pair)
    try:
        for name, node in (("jax", pair.jax), ("port", pair.port)):
            st, r = node.rest_controller.dispatch(
                "POST", "/idx/_async_search",
                {"wait_for_completion_timeout": "0ms"}, {})
            sid = r["id"]
            assert held.started[name].wait(30)
            search = done_search(node, sid)
            st, _ = node.rest_controller.dispatch(
                "DELETE", f"/_async_search/{sid}", {}, None)
            assert st == 200
            assert search.task.is_cancelled()
            st, _ = node.rest_controller.dispatch(
                "GET", f"/_async_search/{sid}", {}, None)
            assert st == 404
            held.release.set()
            assert search.done.wait(30)
            assert search.error["type"] == "task_cancelled_exception"
            assert search.error_status == 400
            held.release.clear()
    finally:
        held.restore()


def test_async_search_error_reported(pair):
    j, p = pair.do("POST", "/missing_index/_async_search",
                   {"wait_for_completion_timeout": "5s"}, {}, expect=404)
    for r in (j, p):
        assert r["is_partial"] is True
        assert r["error"]["type"] == "index_not_found_exception"
    assert p["error"]["reason"] == j["error"]["reason"]


def test_expired_async_search_cancelled_on_reap(pair):
    seed(pair)
    held = Held(pair)
    try:
        for name, node in (("jax", pair.jax), ("port", pair.port)):
            clock = FakeClock()
            node.async_search_service.clock = clock
            st, r = node.rest_controller.dispatch(
                "POST", "/idx/_async_search",
                {"wait_for_completion_timeout": "0ms",
                 "keep_alive": "50ms"}, {})
            sid = r["id"]
            search = done_search(node, sid)
            clock.t += 0.2
            st, r = node.rest_controller.dispatch(
                "GET", f"/_async_search/{sid}", {}, None)   # reaps
            assert st == 404
            assert search.task.is_cancelled()
            held.release.set()
            assert search.done.wait(30)
            held.release.clear()
            assert all(t.action != "indices:data/read/async_search/submit"
                       for t in node.task_manager.list_tasks())
    finally:
        held.restore()


def test_completion_time_stable(pair):
    seed(pair)
    for node in (pair.jax, pair.port):
        clock = FakeClock()
        node.async_search_service.clock = clock
        st, r = node.rest_controller.dispatch(
            "POST", "/idx/_async_search",
            {"wait_for_completion_timeout": "5s"}, {})
        assert st == 200 and r["is_running"] is False
        t1 = r["completion_time_in_millis"]
        clock.t += 3.0
        st, r2 = node.rest_controller.dispatch(
            "GET", f"/_async_search/{r['id']}", {}, None)
        assert r2["completion_time_in_millis"] == t1


def test_async_search_unknown_id_404(pair):
    (jst, j), (st, p) = pair.both("GET", "/_async_search/bogus")
    assert st == jst == 404
    assert p["error"]["type"] == j["error"]["type"] \
        == "resource_not_found_exception"
    (jst, j), (st, p) = pair.both("DELETE", "/_async_search/bogus")
    assert st == jst == 404


# ------------------------------------------------------------ beyond them


@pytest.mark.parametrize("body", [
    {"query": {"match": {"t": "doc number"}}, "size": 3},
    {"query": {"bool": {"must": [{"match": {"t": "number"}}],
                        "filter": [{"range": {"n": {"gte": 2}}}]}}},
    {"query": {"match_all": {}}, "sort": [{"n": "desc"}], "size": 2},
    {"query": {"match": {"t": "doc"}}, "min_score": 0.0, "size": 4},
])
def test_zero_wait_polled_to_the_end_equals_search(pair, body):
    """Phase 19 (c)'s protocol: a 0 wait, then polls to the end; the
    answer equals the body's synchronous `_search` on the port and the
    reference's async answer (scores rtol 1e-6)."""
    seed(pair, 12)
    held = Held(pair)
    try:
        j, p = pair.do("POST", "/idx/_async_search",
                       {"wait_for_completion_timeout": "0ms"}, body)
        assert p["is_running"] is True
        held.release.set()
        st, done = pair.port.rest_controller.dispatch(
            "GET", f"/_async_search/{p['id']}",
            {"wait_for_completion_timeout": "30s"}, None)
        st, ref = pair.jax.rest_controller.dispatch(
            "GET", f"/_async_search/{j['id']}",
            {"wait_for_completion_timeout": "30s"}, None)
    finally:
        held.restore()
    assert done["is_running"] is False and done["is_partial"] is False
    st, sync = pair.port.rest_controller.dispatch("POST", "/idx/_search",
                                                  {}, dict(body))
    got, want = done["response"]["hits"], sync["hits"]
    assert got == want
    rh = ref["response"]["hits"]
    assert got["total"] == rh["total"]
    assert [h["_id"] for h in got["hits"]] == [h["_id"] for h in rh["hits"]]
    np.testing.assert_allclose(
        [h["_score"] or 0.0 for h in got["hits"]],
        [h["_score"] or 0.0 for h in rh["hits"]], rtol=1e-6)


def test_keep_alive_renewal_and_the_submit_task(pair):
    """A GET with ``keep_alive`` moves the expiry on both nodes; while it
    runs, the submit task is listed (cancellable), and it is gone after."""
    seed(pair)
    held = Held(pair)
    try:
        for node in (pair.jax, pair.port):
            clock = FakeClock()
            node.async_search_service.clock = clock
            st, r = node.rest_controller.dispatch(
                "POST", "/idx/_async_search",
                {"wait_for_completion_timeout": "0ms", "keep_alive": "1s"},
                {})
            sid = r["id"]
            assert r["expiration_time_in_millis"] == int(
                (clock.t + 1.0) * 1000)
            st, r = node.rest_controller.dispatch(
                "GET", f"/_async_search/{sid}", {"keep_alive": "10s"}, None)
            assert r["expiration_time_in_millis"] == int(
                (clock.t + 10.0) * 1000)
            clock.t += 5.0
            st, r = node.rest_controller.dispatch(
                "GET", "/_tasks", {"actions":
                                   "indices:data/read/async_search/*"},
                None)
            (task,), = [list(v["tasks"].values())
                        for v in r["nodes"].values()]
            assert task["cancellable"] is True
            st, r = node.rest_controller.dispatch(
                "GET", f"/_async_search/{sid}", {}, None)
            assert st == 200 and r["is_running"] is True
            search = done_search(node, sid)
            held.release.set()
            assert search.done.wait(30)
            held.release.clear()
            assert node.task_manager.list_tasks(
                actions="indices:data/read/async_search/*") == []
    finally:
        held.restore()
