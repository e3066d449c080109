"""The slow logs, background task results across a restart, `_cat` and
`_stats` against the reference, on the CPU.

The reference's tests/test_operational.py cases run on both packages'
nodes: ``test_search_slowlog``, ``test_indexing_slowlog``,
``test_task_results_survive_restart`` and the single-node `_cat` rows
its ``test_cat_family`` reads (``_cat/segments``), beside the other
`_cat` routes of the slice (indices, count, shards, aliases, templates)
and ``GET /_stats``. Each `_cat` text compares row by row, with the
fields that differ between the packages by construction masked: the
epoch of ``_cat/count``, the node name of ``_cat/shards`` and the
segment names of ``_cat/segments`` (each engine names its own).
``GET /_stats`` compares the document counts (each package's index
stats carry their own engine sections). Beyond them: a slow-log entry's
``slowest_stage`` and flight summary, a `0ms` threshold over a burst of
plan, dense and fast bodies, the ``-1`` and level order of the indexing
slow log, and a restarted node numbering its tasks past the stored
results. Every test runs under the leak guard of test_torch_tasks.py.
"""

import json

import pytest

from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.transport import tasks as port_tasks
from test_torch_tasks import Pair, background_threads


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


def seed(pair, name="idx", n=3):
    pair.do("PUT", f"/{name}", body={"mappings": {"properties": {
        "v": {"type": "long"}, "t": {"type": "text"}}}})
    for i in range(n):
        pair.do("PUT", f"/{name}/_doc/{i}", None,
                {"v": i, "t": f"value {i} of the {name} index"}, expect=201)
    pair.do("POST", f"/{name}/_refresh")


def settings_update(pair, name, updates):
    pair.do("PUT", f"/{name}/_settings", body=updates)


# -------------------------------------- tests/test_operational.py cases


def test_search_slowlog(pair):
    seed(pair)
    settings_update(pair, "idx",
                    {"index.search.slowlog.threshold.query.warn": "0ms"})
    pair.do("POST", "/idx/_search", body={"size": 1})
    for node in (pair.jax, pair.port):
        recent = node.search_service.slowlog_recent
        assert recent
        assert recent[-1]["index"] == "idx"
        assert recent[-1]["level"] == "warn"
        assert json.loads(recent[-1]["source"]) == {"size": 1}
        recent.clear()
    settings_update(pair, "idx",
                    {"index.search.slowlog.threshold.query.warn": "-1"})
    pair.do("POST", "/idx/_search", body={"size": 1})
    assert not pair.jax.search_service.slowlog_recent
    assert not pair.port.search_service.slowlog_recent


def test_indexing_slowlog(pair):
    seed(pair, "slow")
    settings_update(pair, "slow",
                    {"index.indexing.slowlog.threshold.index.warn": "0ms"})
    pair.do("PUT", "/slow/_doc/x", None, {"v": 1}, expect=201)
    for svc in (pair.jax.indices_service.get("slow"),
                pair.port.indices["slow"]):
        assert svc.indexing_slowlog_recent
        entry = svc.indexing_slowlog_recent[-1]
        assert (entry["index"], entry["id"], entry["level"]) == (
            "slow", "x", "warn")


def test_task_results_survive_restart(tmp_path):
    """A background `_reindex`'s result persists in the .tasks index and
    resolves through ``GET /_tasks/{id}`` after a restart, by its full
    id and by its bare number, on both packages."""
    from elasticsearch_tpu.node import Node as JaxNode
    out = {}
    for name, make in (("jax", lambda p: JaxNode(data_path=p)),
                       ("port", lambda p: Node(device="cpu",
                                               data_path=p))):
        path = str(tmp_path / name)
        node = make(path)
        try:
            d = node.rest_controller.dispatch
            d("PUT", "/src", None, {"mappings": {"properties": {
                "x": {"type": "long"}}}})
            for i in range(5):
                d("PUT", f"/src/_doc/{i}", None, {"x": i})
            d("POST", "/src/_refresh", None, None)
            st, r = d("POST", "/_reindex", {"wait_for_completion": "false"},
                      {"source": {"index": "src"}, "dest": {"index": "dst"}})
            assert st == 200
            task_id = r["task"]
            st, r = d("GET", f"/_tasks/{task_id}",
                      {"wait_for_completion": "true"}, None)
            assert st == 200 and r["completed"]
            assert r["response"]["total"] == 5
        finally:
            node.close()
        node2 = make(path)
        try:
            d = node2.rest_controller.dispatch
            bare = task_id.split(":", 1)[1]
            st, r = d("GET", f"/_tasks/{bare}", None, None)
            assert st == 200 and r["completed"], r
            out[name] = r["response"]
            if name == "port":
                # the same node id after a restart: the full id resolves,
                # and a new task is numbered past the stored one
                st, r2 = d("GET", f"/_tasks/{task_id}", None, None)
                assert st == 200 and r2["response"] == r["response"]
                assert node2.task_manager._seq >= int(bare)
                with node2.task_manager.task_scope("transport", "x") as t:
                    assert t.id > int(bare)
        finally:
            node2.close()
    keys = ("total", "created", "updated", "deleted", "batches", "noops",
            "version_conflicts", "failures")
    assert {k: out["port"][k] for k in keys} == \
        {k: out["jax"][k] for k in keys}


def test_cat_family_single_node_rows(pair):
    """``_cat/segments`` (the reference's test_cat_family row) and the
    slice's other `_cat` routes, row by row."""
    seed(pair, "idx", 4)
    seed(pair, "other", 2)
    pair.do("DELETE", "/idx/_doc/1", {"refresh": "true"})
    pair.do("POST", "/_aliases", body={"actions": [
        {"add": {"index": "idx", "alias": "al"}},
        {"add": {"index": "other", "alias": "al"}}]})
    pair.do("PUT", "/_index_template/tpl", body={
        "index_patterns": ["logs-*", "metrics-*"], "priority": 7,
        "template": {"settings": {"index.number_of_shards": 1}}})

    def rows(path, mask=()):
        j, p = pair.do("GET", path)
        out = []
        for text in (j["_cat"], p["_cat"]):
            out.append([[("*" if i in mask else f) for i, f in
                         enumerate(line.split())]
                        for line in text.splitlines()])
        assert out[1] == out[0], (path, p["_cat"], j["_cat"])
        return out[1]

    assert rows("/_cat/indices") == [
        ["green", "open", "idx", "1", "0", "3", "1"],
        ["green", "open", "other", "1", "0", "2", "0"]]
    assert rows("/_cat/count", mask=(0,)) == [["*", "5"]]
    assert rows("/_cat/shards", mask=(5,)) == [
        ["idx", "0", "p", "STARTED", "3", "*"],
        ["other", "0", "p", "STARTED", "2", "*"]]
    assert rows("/_cat/aliases") == [
        ["al", "idx", "-", "-", "-", "-"],
        ["al", "other", "-", "-", "-", "-"]]
    assert rows("/_cat/templates") == [["tpl", "[logs-*,metrics-*]", "7"]]
    segs = rows("/_cat/segments", mask=(4,))
    assert [r[0] for r in segs] == ["idx"] * (len(segs) - 1) + ["other"]
    assert "idx" in pair.port.rest_controller.dispatch(
        "GET", "/_cat/segments", {}, None)[1]["_cat"]


def test_stats_counts(pair):
    seed(pair, "idx", 4)
    seed(pair, "other", 2)
    j, p = pair.do("GET", "/_stats")
    assert p["_all"] == j["_all"] == {"primaries": {"docs": {"count": 6}}}
    assert set(p["indices"]) == set(j["indices"]) == {"idx", "other"}
    for name in p["indices"]:
        assert p["indices"][name]["docs"] == j["indices"][name]["docs"]


# ------------------------------------------------------------ beyond them


def test_every_search_of_a_burst_lands_with_its_slowest_stage(tmp_path):
    """With a 0ms threshold, each search of a burst (a fast-grammar
    match, a plan bool, a dense range and a profiled body) lands in the
    slow log with its ``slowest_stage`` (the profile's for the profiled
    body, the task timeline's for the rest), its trace id and its flight
    summary."""
    node = Node(device="cpu", data_path=str(tmp_path / "n"))
    try:
        d = node.rest_controller.dispatch
        lines = []
        for i in range(50):
            lines += [{"index": {"_index": "b", "_id": str(i)}},
                      {"t": f"alpha beta {i % 7} gamma", "v": i}]
        d("POST", "/_bulk", {"refresh": "true"}, lines)
        d("PUT", "/b/_settings", None,
          {"index.search.slowlog.threshold.query.warn": "0ms"})
        bodies = [{"query": {"match": {"t": "alpha"}}},
                  {"query": {"bool": {"should": [{"match": {"t": "beta"}}],
                                      "filter": [{"range": {"v": {
                                          "gte": 10}}}]}}},
                  {"query": {"range": {"v": {"lt": 20}}},
                   "sort": [{"v": "desc"}]},
                  {"query": {"match": {"t": "gamma"}}, "profile": True,
                   "min_score": 0.0}]
        recent = node.search_service.slowlog_recent
        recent.clear()
        for b in bodies:
            st, _ = d("POST", "/b/_search", {}, b)
            assert st == 200
        assert len(recent) == len(bodies)
        for entry, body in zip(recent, bodies):
            assert entry["index"] == "b" and entry["level"] == "warn"
            assert json.loads(entry["source"]) == body
            stage, ms, where = entry["slowest_stage"].split()
            assert ms.endswith("ms") and float(ms[:-2]) >= 0
            assert where == ("[b][0]" if body.get("profile") else "task")
            # the request's trace, which the tracer's ring resolves
            st, trace = d("GET", f"/_traces/{entry['trace.id']}")
            assert st == 200 and trace["spans"][0]["name"] == "rest.search"
            assert entry["regime"] in ("fast", "degraded")
            assert entry["readbacks"] >= 0
    finally:
        node.close()


def test_indexing_slowlog_levels_and_disable(tmp_path):
    node = Node(device="cpu", data_path=str(tmp_path / "n"))
    try:
        svc = node.create_index("s")
        svc.update_settings({
            "index.indexing.slowlog.threshold.index.warn": "1h",
            "index.indexing.slowlog.threshold.index.info": "0ms"})
        svc.index_doc("a", {"v": 1})
        assert [(e["id"], e["level"]) for e in
                svc.indexing_slowlog_recent] == [("a", "info")]
        svc.update_settings({
            "index.indexing.slowlog.threshold.index.info": "-1"})
        svc.index_doc("b", {"v": 2})
        assert len(svc.indexing_slowlog_recent) == 1
    finally:
        node.close()
