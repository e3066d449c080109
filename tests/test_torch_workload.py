"""Workload-class accounting of the port against the reference's:
request-shape classification, the class's carry across a thread hop and
its wire header, and the single-node REST surface (``_workload/stats``:
search classified interactive or aggs, a scroll open in ``scroll``, a
``_bulk`` charging the ``bulk`` class, an async search in ``async``,
the ``X-Workload-Class`` header beating classification, the
``_cat/workload`` render, and the slowlog's ``search.class``).

Unit cases run on both packages (``pkg``). REST cases send the same
requests to the reference's node and the port's (``device="cpu"``) and
compare ``/_workload/stats`` with the timing fields masked (latency
sums, bucket quantiles and SLO counts, launch ms) and cohort slots
(test_torch_tenants.py ``test_fast_path_bodies_charge_no_cohort_slot``).
"""

import importlib
import json

import pytest

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node

PACKAGES = ("elasticsearch_tpu", "elasticsearch_tpu_torch")


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return (importlib.import_module(f"{request.param}.telemetry.context"),
            importlib.import_module(f"{request.param}.telemetry.workload"))


def test_classify_search_request_shapes(pkg):
    _, w = pkg
    classify = w.classify_search_request
    assert classify({"query": {"match": {"b": "x"}}}) == w.CLASS_INTERACTIVE
    assert classify({"query": {"bool": {"must": []}}}) == \
        w.CLASS_INTERACTIVE
    assert classify({"knn": {"field": "v", "query_vector": [1.0]}}) == \
        w.CLASS_INTERACTIVE
    assert classify({"aggs": {"a": {"terms": {"field": "c"}}}}) == \
        w.CLASS_AGGS
    assert classify({"aggregations": {"a": {"avg": {"field": "p"}}}}) == \
        w.CLASS_AGGS
    assert classify({}, scroll=60.0) == w.CLASS_SCROLL
    assert classify({"pit": {"id": "x"}}) == w.CLASS_SCROLL
    assert classify(None) == w.CLASS_INTERACTIVE


def test_workload_class_rides_capture_bind(pkg):
    ctx, _ = pkg
    with ctx.activate_workload_class("bulk"):
        bound = ctx.bind(lambda: ctx.current_workload_class())
    with ctx.activate_workload_class("aggs"):
        assert bound() == "bulk"
        assert ctx.current_workload_class() == "aggs"
    assert ctx.current_workload_class() is None


def test_workload_header_round_trips(pkg):
    ctx, _ = pkg
    with ctx.activate_workload_class("scroll"):
        headers = ctx.stamp_task_headers({})
    assert headers[ctx.WORKLOAD_HEADER] == "scroll"
    with ctx.incoming(headers):
        assert ctx.current_workload_class() == "scroll"
    assert ctx.current_workload_class() is None


def test_accounting_renders_equal_in_both_packages():
    out = []
    for root in PACKAGES:
        m = importlib.import_module(f"{root}.telemetry.metrics")
        w = importlib.import_module(f"{root}.telemetry.workload")
        acct = w.WorkloadAccounting(m.MetricsRegistry(clock=lambda: 5.0),
                                    max_classes=3)
        for i, c in enumerate(["interactive", "aggs", "bulk", "x", None,
                               "interactive", "scroll", "aggs"]):
            acct.record_search(c, 3.0 * (i + 1))
            acct.record_cohort(c)
            acct.record_launch(c, 0.5)
        acct.record_indexing("bulk", 1000)
        acct.record_rejection("bulk", "coordinating")
        merged = w.merge_workload_stats({"n": acct.stats()})
        out.append((json.dumps(merged, sort_keys=True),
                    w.render_cat_workload(merged), acct.top_n()))
    assert out[0] == out[1]


# ------------------------------------------------------------ REST, both

@pytest.fixture(params=["jax", "torch"])
def node(request, tmp_path):
    n = (JaxNode(data_path=str(tmp_path / "data"))
         if request.param == "jax" else Node(device="cpu"))
    yield n
    n.close()


def do(node, method, path, params=None, body=None, headers=None,
       expect=200):
    status, resp = node.rest_controller.dispatch(
        method, path, params, body, headers=headers)
    assert status == expect, f"{method} {path} -> {status}: {resp}"
    return resp


def _seed(node, index="logs", settings=None):
    do(node, "PUT", f"/{index}", body={
        "settings": settings or {},
        "mappings": {"properties": {"category": {"type": "keyword"}}}})
    do(node, "PUT", f"/{index}/_doc/1",
       body={"body": "quick brown fox", "category": "a"}, expect=201)
    do(node, "POST", f"/{index}/_refresh")


def test_request_shapes_classify_into_workload_stats(node):
    _seed(node)
    do(node, "POST", "/logs/_search",
       body={"query": {"match": {"body": "fox"}}})
    do(node, "POST", "/logs/_search",
       body={"size": 0, "request_cache": False,
             "aggs": {"c": {"terms": {"field": "category"}}}})
    stats = do(node, "GET", "/_workload/stats")
    assert stats["nodes"] == [node.node_id]
    assert stats["classes"]["interactive"]["search"]["count"] == 1
    assert stats["classes"]["aggs"]["search"]["count"] == 1
    ndjson = "\n".join(json.dumps(line) for line in [
        {"index": {"_index": "logs", "_id": "b1"}}, {"body": "more fox"}])
    do(node, "POST", "/_bulk", params={"refresh": "true"}, body=ndjson)
    stats = do(node, "GET", "/_workload/stats")
    assert stats["classes"]["bulk"]["indexing"]["bytes"] > 0


def test_workload_header_beats_classification(node):
    _seed(node)
    do(node, "POST", "/logs/_search",
       body={"query": {"match": {"body": "fox"}}},
       headers={"X-Workload-Class": "canary"})
    classes = do(node, "GET", "/_workload/stats")["classes"]
    assert classes["canary"]["search"]["count"] == 1
    assert classes.get("interactive", {}).get(
        "search", {}).get("count", 0) == 0


def test_cat_workload_shares_stats_shaping(node):
    _seed(node)
    do(node, "POST", "/logs/_search",
       body={"query": {"match": {"body": "fox"}}})
    stats = do(node, "GET", "/_workload/stats")
    lines = do(node, "GET", "/_cat/workload")["_cat"].splitlines()
    assert lines[0].startswith("class")
    for c, e in stats["classes"].items():
        row = next(ln for ln in lines[1:] if ln.split()[0] == c)
        assert row.split()[1] == str(e["search"]["count"])


def test_slowlog_carries_class(node):
    _seed(node, index="slowidx", settings={
        "index.search.slowlog.threshold.query.warn": "0ms"})
    do(node, "POST", "/slowidx/_search",
       body={"query": {"match": {"body": "fox"}}},
       headers={"X-Opaque-Id": "op-9"})
    entries = [e for e in node.search_service.slowlog_recent
               if e.get("search.class") == "interactive"]
    assert entries, list(node.search_service.slowlog_recent)
    assert entries[-1]["x_opaque_id"] == "op-9"


def test_scroll_open_is_the_scroll_class(node):
    _seed(node)
    r = do(node, "POST", "/logs/_search", params={"scroll": "1m"},
           body={"query": {"match_all": {}}, "size": 1})
    do(node, "DELETE", "/_search/scroll",
       body={"scroll_id": r["_scroll_id"]})
    classes = do(node, "GET", "/_workload/stats")["classes"]
    assert classes["scroll"]["search"]["count"] == 1


def _masked_classes(stats):
    out = {}
    for name, e in stats["classes"].items():
        e = json.loads(json.dumps(e))
        lat = e["search"]["latency"]
        for key in ("sum_ms", "p50_ms", "p99_ms"):
            lat.pop(key)
        e.pop("slo")
        e.get("device", {}).pop("launch_ms", None)
        e.get("device", {}).pop("cohort_slots", None)
        e.pop("cohort", None)
        out[name] = e
    return out


def test_workload_stats_equal_the_reference(tmp_path):
    answers = []
    for kind in ("jax", "torch"):
        n = (JaxNode(data_path=str(tmp_path / kind)) if kind == "jax"
             else Node(device="cpu"))
        try:
            _seed(n)
            bulk = "".join(json.dumps(x) + "\n" for x in (
                {"index": {"_index": "logs", "_id": "2"}},
                {"body": "lazy dog", "category": "b"}))
            do(n, "POST", "/_bulk", {"refresh": "true"}, bulk)
            do(n, "POST", "/logs/_search",
               body={"query": {"match": {"body": "fox"}}})
            do(n, "POST", "/logs/_search",
               body={"size": 0, "request_cache": False,
                     "aggs": {"c": {"terms": {"field": "category"}}}})
            do(n, "POST", "/logs/_search",
               body={"query": {"match": {"body": "dog"}}},
               headers={"X-Workload-Class": "canary"})
            r = do(n, "POST", "/logs/_search", params={"scroll": "1m"},
                   body={"query": {"match_all": {}}, "size": 1})
            do(n, "DELETE", "/_search/scroll",
               body={"scroll_id": r["_scroll_id"]})
            answers.append(_masked_classes(do(n, "GET",
                                              "/_workload/stats")))
        finally:
            n.close()
    assert answers[0] == answers[1]


def test_async_search_is_the_async_class(node):
    """An async search runs under the ``async`` class on its background
    thread, and its render names the class and the submitter's
    tenant."""
    _seed(node)
    r = do(node, "POST", "/logs/_async_search",
           params={"wait_for_completion_timeout": "30s"},
           body={"query": {"match": {"body": "fox"}}},
           headers={"X-Tenant-Id": "as-t"})
    assert r["is_running"] is False
    assert r["search.class"] == "async" and r["tenant"] == "as-t"
    classes = do(node, "GET", "/_workload/stats")["classes"]
    assert classes["async"]["search"]["count"] == 1
    tenants = do(node, "GET", "/_tenants/stats")["tenants"]
    assert tenants["as-t"]["search"]["count"] == 1
