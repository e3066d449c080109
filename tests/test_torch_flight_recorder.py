"""The port's launch-path flight recorder (telemetry/flightrecorder.py,
a copy of the reference's) held to tests/test_flight_recorder.py: the
bounded ring, filters and paging, the fill histogram, the regime
classifier with its flip cause and hysteresis, its metrics (the
reference's MetricsRegistry as the sink), the readback funnel's
provenance, the ambient trace, ``bind`` across threads, and the REST
surfaces. Beyond the reference's cases: one launch event per tracked call
and one readback event per funnel readback on the serving path, the
fast path's drain thread and a PlanBatcher leader recording into the
node's ring. The waterfall, X-Opaque-Id, slowlog and cluster cases wait
for the port's tracer.
"""

import json
import threading

import numpy as np
import pytest
import torch

from elasticsearch_tpu.telemetry.metrics import MetricsRegistry
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import device as device_ops
from elasticsearch_tpu_torch.telemetry import context as telectx
from elasticsearch_tpu_torch.telemetry import flightrecorder as flightrec
from elasticsearch_tpu_torch.telemetry.engine import TRACKER
from elasticsearch_tpu_torch.telemetry.flightrecorder import FlightRecorder


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ------------------------------------------------------------ unit: ring

def test_ring_bounded_under_overload():
    fr = FlightRecorder(node="n1", clock=FakeClock(), capacity=64)
    for i in range(640):
        fr.record_launch(f"k{i % 3}", "(8,128)", dispatch_ns=1_000_000,
                         cohort=4, capacity=8)
    agg = fr.aggregates()
    assert agg["ring"] == {"capacity": 64, "events": 64,
                           "recorded_total": 640}
    assert agg["launches"] == 640
    assert len(fr.events(limit=10_000)) == 64


def test_event_filters_and_paging():
    clock = FakeClock()
    fr = FlightRecorder(node="n1", clock=clock)
    for _ in range(6):
        clock.t += 1.0
        fr.record_launch("plan_topk", "(8,128)", dispatch_ns=1000)
        fr.record_readback("ops.aggs.terms_counts", 4096)
    assert len(fr.events(kind="launch", limit=100)) == 6
    assert len(fr.events(kernel="plan_topk", limit=100)) == 6
    assert len(fr.events(site="ops.aggs.terms_counts", limit=100)) == 6
    assert fr.events(site="nope") == []
    late = fr.events(since_ns=int(4.5e9), limit=100)
    assert late and all(e["t_ns"] > 4.5e9 for e in late)
    page1 = fr.events(limit=3)
    page2 = fr.events(limit=3, offset=3)
    assert [e["seq"] for e in page1] > [e["seq"] for e in page2]


def test_fill_histogram_and_percentiles():
    fr = FlightRecorder(node="n1", clock=FakeClock())
    for cohort in (1, 2, 8, 8, 8, 8):
        fr.record_launch("k", "(8,)", cohort=cohort, capacity=8)
    pct = fr.fill_percentiles()
    assert pct["p50"] == 100.0
    assert pct["p99"] == 100.0
    agg = fr.aggregates()
    assert agg["fill_pct_overall"] == pytest.approx(
        100.0 * (1 + 2 + 8 * 4) / (8 * 6), abs=0.1)
    assert sum(agg["fill_histogram_pct"].values()) == 6


# --------------------------------------------------------- unit: regime

def test_regime_flips_with_cause_then_recovers():
    clock = FakeClock()
    fr = FlightRecorder(node="n1", clock=clock)
    assert fr.regime == "fast"
    for _ in range(6):
        clock.t += 0.05
        fr.record_launch("plan_topk", "(8,128)", dispatch_ns=60_000_000)
    agg = fr.aggregates()
    assert agg["regime"]["current"] == "degraded"
    assert agg["regime"]["flips"] == 1
    assert agg["regime"]["last_flip"]["cause"] == "launch plan_topk"
    assert agg["regime"]["last_flip"]["to"] == "degraded"
    for _ in range(3):
        clock.t += 0.05
        fr.record_launch("plan_topk", "(8,128)", dispatch_ns=18_000_000)
    assert fr.regime == "degraded"
    for _ in range(40):
        clock.t += 0.05
        fr.record_launch("plan_topk", "(8,128)", dispatch_ns=1_000_000)
    assert fr.regime == "fast"
    secs = fr.regime_seconds()
    assert secs["degraded"] > 0 and secs["fast"] > 0


def test_regime_ignores_compile_length_outliers():
    clock = FakeClock()
    fr = FlightRecorder(node="n1", clock=clock)
    for _ in range(5):
        clock.t += 1.0
        fr.record_launch("k", "(8,)", dispatch_ns=9_000_000_000)
    assert fr.regime == "fast"


def test_regime_seconds_feed_metrics_as_monotonic_counters():
    clock = FakeClock()
    reg = MetricsRegistry(clock=clock)
    fr = FlightRecorder(node="n1", clock=clock, metrics=reg)
    for _ in range(6):
        clock.t += 0.05
        fr.record_launch("k", "(8,)", dispatch_ns=60_000_000)
    assert reg.get_value("flight.regime") == 1.0
    assert reg.get_value("flight.regime_flips") == 1
    assert reg.get_value("flight.regime_seconds.degraded") > 0
    assert reg.get_value("flight.launches") == 6


# ------------------------------------------------- unit: funnel + trace

def test_funnel_records_provenance_and_returns_host_arrays():
    fr = FlightRecorder(node="n1", clock=FakeClock())
    with flightrec.activate(fr):
        one = device_ops.readback("test.site.one",
                                  torch.arange(8, dtype=torch.float32))
        a, b = device_ops.readback("test.site.two",
                                   torch.zeros(4, dtype=torch.float64),
                                   torch.ones(2, dtype=torch.float64))
    assert isinstance(one, np.ndarray) and one.shape == (8,)
    assert a.shape == (4,) and b.shape == (2,)
    agg = fr.aggregates()
    assert agg["readbacks"] == 2
    assert agg["readback_by_site"]["test.site.one"] == {"count": 1,
                                                        "bytes": 32}
    assert agg["readback_by_site"]["test.site.two"]["bytes"] == 4 * 8 + 2 * 8


def test_events_carry_ambient_trace_and_span():
    fr = FlightRecorder(node="n1", clock=FakeClock())
    ctx = telectx.TraceContext("t-1", "s-1")
    with telectx.activate(ctx):
        fr.record_launch("k", "(8,)", dispatch_ns=1000)
        fr.record_readback("s", 16)
    evs = fr.events(limit=10)
    assert all(e["trace_id"] == "t-1" for e in evs)
    assert all(e["span_id"] == "s-1" for e in evs)
    summary = fr.summary_for_trace("t-1")
    assert summary["launches"] == 1 and summary["readbacks"] == 1


def test_context_bind_carries_the_recorder_across_threads():
    fr = FlightRecorder(node="n1", clock=FakeClock())
    seen = []
    with flightrec.activate(fr):
        bound = telectx.bind(lambda: seen.append(flightrec.current()))
    t = threading.Thread(target=bound)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert seen == [fr]
    assert telectx.bind(len) is len           # nothing ambient: unchanged


# ------------------------------------------------------------ the node

MAPPINGS = {"properties": {"title": {"type": "text"},
                           "cat": {"type": "keyword"},
                           "rank": {"type": "long"}}}
SEARCH_BODY = {"query": {"match": {"title": "fox"}}, "size": 3,
               "aggs": {"cats": {"terms": {"field": "cat"}}}}


@pytest.fixture(scope="module")
def rest_node():
    node = Node(device="cpu")
    c = node.rest_controller
    c.dispatch("PUT", "/idx", {}, {"mappings": MAPPINGS})
    lines = "".join(
        json.dumps({"index": {"_id": str(i)}}) + "\n"
        + json.dumps({"title": f"fox doc {i} " + "jumps " * (i % 4),
                      "cat": ["x", "y", "z"][i % 3], "rank": i}) + "\n"
        for i in range(40))
    st, r = c.dispatch("POST", "/idx/_bulk", {"refresh": "true"}, lines)
    assert st == 200 and not r["errors"]
    yield node
    node.close()


def _search(node, body):
    status, r = node.rest_controller.dispatch("POST", "/idx/_search", {},
                                              body)
    assert status == 200, r
    return r


def test_flight_recorder_endpoint_records_serving_path(rest_node):
    r = _search(rest_node, SEARCH_BODY)
    assert r["aggregations"]["cats"]["buckets"]
    d = rest_node.rest_controller.dispatch
    st, out = d("GET", "/_flight_recorder", {}, None)
    assert st == 200
    kinds = {e["kind"] for e in out["events"]}
    assert kinds >= {"launch", "readback"}
    agg = out["aggregates"]
    assert agg["launches"] > 0 and agg["readbacks"] > 0
    sites = agg["readback_by_site"]
    assert sites and all("." in s for s in sites)
    assert sum(v["bytes"] for v in sites.values()) > 0
    site = next(iter(sites))
    st, only_rb = d("GET", "/_flight_recorder",
                    {"kind": "readback", "site": site}, None)
    assert only_rb["events"]
    assert all(e["site"] == site for e in only_rb["events"])
    st, page = d("GET", "/_flight_recorder", {"size": "2", "from": "1"},
                 None)
    assert [e["seq"] for e in page["events"]] == \
        [e["seq"] for e in out["events"][1:3]]


def test_nodes_stats_shows_nonzero_readback_by_site(rest_node):
    _search(rest_node, SEARCH_BODY)
    st, stats = rest_node.rest_controller.dispatch(
        "GET", "/_nodes/stats", {}, None)
    assert st == 200
    fl = next(iter(stats["nodes"].values()))["telemetry"][
        "flight_recorder"]
    assert fl["readbacks"] > 0
    assert sum(s["bytes"] for s in fl["readback_by_site"].values()) > 0
    assert fl["regime"]["current"] in ("fast", "degraded")


@pytest.mark.parametrize("body", [
    SEARCH_BODY,
    {"query": {"bool": {"must": [{"match": {"title": "fox jumps"}}]}},
     "size": 5},
    {"query": {"match": {"title": "jumps"}}, "sort": [{"rank": "asc"}]},
])
def test_one_event_per_tracked_call_and_per_readback(rest_node, body):
    fr = rest_node.flight
    calls0 = TRACKER.totals()["calls"]
    reads0 = sum(device_ops.READBACKS.values())
    agg0 = fr.aggregates()
    _search(rest_node, body)
    agg1 = fr.aggregates()
    assert agg1["launches"] - agg0["launches"] == \
        TRACKER.totals()["calls"] - calls0 > 0
    assert agg1["readbacks"] - agg0["readbacks"] == \
        sum(device_ops.READBACKS.values()) - reads0 > 0


def test_the_drain_thread_records_into_the_nodes_ring(rest_node):
    """A body of the fast grammar is served on the fast path's drain
    thread: its cohort's launches and readback land in the node's ring
    all the same."""
    fr = rest_node.flight
    seq0 = fr.aggregates()["ring"]["recorded_total"]
    r = _search(rest_node, {"query": {"match": {"title": "fox jumps"}},
                            "size": 4})
    assert r["hits"]["total"]["value"] == 40
    assert rest_node.fastpath.serving_stats()["dispatch"]
    evs = [e for e in fr.events(limit=4096) if e["seq"] > seq0]
    kernels = {e["kernel"] for e in evs if e["kind"] == "launch"}
    assert "bm25_topk_total_merge_batch" in kernels
    assert {"gather_bm25_contrib", "merge_sorted_slots",
            "stable_topk"} <= kernels
    sites = {e["site"] for e in evs if e["kind"] == "readback"}
    assert "search.fastpath.v2m_cohort" in sites


def test_a_cohort_launch_carries_its_annotation(rest_node):
    """Concurrent plan bodies share one PlanBatcher cohort: the leader's
    launch event carries the cohort's fill and capacity."""
    batcher = rest_node.search_service.plan_batcher
    fr = rest_node.flight
    seq0 = fr.aggregates()["ring"]["recorded_total"]
    bodies = [{"query": {"bool": {"should": [
        {"match": {"title": t}}, {"term": {"cat": "x"}}]}}, "size": 3}
        for t in ("fox", "jumps", "doc", "fox jumps")]
    errors = []

    def run(b):
        try:
            _search(rest_node, b)
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    # hold every launch slot until all four are queued: one cohort forms
    slots = [batcher._launch_slots.acquire() for _ in range(8)]
    threads = [threading.Thread(target=run, args=(b,)) for b in bodies]
    for t in threads:
        t.start()
    import time
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with batcher._lock:
            if sum(len(q) for q in batcher._pending.values()) == 4:
                break
        time.sleep(0.005)
    for _ in slots:
        batcher._launch_slots.release()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    launches = [e for e in fr.events(kind="launch", limit=4096)
                if e["seq"] > seq0 and e["kernel"] == "plan_topk_batch"]
    assert [(e["cohort"], e["capacity"]) for e in launches] == [(4, 4)]
    assert launches[0]["queue_wait_ns"] > 0
