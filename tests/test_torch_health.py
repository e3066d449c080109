"""The health report against the reference, on the CPU.

The single-node and unit cases of the reference's tests/test_health.py
(the report's catalog, the indicator filter and its 400, `_cluster/
health` and `_cat/health` sharing one status, the history ring under
the indicators, the stalled-progress watchdog, ``merge_node_reports``,
``shard_availability_summary``) run on both packages' ``health/`` and
``telemetry/`` modules. Then each indicator's report on both nodes over
the same indices and requests: status, symptom and details equal, with
the fields that differ between the packages by construction masked
(``MASKED``: the ``hbm`` breaker's bytes, which count each package's
own device layout, the launch tracker's process-wide first calls, the
launch-latency EMA, and the cluster's name). The port's device
indicators read its own signals: ``device_engine``'s ``hbm_used_ratio``
is the ``hbm`` breaker's used over its limit, ``device_regime``'s fill
the flight recorder's over the window, and ``repository_integrity``
names a snapshot blob that went missing or unreadable.
"""

import json
import os

import pytest

from elasticsearch_tpu import health as jax_health
from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.health import indicators as jax_indicators
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.telemetry import history as jax_history
from elasticsearch_tpu.telemetry import metrics as jax_metrics
from elasticsearch_tpu_torch import health as port_health
from elasticsearch_tpu_torch.health import indicators as port_indicators
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.telemetry import history as port_history
from elasticsearch_tpu_torch.telemetry import metrics as port_metrics

PKGS = {"jax": (jax_health, jax_indicators, jax_metrics, jax_history),
        "port": (port_health, port_indicators, port_metrics, port_history)}
INDICATOR_NAMES = [cls.name for cls in port_health.DEFAULT_INDICATORS]
# (indicator, details path) that differ by construction
MASKED = (("circuit_breakers", ("breakers", "hbm", "estimated_size_in_bytes")),
          ("circuit_breakers", ("breakers", "parent",
                                "estimated_size_in_bytes")),
          ("device_engine", ("compile_totals",)),
          ("device_regime", ("latency_ema_ms",)))


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _ring(pkg, interval=10.0, retention=600.0, t0=1000.0):
    _, _, metrics, history = PKGS[pkg]
    clock = _Clock(t0)
    reg = metrics.MetricsRegistry(clock=clock)
    hist = history.MetricsHistory(reg, clock, interval=interval,
                                  retention=retention)
    return clock, reg, hist


# ------------------------------------------- single-node REST surface


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
    yield p
    p.close()


def masked_report(r, node_id):
    """The report with its node's details un-nested and ``MASKED``
    dropped."""
    out = {"status": r["status"], "indicators": {}}
    for name, ind in r["indicators"].items():
        ind = json.loads(json.dumps(ind))
        details = ind["details"]["nodes"][node_id]
        for which, path in MASKED:
            if which != name:
                continue
            d = details
            for key in path[:-1]:
                d = d.get(key, {})
            d.pop(path[-1], None)
        ind["details"] = details
        out["indicators"][name] = ind
    return out


def test_health_report_green_catalog(pair):
    j, p = pair.do("GET", "/_health_report")
    for r, node in ((j, pair.jax), (p, pair.port)):
        assert r["status"] == "green"
        assert sorted(r["indicators"]) == sorted(INDICATOR_NAMES)
        for name, ind in r["indicators"].items():
            assert ind["status"] == "green", (name, ind)
            assert ind["symptom"]
            assert node.node_id in ind["details"]["nodes"]
            assert "impacts" not in ind and "diagnosis" not in ind
    assert masked_report(j, pair.jax.node_id) == \
        masked_report(p, pair.port.node_id)


@pytest.mark.parametrize("name", INDICATOR_NAMES)
def test_each_indicator_equal_on_both_nodes(pair, name):
    """Over three indices, writes, searches and a repository: each
    indicator's report on its own (``/_health_report/{name}``)."""
    pair.do("PUT", "/books", body={"settings": {"index": {
        "number_of_shards": 3}}})
    pair.do("PUT", "/one")
    for i in range(8):
        pair.do("PUT", f"/books/_doc/{i}", {"refresh": "true"},
                {"t": f"w{i % 3} common", "n": i}, expect=201)
        pair.do("PUT", f"/one/_doc/{i}", body={"t": f"w{i}"}, expect=201)
    pair.do("POST", "/one/_refresh")
    pair.do("POST", "/books/_search", body={"query": {"match": {
        "t": "common"}}})
    pair.do("POST", "/one/_search", body={"query": {"match_all": {}}})
    for (_, node), loc in zip(pair.nodes(), ("ref", "port")):
        st, _ = node.rest_controller.dispatch("PUT", "/_snapshot/repo", {}, {
            "type": "fs", "settings": {"location": os.path.join(
                node.data_path, "..", f"repo-{loc}")}})
        assert st == 200
    pair.do("PUT", "/_snapshot/repo/s1", body={"indices": "one"})
    j, p = pair.do("GET", f"/_health_report/{name}")
    assert list(p["indicators"]) == [name]
    assert p["status"] == p["indicators"][name]["status"]
    assert masked_report(j, pair.jax.node_id) == \
        masked_report(p, pair.port.node_id)


def test_health_report_unknown_indicator_400(pair):
    j, p = pair.do("GET", "/_health_report/no_such_thing", expect=400)
    assert j == p
    assert p["error"]["type"] == "illegal_argument_exception"
    assert "no_such_thing" in p["error"]["reason"]


def test_cluster_health_and_cat_health_share_status(pair):
    pair.do("PUT", "/books", body={"settings": {"index": {
        "number_of_shards": 3}}})
    pair.do("PUT", "/other")
    j, p = pair.do("GET", "/_cluster/health")
    assert {**j, "cluster_name": None} == {**p, "cluster_name": None}
    assert p["status"] == "green"
    assert p["active_primary_shards"] == p["active_shards"] == 4
    assert p["active_shards_percent_as_number"] == 100.0
    for node, h in ((pair.jax, j), (pair.port, p)):
        st, cat = node.rest_controller.dispatch("GET", "/_cat/health", {},
                                                None)
        assert st == 200
        _, name, status, nodes, data = cat["_cat"].split()
        assert (name, status, nodes, data) == (
            h["cluster_name"], h["status"], "1", "1")
        st, r = node.rest_controller.dispatch(
            "GET", "/_health_report/shards_availability", {}, None)
        assert r["indicators"]["shards_availability"]["status"] \
            == h["status"]


def test_nodes_stats_history_param(pair):
    plain, _ = pair.do("GET", "/_nodes/stats")
    for _, node in pair.nodes():
        st, plain = node.rest_controller.dispatch("GET", "/_nodes/stats",
                                                  {}, None)
        nid = next(iter(plain["nodes"]))
        assert "history" not in plain["nodes"][nid]["telemetry"]
        st, withh = node.rest_controller.dispatch(
            "GET", "/_nodes/stats", {"history": "true"}, None)
        hist = withh["nodes"][nid]["telemetry"]["history"]
        assert hist["interval_s"] > 0 and hist["capacity"] >= 2
        assert hist["samples"] >= 1
        assert hist["memory_bytes"] > 0


# ---------------------------------------------- the history ring


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_history_rate_distinguishes_storm_from_boot_accumulation(pkg):
    health, indicators = PKGS[pkg][:2]
    clock, reg, hist = _ring(pkg, interval=10.0)
    reg.inc("engine.compile.count", 300)
    hist.advance()
    clock.advance(10)
    hist.advance()
    ctx = health.HealthContext(history=hist)
    res = indicators.DeviceEngineIndicator().safe_compute(ctx)
    assert res.status == health.HealthStatus.GREEN
    assert res.details["compiles_per_min"] == 0.0
    assert reg.get_value("engine.compile.count") == 300
    reg.inc("engine.compile.count", 35)
    clock.advance(10)
    hist.advance()
    res = indicators.DeviceEngineIndicator().safe_compute(ctx)
    assert res.status in (health.HealthStatus.YELLOW,
                          health.HealthStatus.RED)
    assert res.details["compiles_per_min"] >= 30.0
    assert res.diagnoses[0].id == "device_engine:compile_storm"


class _StubPressure:
    def __init__(self, current=0, limit=10 ** 9, lifetime_rejections=112):
        self.current = current
        self.limit = limit
        self.lifetime = lifetime_rejections

    def stats(self):
        return {"limit_in_bytes": self.limit,
                "memory": {
                    "current": {"coordinating_in_bytes": self.current},
                    "total": {"coordinating_rejections": self.lifetime}}}


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_history_rejection_burst_vs_lifetime_count(pkg):
    health, indicators = PKGS[pkg][:2]
    clock, reg, hist = _ring(pkg, interval=10.0)
    reg.inc("indexing_pressure.rejections", 100, stage="coordinating")
    hist.advance()
    clock.advance(10)
    hist.advance()
    ctx = health.HealthContext(history=hist,
                               indexing_pressure=_StubPressure())
    res = indicators.IndexingPressureIndicator().safe_compute(ctx)
    assert res.status == health.HealthStatus.GREEN, res.symptom
    assert res.details["lifetime_rejections"] == 112
    reg.inc("indexing_pressure.rejections", 7, stage="coordinating")
    reg.inc("indexing_pressure.rejections", 5, stage="primary")
    clock.advance(10)
    hist.advance()
    res = indicators.IndexingPressureIndicator().safe_compute(ctx)
    assert res.status == health.HealthStatus.RED
    assert res.details["recent_rejections"] == 12.0
    assert res.diagnoses[0].id == "indexing_pressure:saturation"
    assert res.impacts[0].id == "writes_rejected"


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_history_delta_and_rate_anchor_at_newest_sample(pkg):
    clock, reg, hist = _ring(pkg, interval=10.0)
    reg.inc("req", 100)
    hist.advance()
    clock.advance(10)
    reg.inc("req", 30)
    hist.advance()
    clock.advance(10)
    reg.inc("req", 5)
    hist.advance()
    assert hist.delta("req", 60.0) == 35.0
    assert hist.rate("req", 60.0) == pytest.approx(35.0 / 20.0)
    assert hist.delta("req", 10.0) == 5.0
    reg.inc("req", 1000)
    assert hist.delta("req", 60.0) == 35.0


# ------------------------------------------------------ the watchdog


class _StubTask:
    def __init__(self, tid, clock, started_at, action="indices:data/read",
                 profile_stage=None):
        self.id = tid
        self.action = action
        self.profile_stage = profile_stage
        self._clock = clock
        self._started = started_at

    def running_time_nanos(self):
        return int((self._clock() - self._started) * 1e9)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_watchdog_task_stall_transition_counts_once(pkg):
    health, _, metrics, _ = PKGS[pkg]
    clock = _Clock(0.0)
    reg = metrics.MetricsRegistry(clock=clock)
    task = _StubTask(7, clock, started_at=0.0, profile_stage="fetch")
    tasks = [task]
    wd = health.StalledProgressWatchdog(
        clock=clock, metrics=reg, tasks_fn=lambda: tasks,
        stall_after_s=30.0, task_deadline_s=120.0)
    clock.advance(60)
    assert wd.sweep() == []
    clock.advance(61)
    assert wd.sweep() == []
    clock.advance(31)
    findings = wd.sweep()
    assert len(findings) == 1
    f = findings[0]
    assert f["kind"] == "task" and f["resource"] == "task:7"
    assert f["stalled_for_s"] >= 30.0
    assert f["detail"]["profile_stage"] == "fetch"
    assert reg.get_value("watchdog.stalls", kind="task") == 1
    clock.advance(10)
    assert len(wd.sweep()) == 1
    assert reg.get_value("watchdog.stalls", kind="task") == 1
    task.profile_stage = "reduce"
    assert wd.sweep() == []
    tasks.clear()
    wd.sweep()
    assert wd.stats()["tracked"] == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_watchdog_state_lag_constant_vs_shrinking(pkg):
    health, _, metrics, _ = PKGS[pkg]
    clock = _Clock(0.0)
    reg = metrics.MetricsRegistry(clock=clock)
    lags = {"dn-1": 5, "dn-2": 3}
    wd = health.StalledProgressWatchdog(
        clock=clock, metrics=reg, lag_fn=lambda: lags, stall_after_s=20.0)
    wd.sweep()
    clock.advance(10)
    lags["dn-2"] = 1
    wd.sweep()
    clock.advance(15)
    findings = wd.sweep()
    assert [f["resource"] for f in findings] == ["dn-1"]
    assert findings[0]["kind"] == "cluster_state_lag"
    assert reg.get_value("watchdog.stalls", kind="cluster_state_lag") == 1
    lags["dn-1"] = 0
    lags["dn-2"] = 0
    assert wd.sweep() == []
    assert wd.stats()["tracked"] == 0


def test_port_watchdog_sees_the_node_tasks(tmp_path):
    """The node's watchdog tracks its task manager's tasks on the
    metrics clock: a task past the deadline whose stage stays is a
    finding of the next report."""
    node = Node(device="cpu", data_path=str(tmp_path / "w"), settings={
        "health.watchdog.stall_after": 0.0,
        "health.watchdog.task_deadline": 0.0})
    try:
        with node.task_manager.task_scope(
                "transport", "indices:data/read/search",
                cancellable=True) as task:
            task.enter_stage("launch")
            node.health.local_report()
            node.health.local_report()
            found = node.health_watchdog.findings()
            assert [f["resource"] for f in found] == [f"task:{task.id}"]
        node.health.local_report()
        assert node.health_watchdog.findings() == []
    finally:
        node.close()


# ------------------------------------------------ merge and summary


def _node_report(node, status, symptom, resources=()):
    ind = {"status": status, "symptom": symptom, "details": {"n": node}}
    if status != "green":
        ind["diagnosis"] = [{
            "id": "shards_availability:replica_unassigned",
            "cause": "c", "action": "a",
            "affected_resources": sorted(resources)}]
    return {"node": node, "status": status,
            "indicators": {"shards_availability": ind}}


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_merge_worst_wins_and_diagnosis_resources_union(pkg):
    merged = PKGS[pkg][0].merge_node_reports({
        "dn-0": _node_report("dn-0", "green", "all good"),
        "dn-1": _node_report("dn-1", "yellow", "1 copy missing", ["idx-b"]),
        "dn-2": _node_report("dn-2", "yellow", "2 copies missing",
                             ["idx-a", "idx-b"]),
    })
    assert merged["status"] == "yellow"
    ind = merged["indicators"]["shards_availability"]
    assert ind["symptom"] == "1 copy missing"
    assert sorted(ind["details"]["nodes"]) == ["dn-0", "dn-1", "dn-2"]
    assert ind["diagnosis"][0]["affected_resources"] == ["idx-a", "idx-b"]
    assert "node_failures" not in merged


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_merge_failures_cap_green_to_unknown(pkg):
    merge = PKGS[pkg][0].merge_node_reports
    merged = merge({"dn-0": _node_report("dn-0", "green", "ok")},
                   node_failures=[{"node": "dn-1", "error": "disconnected"}])
    assert merged["status"] == "unknown"
    assert merged["node_failures"] == [
        {"node": "dn-1", "error": "disconnected"}]
    merged = merge({"dn-0": _node_report("dn-0", "red", "primaries down")},
                   node_failures=[{"node": "dn-1", "error": "disconnected"}])
    assert merged["status"] == "red"


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_merge_is_arrival_order_independent(pkg):
    merge = PKGS[pkg][0].merge_node_reports
    a = _node_report("dn-0", "yellow", "y", ["i1"])
    b = _node_report("dn-1", "red", "r", ["i2"])
    m1 = merge({"dn-0": a, "dn-1": b})
    m2 = merge({"dn-1": b, "dn-0": a})
    assert json.dumps(m1, sort_keys=True) == json.dumps(m2, sort_keys=True)


def test_merge_equal_in_both_packages():
    reports = {"dn-0": _node_report("dn-0", "yellow", "y", ["i1"]),
               "dn-1": _node_report("dn-1", "red", "r", ["i2"])}
    assert jax_health.merge_node_reports(reports) == \
        port_health.merge_node_reports(reports)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_shard_availability_summary_shapes(pkg):
    s = PKGS[pkg][0].shard_availability_summary(None)
    assert s["status"] == "green" and s["active_shards"] == 0


# --------------------------------------- the port's device indicators


def test_port_device_engine_reads_the_hbm_breaker(tmp_path):
    node = Node(device="cpu", data_path=str(tmp_path / "d"), settings={
        "indices.breaker.hbm.limit": "1mb"})
    try:
        for i in range(20):
            node.rest_controller.dispatch("PUT", f"/i/_doc/{i}", {}, {
                "t": f"w{i} common"})
        node.rest_controller.dispatch("POST", "/i/_refresh", {}, None)
        node.rest_controller.dispatch("POST", "/i/_search", {}, {
            "query": {"match": {"t": "common"}}})
        br = node.breaker_service.get_breaker("hbm")
        assert br.used > 0
        st, r = node.rest_controller.dispatch(
            "GET", "/_health_report/device_engine", {}, None)
        details = r["indicators"]["device_engine"]["details"]["nodes"][
            node.node_id]
        assert details["hbm_used_ratio"] == round(br.used / br.limit, 4)
    finally:
        node.close()


def test_port_device_regime_reads_the_flight_ring(tmp_path):
    node = Node(device="cpu", data_path=str(tmp_path / "f"))
    try:
        for i in range(20):
            node.rest_controller.dispatch("PUT", f"/i/_doc/{i}", {}, {
                "t": f"w{i} common"})
        node.rest_controller.dispatch("POST", "/i/_refresh", {}, None)
        node.rest_controller.dispatch("POST", "/i/_search", {}, {
            "query": {"match": {"t": "common"}}})
        st, r = node.rest_controller.dispatch(
            "GET", "/_health_report/device_regime", {}, None)
        details = r["indicators"]["device_regime"]["details"]["nodes"][
            node.node_id]
        hist = node.telemetry.history
        window = port_indicators.HEALTH_RATE_WINDOW_S
        assert details["launches_in_window"] == hist.delta_total(
            "flight.launches", window)
        slots = hist.delta_total("flight.launch.slots", window)
        filled = hist.delta_total("flight.launch.filled", window)
        assert details["fill_ratio_in_window"] == (
            filled / slots if slots else None)
        assert details["regime"] == \
            node.telemetry.flight.aggregates()["regime"]["current"]
    finally:
        node.close()


def test_node_shutdown_markers_need_the_cluster_layer():
    """Green with no markers in both packages; the port reports a node
    handed markers UNKNOWN (the reference reads them through cluster/,
    a later slice of the port), naming them."""
    class _State:
        class metadata:
            node_shutdowns = {"dn-1": object()}

    for pkg in ("jax", "port"):
        health, indicators = PKGS[pkg][:2]
        res = indicators.NodeShutdownIndicator().safe_compute(
            health.HealthContext())
        assert res.status == health.HealthStatus.GREEN, pkg
        assert res.symptom == "no node shutdowns in progress"
    res = port_indicators.NodeShutdownIndicator().safe_compute(
        port_health.HealthContext(cluster_state=_State()))
    assert res.status == port_health.HealthStatus.UNKNOWN
    assert res.details == {"shutdowns": ["dn-1"]}
