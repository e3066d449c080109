"""Tenant accounting of the port against the reference's: the bounded
table (the ``_default`` bucket, LRU eviction folding into ``_other``,
reserved buckets, pruning of an evicted tenant's series, bucket-bound
quantiles, SLO violations and budget burn), the merge and the
``_cat/tenants`` render, the ambient tenant's carry and wire headers,
and the single-node REST surface (tagging precedence header > body >
``index.tenant.default``, slowlog entries, ``_nodes/stats`` top-n).

Unit cases run on both packages (``pkg``) with the reference's
expectations, and their renders are compared equal. REST cases send the
same requests to the reference's node and the port's (``device="cpu"``)
and compare ``/_tenants/stats`` with the node ids and the timing fields
masked (latency sums and bucket quantiles, device launch ms and
readback bytes: the two engines time and read back differently).
"""

import importlib
import json
from types import SimpleNamespace

import pytest

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node

PACKAGES = ("elasticsearch_tpu", "elasticsearch_tpu_torch")


def load(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    return SimpleNamespace(context=mod("telemetry.context"),
                           history=mod("telemetry.history"),
                           metrics=mod("telemetry.metrics"),
                           tenants=mod("telemetry.tenants"))


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return load(request.param)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _table(p, max_tenants=64, with_history=True, **kwargs):
    clock = _Clock()
    reg = p.metrics.MetricsRegistry(clock=clock)
    hist = (p.history.MetricsHistory(reg, clock, interval=10.0)
            if with_history else None)
    return clock, reg, hist, p.tenants.TenantAccounting(
        reg, history=hist, max_tenants=max_tenants, **kwargs)


# ---------------------------------------------------------------- the table

def test_untagged_work_lands_in_default_bucket(pkg):
    _, _, _, acct = _table(pkg)
    acct.record_search(None, 12.0, shards=3)
    acct.record_indexing("", 256)
    s = acct.stats()
    assert list(s["tenants"]) == [pkg.tenants.DEFAULT_TENANT]
    e = s["tenants"][pkg.tenants.DEFAULT_TENANT]
    assert e["search"]["count"] == 1
    assert e["search"]["shard_fanout"] == 3
    assert e["indexing"]["bytes"] == 256


def test_lru_eviction_folds_totals_into_other(pkg):
    _, _, _, acct = _table(pkg, max_tenants=2)
    acct.record_search("t1", 10.0)
    acct.record_indexing("t1", 100)
    acct.record_search("t2", 20.0)
    acct.record_search("t3", 30.0)   # evicts t1
    s = acct.stats()
    other_name = pkg.tenants.OVERFLOW_TENANT
    assert sorted(s["tenants"]) == [other_name, "t2", "t3"]
    assert s["cardinality"]["evictions"] == 1
    other = s["tenants"][other_name]
    assert other["search"]["count"] == 1
    assert other["search"]["latency"]["count"] == 1
    assert other["indexing"]["bytes"] == 100
    assert sum(e["search"]["count"] for e in s["tenants"].values()) == 3


def test_reserved_buckets_never_count_against_cap(pkg):
    t = pkg.tenants
    _, _, _, acct = _table(pkg, max_tenants=2)
    acct.record_search(None, 1.0)
    acct.record_search("a", 1.0)
    acct.record_search("b", 1.0)
    assert acct.stats()["cardinality"]["evictions"] == 0
    acct.record_search("c", 1.0)
    assert sorted(acct.stats()["tenants"]) == [
        t.DEFAULT_TENANT, t.OVERFLOW_TENANT, "b", "c"]
    for i in range(5):
        acct.record_search(f"churn-{i}", 1.0)
    live = acct.active_tenants()
    assert t.DEFAULT_TENANT in live and t.OVERFLOW_TENANT in live


def test_eviction_prunes_registry_ring_and_exemplar_slots(pkg):
    t, ctx = pkg.tenants, pkg.context
    clock, reg, hist, acct = _table(pkg, max_tenants=1)
    with ctx.activate(ctx.TraceContext("trace-ev1")):
        acct.record_search("ev1", 42.0)
    clock.advance(10.0)
    assert hist.advance()
    assert any(lk and dict(lk).get(t.TENANT_LABEL) == "ev1"
               for (_n, lk) in hist.samples()[-1][1])
    assert [e for e in reg.exemplars_of(t.LATENCY_METRIC)
            if e.get("trace_id") == "trace-ev1"]
    acct.record_search("ev2", 7.0)   # evicts ev1
    with reg._lock:
        leaked = [(n, lk) for (n, lk) in reg._metrics
                  if lk and dict(lk).get(t.TENANT_LABEL) == "ev1"]
    assert leaked == []
    assert [e for e in reg.exemplars_of(t.LATENCY_METRIC)
            if e.get("trace_id") == "trace-ev1"] == []
    for _ts, snap in hist.samples():
        assert not any(lk and dict(lk).get(t.TENANT_LABEL) == "ev1"
                       for (_n, lk) in snap)
    other = acct.stats()["tenants"][t.OVERFLOW_TENANT]
    assert other["search"]["count"] == 1
    assert other["search"]["latency"]["sum_ms"] == 42.0


def test_latency_quantiles_are_deterministic_bucket_bounds(pkg):
    _, _, _, acct = _table(pkg)
    for v in (1.0, 1.0, 1.0, 900.0):
        acct.record_search("q", v)
    lat = acct.stats()["tenants"]["q"]["search"]["latency"]
    assert lat["p50_ms"] == 1.0
    assert lat["p99_ms"] == 1000.0
    assert lat["count"] == 4


def test_slo_violations_and_budget_burn(pkg):
    _, _, _, acct = _table(pkg, slo_objectives={"slo-t": 10.0})
    for _ in range(95):
        acct.record_search("slo-t", 5.0)
    for _ in range(5):
        acct.record_search("slo-t", 50.0)
    slo = acct.stats()["tenants"]["slo-t"]["slo"]
    assert slo["objective_ms"] == 10.0
    assert slo["violations"] == 5
    assert slo["budget_burn_pct"] == 500.0


def test_slo_default_applies_when_no_override(pkg):
    _, _, _, acct = _table(pkg, slo_default_ms=20.0,
                           slo_objectives={"fast": 5.0})
    assert acct.objective_ms("fast") == 5.0
    assert acct.objective_ms("anyone") == 20.0


def _two_node_sections(p):
    _, _, _, a = _table(p)
    a.record_search("t1", 2.0, shards=2)
    a.record_search("t1", 200.0)
    a.record_indexing("t1", 50)
    a.record_launch("t1", 3.5)
    a.record_cohort("t1")
    a.record_readback("t1", 4096)
    a.record_breaker_trip("t1", "request")
    _, _, _, b = _table(p)
    b.record_search("t1", 2.0)
    b.record_search("t2", 8.0)
    b.record_rejection("t2")
    return {"n-a": a.stats(), "n-b": b.stats()}


def test_merge_sums_counters_and_recomputes_quantiles(pkg):
    merged = pkg.tenants.merge_tenant_stats(_two_node_sections(pkg))
    assert merged["nodes"] == ["n-a", "n-b"]
    t1 = merged["tenants"]["t1"]
    assert t1["search"]["count"] == 3
    assert t1["search"]["shard_fanout"] == 2
    assert t1["search"]["latency"]["p50_ms"] == 5.0
    assert t1["search"]["latency"]["p99_ms"] == 500.0
    assert merged["tenants"]["t2"]["indexing"]["rejections"] == 1
    assert merged["cardinality"]["live"] == 2


def test_merge_is_order_independent_and_reports_failures(pkg):
    sections = _two_node_sections(pkg)
    fwd = pkg.tenants.merge_tenant_stats(dict(sections))
    rev = pkg.tenants.merge_tenant_stats(
        dict(reversed(list(sections.items()))))
    assert json.dumps(fwd, sort_keys=True) == \
        json.dumps(rev, sort_keys=True)
    failed = pkg.tenants.merge_tenant_stats(
        sections, [{"node": "n-c", "error": "boom"}])
    assert failed["node_failures"] == [{"node": "n-c", "error": "boom"}]


def test_merged_and_cat_renders_equal_in_both_packages():
    out = []
    for root in PACKAGES:
        p = load(root)
        merged = p.tenants.merge_tenant_stats(_two_node_sections(p))
        out.append((json.dumps(merged, sort_keys=True),
                    p.tenants.render_cat_tenants(merged)))
    assert out[0] == out[1]
    lines = out[0][1].splitlines()
    assert lines[0].split()[:2] == ["tenant", "search.count"]
    assert [ln.split()[0] for ln in lines[1:]] == ["t1", "t2"]


# ------------------------------------------------------- ambient carry

def test_capture_bind_carries_tenant_across_hop(pkg):
    ctx = pkg.context
    captured = {}

    def probe():
        captured["t"] = ctx.current_tenant()

    with ctx.activate_tenant("hopper"):
        bound = ctx.bind(probe)
    assert ctx.current_tenant() is None
    bound()
    assert captured["t"] == "hopper"
    assert ctx.current_tenant() is None


def test_wire_headers_round_trip_tenant(pkg):
    ctx = pkg.context
    with ctx.activate_tenant("wire-t"):
        headers = ctx.stamp_task_headers(None)
    assert headers[ctx.TENANT_HEADER] == "wire-t"
    with ctx.incoming(headers):
        assert ctx.current_tenant() == "wire-t"
    assert ctx.current_tenant() is None


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
    do(node, "PUT", f"/{index}", body={"settings": settings or {}})
    do(node, "PUT", f"/{index}/_doc/1", body={"body": "quick brown fox"},
       expect=201)
    do(node, "POST", f"/{index}/_refresh")


def test_header_tagging_reaches_tenants_stats(node):
    _seed(node)
    do(node, "POST", "/logs/_search",
       body={"query": {"match": {"body": "fox"}}},
       headers={"x-tenant-id": "acme"})
    stats = do(node, "GET", "/_tenants/stats")
    assert stats["nodes"] == [node.node_id]
    assert stats["tenants"]["acme"]["search"]["count"] == 1
    assert stats["tenants"]["acme"]["search"]["latency"]["count"] == 1


def test_tagging_precedence_header_beats_body_beats_index_default(node):
    _seed(node, index="tagged",
          settings={"index.tenant.default": "from-index"})
    do(node, "POST", "/tagged/_search", body={"query": {"match_all": {}}})
    do(node, "POST", "/tagged/_search",
       body={"query": {"match_all": {}}, "tenant": "from-body"})
    do(node, "POST", "/tagged/_search",
       body={"query": {"match_all": {}}, "tenant": "from-body"},
       headers={"X-Tenant-Id": "from-header"})
    t = do(node, "GET", "/_tenants/stats")["tenants"]
    assert t["from-index"]["search"]["count"] == 1
    assert t["from-body"]["search"]["count"] == 1
    assert t["from-header"]["search"]["count"] == 1


def test_untagged_search_charges_default_bucket(node):
    _seed(node)
    do(node, "POST", "/logs/_search",
       body={"query": {"match": {"body": "fox"}}})
    t = do(node, "GET", "/_tenants/stats")["tenants"]
    assert t["_default"]["search"]["count"] >= 1


def test_cat_tenants_shares_stats_shaping(node):
    _seed(node)
    do(node, "POST", "/logs/_search",
       body={"query": {"match_all": {}}, "tenant": "cat-t"})
    stats = do(node, "GET", "/_tenants/stats")
    lines = do(node, "GET", "/_cat/tenants")["_cat"].splitlines()
    assert lines[0].startswith("tenant")
    for t, e in stats["tenants"].items():
        row = next(ln for ln in lines[1:] if ln.split()[0] == t)
        assert row.split()[1] == str(e["search"]["count"])


def test_slowlog_entries_carry_tenant(node):
    _seed(node, index="slowidx", settings={
        "index.search.slowlog.threshold.query.warn": "0ms"})
    do(node, "POST", "/slowidx/_search",
       body={"query": {"match": {"body": "fox"}}, "tenant": "slow-t"})
    entries = [e for e in node.search_service.slowlog_recent
               if e.get("tenant") == "slow-t"]
    assert entries, list(node.search_service.slowlog_recent)
    assert entries[-1]["search.class"] == "interactive"


def test_nodes_stats_renders_tenant_top_n(node):
    _seed(node)
    for _ in range(3):
        do(node, "POST", "/logs/_search",
           body={"query": {"match_all": {}}, "tenant": "busy"})
    do(node, "POST", "/logs/_search",
       body={"query": {"match_all": {}}, "tenant": "idle"})
    ns = do(node, "GET", "/_nodes/stats")
    section = ns["nodes"][node.node_id]["telemetry"]["tenants"]
    assert section["cardinality"]["live"] >= 2
    top = section["top"]
    busy = next(r for r in top if r["tenant"] == "busy")
    assert busy["search_count"] == 3
    assert top[0]["tenant"] == "busy"


def _masked_tenants(stats):
    out = {}
    for name, e in stats["tenants"].items():
        e = json.loads(json.dumps(e))
        lat = e["search"]["latency"]
        for key in ("sum_ms", "p50_ms", "p99_ms"):
            lat.pop(key)
        e["device"].pop("launch_ms")
        e["device"].pop("readback_bytes")
        # the port's fast path serves a one-segment index without the
        # PlanBatcher (test_fast_path_bodies_charge_no_cohort_slot)
        e["device"].pop("cohort_slots")
        e["slo"].pop("violations")
        e["slo"].pop("budget_burn_pct")
        out[name] = e
    return {"tenants": out, "cardinality": stats["cardinality"]}


def test_tenants_stats_equal_the_reference(tmp_path):
    """One mix of tagged, body-tagged, index-default and untagged
    searches and a tagged bulk on both nodes: the tables agree once the
    timing fields are masked."""
    answers = []
    for kind in ("jax", "torch"):
        n = (JaxNode(data_path=str(tmp_path / kind)) if kind == "jax"
             else Node(device="cpu"))
        try:
            _seed(n, index="a", settings={"index.tenant.default": "dflt"})
            _seed(n, index="b")
            bulk = "".join(json.dumps(x) + "\n" for x in (
                {"index": {"_index": "b", "_id": "2"}},
                {"body": "lazy dog"}))
            do(n, "POST", "/_bulk", {"refresh": "true"}, bulk,
               headers={"X-Tenant-Id": "writer"})
            for body, headers in [
                    ({"query": {"match": {"body": "fox"}}}, None),
                    ({"query": {"match_all": {}}}, {"X-Tenant-Id": "h"}),
                    ({"query": {"match_all": {}}, "tenant": "bt"}, None)]:
                do(n, "POST", "/a/_search", body=body, headers=headers)
                do(n, "POST", "/b/_search", body=body, headers=headers)
            answers.append(_masked_tenants(do(n, "GET", "/_tenants/stats")))
        finally:
            n.close()
    assert answers[0] == answers[1]


def test_fast_path_bodies_charge_no_cohort_slot():
    """A cohort slot is a PlanBatcher (or KnnBatcher) entry. The port's
    fast path serves a bare ``match`` on a one-segment index from its
    own cohorts, so that body charges none; the same body on an index
    of two segments takes the plan path and charges one, as each body
    of the reference does."""
    n = Node(device="cpu")
    try:
        _seed(n, index="one")
        _seed(n, index="two")
        do(n, "PUT", "/two/_doc/2", body={"body": "lazy fox"}, expect=201)
        do(n, "POST", "/two/_refresh")
        body = {"query": {"match": {"body": "fox"}}}
        do(n, "POST", "/one/_search", body=body, headers={"X-Tenant-Id": "f"})
        do(n, "POST", "/two/_search", body=body, headers={"X-Tenant-Id": "p"})
        t = do(n, "GET", "/_tenants/stats")["tenants"]
        assert t["f"]["device"]["cohort_slots"] == 0
        assert t["p"]["device"]["cohort_slots"] == 2     # two segments
        assert n.fastpath.serving_stats()["dispatch"]
    finally:
        n.close()
