"""Traces, waterfalls, flight attribution and the request breaker of
the port against the reference's.

- ``GET /_traces`` (recent summaries, ``exemplar_for``),
  ``GET /_traces/{id}`` (one ``rest.search`` root over its
  ``shard[{index}][{n}]`` and ``fetch`` spans) and
  ``GET /_flight_recorder/waterfall/{id}`` (each launch and readback
  under the span it ran in): the same bodies on both nodes give the
  same span trees, names and tags, once span ids, trace ids and times
  are masked; a trace id sent in (``trace.id`` with ``span.id``) roots
  the request's spans under the caller's.
- the flight recorder's attribution units (events carry the ambient
  trace, span, tenant and class; ``bind`` carries the recorder and the
  client id; ``build_waterfall`` stitches, keeps unattached events and
  computes self time), on both packages.
- the ``request`` breaker: the dense path charges each segment's
  aggregation-mask readback and its top-k rows while the shard's phase
  runs and releases them when it ends (``used`` back to 0); a limit
  below one segment's mask answers 429 ``circuit_breaking_exception``,
  counts ``breaker.tripped{breaker=request}`` and the tenant's trip;
  the body without ``aggs`` answers its exact total. The named
  departure: the reference charges the [ND] score column it reads back,
  the port gathers the winners on the device and never reads that
  column back, so a body whose column trips the reference's breaker
  answers 200 in the port.
"""

import importlib
import json

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node

PACKAGES = ("elasticsearch_tpu", "elasticsearch_tpu_torch")
WORDS = ["fox", "dog", "cat", "owl", "eel", "bee", "ant", "yak"]


def _docs(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        words = rng.choice(WORDS, size=int(rng.integers(3, 9)))
        out.append({"body": " ".join(words), "cat": f"c{i % 4}",
                    "n": int(rng.integers(0, 1000))})
    return out


MAPPINGS = {"properties": {"body": {"type": "text"},
                           "cat": {"type": "keyword"},
                           "n": {"type": "long"}}}


def do(node, method, path, params=None, body=None, headers=None,
       expect=200):
    status, resp = node.rest_controller.dispatch(
        method, path, params, body, headers=headers)
    assert status == expect, f"{method} {path} -> {status}: {resp}"
    return resp


def _seed(node, index, docs, shards=1):
    do(node, "PUT", f"/{index}", body={
        "mappings": MAPPINGS,
        "settings": {"index": {"number_of_shards": shards}}})
    lines = []
    for i, d in enumerate(docs):
        lines.append(json.dumps({"index": {"_id": str(i)}}))
        lines.append(json.dumps(d))
    do(node, "POST", f"/{index}/_bulk", {"refresh": "true"},
       "\n".join(lines) + "\n")


def _nodes(tmp_path, settings=None):
    jax = JaxNode(Settings.from_dict(settings or {}),
                  data_path=str(tmp_path / "jax"))
    torch_node = Node(device="cpu", settings=settings)
    return jax, torch_node


def _shape(tree):
    """(name, tags, children) of a span tree, ids and times dropped."""
    return [(n["name"], n.get("tags", {}),
             _shape(n.get("children", []))) for n in tree]


DENSE = {"query": {"match": {"body": "fox"}}, "min_score": 0.01,
         "size": 5, "aggs": {"cats": {"terms": {"field": "cat"}}}}
PLAN = {"query": {"bool": {"should": [{"match": {"body": "dog"}},
                                      {"term": {"cat": "c1"}}]}},
        "size": 5}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    # the one-card semantics: the reference's per-shard loop, not its
    # mesh over the tests' virtual devices
    mp = pytest.MonkeyPatch()
    mp.setenv("ESTPU_MESH_SERVING", "0")
    tmp = tmp_path_factory.mktemp("traces")
    jax, port = _nodes(tmp)
    docs = _docs(300, 3)
    for n in (jax, port):
        _seed(n, "one", docs)
        _seed(n, "three", docs, shards=3)
    yield jax, port
    jax.close()
    port.close()
    mp.undo()


@pytest.mark.parametrize("index", ["one", "three"])
@pytest.mark.parametrize("body", [DENSE, PLAN], ids=["dense", "plan"])
def test_trace_trees_equal_the_reference(pair, index, body):
    trees = []
    for n in pair:
        r = do(n, "POST", f"/{index}/_search", body=body)
        tid = r["_headers"]["trace.id"]
        t = do(n, "GET", f"/_traces/{tid}")
        assert t["trace_id"] == tid
        roots = [s for s in t["spans"] if s["parent_id"] is None]
        assert [s["name"] for s in roots] == ["rest.search"]
        trees.append(_shape(t["tree"]))
    assert trees[0] == trees[1]
    shards = [c for c in trees[1][0][2] if c[0].startswith("shard[")]
    assert len(shards) == (3 if index == "three" else 1)
    assert any(c[0] == "fetch" for c in trees[1][0][2])


def test_recent_traces_list_the_newest_first(pair):
    for n in pair:
        ids = [do(n, "POST", "/one/_search", body=PLAN)["_headers"][
            "trace.id"] for _ in range(3)]
        listed = do(n, "GET", "/_traces", {"size": "3"})["traces"]
        assert [t["trace_id"] for t in listed] == ids[::-1]
        assert all(t["root"] == "rest.search" for t in listed)
        paged = do(n, "GET", "/_traces", {"size": "1", "from": "1"})
        assert [t["trace_id"] for t in paged["traces"]] == [ids[1]]


def test_exemplars_resolve_to_traces(pair):
    for n in pair:
        do(n, "POST", "/one/_search", body=PLAN)
        ex = do(n, "GET", "/_traces",
                {"exemplar_for": "search.latency"})
        assert ex["metric"] == "search.latency"
        assert ex["exemplars"]
        ok = [e for e in ex["exemplars"] if e["resolvable"]]
        assert ok and all(e["root"] == "rest.search" for e in ok)


def test_waterfall_lists_the_requests_launches(pair):
    """A dense body with a terms agg on three shards: its launches and
    readbacks (the port's: the contribution kernel, the aggregation
    masks, the top-k rows) are the events recorded under its trace, each
    attached to the span that was ambient when it ran. As in the
    reference that is the ``rest.search`` root: the shard spans time the
    shards but are not made ambient. An unknown trace is a 404."""
    for n in pair:
        r = do(n, "POST", "/three/_search", body=DENSE)
        tid = r["_headers"]["trace.id"]
        w = do(n, "GET", f"/_flight_recorder/waterfall/{tid}")
        assert w["trace_id"] == tid and w["span_count"] == 5
        assert "unattached_events" not in w
        root = w["waterfall"][0]
        assert root["name"] == "rest.search"
        events = root["events"]
        assert w["event_count"] == len(events)
        assert [e["site"] for e in events if e["kind"] == "readback"
                ].count("search.searcher.dense_topk") == 3
        assert all(e["trace_id"] == tid and e["span_id"] == root["span_id"]
                   for e in events)
        flight = n.telemetry.flight if hasattr(n, "telemetry") else None
        assert flight is not None
        assert events == flight.events_for_trace(tid)
        assert [c["name"] for c in root["children"]] == [
            "shard[three][0]", "shard[three][1]", "shard[three][2]",
            "fetch"]
        assert root["self_ns"] >= 0
        do(n, "GET", "/_flight_recorder/waterfall/no-such-trace",
           expect=404)
        do(n, "GET", "/_traces/no-such-trace", expect=404)
    port_events = [e.get("kernel") or e.get("site") for e in
                   pair[1].telemetry.flight.events(limit=64)]
    assert "gather_bm25_contrib" in port_events
    assert "search.searcher.agg_mask" in port_events


def test_incoming_trace_id_roots_the_request(pair):
    for root in PACKAGES:
        ctx = importlib.import_module(f"{root}.telemetry.context")
        n = pair[PACKAGES.index(root)]
        with ctx.incoming({"trace.id": f"ext-{root}", "span.id": "ext-s1"}):
            r = do(n, "POST", "/one/_search", body=PLAN)
        assert r["_headers"]["trace.id"] == f"ext-{root}"
        t = do(n, "GET", f"/_traces/ext-{root}")
        top = [s for s in t["spans"] if s["name"] == "rest.search"]
        assert [s["parent_id"] for s in top] == ["ext-s1"]


def test_profile_names_its_trace(pair):
    for n in pair:
        r = do(n, "POST", "/three/_search",
               body={**PLAN, "profile": True},
               headers={"X-Tenant-Id": "prof-t"})
        assert r["profile"]["trace.id"] == r["_headers"]["trace.id"]
        assert all(s.get("tenant") == "prof-t"
                   for s in r["profile"]["shards"])
        assert all(s.get("search.class") == "interactive"
                   for s in r["profile"]["shards"])


# ------------------------------------------------- attribution units

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(params=PACKAGES)
def pkg(request):
    root = request.param
    return (importlib.import_module(f"{root}.telemetry.context"),
            importlib.import_module(f"{root}.telemetry.flightrecorder"),
            importlib.import_module(f"{root}.telemetry.tracing"),
            importlib.import_module(f"{root}.transport.tasks"))


def test_events_carry_ambient_trace_span_tenant_and_class(pkg):
    ctx, fl, tracing, _ = pkg
    tracer = tracing.Tracer(node="n1", clock=FakeClock())
    fr = fl.FlightRecorder(node="n1", clock=FakeClock())
    span = tracer.start_span("search")
    with ctx.activate_span(span), ctx.activate_tenant("t9"), \
            ctx.activate_workload_class("aggs"):
        fr.record_launch("k", "(8,)", dispatch_ns=1000)
        fr.record_readback("s", 16)
    span.finish()
    evs = fr.events(limit=10)
    assert all(e["trace_id"] == span.trace_id for e in evs)
    assert all(e["span_id"] == span.span_id for e in evs)
    assert all(e["tenant"] == "t9" and e["workload_class"] == "aggs"
               for e in evs)
    summary = fr.summary_for_trace(span.trace_id)
    assert summary["launches"] == 1 and summary["readbacks"] == 1


def test_context_bind_carries_recorder_and_opaque(pkg):
    ctx, fl, _, _ = pkg
    fr = fl.FlightRecorder(node="n1", clock=FakeClock())
    with fl.activate(fr), ctx.activate_opaque("req-42"):
        bound = ctx.bind(lambda: (fl.current(), ctx.current_opaque_id()))
    assert fl.current() is None and ctx.current_opaque_id() is None
    assert bound() == (fr, "req-42")
    assert fl.current() is None


def test_task_captures_client_tenant_and_class(pkg):
    ctx, _, _, tasks = pkg
    with ctx.activate_opaque("admin-7"), ctx.activate_tenant("t"), \
            ctx.activate_workload_class("scroll"):
        t = tasks.Task(1, "transport", "indices:data/read/search")
    d = t.to_dict("n1")
    assert d["headers"] == {"X-Opaque-Id": "admin-7"}
    assert d["tenant"] == "t" and d["search.class"] == "scroll"
    assert "headers" not in tasks.Task(2, "transport", "x").to_dict("n1")


def test_build_waterfall_equal_in_both_packages():
    spans = [{"span_id": "c/1", "parent_id": None, "name": "search",
              "start_ms": 0.0, "duration_ms": 10.0},
             {"span_id": "d/2", "parent_id": "c/1", "name": "shard[i][0]",
              "start_ms": 1.0, "duration_ms": 6.0}]
    events = [{"kind": "launch", "seq": 1, "node": "dn-1", "t_ns": 2,
               "kernel": "k", "span_id": "d/2", "trace_id": "t1"},
              {"kind": "readback", "seq": 2, "node": "dn-1", "t_ns": 3,
               "site": "s", "span_id": "gone", "trace_id": "t1"}]
    out = []
    for root in PACKAGES:
        fl = importlib.import_module(f"{root}.telemetry.flightrecorder")
        w = fl.build_waterfall("t1", [
            {"node": "coord", "spans": [spans[0]], "events": []},
            {"node": "dn-1", "spans": [spans[1]], "events": events}])
        assert w["nodes"] == ["coord", "dn-1"]
        child = w["waterfall"][0]["children"][0]
        assert [e["kind"] for e in child["events"]] == ["launch"]
        assert [e["seq"] for e in w["unattached_events"]] == [2]
        assert w["waterfall"][0]["self_ns"] == 4_000_000
        assert fl.build_waterfall("t2", [{"node": "x", "spans": [],
                                          "events": []}]) is None
        out.append(w)
    assert out[0] == out[1]


# ------------------------------------------------------ request breaker

AGG_BODY = {"query": {"match": {"body": "fox"}}, "size": 5,
            "aggs": {"cats": {"terms": {"field": "cat"}}}}


def _request_stats(node):
    return do(node, "GET", "/_nodes/stats")["nodes"][node.node_id][
        "breakers"]["request"]


def test_dense_readbacks_are_charged_and_released(monkeypatch):
    node = Node(device="cpu")
    try:
        _seed(node, "idx", _docs(2000, 5))
        seen = []
        ba = node.device_cache.bigarrays
        adopt = ba.adopt

        def spy(array, label="array"):
            acc = adopt(array, label)
            seen.append((label, int(array.nbytes),
                         node.breaker_service.get_breaker("request").used))
            return acc
        monkeypatch.setattr(ba, "adopt", spy)
        r = do(node, "POST", "/idx/_search", body=AGG_BODY)
        labels = [s[0] for s in seen]
        assert labels.count("agg_mask_readback") == 1
        assert "dense_topk_readback" in labels
        mask = next(s for s in seen if s[0] == "agg_mask_readback")
        assert mask[1] == 2000               # one bool a doc
        assert max(s[2] for s in seen) >= mask[1]
        assert _request_stats(node)["estimated_size_in_bytes"] == 0
        assert r["aggregations"]["cats"]["buckets"]
    finally:
        node.close()


def test_a_request_limit_below_the_mask_answers_429(tmp_path):
    """limit 1kb, one segment of 2,000 docs (a 2,000-byte mask): the
    aggregation body trips in both packages (the reference charges its
    8,000-byte score column); without ``aggs`` the port answers its
    exact total (the departure: its top-k rows are under the limit)."""
    settings = {"indices.breaker.request.limit": "1kb"}
    jax, port = _nodes(tmp_path, settings)
    try:
        docs = _docs(2000, 5)
        for n in (jax, port):
            _seed(n, "idx", docs)
        for n in (jax, port):
            st, r = n.rest_controller.dispatch("POST", "/idx/_search", {},
                                               AGG_BODY,
                                               headers={"X-Tenant-Id": "t"})
            assert st == 429, r
            assert r["error"]["type"] == "circuit_breaking_exception"
        tele = port.telemetry
        assert tele.metrics.get_value("breaker.tripped",
                                      breaker="request") == 1
        assert tele.tenants.stats()["tenants"]["t"]["indexing"][
            "breaker_trips"] == 1
        assert _request_stats(port)["estimated_size_in_bytes"] == 0
        assert _request_stats(port)["tripped"] == 1
        plain = {"query": AGG_BODY["query"], "size": 5, "min_score": 0.0}
        r = do(port, "POST", "/idx/_search", body=plain)
        want = sum("fox" in d["body"].split() for d in docs)
        assert r["hits"]["total"] == {"value": want, "relation": "eq"}
    finally:
        jax.close()
        port.close()


def test_the_port_never_charges_a_score_column(tmp_path):
    """The named departure: a dense body without aggregations whose
    [ND] score column passes the reference's limit answers 429 there
    and 200 here, with the reference's answer at a limit that admits
    the column."""
    body = {"query": {"match": {"body": "fox"}}, "size": 5,
            "min_score": 0.0}
    docs = _docs(2000, 9)
    tight = {"indices.breaker.request.limit": "2kb"}
    jax, port = _nodes(tmp_path / "tight", tight)
    try:
        for n in (jax, port):
            _seed(n, "idx", docs)
        st, r = jax.rest_controller.dispatch("POST", "/idx/_search", {},
                                             body)
        assert st == 429 and r["error"]["type"] == \
            "circuit_breaking_exception"
        got = do(port, "POST", "/idx/_search", body=body)
    finally:
        jax.close()
        port.close()
    ref = JaxNode(data_path=str(tmp_path / "loose"))
    try:
        _seed(ref, "idx", docs)
        want = do(ref, "POST", "/idx/_search", body=body)
    finally:
        ref.close()
    assert got["hits"]["total"] == want["hits"]["total"]
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in want["hits"]["hits"]]
    np.testing.assert_allclose(
        [h["_score"] for h in got["hits"]["hits"]],
        [h["_score"] for h in want["hits"]["hits"]], rtol=1e-5)
