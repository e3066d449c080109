"""The port's telemetry units against the reference's: the metrics
registry (counters, gauges, histograms, their buckets and overflow,
labeled series, exemplars), the tracer (span trees, the bounded trace
ring, the per-trace span cap, remote trace ids), the history ring (rates
and deltas on an injected clock), shaping's bucket quantiles, the stage
sink and the ambient context's carry across a thread hop.

Each case runs the same seeded inputs through both packages
(``pkg``: ``elasticsearch_tpu`` and ``elasticsearch_tpu_torch``) and
checks the reference's expectations on each; the rendered outputs of
the two are compared equal (exactly: both are the same Python
arithmetic on the same float64 inputs). No clock waits: every clock is
injected.
"""

import importlib
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("elasticsearch_tpu", "elasticsearch_tpu_torch")


def load(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    return SimpleNamespace(
        root=root,
        telemetry=mod("telemetry"),
        metrics=mod("telemetry.metrics"),
        tracing=mod("telemetry.tracing"),
        history=mod("telemetry.history"),
        shaping=mod("telemetry.shaping"),
        context=mod("telemetry.context"),
        flight=mod("telemetry.flightrecorder"),
        profile=mod("search.profile"))


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return load(request.param)


@pytest.fixture
def both():
    return [load(root) for root in PACKAGES]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _seeded_values(seed=7, n=200):
    rng = np.random.default_rng(seed)
    return [float(v) for v in rng.lognormal(2.0, 1.5, n)]


# --------------------------------------------------------------- registry

def test_registry_counter_gauge_histogram(pkg):
    clock = FakeClock()
    reg = pkg.metrics.MetricsRegistry(clock=clock)
    reg.inc("search.requests")
    reg.inc("search.requests", 2)
    reg.set_gauge("open_contexts", 7)
    reg.observe("latency", 3.0)
    reg.observe("latency", 400.0)
    with reg.timer("latency"):
        clock.t += 0.5        # 500 ms on the injected clock
    d = reg.to_dict()
    assert d["search.requests"] == {"type": "counter", "value": 3}
    assert d["open_contexts"] == {"type": "gauge", "value": 7}
    h = d["latency"]
    assert h["type"] == "histogram" and h["count"] == 3
    assert h["min"] == 3.0 and h["max"] == 500.0
    assert h["buckets"]["le_5"] == 1
    assert h["buckets"]["le_500"] == 3
    assert h["buckets"]["le_inf"] == h["count"]
    assert h["sum"] == pytest.approx(903.0)


def test_labeled_series_render_as_list(pkg):
    reg = pkg.metrics.MetricsRegistry()
    reg.inc("transport.requests.sent", action="a/one")
    reg.inc("transport.requests.sent", action="a/two")
    reg.inc("transport.requests.sent", action="a/one")
    d = reg.to_dict()["transport.requests.sent"]
    assert isinstance(d, list) and len(d) == 2
    assert {s["labels"]["action"]: s["value"] for s in d} == \
        {"a/one": 2, "a/two": 1}
    assert reg.get_value("transport.requests.sent", action="a/one") == 2


def test_histogram_overflow_bucket(pkg):
    h = pkg.metrics.Histogram(buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 100.0):
        h.observe(v)
    assert h.counts == [1, 1, 1]
    assert h.to_dict()["buckets"] == {"le_1": 1, "le_10": 2, "le_inf": 3}


def test_seeded_registry_renders_equal_in_both_packages(both):
    """The same seeded observations (default buckets, labels, a timer
    on the injected clock) render the same registry in both packages."""
    out = []
    for p in both:
        clock = FakeClock(100.0)
        reg = p.metrics.MetricsRegistry(clock=clock)
        for i, v in enumerate(_seeded_values()):
            reg.observe("search.latency", v)
            reg.inc("search.requests", kind=("a", "b", "c")[i % 3])
            reg.set_gauge("tasks.current", i % 5)
            with reg.timer("stage"):
                clock.t += v / 1000.0
        out.append(json.dumps(reg.to_dict(), sort_keys=True))
    assert out[0] == out[1]


def test_exemplars_keep_the_last_trace_of_each_bucket(pkg):
    reg = pkg.metrics.MetricsRegistry()
    ctx = pkg.context
    for i, v in enumerate((1.0, 2.0, 300.0, 4000.0)):
        with ctx.activate(ctx.TraceContext(f"tr-{i}")):
            reg.observe("search.latency", v)
    reg.observe("search.latency", 2.5)      # untraced: no exemplar
    ex = reg.exemplars_of("search.latency")
    # one a bucket, tail first; the untraced 2.5 leaves le_5's tr-1
    assert [(e["bucket"], e["trace_id"], e["value"]) for e in ex] == [
        ("le_5000", "tr-3", 4000.0), ("le_500", "tr-2", 300.0),
        ("le_5", "tr-1", 2.0), ("le_1", "tr-0", 1.0)]


def test_exemplars_equal_in_both_packages(both):
    out = []
    for p in both:
        reg = p.metrics.MetricsRegistry()
        for i, v in enumerate(_seeded_values(3, 60)):
            with p.context.activate(p.context.TraceContext(f"t{i}")):
                reg.observe("search.latency", v)
        out.append(reg.exemplars_of("search.latency"))
    assert out[0] == out[1]


# ----------------------------------------------------------------- tracer

def test_tracer_span_tree_and_ring(pkg):
    clock = FakeClock()
    tr = pkg.tracing.Tracer(clock=clock, node="n1", max_traces=2)
    root = tr.start_span("search")
    clock.t += 0.01
    child = tr.start_span("query", parent=root)
    assert child.trace_id == root.trace_id
    assert len(tr.open_spans()) == 2
    child.finish(outcome="ok")
    root.finish()
    t = tr.trace(root.trace_id)
    assert [s["name"] for s in t["spans"]] == ["search", "query"]
    assert t["tree"][0]["name"] == "search"
    assert [c["name"] for c in t["tree"][0]["children"]] == ["query"]
    assert not tr.open_spans()
    for _ in range(3):
        tr.start_span("s").finish()
    assert tr.trace(root.trace_id) is None
    assert len(tr.recent_traces()) == 2


def test_tracer_caps_spans_per_trace(pkg):
    tr = pkg.tracing.Tracer(clock=FakeClock(), node="n",
                            max_spans_per_trace=3)
    root = tr.start_span("root")
    for i in range(5):
        tr.start_span(f"c{i}", parent=root).finish()
    root.finish()
    t = tr.trace(root.trace_id)
    # the oldest two children went; spans sort by (start, span id)
    assert [s["name"] for s in t["spans"]] == ["root", "c3", "c4"]
    assert t["dropped_spans"] == 3
    assert tr.dropped_spans_total == 3
    assert tr.recent_traces()[0]["dropped_spans"] == 3


def test_tracer_joins_remote_trace_ids(pkg):
    tr = pkg.tracing.Tracer(node="n2")
    span = tr.start_span("shard_query", trace_id="n1-t000001",
                         parent_span_id="n1-s000003")
    span.finish()
    t = tr.trace("n1-t000001")
    assert t["spans"][0]["parent_id"] == "n1-s000003"
    # a span under an incoming (remote) context parents to it
    ctx = pkg.context
    with ctx.incoming({"trace.id": "remote-7", "span.id": "r-s1"}):
        local = tr.start_span("rest.search")
        with ctx.activate_span(local):
            child = tr.start_span("shard[i][0]")
        child.finish()
        local.finish()
    t = tr.trace("remote-7")
    assert [(s["name"], s["parent_id"]) for s in t["spans"]] == [
        ("rest.search", "r-s1"), ("shard[i][0]", local.span_id)]
    assert [r["name"] for r in t["tree"]] == ["rest.search"]


def test_seeded_traces_render_equal_in_both_packages(both):
    out = []
    for p in both:
        clock = FakeClock(5.0)
        tr = p.tracing.Tracer(clock=clock, node="n", max_traces=4)
        for i, v in enumerate(_seeded_values(11, 12)):
            root = tr.start_span("rest.search", tags={"i": i})
            clock.t += v / 1000.0
            tr.start_span("shard", parent=root).finish()
            root.finish()
        out.append((tr.recent_traces(10),
                    [tr.trace(t["trace_id"]) for t in tr.recent_traces()]))
    assert out[0] == out[1]


# ---------------------------------------------------- history and shaping

def test_history_rates_and_deltas(pkg):
    clock = FakeClock(1000.0)
    reg = pkg.metrics.MetricsRegistry(clock=clock)
    hist = pkg.history.MetricsHistory(reg, clock, interval=10.0,
                                      retention=60.0)
    reg.inc("search.requests", 5)
    assert hist.advance()
    for step in range(1, 5):
        clock.t += 10.0
        reg.inc("search.requests", 10 * step)
        reg.inc("search.failed", kind="x")
        hist.advance()
    # the last 30 s hold steps 2..4: 20 + 30 + 40 requests
    assert hist.delta("search.requests", 30.0) == 90.0
    assert hist.rate("search.requests", 30.0) == pytest.approx(3.0)
    assert hist.delta_total("search.failed", 30.0) == 3.0
    assert [v for _, v in hist.series("search.requests")] == \
        [5.0, 15.0, 35.0, 65.0, 105.0]
    # advancing within one interval records nothing new
    clock.t += 1.0
    assert not hist.advance()


def test_history_equal_in_both_packages(both):
    out = []
    for p in both:
        clock = FakeClock(1000.0)
        reg = p.metrics.MetricsRegistry(clock=clock)
        hist = p.history.MetricsHistory(reg, clock, interval=10.0,
                                        retention=60.0)
        for i, v in enumerate(_seeded_values(5, 40)):
            reg.inc("search.requests")
            reg.observe("search.latency", v)
            reg.set_gauge("tasks.current", i % 7)
            clock.t += 2.5
            hist.advance()
        out.append((json.dumps(hist.to_dict(), sort_keys=True),
                    json.dumps(hist.to_dict(window=20.0), sort_keys=True),
                    len(hist.samples())))
    assert out[0] == out[1]
    assert out[0][2] <= 7        # retention 60 s / interval 10 s, + now


def test_history_retention_bounds_the_ring(pkg):
    clock = FakeClock(0.0)
    reg = pkg.metrics.MetricsRegistry(clock=clock)
    hist = pkg.history.MetricsHistory(reg, clock, interval=1.0,
                                      retention=5.0)
    for _ in range(50):
        clock.t += 1.0
        reg.inc("x")
        hist.advance()
    assert len(hist.samples()) <= 7


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_shaping_quantiles_equal(both, q):
    """Bucket-bound quantiles and the latency summary of seeded
    observations, as both packages shape them."""
    got = []
    for p in both:
        h = p.metrics.Histogram()
        for v in _seeded_values(int(q * 100), 300):
            h.observe(v)
        d = h.to_dict()
        got.append((p.shaping.quantile_ms(d["buckets"], q),
                    p.shaping.latency_summary(d["buckets"], d["count"],
                                              d["sum"]),
                    p.shaping.budget_burn_pct(300, 7, 0.99)))
    assert got[0] == got[1]
    assert got[0][0] in both[0].metrics.DEFAULT_BUCKETS_MS + (float("inf"),)


# --------------------------------------------------- stage sink and carry

def test_stage_sink_folds_profile_stages_into_histograms(pkg):
    tele = pkg.telemetry.Telemetry(node="x")
    profile = pkg.profile
    assert not profile.active()
    with profile.stage_sink(tele.stage_sink()):
        assert profile.active()
        profile.record("launch", 2_000_000)
        profile.record("readback", 500_000)
    d = tele.metrics.to_dict()
    assert d["search.stage.launch"]["count"] == 1
    assert d["search.stage.launch"]["sum"] == pytest.approx(2.0)
    assert d["search.stage.readback"]["count"] == 1
    with profile.profiling() as rec:
        with profile.stage_sink(tele.stage_sink()):
            profile.record("topk", 1_000_000)
    assert rec["topk"] == 1_000_000
    assert tele.metrics.to_dict()["search.stage.topk"]["count"] == 1


def test_bundle_sections_equal_in_both_packages(both):
    out = []
    for p in both:
        clock = FakeClock(50.0)
        tele = p.telemetry.Telemetry(node="n", clock=clock)
        with p.context.activate_tenant("acme"), \
                p.context.activate_workload_class("interactive"):
            tele.flight.record_launch("k", "(8,)", dispatch_ns=2_000_000,
                                      cohort=3, capacity=4)
            tele.flight.record_readback("s", 64, duration_ns=1000)
        tele.tenants.record_search("acme", 12.0, shards=2)
        tele.workload.record_search("interactive", 12.0)
        tele.tenants.record_cohort("acme")
        d = tele.to_dict(history=True)
        d["metrics"].pop("engine.compile.count", None)
        d["metrics"].pop("engine.compile.ms", None)
        out.append(json.dumps(d, sort_keys=True))
    assert out[0] == out[1]


def test_bind_carries_every_ambient_context_across_a_thread(pkg):
    ctx = pkg.context
    fr = pkg.flight.FlightRecorder(node="n1", clock=FakeClock())
    with pkg.flight.activate(fr), ctx.activate_opaque("op-1"), \
            ctx.activate_tenant("t-1"), \
            ctx.activate_workload_class("scroll"), \
            ctx.activate(ctx.TraceContext("tr", "sp")):
        bound = ctx.bind(lambda: (
            pkg.flight.current(), ctx.current_opaque_id(),
            ctx.current_tenant(), ctx.current_workload_class(),
            ctx.current()))
    seen = []
    t = threading.Thread(target=lambda: seen.append(bound()))
    t.start()
    t.join()
    assert seen == [(fr, "op-1", "t-1", "scroll",
                     ctx.TraceContext("tr", "sp"))]
    assert ctx.current_tenant() is None and pkg.flight.current() is None
