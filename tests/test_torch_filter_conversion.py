"""Filter conversion on the port's plan path (search/plan.py
``_convert_filters``) against the reference's, on the CPU.

The thresholds are lowered in both packages (FILTER_CACHE_MIN_BLOCKS =
1, PRUNE_MIN_BLOCKS = 4), as tests/test_plan_prune.py lowers them, so
small corpora convert and prune.

- The reference's ``FILTERED_CASES``: the converted launch answers the
  dense executor's hits and totals, the unconverted launch's (conversion
  set past any group), and the reference's (ids and order tie-aware,
  scores rtol 1e-4, totals exact), also under ``track_total_hits`` 10
  with pruning, whose θ is validated against the composed host mask.
- Converted groups leave the launch: fewer groups and fewer selected
  blocks; one enumerating postings group always stays.
- The masks are really cached (a repeat adds none) and charged to the
  hbm breaker under ``filter_masks``; an LRU eviction of the composed
  mask between bind and launch leaves the answer and the accounting
  right.
- PlanBatcher: bodies with different filter sets never share a cohort;
  bodies with the same one share one launch and answer what each
  answers alone.
- REST on both nodes.
"""

import json
import threading
import time

import numpy as np
import pytest

import elasticsearch_tpu.search.plan as jplan
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.search.queries import parse_query as jax_parse
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import device as tdevice
from elasticsearch_tpu_torch.search import plan as tplan
from elasticsearch_tpu_torch.search.batching import PlanBatcher
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.plan import bind_plan, compile_plan
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import ShardSearcher
from elasticsearch_tpu_torch.utils.breaker import (CircuitBreaker,
                                                   build_breaker_service)
from test_torch_node import assert_same_hits
from test_torch_prune import (addrs, assert_same_as_reference, scores,
                              searchers, zipf_docs)

# tests/test_plan_prune.py FILTERED_CASES
FILTERED_CASES = [
    {"bool": {"must": [{"match": {"title": "alpha wolf"}}],
              "filter": [{"term": {"tag": "red"}}]}},
    {"bool": {"must": [{"match": {"title": "beta"}}],
              "filter": [{"terms": {"tag": ["red", "blue"]}}]}},
    {"bool": {"must": [{"match": {"title": "gamma fox"}}],
              "must_not": [{"term": {"tag": "green"}}]}},
    {"bool": {"should": [{"match": {"title": "alpha"}},
                         {"match": {"title": "cat dog"}}],
              "filter": [{"term": {"tag": "blue"}}]}},
    {"bool": {"filter": [{"term": {"tag": "red"}},
                         {"match": {"title": "alpha"}}]}},
]
# more shapes: two conversions, a filter that must stay, a dense factor
MORE_CASES = [
    {"bool": {"must": [{"match": {"title": "alpha"}}],
              "filter": [{"term": {"tag": "red"}}],
              "must_not": [{"term": {"tag": "green"}}]}},
    {"bool": {"filter": [{"term": {"tag": "red"}}]}},
    {"bool": {"must": [{"match": {"title": "wolf"}}],
              "filter": [{"terms": {"tag": ["red", "green"]}},
                         {"match": {"title": "dog"}}]}},
    {"bool": {"must": [{"match": {"title": "fox cat"}}],
              "must_not": [{"terms": {"tag": ["red", "blue"]}}]}},
]
CASES = FILTERED_CASES + MORE_CASES
NEVER = 1 << 40


@pytest.fixture(autouse=True)
def low_thresholds(monkeypatch):
    monkeypatch.setattr(jplan, "FILTER_CACHE_MIN_BLOCKS", 1)
    monkeypatch.setattr(jplan, "PRUNE_MIN_BLOCKS", 4)
    monkeypatch.setattr(tplan, "FILTER_CACHE_MIN_BLOCKS", 1)
    monkeypatch.setattr(tplan, "PRUNE_MIN_BLOCKS", 4)


@pytest.fixture(scope="module")
def pair():
    return searchers(zipf_docs(1200, 3))


def run(port, body, k, monkeypatch=None, convert=True, **kw):
    if not convert:
        monkeypatch.setattr(tplan, "FILTER_CACHE_MIN_BLOCKS", NEVER)
    try:
        return port.query_phase(parse_query(body), k, **kw)
    finally:
        if not convert:
            monkeypatch.setattr(tplan, "FILTER_CACHE_MIN_BLOCKS", 1)


@pytest.mark.parametrize("body", CASES)
def test_conversion_matches_dense_and_reference(pair, body):
    """The reference's test_filter_conversion_matches_dense on the port,
    then against the reference's converted launch."""
    ref, port = pair
    query = parse_query(body).rewrite(port)
    assert compile_plan(query, port) is not None, body
    fast = port.query_phase(parse_query(body), 2000)
    dense = port.query_phase(parse_query(body), 2000, collect_masks=True)
    f = {(d.segment_idx, d.docid): d.score for d in fast.docs}
    e = {(d.segment_idx, d.docid): d.score for d in dense.docs}
    assert set(f) == set(e), body
    for key in f:
        assert f[key] == pytest.approx(e[key], rel=8e-4, abs=1e-5), body
    assert fast.total_hits == dense.total_hits, body
    r = ref.query_phase(jax_parse(body), 50)
    got = port.query_phase(parse_query(body), 50)
    assert got.total_hits == r.total_hits
    assert_same_as_reference(got, r)


@pytest.mark.parametrize("body", CASES)
def test_conversion_on_equals_off(pair, body, monkeypatch):
    """Hits, order, scores and totals of the converted launch equal the
    unconverted launch's."""
    _, port = pair
    on = run(port, body, 100, monkeypatch)
    off = run(port, body, 100, monkeypatch, convert=False)
    assert addrs(on) == addrs(off)
    np.testing.assert_allclose(scores(on), scores(off), rtol=1e-6)
    assert on.total_hits == off.total_hits


@pytest.mark.parametrize("body", CASES)
def test_conversion_under_pruning(pair, body, monkeypatch):
    """track_total_hits 10 (pruning allowed, θ checked against the
    composed host mask): the hits are the exact run's, the total a lower
    bound, and the reference's pruned answer agrees."""
    ref, port = pair
    k = 12
    exact = run(port, body, k, monkeypatch, track_total_hits=True)
    pruned = run(port, body, k, monkeypatch, track_total_hits=10)
    off = run(port, body, k, monkeypatch, convert=False,
              track_total_hits=10)
    assert addrs(pruned) == addrs(exact) == addrs(off)
    np.testing.assert_allclose(scores(pruned), scores(exact), rtol=1e-6)
    assert pruned.total_hits <= exact.total_hits
    rp = ref.query_phase(jax_parse(body), k, track_total_hits=10)
    assert_same_as_reference(pruned, rp)


def test_pruning_engages_with_a_converted_filter(monkeypatch):
    """On a skewed corpus a converted FILTER no longer declines pruning
    (it is a host mask, not a launch group)."""
    from test_torch_prune import skewed_docs
    ref, port = searchers(skewed_docs())
    body = {"bool": {"must": [{"match": {"title": "alpha"}}],
                     "filter": [{"terms": {"tag": ["red", "green"]}}]}}
    exact = run(port, body, 10, monkeypatch)
    pruned = run(port, body, 10, monkeypatch, track_total_hits=10)
    assert pruned.total_lower_bound
    assert addrs(pruned) == addrs(exact)
    rp = ref.query_phase(jax_parse(body), 10, track_total_hits=10)
    assert rp.total_lower_bound == pruned.total_lower_bound
    assert_same_as_reference(pruned, rp)


def test_converted_groups_leave_the_launch(pair):
    _, port = pair
    ctx = port._contexts()[0]
    body = CASES[0]
    plan = compile_plan(parse_query(body).rewrite(port), port)
    bp = bind_plan(plan, ctx, 10)
    assert bp.n_converted == 1 and bp.shared_mask is not None
    assert bp.dense_mask is None and bp.host_masks
    assert bp.n_filter == 0
    # one real group (the match) in the launch; the rest are pads
    assert int((bp.group_req < tplan._NEVER).sum()) == 1
    # the unconverted bind sorts the filter's blocks too
    tplan.FILTER_CACHE_MIN_BLOCKS = NEVER
    try:
        full = bind_plan(plan, ctx, 10)
    finally:
        tplan.FILTER_CACHE_MIN_BLOCKS = 1
    assert full.n_converted == 0 and full.shared_mask is None
    assert sum(int(np.count_nonzero(st.sel_weight)) +
               int(np.count_nonzero(st.sel_blocks != st.sel_blocks[-1]))
               for st in full.streams) > \
        sum(int(np.count_nonzero(st.sel_weight)) +
            int(np.count_nonzero(st.sel_blocks != st.sel_blocks[-1]))
            for st in bp.streams)


@pytest.mark.parametrize("body,n_conv,n_filter", [
    ({"bool": {"filter": [{"term": {"tag": "red"}}]}}, 0, 1),
    ({"bool": {"filter": [{"term": {"tag": "red"}},
                          {"match": {"title": "alpha"}}]}}, 1, 1),
    ({"bool": {"must": [{"match": {"title": "alpha"}}],
               "filter": [{"term": {"tag": "red"}}],
               "must_not": [{"term": {"tag": "green"}}]}}, 2, 0),
    ({"bool": {"should": [{"match": {"title": "alpha"}}],
               "filter": [{"term": {"tag": "red"}}],
               "minimum_should_match": 0}}, 0, 1),
])
def test_one_enumerating_group_stays(pair, body, n_conv, n_filter):
    """A FILTER converts only while a MUST, a SHOULD under
    minimum_should_match or another FILTER enumerates; a MUST_NOT
    always may."""
    _, port = pair
    plan = compile_plan(parse_query(body).rewrite(port), port)
    assert plan is not None
    bp = bind_plan(plan, port._contexts()[0], 10)
    assert (bp.n_converted, bp.n_filter) == (n_conv, n_filter)


def test_masks_actually_cached(pair):
    """The reference's test_masks_actually_cached on the port."""
    _, port = pair
    body = {"bool": {"must": [{"match": {"title": "alpha"}}],
                     "filter": [{"term": {"tag": "red"}}]}}
    port.query_phase(parse_query(body), 10)
    dev = port.cache.get(port.segments[0])
    cached = len(dev._filter_masks)
    assert cached >= 1
    hits = dev.filter_mask_hits
    port.query_phase(parse_query(body), 10)
    assert len(dev._filter_masks) == cached
    # a repeat reuses its bound plan; a new query with the same filter
    # set hits the composed mask
    port.query_phase(parse_query({"bool": {
        "must": [{"match": {"title": "beta"}}],
        "filter": [{"term": {"tag": "red"}}]}}), 10)
    assert dev.filter_mask_hits > hits
    assert len(dev._filter_masks) == cached


def _charged_searcher(docs):
    svc = build_breaker_service({"indices.breaker.hbm.limit": "1gb"}.get)
    br = svc.get_breaker(CircuitBreaker.HBM)
    _, port = searchers(docs)
    cache = DeviceSegmentCache("cpu")
    cache.set_breaker(br)
    return ShardSearcher(port.segments, port.mapper, cache), cache, br


def test_breaker_charge_and_eviction(monkeypatch):
    """The composed mask is charged under filter_masks, the breaker
    equals the engine's bytes; with an LRU of one mask, a bound plan
    whose composed mask was evicted fetches (rebuilds and charges) it
    again at launch and answers the same."""
    port, cache, br = _charged_searcher(zipf_docs(1200, 3))
    body = CASES[0]
    first = port.query_phase(parse_query(body), 20, cache_key="a")
    dev = cache.get(port.segments[0])
    assert dev.hbm_bytes_by_class()["filter_masks"] > 0
    assert br.used == cache.hbm_stats()["total_bytes"]
    monkeypatch.setattr(tdevice, "FILTER_MASK_CACHE_MAX", 1)
    other = {"bool": {"must": [{"match": {"title": "beta"}}],
                      "filter": [{"term": {"tag": "green"}}]}}
    port.query_phase(parse_query(other), 20)
    assert len(dev._filter_masks) == 1
    assert br.used == cache.hbm_stats()["total_bytes"]
    evictions = dev.filter_mask_evictions
    again = port.query_phase(parse_query(body), 20, cache_key="a")
    assert dev.bound_plan_hits >= 1
    assert dev.filter_mask_evictions > evictions
    assert addrs(again) == addrs(first)
    np.testing.assert_array_equal(scores(again), scores(first))
    assert br.used == cache.hbm_stats()["total_bytes"]


def _one_window(searcher, bodies, k):
    """Every body from its own thread, all queued before any cohort
    launches (the batcher's launch slots held until then)."""
    batcher = searcher.batcher
    out = [None] * len(bodies)

    def call(i):
        out[i] = searcher.query_phase(parse_query(bodies[i]), k)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(bodies))]
    held = 0
    while batcher._launch_slots.acquire(blocking=False):
        held += 1
    try:
        for t in threads:
            t.start()
        while True:
            with batcher._lock:
                if sum(map(len, batcher._pending.values())) == len(bodies):
                    break
            time.sleep(0.001)
    finally:
        for _ in range(held):
            batcher._launch_slots.release()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("filters,launches", [
    ([["red"], ["red"], ["red"], ["red"]], 1),
    ([["red"], ["green"], ["red"], ["green"]], 2),
    ([["red"], ["blue", "red"], ["red", "blue"], ["green"]], 3),
])
def test_cohorts_key_on_the_filter_set(pair, filters, launches):
    """Bodies with different filter sets never share a launch's mask:
    the signature keys the (field, terms, negate) set, so each answers
    what it answers alone; bodies with one filter set share a cohort."""
    _, port = pair
    bodies = [{"bool": {"must": [{"match": {"title": w}}],
                        "filter": [{"terms": {"tag": f}}]}}
              for w, f in zip(["alpha", "beta", "wolf", "gamma"], filters)]
    solo = [port.query_phase(parse_query(b), 20) for b in bodies]
    batched = ShardSearcher(port.segments, port.mapper, port.cache)
    batched.batcher = PlanBatcher()
    out = _one_window(batched, bodies, 20)
    assert batched.batcher.stats()["launches"] == launches
    assert batched.batcher.stats()["batched_queries"] == len(bodies)
    for a, b in zip(out, solo):
        assert addrs(a) == addrs(b)
        np.testing.assert_array_equal(scores(a), scores(b))
        assert a.total_hits == b.total_hits


# ---------------------------------------------------------------------------
# REST on both nodes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("fconv")))
    node = Node(device="cpu")
    docs = zipf_docs(1500, 7)
    mappings = {"properties": {"title": {"type": "text"},
                               "tag": {"type": "keyword"}}}
    for c in (jax_node.rest_controller, node.rest_controller):
        assert c.dispatch("PUT", "/f", {}, {
            "settings": {"index": {"number_of_shards": 1}},
            "mappings": mappings})[0] == 200
        for lo, hi in ((0, 900), (900, 1500)):
            bulk = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                           + json.dumps(docs[i]) + "\n"
                           for i in range(lo, hi))
            st, r = c.dispatch("POST", "/f/_bulk", {"refresh": "true"},
                               bulk)
            assert st == 200 and not r["errors"], r
    yield jax_node, node
    node.close()
    jax_node.close()


@pytest.mark.parametrize("body", CASES)
def test_rest_as_the_reference(nodes, body):
    jax_node, node = nodes
    size = 15
    st, got = node.rest_controller.dispatch(
        "POST", "/f/_search", {}, {"query": body, "size": size})
    st2, ref = jax_node.rest_controller.dispatch(
        "POST", "/f/_search", {}, {"query": body, "size": size + 1})
    assert st == st2 == 200, (got, ref)
    assert_same_hits(got, ref, size)
    cache = node.device_cache
    assert cache.breaker.used == cache.hbm_stats()["total_bytes"]
