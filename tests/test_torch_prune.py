"""Block-max window pruning on the port's plan path
(elasticsearch_tpu_torch/search/plan.py ``_prune_fields``, reached under
``track_total_hits`` other than true) against the reference's, on the
cases of tests/test_plan_prune.py, through both packages' searchers and
REST. The thresholds are lowered on both sides (PRUNE_MIN_BLOCKS = 4;
the reference's FILTER_CACHE_MIN_BLOCKS = 1, so its filters are the host
masks the port builds for its own FILTER groups) so small corpora prune.

- Pruned top k exact: the same ids and order as the exact run, scores
  bit-equal to it (a surviving doc keeps all its postings), and equal to
  the reference's pruned run (scores within rtol 1e-4, the plan path's
  tolerance: the reference's float32 global prefix sums drift; the same
  docs in each group of scores equal within it); totals a lower bound,
  equal to the reference's when the query has no filter group (the
  port's FILTER groups run in the launch, the reference's are dense
  masks, so a pruned filter block can lower the port's count further).
- Pruning engages on a skewed corpus, and on every incident term of the
  corpus generator's docs as time-ordered logs around an incident
  (whose top k is then the float64 oracle's); exact totals forbid it; REST
  reports relation "gte" when it ran or a threshold clamps; false omits
  ``hits.total``; and a pruned bind is never served to an exact ask.
"""

import json

import numpy as np
import pytest

import elasticsearch_tpu.search.plan as jplan
from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.search.context import \
    DeviceSegmentCache as JaxDeviceSegmentCache
from elasticsearch_tpu.search.queries import parse_query as jax_parse
from elasticsearch_tpu.search.searcher import ShardSearcher as JaxSearcher
from elasticsearch_tpu_torch.corpus import (build_corpus, exact_topk,
                                            segment_from_corpus, term_name,
                                            with_incident_terms)
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search import batching
from elasticsearch_tpu_torch.search import plan as tplan
from elasticsearch_tpu_torch.search.batching import PlanBatcher
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import ShardSearcher

MAPPINGS = {"properties": {"title": {"type": "text"},
                           "tag": {"type": "keyword"}}}
VOCAB = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta",
         "wolf", "fox", "dog", "cat"]
TAGS = ["red", "green", "blue"]


@pytest.fixture(autouse=True)
def low_thresholds(monkeypatch):
    monkeypatch.setattr(jplan, "FILTER_CACHE_MIN_BLOCKS", 1)
    monkeypatch.setattr(jplan, "PRUNE_MIN_BLOCKS", 4)
    monkeypatch.setattr(tplan, "PRUNE_MIN_BLOCKS", 4)


def zipf_docs(n_docs, seed):
    """tests/test_plan_prune.py build_searcher's docs: Zipf-ish titles so
    block maxima vary across the docid space."""
    rng = np.random.default_rng(seed)
    p = np.arange(len(VOCAB), 0, -1.0)
    p /= p.sum()
    return [{"title": " ".join(rng.choice(VOCAB, int(rng.integers(2, 12)),
                                          p=p)),
             "tag": str(rng.choice(TAGS))} for _ in range(n_docs)]


def skewed_docs(n_docs=1600, seed=11):
    """tests/test_plan_prune.py build_skewed_searcher's docs: high-tf
    docs in the first docid region."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_docs):
        if i < n_docs // 8:
            title = " ".join(["alpha"] * int(rng.integers(6, 12))
                             + list(rng.choice(VOCAB, 3)))
        else:
            title = " ".join(rng.choice(VOCAB, int(rng.integers(4, 9))))
        out.append({"title": title, "tag": str(rng.choice(TAGS))})
    return out


def searchers(docs):
    jm, pm = MapperService(mappings=MAPPINGS), DocumentMapper(MAPPINGS)
    jw, pw = JaxWriter(), SegmentWriter()
    for i, d in enumerate(docs):
        jw.add(jm.parse(str(i), d))
        pw.add(pm.parse(str(i), d))
    return (JaxSearcher([jw.build("s0")], jm, JaxDeviceSegmentCache()),
            ShardSearcher([pw.build("s0")], pm, DeviceSegmentCache("cpu")))


def addrs(r):
    return [(d.segment_idx, d.docid) for d in r.docs]


def assert_same_as_reference(got, ref, rtol=1e-4):
    """Scores within ``rtol`` and the same docs in each group of scores
    that agree within it (the reference ranks float32 sums, so a true tie
    can come out of it in another order); the last group may be cut by
    k differently on the two sides."""
    gs, rs = scores(got), scores(ref)
    np.testing.assert_allclose(gs, rs, rtol=rtol, atol=0)
    ga, ra = addrs(got), addrs(ref)
    i = 0
    while i < len(rs):
        j = i + 1
        while j < len(rs) and abs(rs[j] - rs[i]) <= rtol * rs[i]:
            j += 1
        if j < len(rs):
            assert set(ga[i:j]) == set(ra[i:j]), (i, j)
        i = j


def scores(r):
    return np.array([d.score for d in r.docs])


BODIES = [
    {"match": {"title": "alpha beta wolf"}},
    {"match": {"title": "alpha"}},
    {"multi_match": {"query": "wolf cat", "fields": ["title"],
                     "type": "most_fields"}},
    {"bool": {"must": [{"match": {"title": "alpha gamma"}}],
              "filter": [{"term": {"tag": "red"}}]}},
]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("body", BODIES)
def test_pruned_topk_is_exact(body, seed):
    ref, port = searchers(zipf_docs(1500, seed))
    k = 12
    exact = port.query_phase(parse_query(body), k, track_total_hits=True)
    pruned = port.query_phase(parse_query(body), k, track_total_hits=10)
    assert addrs(pruned) == addrs(exact), body
    np.testing.assert_array_equal(scores(pruned), scores(exact))
    assert not exact.total_lower_bound
    assert pruned.total_hits <= exact.total_hits
    if pruned.total_lower_bound:
        assert pruned.total_hits >= k
    rp = ref.query_phase(jax_parse(body), k, track_total_hits=10)
    assert_same_as_reference(pruned, rp)
    assert pruned.total_lower_bound == rp.total_lower_bound
    if "filter" not in str(body):
        assert pruned.total_hits == rp.total_hits


def test_pruning_engages_on_skewed_corpus():
    ref, port = searchers(skewed_docs())
    q = {"match": {"title": "alpha"}}
    exact = port.query_phase(parse_query(q), 10, track_total_hits=True)
    pruned = port.query_phase(parse_query(q), 10, track_total_hits=10)
    assert pruned.total_lower_bound, "pruning should engage here"
    assert pruned.total_hits < exact.total_hits
    assert addrs(pruned) == addrs(exact)
    np.testing.assert_array_equal(scores(pruned), scores(exact))
    rp = ref.query_phase(jax_parse(q), 10, track_total_hits=10)
    assert rp.total_lower_bound and rp.total_hits == pruned.total_hits
    assert_same_as_reference(pruned, rp)


@pytest.mark.parametrize("k", [10, 100])
def test_pruning_engages_on_incident_corpus(k):
    """The corpus generator's docs as time-ordered logs around an
    incident (corpus.py ``with_incident_terms``, the data of
    chip_smoke.py's pruning phase): every incident term's bind prunes,
    and the pruned top k is the exact run's, which is the float64
    oracle's (ids exact, scores within rtol 1e-5: the plan path sums in
    float32)."""
    c = with_incident_terms(
        build_corpus(np.random.default_rng(4), n_docs=20000, vocab=2000),
        np.random.default_rng(9))
    srch = ShardSearcher([segment_from_corpus(c)],
                         DocumentMapper({"properties": {"title":
                                                        {"type": "text"}}}),
                         DeviceSegmentCache("cpu"))
    for t in range(2000, len(c["df"])):
        q = parse_query({"match": {"title": term_name(t)}})
        exact = srch.query_phase(q, k, track_total_hits=True)
        pruned = srch.query_phase(q, k, track_total_hits=10000)
        assert pruned.total_lower_bound, t
        assert pruned.total_hits < exact.total_hits
        assert [d.docid for d in pruned.docs] == [d.docid for d in exact.docs]
        np.testing.assert_array_equal(scores(pruned), scores(exact))
        ids, sc, total = exact_topk(c, [t], k)
        assert exact.total_hits == total
        assert [d.docid for d in exact.docs] == ids.tolist()
        np.testing.assert_allclose(scores(exact), sc, rtol=1e-5, atol=0)


def test_exact_totals_forbid_pruning():
    _, port = searchers(zipf_docs(1500, 5))
    q = parse_query({"match": {"title": "alpha beta"}})
    exact = port.query_phase(q, 10, track_total_hits=True)
    assert not exact.total_lower_bound
    again = port.query_phase(q, 10, track_total_hits=True)
    assert again.total_hits == exact.total_hits


def test_pruned_bind_never_served_to_an_exact_ask():
    """The bound-plan cache keys on allow_prune: a pruned bind cached
    for a threshold ask is not reused by an exact ask of the same query
    and k, and a PlanBatcher cohort holding both answers each right."""
    _, port = searchers(skewed_docs())
    port.batcher = PlanBatcher()
    q = {"match": {"title": "alpha"}}
    key = '{"match": {"title": "alpha"}}'
    pruned = port.query_phase(parse_query(q), 10, cache_key=key,
                              track_total_hits=10)
    exact = port.query_phase(parse_query(q), 10, cache_key=key)
    assert pruned.total_lower_bound and not exact.total_lower_bound
    assert exact.total_hits > pruned.total_hits
    assert len(port.cache.get(port.segments[0])._bound_plans) == 2
    ctx = port._contexts()[0]
    plan = tplan.compile_plan(parse_query(q), port)
    bps = [tplan.bind_plan(plan, ctx, 10, allow) for allow in (True, False)]
    assert bps[0].pruned and not bps[1].pruned
    batcher = PlanBatcher()
    entries = [batching._Entry(bp) for bp in bps]
    batcher._run(entries, ctx, 10, port.k1, port.b)
    assert entries[0].result[2] == pruned.total_hits
    assert entries[1].result[2] == exact.total_hits
    np.testing.assert_array_equal(entries[0].result[1], entries[1].result[1])


@pytest.mark.parametrize("threshold", [7, 10000])
def test_rest_relation_gte(threshold):
    """Through REST on a small index (tests/test_plan_prune.py's 50 docs
    of "alpha wolf"): a threshold below the count clamps the total
    (relation "gte"); one above it keeps it exact, as the reference."""
    node = Node(device="cpu")
    try:
        c = node.rest_controller
        assert c.dispatch("PUT", "/t", {}, {"mappings": MAPPINGS})[0] == 200
        bulk = "".join(
            f'{{"index": {{"_id": "{i}"}}}}\n'
            f'{{"title": "alpha wolf", "tag": "red"}}\n' for i in range(50))
        assert c.dispatch("POST", "/t/_bulk", {"refresh": "true"},
                          bulk)[0] == 200
        st, r = c.dispatch("POST", "/t/_search", {},
                           {"query": {"match": {"title": "alpha"}}})
        assert st == 200
        assert r["hits"]["total"] == {"value": 50, "relation": "eq"}
        # a term query is outside the fast grammar: the plan path
        st, r = c.dispatch("POST", "/t/_search", {}, {
            "query": {"term": {"title": "alpha"}},
            "track_total_hits": threshold})
        assert st == 200
        want = ({"value": 7, "relation": "gte"} if threshold == 7 else
                {"value": 50, "relation": "eq"})
        assert r["hits"]["total"] == want
    finally:
        node.close()


def test_rest_pruned_total_is_gte():
    """A plan-path body on the skewed corpus with a threshold above the
    count: pruning ran, so the total is a lower bound ("gte"), and the
    hits are the exact ones."""
    node = Node(device="cpu")
    try:
        c = node.rest_controller
        c.dispatch("PUT", "/s", {}, {"mappings": MAPPINGS})
        bulk = "".join(f'{{"index": {{"_id": "{i}"}}}}\n'
                       + json.dumps(d) + "\n"
                       for i, d in enumerate(skewed_docs()))
        assert c.dispatch("POST", "/s/_bulk", {"refresh": "true"},
                          bulk)[0] == 200
        body = {"query": {"match": {"title": {"query": "alpha",
                                              "boost": 1.0}}}, "size": 10}
        st, exact = c.dispatch("POST", "/s/_search", {}, body)
        st2, pruned = c.dispatch("POST", "/s/_search", {},
                                 dict(body, track_total_hits=100000))
        assert st == st2 == 200
        assert exact["hits"]["total"]["relation"] == "eq"
        assert pruned["hits"]["total"]["relation"] == "gte"
        assert pruned["hits"]["total"]["value"] < \
            exact["hits"]["total"]["value"]
        assert pruned["hits"]["hits"] == exact["hits"]["hits"]
    finally:
        node.close()


def test_track_total_hits_false_omits_total():
    node = Node(device="cpu")
    try:
        c = node.rest_controller
        c.dispatch("PUT", "/t", {}, {
            "mappings": {"properties": {"m": {"type": "text"}}}})
        c.dispatch("POST", "/t/_bulk", {"refresh": "true"},
                   '{"index": {"_id": "1"}}\n{"m": "x y"}\n')
        st, r = c.dispatch("POST", "/t/_search", {},
                           {"query": {"match": {"m": "x"}},
                            "track_total_hits": False})
        assert st == 200
        assert "total" not in r["hits"]
        assert len(r["hits"]["hits"]) == 1
    finally:
        node.close()
