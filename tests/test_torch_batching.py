"""The port's PlanBatcher on the CPU: concurrent plan-path searches over
mixed selection widths (three NB coalescing tiers) coalesce into shared
launches and return, bit for bit, what single launches return; each
answer equals the reference searcher's on the same postings.

Tolerance against the reference: totals exact; scores rtol 1e-4; ids and
order compared with ``assert_same_hits`` of test_torch_node.py (the
reference sums float32 contributions through a global prefix, the port
per run, so a near tie may come out of the two in either order).
"""

import sys
import threading

import numpy as np
import pytest

from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter
from elasticsearch_tpu.search.context import \
    DeviceSegmentCache as JaxSegmentCache
from elasticsearch_tpu.search.queries import parse_query as jax_parse
from elasticsearch_tpu.search.searcher import ShardSearcher as JaxSearcher
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import segment_from_numpy
from elasticsearch_tpu_torch.search import batching
from elasticsearch_tpu_torch.search.batching import PlanBatcher, _Entry
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.plan import bind_plan, compile_plan
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import ShardSearcher
from test_torch_node import assert_same_hits

MAPPINGS = {"properties": {"title": {"type": "text"},
                           "tag": {"type": "keyword"}}}
COMMON = ["ant", "bee", "cat", "dog"]
K = 20


def rare(lo, hi):
    return " ".join(f"r{i}" for i in range(lo, hi))


# a common term has 7 postings blocks, a rare one (3 in 4 of them
# occur) 1: one to four common terms or 40 rare ones bind 8-64 blocks
# (tier 64), 100 rare ones 128 (tier 256), 420 rare ones 512 (tier 1024). Few postings per block keep
# the reference's float32 prefix sums within the tolerance.
BODIES = [
    {"match": {"title": "ant"}},
    {"match": {"title": "ant bee"}},
    {"match": {"title": rare(0, 40)}},
    {"match": {"title": rare(100, 200)}},
    {"match": {"title": "ant bee cat dog " + rare(200, 260)}},
    {"match": {"title": rare(0, 420)}},
    {"bool": {"must": [{"match": {"title": "cat"}}],
              "filter": [{"term": {"tag": "a"}}]}},
    {"bool": {"should": [{"match": {"title": "ant " + rare(50, 140)}},
                         {"match": {"title": "dog"}}],
              "must_not": [{"term": {"tag": "b"}}]}},
    {"multi_match": {"query": "dog " + rare(300, 330),
                     "fields": ["title"]}},
    {"match": {"title": {"query": rare(400, 820),
                         "minimum_should_match": 2}}},
]


@pytest.fixture(scope="module")
def searchers():
    rng = np.random.default_rng(3)
    svc = MapperService(mappings=MAPPINGS)
    w = SegmentWriter()
    for i in range(2000):
        words = list(rng.choice(COMMON, 2)) + \
            [f"r{j}" for j in rng.integers(0, 4000, 3)]
        w.add(svc.parse(str(i), {"title": " ".join(words),
                                 "tag": str(rng.choice(["a", "b"]))}))
    seg = w.build("b0")
    ref = JaxSearcher([seg], svc, JaxSegmentCache())
    fields = {}
    for f in ("title", "tag"):
        pf = seg.postings[f]
        fields[f] = {a: np.asarray(getattr(pf, a)) for a in (
            "doc_freq", "total_term_freq", "term_block_start",
            "term_block_count", "block_docids", "block_tfs",
            "field_lengths")}
        fields[f]["terms"] = list(pf.terms)
    port_seg = segment_from_numpy({"fields": fields,
                                   "ids": list(seg.stored.ids)}, name="b0")
    port = ShardSearcher([port_seg], DocumentMapper(MAPPINGS),
                         DeviceSegmentCache("cpu"))
    return ref, port


def rows(res):
    return [(d.segment_idx, d.docid, d.score) for d in res.docs], \
        res.total_hits


def as_hits(res):
    return {"hits": {"total": {"value": res.total_hits, "relation": "eq"},
                     "hits": [{"_id": str(d.docid), "_score": d.score}
                              for d in res.docs]}}


def test_bodies_span_three_tiers(searchers):
    _, port = searchers
    ctx = port._contexts()[0]
    tiers = set()
    for body in BODIES:
        bp = bind_plan(compile_plan(parse_query(body), port), ctx)
        tiers.update(batching._nb_tier(int(st.sel_blocks.shape[0]))
                     for st in bp.streams)
    assert tiers == {64, 256, 1024}


def test_concurrent_cohorts_equal_single_launches_and_reference(searchers):
    ref, port = searchers
    port.batcher = None
    solo = [rows(port.query_phase(parse_query(b), K)) for b in BODIES]
    for body, (docs, total) in zip(BODIES, solo):
        r = ref.query_phase(jax_parse(body), K + 1)
        got = port.query_phase(parse_query(body), K)
        assert total == r.total_hits > 0
        assert_same_hits(as_hits(got), as_hits(r), K)

    batcher = PlanBatcher()
    for i, got in enumerate(run_threads(port, batcher)):
        assert got == solo[i % len(BODIES)], i
    st = batcher.stats()
    assert st["batched_queries"] == 3 * len(BODIES)
    assert 1 <= st["launches"] <= 3 * len(BODIES)


def run_threads(port, batcher):
    """Each body three times from as many threads, through ``batcher``:
    the (rows, total) of each thread's answer."""
    port.batcher = batcher
    n_threads = 3 * len(BODIES)          # more threads than cores
    results = [None] * n_threads
    errors = []

    def run(i):
        try:
            results[i] = rows(port.query_phase(
                parse_query(BODIES[i % len(BODIES)]), K))
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        port.batcher = None
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


def test_lane_limit_admits_cohorts_in_turn(monkeypatch):
    """A cohort waits while the lanes in flight and its own would pass
    MAX_LANES_IN_FLIGHT; one wider than the limit runs alone."""
    monkeypatch.setattr(batching, "MAX_LANES_IN_FLIGHT", 1000)
    batcher = PlanBatcher()
    batcher._acquire_lanes(800)
    admitted = threading.Event()

    def second():
        batcher._acquire_lanes(300)
        admitted.set()

    t = threading.Thread(target=second)
    t.start()
    assert not admitted.wait(0.2)
    batcher._release_lanes(800)
    assert admitted.wait(10)
    t.join()
    batcher._release_lanes(300)
    batcher._acquire_lanes(5000)         # alone: admitted at once
    batcher._release_lanes(5000)
    st = batcher.stats()
    assert st["admission_waits"] == 1
    assert st["peak_lanes_in_flight"] == 5000


def test_concurrent_cohorts_under_a_tight_lane_limit(searchers, monkeypatch):
    """With room for one tier-64 query at a time, cohorts launch in
    chunks within the limit (a query wider than it alone), the threads'
    answers still equal single launches, and the lanes in flight never
    pass the limit but by a query that ran alone."""
    _, port = searchers
    port.batcher = None
    solo = [rows(port.query_phase(parse_query(b), K)) for b in BODIES]
    limit = 64 * 128
    monkeypatch.setattr(batching, "MAX_LANES_IN_FLIGHT", limit)
    batcher = PlanBatcher()
    launched = []
    lanes_of = batcher._lanes

    def lanes(batch):
        n = lanes_of(batch)
        launched.append((len(batch), n))
        return n

    monkeypatch.setattr(batcher, "_lanes", lanes)
    for i, got in enumerate(run_threads(port, batcher)):
        assert got == solo[i % len(BODIES)], i
    st = batcher.stats()
    assert st["batched_queries"] == 3 * len(BODIES)
    assert all(n <= limit or q == 1 for q, n in launched), launched
    assert st["peak_lanes_in_flight"] <= max(
        [limit] + [n for q, n in launched if q == 1])


def test_chunks_fit_the_lane_limit(searchers, monkeypatch):
    """A cohort of 32 tier-64 plans launches 32 at a time under the
    default limit, and in chunks of the largest power of two that fits
    under a tight one."""
    _, port = searchers
    ctx = port._contexts()[0]
    bp = bind_plan(compile_plan(parse_query(BODIES[2]), port), ctx)
    batch = [_Entry(bp) for _ in range(32)]
    row = PlanBatcher._row_lanes(batch)
    assert row == 32 * 128
    assert PlanBatcher._chunk(batch) == 32
    monkeypatch.setattr(batching, "MAX_LANES_IN_FLIGHT", 5 * row)
    assert PlanBatcher._chunk(batch) == 4
    monkeypatch.setattr(batching, "MAX_LANES_IN_FLIGHT", row - 1)
    assert PlanBatcher._chunk(batch) == 1


def test_mixed_widths_of_one_tier_share_a_cohort(searchers):
    """Two plans bound to different widths of one tier (8 and 32
    blocks) share a signature; their padded cohort returns exactly what
    each returns alone."""
    _, port = searchers
    ctx = port._contexts()[0]
    bps = [bind_plan(compile_plan(parse_query(b), port), ctx)
           for b in (BODIES[0], BODIES[2])]
    assert [int(bp.streams[0].sel_blocks.shape[0]) for bp in bps] == \
        [8, 32]
    batcher = PlanBatcher()
    sigs = {batcher._signature(bp, ctx, K, port.k1, port.b) for bp in bps}
    assert len(sigs) == 1
    solo = [batcher.execute(bp, ctx, K, port.k1, port.b) for bp in bps]
    entries = [_Entry(bp) for bp in bps]
    batcher._run(entries, ctx, K, port.k1, port.b)
    assert batcher.stats()["launches"] == 3
    assert batcher.stats()["batch_hist"] == {"1": 2, "2": 1}
    for e, (v, i, t) in zip(entries, solo):
        gv, gi, gt = e.result
        assert gt == t
        np.testing.assert_array_equal(gi, i)
        np.testing.assert_array_equal(gv, v)
