"""The fetch and sort slice on the card against the same calls on the CPU.

- The keyword sort column (``DeviceSegment.keyword_ord_column``) and the
  keyword cursor's masks (``_keyword_after_masks``) equal their CPU
  builds, and keyword-sorted query phases over two segments (a term in
  one of them only, docs without a value) answer the CPU's ids, order
  and sort values.
- A plan cohort whose FILTER and MUST_NOT groups convert into the
  cached composed mask answers what the unconverted launches answer, on
  the card and on the CPU, with conversion on and off.
- The bytes the column and the composed mask are charged equal what
  ``memory_allocated()`` grows by, within the caching allocator's
  rounding (512 B a tensor).
"""

import gc
import threading
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.corpus import (bench_cat, build_corpus,
                                            keyword_postings,
                                            segment_from_corpus, term_name)
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.search import plan as tplan
from elasticsearch_tpu_torch.search.batching import PlanBatcher
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    SegmentContext,
                                                    ShardStats)
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import (ShardSearcher,
                                                     _keyword_after_masks)

pytestmark = pytest.mark.cuda

N_DOCS, VOCAB = 40000, 2000
MAPPINGS = {"properties": {"title": {"type": "text"},
                           "cat": {"type": "keyword"}}}


def _segments():
    """Two segments of one corpus each, with the bench's skewed ``cat``
    keyword (every 11th doc without one); the second segment also holds
    a term of its own, "zz-only"."""
    segs = []
    for i, seed in enumerate((41, 42)):
        corpus = build_corpus(np.random.default_rng(seed), N_DOCS, VOCAB)
        ords, terms = bench_cat(N_DOCS, seed=seed)
        ords = ords.copy()
        ords[::11] = -1
        if i == 1:
            terms = terms + ["zz-only"]
            ords[5::97] = len(terms) - 1
        segs.append(segment_from_corpus(
            corpus, name=f"kw{i}",
            keywords={"cat": {"ords": ords, "terms": terms}},
            fields={"cat": keyword_postings(ords, terms)}))
    return segs


@pytest.fixture(scope="module")
def segs():
    return _segments()


def _searchers(segs, device):
    return ShardSearcher(segs, DocumentMapper(MAPPINGS),
                         DeviceSegmentCache(device))


def test_keyword_column_and_masks_equal_the_cpu(cuda_device, segs):
    gpu, cpu = _searchers(segs, cuda_device), _searchers(segs, "cpu")
    for g, c in zip(gpu._contexts(), cpu._contexts()):
        gcol, gmiss = g.keyword_ord_column("cat")
        ccol, cmiss = c.keyword_ord_column("cat")
        assert gcol.device.type == cuda_device.type
        assert torch.equal(gcol.cpu(), ccol) and torch.equal(gmiss.cpu(),
                                                             cmiss)
        for term in ("c000", "c250", "c499", "zz-only", "m", None):
            for order in ("asc", "desc"):
                gs, gt = _keyword_after_masks(g, "cat", term, order)
                cs, ct = _keyword_after_masks(c, "cat", term, order)
                assert torch.equal(gs.cpu(), cs), (term, order)
                assert torch.equal(gt.cpu(), ct), (term, order)


@pytest.mark.parametrize("body", [
    {"sort": [{"cat": "asc"}]},
    {"sort": [{"cat": "desc"}]},
    {"sort": [{"cat": "asc"}], "search_after": ["zz-only"]},
    {"sort": [{"cat": "desc"}], "search_after": ["c100"]},
    {"sort": [{"cat": "asc"}, "_doc"], "search_after": ["c003", 500]},
    {"query": {"match": {"title": term_name(3)}},
     "sort": [{"cat": "desc"}]},
])
def test_keyword_sorted_query_phase_equals_the_cpu(cuda_device, segs, body):
    gpu, cpu = _searchers(segs, cuda_device), _searchers(segs, "cpu")
    q = body.get("query", {"match_all": {}})
    out = []
    for s in (gpu, cpu):
        r = s.query_phase(parse_query(q), 300, sort=body["sort"],
                          search_after=body.get("search_after"))
        out.append([(d.segment_idx, d.docid, d.sort_values)
                    for d in r.docs] + [r.total_hits])
    assert out[0] == out[1]


FILTERED = [
    {"bool": {"must": [{"match": {"title": term_name(t)}}],
              "filter": [{"term": {"cat": "c000"}}]}} for t in (1, 5, 9)
] + [
    {"bool": {"must": [{"match": {"title": term_name(t)}}],
              "must_not": [{"terms": {"cat": ["c000", "c001"]}}]}}
    for t in (2, 7)
]


def _one_window(searcher, bodies, k):
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
        t.join(timeout=120)
    return out


def test_converted_cohort_equals_unconverted(cuda_device, segs, monkeypatch):
    rows = {}
    for device in (cuda_device, "cpu"):
        for convert in (True, False):
            monkeypatch.setattr(tplan, "FILTER_CACHE_MIN_BLOCKS",
                                8 if convert else 1 << 40)
            s = _searchers(segs[:1], device)
            s.batcher = PlanBatcher()
            out = _one_window(s, FILTERED, 100)
            rows[(str(device), convert)] = [
                ([(d.docid) for d in r.docs],
                 np.array([d.score for d in r.docs]), r.total_hits)
                for r in out]
            if convert:
                # two filter sets: never one cohort
                assert s.batcher.stats()["launches"] >= 2
    base = rows[("cpu", False)]
    for key, got in rows.items():
        for (ids, sc, tot), (bids, bsc, btot) in zip(got, base):
            assert ids == bids and tot == btot, key
            np.testing.assert_allclose(sc, bsc, rtol=1e-6)


def settled():
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def test_charged_bytes_equal_memory_allocated(cuda_device, segs):
    cache = DeviceSegmentCache(cuda_device)
    seg = segs[1]
    dev = cache.get(seg)
    ctx = SegmentContext(seg, dev, DocumentMapper(MAPPINGS),
                         ShardStats([seg]))
    before, cls0 = settled(), dev.hbm_bytes_by_class()
    col, miss = ctx.keyword_ord_column("cat")
    grown = settled() - before
    charged = dev.hbm_bytes_by_class()["ordinals"] - cls0["ordinals"]
    assert charged == int(col.nbytes + miss.nbytes)
    assert 0 <= grown - charged <= 2 * 512
    before = settled()
    mask, _host = dev.composed_filter_mask(
        [("cat", ["c000"], False), ("cat", ["c001", "c002"], True)])
    grown = settled() - before
    charged = dev.hbm_bytes_by_class()["filter_masks"] - \
        cls0["filter_masks"]
    # the composition and its two parts are cached, each charged
    assert charged == 3 * int(mask.nbytes)
    assert 0 <= grown - charged <= 3 * 512
    assert cache.hbm_stats()["total_bytes"] == dev.hbm_bytes()
