"""The dense executor on the card against the same calls on the CPU.

One seeded logs-shaped corpus (``corpus.py`` ``build_corpus``,
``with_incident_terms`` and ``logs_columns``) as one segment on each
device: the dense scorer (``bm25_dense_scores_sorted``, whose gather and
contribution launch the contribution kernel on the card) and
``masked_topk`` (ties at the kth key) equal their CPU runs; then whole
dense bodies and plan bodies with dense factors through
``ShardSearcher``, under field sorts, ``search_after`` and
``min_score``: ids, order, totals and sort values equal, scores within
rtol 1e-6 (the same float32 operations, sorts and selections on both
devices)."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.corpus import (LOGS_MAPPINGS, LOGS_T0_MS,
                                            build_corpus, logs_columns,
                                            segment_from_corpus, term_name,
                                            with_incident_terms)
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.ops import plan as plan_ops
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.ops.topk import masked_topk
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import ShardSearcher

pytestmark = pytest.mark.cuda

RTOL = 1e-6
N_DOCS, VOCAB = 60000, 3000
HOUR = 3_600_000


@pytest.fixture(scope="module")
def logs():
    rng = np.random.default_rng(21)
    corpus = with_incident_terms(build_corpus(rng, N_DOCS, VOCAB),
                                 np.random.default_rng(22))
    seg = segment_from_corpus(corpus, name="logs_cuda",
                              numerics=logs_columns(
                                  N_DOCS, np.random.default_rng(23)))
    return corpus, seg


def test_dense_scorer_launches_the_kernel(cuda_device, logs):
    corpus, seg = logs
    cuda = DeviceSegmentCache(cuda_device).get(seg)
    cpu = DeviceSegmentCache("cpu").get(seg)
    tid = VOCAB + int(np.argmax(corpus["nb"][VOCAB:]))
    out = []
    before = gather_bm25_contrib.launches
    for dev in (cuda, cpu):
        dp = dev.postings["title"]
        sel, ws = dp.select_blocks([tid, 7, tid], [1.3, 0.8, 1.3])
        out.append(plan_ops.bm25_dense_scores_sorted(
            dp.block_docids, dp.block_tfs, sel, ws, dp.doc_lens,
            dp.avg_len, 1.2, 0.75, max_run=32,
            mask_row=dev.all_docs_row).cpu())
    assert gather_bm25_contrib.launches == before + 1
    assert torch.equal(out[0] > 0, out[1] > 0) and (out[1] > 0).any()
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("k", [10, 500, 4000])
def test_masked_topk_ties_on_the_card(cuda_device, k):
    rng = np.random.default_rng(k)
    scores = torch.from_numpy(rng.integers(0, 4, 300000).astype(np.float32))
    mask = torch.from_numpy(rng.random(300000) < 0.3)
    v0, i0 = masked_topk(scores.to(cuda_device), mask.to(cuda_device), k)
    v1, i1 = masked_topk(scores, mask, k)
    assert torch.equal(v0.cpu(), v1) and torch.equal(i0.cpu(), i1)


def iso(ms):
    import datetime as dt
    t = dt.datetime.fromtimestamp(ms // 1000, tz=dt.timezone.utc)
    return t.strftime("%Y-%m-%dT%H:%M:%S.") + f"{ms % 1000:03d}Z"


def bodies():
    t_inc = term_name(VOCAB)
    lo, hi = LOGS_T0_MS + 3 * HOUR, LOGS_T0_MS + 5 * HOUR
    rng = {"range": {"@timestamp": {"gte": iso(lo), "lt": iso(hi)}}}
    return [
        ({"range": {"@timestamp": {"gte": iso(lo), "lt": iso(hi)}}}, {}),
        ({"bool": {"filter": [rng]}}, {"sort": [{"@timestamp": "desc"}]}),
        ({"match_all": {}}, {"sort": [{"@timestamp": "asc"}]}),
        ({"match_all": {}}, {"sort": [{"@timestamp": "desc"}],
                             "search_after": [float(hi)]}),
        ({"match_all": {}}, {"sort": [{"bytes": "asc"}, "_doc"]}),
        ({"exists": {"field": "bytes"}}, {}),
        ({"bool": {"must_not": [{"term": {"status": 200}}]}}, {}),
        ({"boosting": {"positive": {"match": {"title": t_inc}},
                       "negative": {"range": {"status": {"gte": 500}}},
                       "negative_boost": 0.5}}, {}),
        ({"dis_max": {"queries": [{"match": {"title": t_inc}},
                                  {"range": {"bytes": {"gte": 50000}}}],
                      "tie_breaker": 0.2}}, {}),
        ({"ids": {"values": ["5", "77", "40000", "x"]}}, {}),
        ({"match": {"title": t_inc}}, {"min_score": 1.0}),
        ({"bool": {"must": [{"match": {"title": t_inc}}],
                   "filter": [{"term": {"status": 500}}]}}, {}),
        ({"bool": {"must": [{"match": {"title": f"{t_inc} t000012"}}],
                   "filter": [rng]}}, {}),
    ]


@pytest.mark.parametrize("size", [10, 600])
def test_dense_bodies_card_equals_cpu(cuda_device, logs, size):
    _, seg = logs
    mapper = DocumentMapper(LOGS_MAPPINGS)
    card = ShardSearcher([seg], mapper, DeviceSegmentCache(cuda_device))
    cpu = ShardSearcher([seg], mapper, DeviceSegmentCache("cpu"))
    for query, kw in bodies():
        for allow_plan in (True, False):
            a = card.query_phase(parse_query(query), size,
                                 allow_plan=allow_plan, **kw)
            b = cpu.query_phase(parse_query(query), size,
                                allow_plan=allow_plan, **kw)
            assert a.total_hits == b.total_hits, query
            assert [(d.docid, d.sort_values) for d in a.docs] == \
                [(d.docid, d.sort_values) for d in b.docs], query
            np.testing.assert_allclose([d.score for d in a.docs],
                                       [d.score for d in b.docs],
                                       rtol=RTOL, atol=0)
