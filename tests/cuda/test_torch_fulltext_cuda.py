"""The full-text query breadth on the card against the same calls on the
CPU.

One seeded corpus (``corpus.py`` ``build_corpus`` with its token
streams, ``rank_feature_columns`` for a ``rank_features`` field) as one
segment on each device: the conjunction filter (``conjunction_mask``)
and the feature plane's weighted sum (``feature_plane_sum``) equal
their CPU runs (the sum to float32 rounding: both devices within rtol
1e-5 of its float64 value); fuzzy's weighted launch runs the
contribution kernel on the card (its ``.launches`` grows by one) and
equals the kernel's plain twin on the CPU; then whole bodies of every
new query type through ``ShardSearcher``: totals equal, ids and order
equal and scores within rtol 1e-6, except text_expansion's float32 sums,
held by the tie-aware rule (scores rtol 1e-5, ids equal above the kth
score's ties)."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.corpus import (build_corpus, corpus_streams,
                                            rank_feature_columns,
                                            segment_from_corpus, term_name)
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.ops import bm25 as bm25_ops
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.ops.features import feature_plane_sum
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import ShardSearcher

pytestmark = pytest.mark.cuda

RTOL = 1e-6
F32_RTOL = 1e-5   # a float32 sum reduced in another order
N_DOCS, VOCAB = 50000, 2000
MAPPINGS = {"properties": {"title": {"type": "text"},
                           "views": {"type": "long"},
                           "ml": {"properties": {"tokens": {
                               "type": "rank_features"}}}}}


@pytest.fixture(scope="module")
def corpus_seg():
    corpus = build_corpus(np.random.default_rng(31), N_DOCS, VOCAB)
    numerics = rank_feature_columns(N_DOCS, np.random.default_rng(32),
                                    n_keys=32, per_doc=6)
    numerics["views"] = {"values": np.random.default_rng(33).integers(
        0, 100, N_DOCS).astype(np.float64)}
    seg = segment_from_corpus(corpus, name="ft_cuda", numerics=numerics,
                              streams=corpus_streams(corpus))
    return corpus, seg


def _phrase(corpus, seg, doc, start, n):
    row = seg.streams["title"].tokens[doc]
    return " ".join(term_name(int(t)) for t in row[start:start + n])


def test_conjunction_mask_on_the_card(cuda_device, corpus_seg):
    _, seg = corpus_seg
    out = []
    for dev in (DeviceSegmentCache(cuda_device).get(seg),
                DeviceSegmentCache("cpu").get(seg)):
        dp = dev.postings["title"]
        sels, cids = [], []
        for ci, tid in enumerate((3, 40, 211)):
            s, _ = dp.select_blocks([tid], [1.0])
            sels.append(s)
            cids.append(np.full(len(s), ci, np.int32))
        out.append(bm25_ops.conjunction_mask(
            dp.block_docids, dp.block_tfs,
            torch.from_numpy(np.concatenate(sels)).to(dev.device),
            torch.from_numpy(np.concatenate(cids)).to(dev.device),
            3, dev.n_docs_padded).cpu())
    assert torch.equal(out[0], out[1]) and out[1].any()


def test_feature_plane_sum_on_the_card(cuda_device):
    rng = np.random.default_rng(5)
    plane = torch.from_numpy(rng.uniform(0.1, 4, (32, 200000)).astype(
        np.float32))
    missing = torch.from_numpy(rng.random((32, 200000)) < 0.9)
    w = torch.from_numpy(rng.uniform(0.1, 2, 32).astype(np.float32))
    s0, p0 = feature_plane_sum(plane.to(cuda_device),
                               missing.to(cuda_device), w.to(cuda_device))
    s1, p1 = feature_plane_sum(plane, missing, w)
    assert torch.equal(p0.cpu(), p1)
    want = (np.where(missing.numpy(), 0.0, plane.numpy().astype(np.float64))
            * w.numpy().astype(np.float64)[:, None]).sum(axis=0)
    for s in (s0.cpu(), s1):
        np.testing.assert_allclose(s.numpy(), want, rtol=F32_RTOL, atol=0)


def test_fuzzy_launches_the_contribution_kernel(cuda_device, corpus_seg):
    """fuzzy's expansions score in ONE launch of the contribution kernel
    on the card, equal to the kernel's plain twin on the CPU."""
    _, seg = corpus_seg
    mapper = DocumentMapper(MAPPINGS)
    body = {"fuzzy": {"title": {"value": term_name(123),
                                "fuzziness": 1}}}
    out = []
    for device in (cuda_device, "cpu"):
        searcher = ShardSearcher([seg], mapper, DeviceSegmentCache(device))
        ctx = searcher._contexts()[0]
        before = gather_bm25_contrib.launches
        s, m = parse_query(body).execute(ctx)
        torch.cuda.synchronize()
        launched = gather_bm25_contrib.launches - before
        assert launched == (1 if device == cuda_device else 0)
        out.append((s.cpu().numpy(), m.cpu().numpy()))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert out[1][1].any()
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=RTOL, atol=0)


def _bodies(corpus, seg):
    ph2 = _phrase(corpus, seg, 17, 3, 2)
    ph3 = _phrase(corpus, seg, 4242, 0, 3)
    return [
        {"match_phrase": {"title": ph2}},
        {"match_phrase": {"title": {"query": ph3, "slop": 2}}},
        {"match_phrase_prefix": {"title": ph2[:-2]}},
        {"match_bool_prefix": {"title": ph3[:-3]}},
        {"prefix": {"title": "t0001"}},
        {"wildcard": {"title": "t00?2*"}},
        {"regexp": {"title": "t000[1-3][0-9]5"}},
        {"fuzzy": {"title": {"value": term_name(77), "fuzziness": "AUTO"}}},
        {"intervals": {"title": {"match": {"query": ph2, "max_gaps": 2}}}},
        {"span_near": {"clauses": [
            {"span_term": {"title": w}} for w in ph3.split()[:2]],
            "slop": 1, "in_order": True}},
        {"query_string": {"query": f"title:{term_name(5)} AND "
                                   f"(title:{term_name(9)} OR "
                                   f"title:{term_name(11)})"}},
        {"simple_query_string": {"query": f'"{ph2}" | t0003*',
                                 "fields": ["title"]}},
        {"more_like_this": {"fields": ["title"], "like": ph3 + " " + ph3,
                            "min_doc_freq": 1}},
        {"pinned": {"ids": ["9", "3"], "organic": {"match_phrase": {
            "title": ph2}}}},
        {"distance_feature": {"field": "views", "origin": 50, "pivot": 7}},
        {"text_expansion": {"ml.tokens": {"tokens": {
            f"k{k:03d}": 0.1 * (k + 1) for k in range(0, 32, 3)}}}},
        {"rank_feature": {"field": "ml.tokens.k004"}},
        {"rank_feature": {"field": "ml.tokens.k001",
                          "sigmoid": {"pivot": 2.0, "exponent": 0.6}}},
        {"bool": {"must": [{"match_phrase": {"title": ph2}}],
                  "filter": [{"range": {"views": {"gte": 20}}}]}},
    ]


@pytest.mark.parametrize("bi", range(19))
def test_bodies_on_the_card_equal_the_cpu(cuda_device, corpus_seg, bi):
    corpus, seg = corpus_seg
    body = _bodies(corpus, seg)[bi]
    mapper = DocumentMapper(MAPPINGS)
    res = []
    for device in (cuda_device, "cpu"):
        searcher = ShardSearcher([seg], mapper, DeviceSegmentCache(device))
        res.append(searcher.query_phase(parse_query(body), 100))
    card, cpu = res
    assert card.total_hits == cpu.total_hits and cpu.total_hits > 0, body
    sa = np.array([d.score for d in card.docs])
    sb = np.array([d.score for d in cpu.docs])
    if "text_expansion" not in body:
        assert [d.docid for d in card.docs] == [d.docid for d in cpu.docs]
        np.testing.assert_allclose(sa, sb, rtol=RTOL, atol=0)
        return
    np.testing.assert_allclose(sa, sb, rtol=F32_RTOL, atol=0)
    firm = np.abs(sa - sa[-1]) > F32_RTOL * abs(sa[-1])
    assert ({d.docid for d, f in zip(card.docs, firm) if f}
            == {d.docid for d, f in zip(cpu.docs, firm) if f})
