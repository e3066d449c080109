"""The plan path on the card against the same calls on the CPU.

``plan_topk_batch`` on CUDA and on the CPU over one seeded corpus and
cohort (both combine modes, pad groups, const groups, MUST / SHOULD /
FILTER / MUST_NOT, k above the row length): ids, their order and the
totals are equal, scores within rtol 1e-6 (the launch is the same
sequence of elementwise float32 operations, sorts and selections on both
devices). Then whole queries through ``ShardSearcher`` with its
``PlanBatcher`` on a two-segment index, card against CPU."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.corpus import build_corpus, term_name
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import segment_from_numpy
from elasticsearch_tpu_torch.ops import plan as plan_ops
from elasticsearch_tpu_torch.search.batching import PlanBatcher
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import ShardSearcher

pytestmark = pytest.mark.cuda

RTOL = 1e-6


def corpus(seed, n_docs=40000, vocab=3000):
    rng = np.random.default_rng(seed)
    c = build_corpus(rng, n_docs=n_docs, vocab=vocab)
    tb = c["block_docids"].shape[0]
    bd = np.concatenate([c["block_docids"], np.zeros((1, 128), np.int32)])
    bt = np.concatenate([c["block_tfs"], np.zeros((1, 128), np.float32)])
    live = rng.random(n_docs) > 0.02
    return c, tb, bd, bt, live


def cohort(c, tb, q, nb, ngroups, rng):
    """[q, nb] selections: whole terms' block ranges, each term one
    (group, subgroup) entry; the rest pads (zero block, group=ngroups)."""
    sel = np.full((q, nb), tb, np.int32)
    grp = np.full((q, nb), ngroups, np.int32)
    sub = np.zeros((q, nb), np.int32)
    w = np.zeros((q, nb), np.float32)
    cst = np.zeros((q, nb), bool)
    df, nbs, starts = c["df"], c["nb"], c["tbs"]
    n_docs = len(c["lens"])
    for qi in range(q):
        pos = 0
        for _ in range(int(rng.integers(2, 10))):
            t = int(rng.integers(0, len(df)))
            cnt = int(nbs[t])
            if cnt == 0 or pos + cnt > nb:
                continue
            sel[qi, pos:pos + cnt] = np.arange(starts[t], starts[t] + cnt)
            grp[qi, pos:pos + cnt] = rng.integers(0, ngroups)
            sub[qi, pos:pos + cnt] = rng.integers(0, 3)
            w[qi, pos:pos + cnt] = np.log1p((n_docs - df[t] + 0.5)
                                            / (df[t] + 0.5))
            cst[qi, pos:pos + cnt] = rng.random() < 0.2
            pos += cnt
    return sel, grp, sub, w, cst


def launch(dev, c, bd, bt, live, sels, g, scal, k, combine):
    stream = plan_ops.FieldStream(
        torch.from_numpy(bd).to(dev), torch.from_numpy(bt).to(dev),
        torch.from_numpy(c["lens"]).to(dev), float(c["lens"].mean()), *sels)
    out = plan_ops.plan_topk_batch(
        [stream], *g, torch.from_numpy(live).to(dev), *scal, k=k,
        combine=combine)
    return out.cpu().numpy()


@pytest.mark.parametrize("combine", ["sum", "dismax"])
@pytest.mark.parametrize("q,nb,k", [(32, 1024, 1000), (4, 64, 9000)])
def test_plan_topk_batch_card_equals_cpu(cuda_device, q, nb, k, combine):
    c, tb, bd, bt, live = corpus(1)
    rng = np.random.default_rng(q * nb)
    ng = 4
    sels = cohort(c, tb, q, nb, ng, rng)
    kind = np.full((q, 8), plan_ops.FILTER, np.int32)
    req = np.full((q, 8), 1 << 30, np.int32)
    const = np.full((q, 8), np.nan, np.float32)
    kind[:, :ng] = [plan_ops.SHOULD, plan_ops.SHOULD, plan_ops.FILTER,
                    plan_ops.MUST_NOT]
    req[:, :ng] = [1, 2, 1, 1]
    const[:, 1] = 0.5
    # half the queries require the FILTER group, all need one SHOULD
    scal = (np.zeros(q, np.int32), (np.arange(q) % 2).astype(np.int32),
            np.ones(q, np.int32), np.zeros(q, np.float32),
            np.full(q, 0.3, np.float32))
    got = launch(cuda_device, c, bd, bt, live, sels, (kind, req, const),
                 scal, k, combine)
    ref = launch("cpu", c, bd, bt, live, sels, (kind, req, const), scal, k,
                 combine)
    for qi in range(q):
        gv, gi, gt = plan_ops.unpack_result(got[qi], k)
        rv, ri, rt = plan_ops.unpack_result(ref[qi], k)
        assert gt == rt
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(rv))
        f = np.isfinite(rv)
        np.testing.assert_allclose(gv[f], rv[f], rtol=RTOL, atol=0)
    assert sum(plan_ops.unpack_result(ref[qi], k)[2] for qi in range(q)) > 0


def test_searcher_with_batcher_card_equals_cpu(cuda_device):
    """Two segments of one index, match / bool / term / dis_max bodies,
    through the batcher on the card and singly on the CPU."""
    segs = []
    for i, seed in enumerate((2, 3)):
        c = build_corpus(np.random.default_rng(seed), n_docs=20000,
                         vocab=500)
        segs.append(segment_from_numpy(dict(
            terms=[term_name(t) for t in range(len(c["df"]))],
            doc_freq=c["df"], term_block_start=c["tbs"][:-1],
            term_block_count=c["nb"], block_docids=c["block_docids"],
            block_tfs=c["block_tfs"], field_lengths=c["lens"]),
            name=f"seg{i}", field="title"))
    mapper = DocumentMapper({"properties": {"title": {"type": "text"}}})
    card = ShardSearcher(segs, mapper, DeviceSegmentCache(cuda_device))
    card.batcher = PlanBatcher()
    cpu = ShardSearcher(segs, mapper, DeviceSegmentCache("cpu"))
    t = [term_name(i) for i in (3, 40, 77, 120, 300, 450)]
    bodies = [
        {"match": {"title": f"{t[0]} {t[1]} {t[2]}"}},
        {"match": {"title": {"query": f"{t[1]} {t[3]}", "operator": "and"}}},
        {"bool": {"must": [{"match": {"title": t[0]}}],
                  "should": [{"term": {"title": t[4]}}],
                  "must_not": [{"term": {"title": t[5]}}]}},
        {"dis_max": {"queries": [{"match": {"title": t[2]}},
                                 {"match": {"title": t[3]}}],
                     "tie_breaker": 0.4}},
    ]
    for body in bodies:
        got = card.query_phase(parse_query(body), 500)
        ref = cpu.query_phase(parse_query(body), 500)
        assert got.total_hits == ref.total_hits > 0
        assert [(d.segment_idx, d.docid) for d in got.docs] == \
            [(d.segment_idx, d.docid) for d in ref.docs]
        np.testing.assert_allclose([d.score for d in got.docs],
                                   [d.score for d in ref.docs], rtol=RTOL,
                                   atol=0)
